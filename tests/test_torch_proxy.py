"""The port's subprocess-isolated collectives against the JAX package's:
the cases of ``tests/test_proxy.py`` on ``torchft_tpu_torch.proxy`` and
``torchft_tpu_torch.multiprocessing``.

* ``MonitoredQueue`` notices a dead process and re-raises a child's
  exception.
* The shared-memory allreduce (float32 and bfloat16, SUM and AVG) at world
  2 on random numpy inputs: each rank's result bitwise equal to the JAX
  proxy's on the same inputs, in the caller's arrays, no segment left in
  ``/dev/shm``; the small allreduce (the pickle path) lands in place.
* A killed child fails the next op within the JAX test's 5 s; reconfigure
  respawns the child; the parent-side ``collective.issue`` fault point.
* Two threaded groups, each a Manager over a proxy around ``CollectivesTcp``
  and SGD(0.05) on a linear model (batches drawn from the committed step):
  group 1 kills its child at step 2; the step fails on both groups, the
  next quorum respawns the children and both groups end bit-identical,
  with no trainer restart. The same loop on the JAX package ends with the
  same params to ``PARAMS_RTOL`` (float32; the packages' matmul sums differ
  in order).

The proxies' factories are ``functools.partial`` of each package's
``CollectivesTcp``, so the spawned children import the package and not
this test module.
"""

from __future__ import annotations

import functools
import glob
import multiprocessing as mp
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import ml_dtypes
import numpy as np
import pytest

from torchft_tpu import collectives as JC
from torchft_tpu import proxy as JP
from torchft_tpu import store as JS
from torchft_tpu_torch import collectives as PC
from torchft_tpu_torch import proxy as PP
from torchft_tpu_torch import store as PS
from torchft_tpu_torch.faultinject import core as fi
from torchft_tpu_torch.multiprocessing import MonitoredQueue

T = timedelta(seconds=20)
PARAMS_RTOL = 1e-5


def _pair(proxy_mod, coll_mod, store_mod):
    store = store_mod.StoreServer()
    factory = functools.partial(coll_mod.CollectivesTcp, timeout=timedelta(seconds=10))
    proxies = [proxy_mod.CollectivesProxy(factory, timeout=T) for _ in range(2)]
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda i: proxies[i].configure(store.address(), i, 2), range(2)))
    return proxies, store


def _close(proxies, store):
    for p in proxies:
        p.shutdown()
    store.shutdown()


@pytest.fixture
def port_pair():
    proxies, store = _pair(PP, PC, PS)
    yield proxies
    _close(proxies, store)


@pytest.fixture(scope="module")
def both_pairs():
    """One proxy pair of each package, for the cases that only read."""
    port, pstore = _pair(PP, PC, PS)
    jax, jstore = _pair(JP, JC, JS)
    yield {"port": port, "jax": jax}
    _close(port, pstore)
    _close(jax, jstore)


def _allreduce(proxies, arrays, op):
    works = [p.allreduce([a], op) for p, a in zip(proxies, arrays)]
    for w in works:
        w.wait(timeout=T)


# ---------------------------------------------------------------------------
# MonitoredQueue
# ---------------------------------------------------------------------------


def test_monitored_queue_dead_process_detection():
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=time.sleep, args=(0.2,))
    proc.start()
    proc.join()
    with pytest.raises(RuntimeError, match="dead"):
        MonitoredQueue(q).get(proc, timeout=5.0)


def test_monitored_queue_exception_reraise():
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=time.sleep, args=(5,))
    proc.start()
    try:
        q.put(ValueError("boom"))
        with pytest.raises(ValueError, match="boom"):
            MonitoredQueue(q).get(proc, timeout=5.0)
    finally:
        proc.terminate()
        proc.join()


# ---------------------------------------------------------------------------
# the proxy
# ---------------------------------------------------------------------------


def test_plane_info_reports_inner_backend(both_pairs):
    """``proxy:<inner>``: the child's live transport, as the JAX proxy
    reports it, and the codec the child rides."""
    for pkg in ("port", "jax"):
        for p in both_pairs[pkg]:
            info = p.plane_info()
            assert info.startswith("proxy:") and len(info) > len("proxy:"), (pkg, info)
            assert "CollectivesTcp" not in info
            assert p.wire_codec() == "f32"
    assert [p.plane_info() for p in both_pairs["port"]] == [
        p.plane_info() for p in both_pairs["jax"]]


@pytest.mark.parametrize("dtype,op", [
    (np.float32, "SUM"), (np.float32, "AVG"), (ml_dtypes.bfloat16, "AVG"),
], ids=["float32-sum", "float32-avg", "bfloat16-avg"])
def test_allreduce_shm_bitwise_equal_to_jax(both_pairs, dtype, op):
    """Above ``_SHM_MIN_BYTES`` the buffers ride shared memory and land in
    the callers' arrays; both packages' results are the same bits."""
    n = 1 << 16
    rng = np.random.default_rng(11)
    inputs = [rng.standard_normal(n).astype(np.float32).astype(dtype) for _ in range(2)]
    assert inputs[0].nbytes >= PP._SHM_MIN_BYTES
    out = {}
    before = set(glob.glob("/dev/shm/psm_*"))
    for pkg, mod in (("port", PC), ("jax", JC)):
        arrays = [a.copy() for a in inputs]
        _allreduce(both_pairs[pkg], arrays, getattr(mod.ReduceOp, op))
        out[pkg] = arrays
    for a, b in zip(out["port"], out["jax"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert out["port"][0].tobytes() == out["port"][1].tobytes()
    ref = inputs[0].astype(np.float32) + inputs[1].astype(np.float32)
    if op == "AVG":
        ref = ref / 2
    np.testing.assert_allclose(out["port"][0].astype(np.float32), ref,
                               rtol=1e-6 if dtype is np.float32 else 2.0 ** -7, atol=1e-6)
    # the segments are unlinked after the copy back (no /dev/shm leak)
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline:
        leaked = set(glob.glob("/dev/shm/psm_*")) - before
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, leaked


def test_allreduce_in_place(both_pairs):
    """Below the threshold the arrays go through the queue (pickled) and the
    result is copied into the callers' buffers."""
    for pkg, mod in (("port", PC), ("jax", JC)):
        a = np.array([1.0, 2.0], dtype=np.float32)
        b = np.array([3.0, 4.0], dtype=np.float32)
        _allreduce(both_pairs[pkg], [a, b], mod.ReduceOp.SUM)
        np.testing.assert_array_equal(a, [4.0, 6.0])
        np.testing.assert_array_equal(b, [4.0, 6.0])


def test_child_kill_surfaces_quickly(port_pair):
    port_pair[0].kill_child()
    t0 = time.monotonic()
    w = port_pair[0].allreduce([np.ones(2, dtype=np.float32)], PC.ReduceOp.SUM)
    with pytest.raises(Exception):
        w.wait(timeout=timedelta(seconds=10))
    assert time.monotonic() - t0 < 5.0  # the JAX test's bound


def test_pending_op_fails_when_the_child_dies(port_pair):
    """The drain thread fails an op in flight when its child dies (the peer
    never joins this allreduce, so only the death can end it)."""
    w = port_pair[0].allreduce([np.ones(4, dtype=np.float32)], PC.ReduceOp.SUM)
    time.sleep(0.2)
    assert port_pair[0].num_active_work() == 1
    t0 = time.monotonic()
    port_pair[0].kill_child()
    with pytest.raises(RuntimeError, match="child died"):
        w.wait(timeout=timedelta(seconds=10))
    assert time.monotonic() - t0 < 5.0
    assert port_pair[0].num_active_work() == 0


def test_reconfigure_respawns(port_pair):
    store2 = PS.StoreServer()
    try:
        port_pair[0].kill_child()
        old_pids = [p._proc.pid for p in port_pair]
        with ThreadPoolExecutor(max_workers=2) as pool:
            list(pool.map(lambda i: port_pair[i].configure(store2.address(), i, 2), range(2)))
        assert all(new != old for new, old in zip([p._proc.pid for p in port_pair], old_pids))
        a = np.ones(4, dtype=np.float32)
        b = np.ones(4, dtype=np.float32)
        _allreduce(port_pair, [a, b], PC.ReduceOp.AVG)
        np.testing.assert_array_equal(a, 1.0)
    finally:
        store2.shutdown()


def test_issue_fault_point_fires_parent_side(port_pair):
    """``collective.issue`` with ``match="proxy.<op>"`` at the parent, as the
    JAX proxy's site."""
    fi.configure({"seed": 1, "rules": [{"site": "collective.issue", "match": "proxy.allreduce",
                                        "nth": 1, "action": "error", "exc": "ConnectionError"}]})
    try:
        with pytest.raises(ConnectionError):
            port_pair[0].allreduce([np.ones(2, dtype=np.float32)], PC.ReduceOp.SUM)
    finally:
        fi.configure(None)


# ---------------------------------------------------------------------------
# a Manager over the proxy, both packages
# ---------------------------------------------------------------------------

TOTAL_STEPS = 4
KILL_AT = 2


def _batch(gid, step):
    rng = np.random.default_rng(77 + 1000 * gid + step)
    return (rng.standard_normal((8, 3)).astype(np.float32),
            rng.standard_normal((8, 4)).astype(np.float32))


def _init():
    rng = np.random.default_rng(42)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": np.zeros(4, dtype=np.float32)}


def _port_loop(gid, lighthouse_addr, store_addr, killed):
    import torch

    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.optim import ManagedOptimizer
    from torchft_tpu_torch.utils.tree import tree_leaves

    torch.set_num_threads(1)
    factory = functools.partial(PC.CollectivesTcp, timeout=timedelta(seconds=10))
    manager = Manager(
        collectives=PP.CollectivesProxy(factory, timeout=T), load_state_dict=None,
        state_dict=None, min_replica_size=2, replica_id=str(gid), store_addr=store_addr,
        rank=0, world_size=1, lighthouse_addr=lighthouse_addr,
        timeout=timedelta(seconds=15), quorum_timeout=timedelta(seconds=30))
    try:
        opt = ManagedOptimizer(
            manager, lambda p: torch.optim.SGD(tree_leaves(p), lr=0.05))
        opt.init({k: torch.from_numpy(v) for k, v in _init().items()})
        commits = []
        for _ in range(40):
            opt.begin_step()
            step = manager.current_step()
            if gid == 1 and step == KILL_AT and not killed.is_set():
                killed.set()
                manager._collectives.kill_child()
            x, y = (torch.from_numpy(a) for a in _batch(gid, step))
            w = opt.params["w"].detach().requires_grad_(True)
            b = opt.params["b"].detach().requires_grad_(True)
            loss = ((x @ w + b - y) ** 2).mean()
            gw, gb = torch.autograd.grad(loss, [w, b])
            opt.step({"w": gw, "b": gb})
            commits.append(manager.current_step() > step)
            if manager.current_step() >= TOTAL_STEPS:
                break
        return {"params": {k: v.numpy().copy() for k, v in opt.params.items()},
                "commits": commits, "step": manager.current_step(),
                "plane": manager._collectives.plane_info()}
    finally:
        manager.shutdown(wait=False)


def _jax_loop(gid, lighthouse_addr, store_addr, killed):
    import jax
    import optax

    from torchft_tpu.manager import Manager
    from torchft_tpu.optim import ManagedOptimizer

    factory = functools.partial(JC.CollectivesTcp, timeout=timedelta(seconds=10))
    manager = Manager(
        collectives=JP.CollectivesProxy(factory, timeout=T), load_state_dict=None,
        state_dict=None, min_replica_size=2, replica_id=str(gid), store_addr=store_addr,
        rank=0, world_size=1, lighthouse_addr=lighthouse_addr,
        timeout=timedelta(seconds=15), quorum_timeout=timedelta(seconds=30))

    def loss_fn(params, x, y):
        return ((x @ params["w"] + params["b"] - y) ** 2).mean()

    try:
        opt = ManagedOptimizer(manager, optax.sgd(0.05))
        opt.init(_init())
        grad_fn = jax.jit(jax.grad(loss_fn))
        commits = []
        for _ in range(40):
            opt.begin_step()
            step = manager.current_step()
            if gid == 1 and step == KILL_AT and not killed.is_set():
                killed.set()
                manager._collectives.kill_child()
            x, y = _batch(gid, step)
            opt.step(grad_fn(opt.params, x, y))
            commits.append(manager.current_step() > step)
            if manager.current_step() >= TOTAL_STEPS:
                break
        return {"params": jax.tree_util.tree_map(np.asarray, opt.params), "commits": commits,
                "step": manager.current_step(), "plane": manager._collectives.plane_info()}
    finally:
        manager.shutdown(wait=False)


def _run_groups(loop, coord_mod, store_mod):
    lighthouse = coord_mod.LighthouseServer(bind="[::]:0", min_replicas=2)
    stores = [store_mod.StoreServer() for _ in range(2)]
    killed = threading.Event()
    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            return list(ex.map(lambda g: loop(g, lighthouse.address(), stores[g].address(),
                                              killed), range(2)))
    finally:
        for s in stores:
            s.shutdown()
        lighthouse.shutdown()


def test_manager_over_proxy_kill_child_recovers_without_restart_as_jax():
    from torchft_tpu import coordination as JCo
    from torchft_tpu_torch import coordination as PCo

    # both packages' runs at once (each its own lighthouse and stores)
    with ThreadPoolExecutor(max_workers=2) as ex:
        port_f = ex.submit(_run_groups, _port_loop, PCo, PS)
        jax_f = ex.submit(_run_groups, _jax_loop, JCo, JS)
        port, jax = port_f.result(), jax_f.result()
    for res in (port, jax):
        a, b = res
        assert a["step"] >= TOTAL_STEPS and b["step"] >= TOTAL_STEPS
        # the killed child's step committed on neither group...
        assert False in a["commits"] and False in b["commits"]
        # ...and both groups converge to bit-identical params afterwards
        for key in a["params"]:
            np.testing.assert_array_equal(a["params"][key], b["params"][key])
        assert a["plane"].startswith("proxy:")
    for key in port[0]["params"]:
        np.testing.assert_allclose(port[0]["params"][key], jax[0]["params"][key],
                                   rtol=PARAMS_RTOL, atol=1e-6)
