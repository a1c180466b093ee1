"""The port's public API against the JAX package's.

``torchft_tpu_torch`` exports the JAX package's ``__all__`` less the one
name whose module is not ported yet (ROADMAP queue 1 item 6:
``CollectivesDeviceDist``), the heavier wrappers (``CollectivesProxy`` and
``ParameterServer`` among them) at first access; importing it in a fresh process starts
no thread and imports no JAX. ``CollectivesDummy`` answers every op as the
JAX one does on the same numpy inputs; ``ManagedCollectives`` over a stub
Manager behaves as the JAX one, and over two real threaded groups averages
like the JAX package's through ``Manager.allreduce``; ``Future.failed`` and
``future_wait`` behave as the JAX futures'.
"""

import json
import os
import subprocess
import sys
import threading
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest

import torchft_tpu
import torchft_tpu_torch
from torchft_tpu import collectives as JC
from torchft_tpu import futures as JF
from torchft_tpu_torch import collectives as PC
from torchft_tpu_torch import futures as PF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_YET = {"CollectivesDeviceDist"}


def test_public_names_are_the_jax_packages_less_the_unported():
    assert set(torchft_tpu_torch.__all__) == set(torchft_tpu.__all__) - NOT_YET
    for name in torchft_tpu_torch.__all__:
        assert getattr(torchft_tpu_torch, name) is not None, name


@pytest.mark.parametrize("name,module", [
    ("telemetry", "torchft_tpu_torch.telemetry"),
    ("ManagedOptimizer", "torchft_tpu_torch.optim"),
    ("LocalSGD", "torchft_tpu_torch.local_sgd"),
    ("DiLoCo", "torchft_tpu_torch.local_sgd"),
    ("CollectivesDevice", "torchft_tpu_torch.collectives_device"),
    ("FTTrainer", "torchft_tpu_torch.parallel.ft"),
    ("WorldSizeMode", "torchft_tpu_torch.manager"),
    ("CollectivesProxy", "torchft_tpu_torch.proxy"),
    ("ParameterServer", "torchft_tpu_torch.parameter_server"),
])
def test_lazy_names_resolve_to_their_modules(name, module):
    got = getattr(torchft_tpu_torch, name)
    assert (got.__name__ if name == "telemetry" else got.__module__) == module
    assert getattr(torchft_tpu, name).__name__.rsplit(".", 1)[-1] == name.rsplit(".", 1)[-1]


@pytest.mark.parametrize("name", sorted(NOT_YET) + ["NoSuchName"])
def test_unported_names_raise_attribute_error(name):
    with pytest.raises(AttributeError, match=name):
        getattr(torchft_tpu_torch, name)


def test_import_starts_nothing_and_imports_no_jax():
    code = (
        "import json, sys, threading\n"
        "import torchft_tpu_torch\n"
        "print(json.dumps({'threads': [t.name for t in threading.enumerate()],\n"
        "                  'modules': sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                                    ('jax', 'jaxlib', 'optax', 'torchft_tpu')),\n"
        "                  'native': 'torchft_tpu_torch._native' in sys.modules and\n"
        "                            sys.modules['torchft_tpu_torch._native']._lib is not None}))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"threads": ["MainThread"], "modules": [], "native": False}, out


# ---------------------------------------------------------------------------
# CollectivesDummy
# ---------------------------------------------------------------------------


def _arrays(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(int(rng.integers(1, 9))).astype(np.float32) for _ in range(n)]


def _dummy_ops(pkg):
    c = pkg.CollectivesDummy(rank=1, world_size=3)
    c.configure("store/torchft/7/1", 2, 4)
    a = _arrays(0)
    out = {
        "allreduce": c.allreduce(a).wait(),
        "allgather": c.allgather(a[0]).wait(),
        "broadcast": c.broadcast(a[1], root=2).wait(),
        "reduce_scatter": c.reduce_scatter(_arrays(1, 4)).wait(),
        "alltoall": c.alltoall(_arrays(2, 4)).wait(),
        "send": c.send(a[0], dst=1).wait(),
        "recv": c.recv(a[2], src=0).wait(),
        "barrier": c.barrier().wait(),
    }
    return out, (c.size(), c.rank(), c.configure_count, c.plane_info())


def test_collectives_dummy_equals_jax():
    port, p_state = _dummy_ops(PC)
    ref, j_state = _dummy_ops(JC)
    assert p_state[:3] == j_state[:3] == (4, 2, 1)
    assert p_state[3] == j_state[3] == "CollectivesDummy"
    for op in port:
        got, want = port[op], ref[op]
        if want is None:
            assert got is None, op
        elif isinstance(want, list):
            assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want)), op
        else:
            assert np.array_equal(got, want), op


# ---------------------------------------------------------------------------
# ManagedCollectives
# ---------------------------------------------------------------------------


def _stub_manager(pkg_futures, participants=3, rank=None):
    seen = []

    def allreduce(arr):
        seen.append(arr)
        return pkg_futures.Future.completed(arr / participants)

    return SimpleNamespace(allreduce=allreduce, num_participants=lambda: participants,
                           participating_rank=lambda: rank, wire_codec=lambda: "bfloat16",
                           seen=seen)


@pytest.mark.parametrize("rank", [None, 2])
def test_managed_collectives_on_a_stub_equal_jax(rank):
    results = {}
    for pkg, fut in ((PC, PF), (JC, JF)):
        mgr = _stub_manager(fut, rank=rank)
        c = pkg.ManagedCollectives(mgr)
        arr = np.arange(6, dtype=np.float32)
        out = c.allreduce([arr]).wait()
        errors = []
        for call in (lambda: c.allreduce([arr, arr]), lambda: c.configure("s", 0, 1),
                     lambda: c.allgather(arr), lambda: c.broadcast(arr),
                     lambda: c.reduce_scatter([arr]), lambda: c.alltoall([arr]),
                     lambda: c.send(arr, 0), lambda: c.recv(arr, 0), lambda: c.barrier()):
            try:
                call()
                errors.append(None)
            except Exception as e:  # noqa: BLE001 — compared below
                errors.append((type(e).__name__, str(e)))
        results[pkg] = (out, c.size(), c.rank(), c.wire_codec(), errors, len(mgr.seen))
    port, ref = results[PC], results[JC]
    assert np.array_equal(port[0], ref[0])
    assert port[1:] == ref[1:]
    assert port[1:4] == (3, rank if rank is not None else 0, "bfloat16")


TIMEOUT = timedelta(seconds=20)


def _two_groups(make_manager, make_managed, arrays):
    """Two threaded groups, each averaging its array through
    ``ManagedCollectives`` (``Manager.allreduce``) for two steps."""
    out, errors = {}, []

    def group(gid):
        try:
            manager = make_manager(gid)
            try:
                c = make_managed(manager)
                got = []
                for step in range(2):
                    manager.start_quorum()
                    got.append((c.size(), np.array(c.allreduce([arrays[gid][step].copy()]).wait())))
                    assert manager.should_commit()
                out[gid] = got
            finally:
                manager.shutdown(wait=False)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=group, args=(g,)) for g in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not any(th.is_alive() for th in threads), "a group hung"
    if errors:
        raise errors[0]
    return out


def _port_manager_factory(lighthouse, stores):
    from torchft_tpu_torch.manager import Manager

    def make(gid):
        return Manager(collectives=PC.CollectivesTcp(timeout=TIMEOUT), load_state_dict=lambda s: None,
                       state_dict=lambda: {}, min_replica_size=2, replica_id=f"api{gid}",
                       store_addr=stores[gid].address(), rank=0, world_size=1,
                       lighthouse_addr=lighthouse.address(), timeout=TIMEOUT)

    return make


def _jax_manager_factory(lighthouse, stores):
    from torchft_tpu.manager import Manager

    def make(gid):
        return Manager(collectives=JC.CollectivesTcp(timeout=TIMEOUT), load_state_dict=lambda s: None,
                       state_dict=lambda: {}, min_replica_size=2, replica_id=f"api{gid}",
                       store_addr=stores[gid].address(), rank=0, world_size=1,
                       lighthouse_addr=lighthouse.address(), timeout=TIMEOUT)

    return make


def test_managed_collectives_average_across_two_groups_as_jax():
    """Each group's ManagedCollectives (through ``Manager.allreduce``) sees
    the participating world of 2 and returns, bitwise, the JAX package's
    average: after the bootstrap heal's step, the groups' mean."""
    from torchft_tpu.coordination import LighthouseServer as JLighthouse
    from torchft_tpu.store import StoreServer as JStore
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.store import StoreServer

    rng = np.random.default_rng(3)
    arrays = {g: [rng.standard_normal(257).astype(np.float32) for _ in range(2)] for g in range(2)}
    results = {}
    for name, lh_cls, store_cls, factory, managed in (
            ("port", LighthouseServer, StoreServer, _port_manager_factory, PC.ManagedCollectives),
            ("jax", JLighthouse, JStore, _jax_manager_factory, JC.ManagedCollectives)):
        lighthouse = lh_cls(bind="[::]:0", min_replicas=2)
        stores = [store_cls() for _ in range(2)]
        try:
            results[name] = _two_groups(factory(lighthouse, stores), managed, arrays)
        finally:
            for st in stores:
                st.shutdown()
            lighthouse.shutdown()
    for gid in range(2):
        for step in range(2):
            (psize, pval), (jsize, jval) = results["port"][gid][step], results["jax"][gid][step]
            assert psize == jsize == 2
            assert np.array_equal(pval, jval)
        # step 0 holds the bootstrap heal (the healing group adds zeros); at
        # step 1 both contribute
        np.testing.assert_allclose(results["port"][gid][1][1],
                                   (arrays[0][1] + arrays[1][1]) / 2, rtol=1e-6)


# ---------------------------------------------------------------------------
# Future.failed, future_wait
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exc", [ValueError("bad"), TimeoutError("late"), KeyError("k")])
def test_failed_future_equals_jax(exc):
    for fut in (PF.Future.failed(exc), JF.Future.failed(exc)):
        assert fut.done() and fut.exception() is exc
        with pytest.raises(type(exc)):
            fut.wait()
        with pytest.raises(type(exc)):
            fut.value()
        chained = fut.then(lambda f: f.value() + 1)
        assert chained.done() and chained.exception() is exc


def test_future_wait_equals_jax():
    for pkg in (PF, JF):
        assert pkg.future_wait(pkg.Future.completed(7), timedelta(seconds=1)) == 7
        pending = pkg.Future()
        with pytest.raises(TimeoutError):
            pkg.future_wait(pending, timedelta(milliseconds=50))
        threading.Timer(0.05, lambda p=pending: p.set_result("late")).start()
        assert pkg.future_wait(pending, timedelta(seconds=5)) == "late"
        with pytest.raises(RuntimeError):
            pkg.future_wait(pkg.Future.failed(RuntimeError("x")), timedelta(seconds=1))
    assert "future_wait" in PF.__all__ and "future_wait" in JF.__all__
