"""The port's LocalSGD and DiLoCo against the JAX package's.

* Stub-manager cases of ``tests/test_local_sgd_integ.py`` through both
  packages on the same numpy inputs: DiLoCo's paper-sign pseudogradient
  (``backup - local``) lands exactly on the inner params at outer lr 1 and
  halfway at 0.5, and the LocalSGD backup never aliases the live params
  (exact; atol 1e-6 for the JAX side's float arithmetic, as its test has).
* Two replica groups as threads (a real native lighthouse, stores,
  CollectivesTcp, the HTTP heal transport) on the tiny transformer of
  ``tests/test_torch_ft_slice.py``, from one ``params_from_jax`` init and
  the same tokens: inner AdamW (``optax.adamw(3e-4)`` on the JAX side),
  re-initialised after every sync, and for DiLoCo the outer SGD(0.7,
  momentum 0.9, Nesterov). After 2 syncs the port's params agree with
  JAX's within rtol 1e-4, atol 1e-5 (float32 summation order and the two
  AdamW formulations' rounding), and the port's groups are bit-identical,
  DiLoCo's outer momentum included.
* A late joiner heals the DiLoCo state at its first sync quorum and ends
  bit-identical (params and outer momentum).
* DiLoCo refuses an async-quorum and a pipelined manager; error feedback
  and the low-rank outer step are refused until the wire codecs are
  ported.
"""

import hashlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_commit_pipeline import ManagerHarness
from tests.test_torch_ft_slice import JCFG, TCFG, TIMEOUT, _np_init, _run_groups, _tokens
from tests.test_torch_optim import port_manager
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.futures import Future
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD
from torchft_tpu_torch.models import transformer as T
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.tree import tree_leaves

SYNC_EVERY = 2
SYNCS = 2


def nesterov_sgd(params):
    return torch.optim.SGD(params, lr=0.7, momentum=0.9, nesterov=True)


class _StubManager:
    """One group: the average is the identity, the commits are scripted."""

    _use_async_quorum = False

    def __init__(self, commits):
        self._commits = list(commits)

    def commit_pipeline_enabled(self):
        return False

    def pending_commit(self):
        return None

    def start_quorum(self):
        pass

    def num_participants(self):
        return 1

    def errored(self):
        return None

    def allreduce(self, arr):
        return self.allreduce_many([arr]).then(lambda f: f.value()[0])

    def allreduce_many(self, arrays):
        return Future.completed(arrays)

    def should_commit(self):
        return self._commits.pop(0)


def _jax_stub(commits):
    from tests.test_local_sgd_integ import _StubManager as JStub

    return JStub(commits)


@pytest.mark.parametrize("lr,expect", [(1.0, 2.0), (0.5, 1.0)])
def test_diloco_outer_step_descends_toward_inner_progress(lr, expect):
    from torchft_tpu.local_sgd import DiLoCo as JDiLoCo

    start = np.zeros(4, dtype=np.float32)
    inner = np.full(4, 2.0, dtype=np.float32)

    jd = JDiLoCo(_jax_stub([True]), optax.sgd(lr), sync_every=1)
    jd.save({"w": start})
    j_out = np.asarray(jd.step({"w": inner})["w"])

    params = {"w": torch.from_numpy(start.copy())}
    d = DiLoCo(_StubManager([True]), lambda ps: torch.optim.SGD(ps, lr=lr), sync_every=1)
    d.save(params)
    params["w"].copy_(torch.from_numpy(inner))  # the inner steps, in place
    assert d.step(params)
    np.testing.assert_allclose(params["w"].numpy(), np.full(4, expect), atol=1e-6)
    np.testing.assert_allclose(params["w"].numpy(), j_out, atol=1e-6)
    # the backup holds the outer step's result, apart from the live params
    assert torch.equal(d._backup["w"], params["w"])
    assert d._backup["w"].data_ptr() != params["w"].data_ptr()


def test_local_sgd_backup_does_not_alias_live_params():
    """After a committed sync the caller keeps training in place; a later
    failed sync restores the synced snapshot, not the mutated buffer."""
    from torchft_tpu.local_sgd import LocalSGD as JLocalSGD

    jl = JLocalSGD(_jax_stub([True, False, False]), sync_every=1)
    jp = {"w": np.full(4, 3.0, dtype=np.float32)}
    jl.save(jp)
    jp["w"][...] = 5.0
    j_seq = []
    synced = jl.step(jp)
    j_seq.append(np.array(synced["w"]))
    synced["w"][...] = 9.0
    restored = jl.step(synced)
    j_seq.append(np.array(restored["w"]))
    restored["w"][...] = 9.0
    j_seq.append(np.array(jl.step(restored)["w"]))

    lsgd = LocalSGD(_StubManager([True, False, False]), sync_every=1)
    params = {"w": torch.full((4,), 3.0)}
    lsgd.save(params)
    params["w"].fill_(5.0)  # in-place update before the first sync
    seq = []
    assert lsgd.step(params)  # commit: the backup takes 5.0
    seq.append(params["w"].numpy().copy())
    params["w"].fill_(9.0)  # in-place inner steps after the sync
    assert lsgd.step(params)  # no commit: back to the snapshot
    seq.append(params["w"].numpy().copy())
    params["w"].fill_(9.0)
    lsgd.step(params)
    seq.append(params["w"].numpy().copy())
    for got, want in zip(seq, j_seq):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.full(4, 5.0))


# ---------------------------------------------------------------------------
# two groups on both packages
# ---------------------------------------------------------------------------


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _momentum(diloco):
    opt = diloco.outer_optimizer
    return [opt.state[p]["momentum_buffer"] for p in opt.param_groups[0]["params"]]


def _port_run(mode, np_params):
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)

    def group(gid):
        store = StoreServer()
        manager = port_manager(gid, lighthouse, store, min_replica_size=2,
                               use_async_quorum=False)
        try:
            ts = TrainStep(TCFG, device="cpu")
            params = T.params_from_jax(np_params, device="cpu")
            if mode == "local_sgd":
                wrapper = LocalSGD(manager, sync_every=SYNC_EVERY)
            else:
                wrapper = DiLoCo(manager, nesterov_sgd, sync_every=SYNC_EVERY)
            wrapper.save(params)
            state = _register(manager, ts, params, wrapper)
            k = 0
            while manager.current_step() < SYNCS:
                ts.step(params, state["opt"], torch.from_numpy(_tokens(gid, k)))
                k += 1
                if wrapper.step(params):
                    state["opt"] = ts.init_opt(params)
            out = {"params": {n: t.detach().numpy().copy() for n, t in _flat(params)}}
            out["digest"] = _digest(tree_leaves(params))
            if mode == "diloco":
                out["momentum"] = _digest(_momentum(wrapper))
            return out
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        return _run_groups(group)
    finally:
        lighthouse.shutdown()


def _register(manager, ts, params, wrapper):
    """Live recovery of the params and the wrapper's state (the quorum at
    step 0 bootstraps every group from one source); a healed group starts
    a fresh inner optimizer. Returns the holder of the inner optimizer."""
    state = {"opt": ts.init_opt(params), "healed": 0}

    def load(s):
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params), tree_leaves(s["params"])):
                dst.copy_(src)
        wrapper.load_state_dict(s["wrapper"])
        state["opt"] = ts.init_opt(params)
        state["healed"] += 1

    manager.set_state_dict_fns(
        load, lambda: {"params": params, "wrapper": wrapper.state_dict()}
    )
    return state


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _jax_run(mode, np_params):
    from torchft_tpu.collectives import CollectivesTcp as JCollectivesTcp
    from torchft_tpu.coordination import LighthouseServer as JLighthouse
    from torchft_tpu.local_sgd import DiLoCo as JDiLoCo
    from torchft_tpu.local_sgd import LocalSGD as JLocalSGD
    from torchft_tpu.manager import Manager as JManager
    from torchft_tpu.parallel.mesh import MeshConfig, make_mesh
    from torchft_tpu.parallel.train_step import TrainStep as JTrainStep
    from torchft_tpu.store import StoreServer as JStore

    lighthouse = JLighthouse(bind="[::]:0", min_replicas=2)

    def group(gid):
        store = JStore()
        manager = JManager(
            collectives=JCollectivesTcp(timeout=TIMEOUT), load_state_dict=None,
            state_dict=None, min_replica_size=2, replica_id=f"g{gid}",
            store_addr=store.address(), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(), timeout=TIMEOUT,
            use_async_quorum=False,
        )
        try:
            ts = JTrainStep(JCFG, optax.adamw(3e-4), make_mesh(MeshConfig(), jax.devices()[:1]))

            def place(tree):
                return jax.device_put(tree, ts._param_shardings)

            st = {"params": place(np_params)}
            st["opt"] = ts.init_opt(st["params"])
            if mode == "local_sgd":
                wrapper = JLocalSGD(manager, sync_every=SYNC_EVERY)
            else:
                wrapper = JDiLoCo(manager, optax.sgd(0.7, momentum=0.9, nesterov=True),
                                  sync_every=SYNC_EVERY)
            wrapper.save(st["params"])

            def load(s):
                st["params"] = place(s["params"])
                st["opt"] = ts.init_opt(st["params"])
                wrapper.load_state_dict(s["wrapper"])

            manager.set_state_dict_fns(
                load, lambda: {"params": st["params"], "wrapper": wrapper.state_dict()}
            )
            k = 0
            while manager.current_step() < SYNCS:
                tokens = ts.shard_batch(jnp.asarray(_tokens(gid, k)))
                k += 1
                _, grads = ts.grads(st["params"], tokens)
                params, st["opt"] = ts.apply(st["params"], st["opt"], grads, donate=False)
                st["params"] = params
                synced = wrapper.step(params)
                if synced is not params:
                    st["params"] = place(synced)
                    st["opt"] = ts.init_opt(st["params"])
            return {n: np.asarray(v) for n, v in _flat(jax.tree_util.tree_map(np.asarray, st["params"]))}
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        return _run_groups(group)
    finally:
        lighthouse.shutdown()


@pytest.mark.parametrize("mode", ["local_sgd", "diloco"])
def test_two_groups_match_jax(mode):
    np_params = _np_init()
    jax_out = _jax_run(mode, np_params)
    port = _port_run(mode, np_params)
    for gid in (0, 1):
        for name, want in jax_out[gid].items():
            np.testing.assert_allclose(
                port[gid]["params"][name], want, rtol=1e-4, atol=1e-5, err_msg=name
            )
    assert port[0]["digest"] == port[1]["digest"], "port groups diverged"
    if mode == "diloco":
        assert port[0]["momentum"] == port[1]["momentum"], "outer momentum diverged"


def test_diloco_late_joiner_heals_bit_identical():
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    first_sync = threading.Event()

    def group(gid):
        if gid == 1 and not first_sync.wait(timeout=120):
            raise TimeoutError("group 0 never synced")
        store = StoreServer()
        manager = port_manager(gid, lighthouse, store, min_replica_size=1,
                               use_async_quorum=False)
        try:
            ts = TrainStep(TCFG, device="cpu")
            params = ts.init_params(10 + gid)  # different inits: the heal must matter
            diloco = DiLoCo(manager, nesterov_sgd, sync_every=SYNC_EVERY)
            diloco.save(params)
            state = _register(manager, ts, params, diloco)
            joint = k = 0
            while joint < 1 + SYNCS:  # the heal's sync, then two more
                ts.step(params, state["opt"], torch.from_numpy(_tokens(gid, k)))
                k += 1
                if diloco.step(params):
                    assert not diloco._just_healed  # consumed by the sync
                    state["opt"] = ts.init_opt(params)
                    if manager.num_participants() == 2:
                        joint += 1
                    first_sync.set()
            return (manager.current_step(), _digest(tree_leaves(params)),
                    _digest(_momentum(diloco)), state["healed"])
        finally:
            first_sync.set()
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        (s0, d0, m0, h0), (s1, d1, m1, h1) = (r for _, r in sorted(_run_groups(group).items()))
    finally:
        lighthouse.shutdown()
    assert h0 == 0 and h1 == 1, "group 1 did not heal exactly once"
    assert s0 == s1 and d0 == d1 and m0 == m1


def test_diloco_rejects_async_and_pipelined_managers(store_server):
    for kwargs, match in (
        (dict(use_async_quorum=True, commit_pipeline=False), "use_async_quorum"),
        (dict(use_async_quorum=False, commit_pipeline=True), "commit_pipeline"),
    ):
        h = ManagerHarness(store_server, **kwargs)
        try:
            with pytest.raises(ValueError, match=match):
                DiLoCo(h.manager, nesterov_sgd, sync_every=2)
        finally:
            h.shutdown()


def test_wire_codec_options_are_refused(monkeypatch):
    """The wire-codec options are no longer refused (the codecs are
    ported): they resolve as the JAX package's do, ``outer_rank`` from the
    argument or ``TORCHFT_WIRE_OUTER_RANK``, with a low-rank carry in the
    state only when it is on."""
    from torchft_tpu.local_sgd import DiLoCo as JDiLoCo
    from torchft_tpu_torch.wire_codec import ErrorFeedback, get_codec

    stub = _StubManager([])
    shared = ErrorFeedback(get_codec("bfloat16"))
    assert LocalSGD(stub, sync_every=2, error_feedback=shared).error_feedback is shared
    assert LocalSGD(stub, sync_every=2).error_feedback is None  # exact wire
    for kwargs, env in (({"outer_rank": 4}, None), ({}, "2"), ({"outer_rank": 0}, None)):
        if env is not None:
            monkeypatch.setenv("TORCHFT_WIRE_OUTER_RANK", env)
        d = DiLoCo(stub, nesterov_sgd, sync_every=2, error_feedback=False, **kwargs)
        j = JDiLoCo(_jax_stub([]), optax.sgd(0.7), sync_every=2, error_feedback=False, **kwargs)
        assert d._outer_rank == j._outer_rank
        d.save([torch.zeros(2, 2)])
        assert ("lr_ef" in d.state_dict()) == (j._lr_ef is not None)
        monkeypatch.delenv("TORCHFT_WIRE_OUTER_RANK", raising=False)


@pytest.fixture
def store_server():
    s = StoreServer()
    yield s
    s.shutdown()
