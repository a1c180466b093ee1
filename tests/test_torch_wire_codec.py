"""The port's wire codecs and error feedback against the JAX package's.

* The bytes of ``encode_into`` (and the decoded floats) equal the JAX
  codecs' for f32, bfloat16 and int8, on seeded random data, on random
  bit patterns (every NaN payload among them) and on edge values: +-0,
  ties, subnormals, +-inf, NaN, an all-zero chunk and an empty one. The
  port's bfloat16 is numpy bit arithmetic, the JAX one an ``ml_dtypes``
  cast; exact equality.
* ``ErrorFeedback``, ``LowRankErrorFeedback`` and ``lowrank_basis`` reach
  the JAX package's states after the same apply/commit/rollback
  sequence: exact (the same numpy operations on the same inputs).
* ``ManagedOptimizer`` with error feedback, and ``DiLoCo`` with
  ``outer_rank=4``, against the JAX wrappers on the same gradients, on
  single-group stub managers (commits scripted, a veto among them), and
  ``ManagedOptimizer`` over two threaded groups on the bf16 wire (the
  native striped plane) against two JAX groups. Tolerances are stated
  where the two packages' float arithmetic differs (torch SGD against
  optax, torch matmul against numpy's).
"""

from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta

import numpy as np
import optax
import pytest
import torch

import torchft_tpu.wire_codec as J
import torchft_tpu_torch.wire_codec as P
from torchft_tpu_torch.futures import Future
from torchft_tpu_torch.utils.tree import tree_leaves

TIMEOUT = timedelta(seconds=15)


def _edge_values() -> np.ndarray:
    floats = np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40, 1.17e-38,
         1.0, -1.0, 3.4e38, -3.4e38], np.float32)
    bits = np.array(
        [0x7F800001, 0x7FBFFFFF, 0xFFC12345, 0x7F7FFFFF, 0xFF7FFFFF, 0x00008000,
         0x00018000, 0x3F808000, 0x3F818000, 0x807FFFFF, 0x00000001, 0x7FFFFFFF],
        np.uint32).view(np.float32)
    return np.concatenate([floats, bits])


def _cases():
    rng = np.random.default_rng(0)
    scaled = (rng.standard_normal(4099) * np.exp(rng.uniform(-80, 80, 4099))).astype(np.float32)
    return {
        "edges": _edge_values(),
        "normal": rng.standard_normal(10007).astype(np.float32),
        "scaled": scaled,
        "bit_patterns": rng.integers(0, 2**32, 16384, dtype=np.uint64)
        .astype(np.uint32).view(np.float32),
        "zeros": np.zeros(33, np.float32),
        "empty": np.zeros(0, np.float32),
        "one": np.array([2.5], np.float32),
    }


@pytest.mark.filterwarnings("ignore::RuntimeWarning")  # ml_dtypes casting NaN
@pytest.mark.parametrize("case", sorted(_cases()))
@pytest.mark.parametrize("codec", P.CODEC_NAMES)
def test_encode_bytes_equal_jax(codec, case):
    x = _cases()[case]
    jc, pc = J.get_codec(codec), P.get_codec(codec)
    assert pc.name == jc.name and pc.lossy == jc.lossy
    assert pc.wire_nbytes(x.size) == jc.wire_nbytes(x.size)
    want = bytes(jc.encode_into(x))
    got = bytes(pc.encode_into(x))
    assert got == want
    if codec != "f32":
        wire = np.frombuffer(got, dtype=np.uint8)
        jd, pd = np.empty_like(x), np.empty_like(x)
        jc.decode_into(wire, jd)
        pc.decode_into(wire, pd)
        assert pd.tobytes() == jd.tobytes()
        assert pc.decode_tmp(wire, x.size).tobytes() == jd.tobytes()
        jr, pr = x.copy(), x.copy()
        jc.roundtrip(jr)
        pc.roundtrip(pr)
        assert pr.tobytes() == jr.tobytes()


def test_codec_registry_and_scratch_reuse():
    with pytest.raises(ValueError):
        P.get_codec("fp4")
    assert isinstance(P.get_codec(None), P.F32Codec)
    assert isinstance(P.get_codec("float32"), P.F32Codec)
    c = P.get_codec("bfloat16")
    c.encode_into(np.ones(1000, np.float32))
    scratch = c._wire
    c.encode_into(np.ones(10, np.float32))
    assert c._wire is scratch  # grown once, reused


def _ef_sequence(mod):
    """One apply/commit/rollback sequence on ``mod``'s classes; returns the
    committed state, the pending keys and the projected buffers."""
    rng = np.random.default_rng(4)
    ef = mod.ErrorFeedback(mod.get_codec("int8"))
    out = []
    for step, fate in enumerate(("commit", "rollback", "commit", "commit")):
        buf = (rng.standard_normal(256) * 0.01).astype(np.float32)
        small = (rng.standard_normal(8 if step < 2 else 16)).astype(np.float32)
        ef.apply("b0_256", buf)
        ef.apply("b1", small)  # the plan changes size at step 2
        out.append((buf.tobytes(), small.tobytes(), ef.pending_keys()))
        getattr(ef, fate)()
    return ef.state_dict(), out


def test_error_feedback_states_equal_jax():
    jstate, jout = _ef_sequence(J)
    pstate, pout = _ef_sequence(P)
    assert pout == jout
    assert pstate["codec"] == jstate["codec"] == "int8"
    assert sorted(pstate["acc"]) == sorted(jstate["acc"])
    for k in jstate["acc"]:
        assert pstate["acc"][k].tobytes() == jstate["acc"][k].tobytes()
    # the heal path: a state loads into either package's accumulator
    ef = P.ErrorFeedback(P.get_codec("int8"))
    ef.load_state_dict(jstate)
    assert ef.state_dict()["acc"]["b0_256"].tobytes() == jstate["acc"]["b0_256"].tobytes()
    other = P.ErrorFeedback(P.get_codec("bfloat16"))
    other.load_state_dict(jstate)  # another codec's grid: dropped
    assert other.state_dict()["acc"] == {}
    with pytest.raises(ValueError):
        P.ErrorFeedback(P.get_codec("f32"))


@pytest.mark.parametrize("shape,rank,seed", [((64, 32), 4, 7), ((48, 16), 2, 0), ((20, 40), 4, 1_000_003)])
def test_lowrank_basis_bitwise_equal_jax(shape, rank, seed):
    q = P.lowrank_basis(shape, rank, seed)
    assert q.tobytes() == J.lowrank_basis(shape, rank, seed).tobytes()
    assert P.lowrank_eligible(shape, rank) == J.lowrank_eligible(shape, rank)


def _lowrank_sequence(mod):
    rng = np.random.default_rng(9)
    m = rng.standard_normal((48, 32)).astype(np.float32)
    ef = mod.LowRankErrorFeedback()
    for t, fate in enumerate(("commit", "rollback", "commit")):
        comp = ef.compensate("l0", m)
        q = mod.lowrank_basis(m.shape, 4, seed=t)
        ef.stage("l0", comp, (comp @ q) @ q.T)
        getattr(ef, fate)()
    return ef.state_dict()


def test_lowrank_error_feedback_state_equal_jax():
    got, want = _lowrank_sequence(P), _lowrank_sequence(J)
    assert sorted(got["acc"]) == sorted(want["acc"]) == ["l0"]
    assert got["acc"]["l0"].tobytes() == want["acc"]["l0"].tobytes()


# ---------------------------------------------------------------------------
# the loop on stub managers (one group: the average is the identity)
# ---------------------------------------------------------------------------


class _PortStub:
    """A one-group Manager stand-in on a lossy wire, commits scripted."""

    _use_async_quorum = False

    def __init__(self, commits, codec):
        self._commits = list(commits)
        self._codec = codec

    def wire_codec(self):
        return self._codec

    def set_state_dict_fns(self, load, save):
        pass

    def pending_commit(self):
        return None

    def commit_pipeline_enabled(self):
        return False

    def start_quorum(self, **kw):
        pass

    def speculation_allowed(self):
        return False

    def device_data_plane(self):
        return False

    def num_participants(self):
        return 1

    def errored(self):
        return None

    def allreduce_many(self, arrays):
        return Future.completed(arrays)

    def should_commit(self):
        return self._commits.pop(0)


def _jax_stub(commits, codec):
    from tests.test_wire_codec import _WireStubManager

    class _Mgr(_WireStubManager):
        _use_async_quorum = False

        def commit_pipeline_enabled(self):
            return False

    return _Mgr(commits, codec=codec)


FATES = [True, False, True, True]


@pytest.mark.parametrize("codec", ["int8", "bfloat16"])
def test_managed_optimizer_error_feedback_equal_jax(codec):
    """The JAX ``TestManagedOptimizerEF`` sequence (commit, abort, commit,
    commit) on both packages: the residuals equal bitwise at every step
    (the same buckets through the same codec), the params within rtol 1e-6
    (torch SGD's update against optax's rounding), an aborted step leaves
    params and residuals untouched, and ``state_dict()["ef"]`` heals a
    fresh optimizer of either package."""
    from torchft_tpu.optim import ManagedOptimizer as JManagedOptimizer
    from torchft_tpu_torch.optim import ManagedOptimizer

    rng = np.random.default_rng(11)
    init = {"b": rng.standard_normal(7).astype(np.float32),
            "w": rng.standard_normal((8, 8)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 0.013).astype(np.float32)
              for k, v in init.items()} for _ in FATES]

    jopt = JManagedOptimizer(_jax_stub(FATES, codec), optax.sgd(1.0))
    jopt.init({k: v.copy() for k, v in init.items()})
    popt = ManagedOptimizer(_PortStub(FATES, codec),
                            lambda p: torch.optim.SGD(tree_leaves(p), lr=1.0))
    popt.init({k: torch.from_numpy(v.copy()) for k, v in init.items()})
    assert popt.error_feedback is not None and popt.error_feedback.codec.name == codec
    for g in grads:
        jopt.step({k: v.copy() for k, v in g.items()})
        popt.step({k: torch.from_numpy(v.copy()) for k, v in g.items()})
        jacc = jopt.error_feedback.state_dict()["acc"]
        pacc = popt.error_feedback.state_dict()["acc"]
        assert sorted(pacc) == sorted(jacc)
        for k in jacc:
            assert pacc[k].tobytes() == jacc[k].tobytes()
        assert popt.error_feedback.pending_keys() == ()
        for k in init:
            np.testing.assert_allclose(popt.params[k].numpy(), np.asarray(jopt.params[k]),
                                       rtol=1e-6, atol=1e-7)
    state = popt.state_dict()
    assert set(state) == {"params", "opt_state", "ef"}
    healed = ManagedOptimizer(_PortStub([], codec), lambda p: torch.optim.SGD(tree_leaves(p), lr=1.0))
    healed.init({k: torch.zeros_like(v) for k, v in popt.params.items()})
    healed.load_state_dict(state)
    for k, v in state["ef"]["acc"].items():
        assert healed.error_feedback.state_dict()["acc"][k].tobytes() == v.tobytes()
    lazy = ManagedOptimizer(_PortStub([], "f32"), lambda p: torch.optim.SGD(tree_leaves(p), lr=1.0))
    lazy.init({k: torch.zeros_like(v) for k, v in popt.params.items()})
    assert lazy.error_feedback is None  # exact wire: no accumulator yet
    lazy.load_state_dict(state)  # adopts the healed accumulators
    assert lazy.error_feedback is not None
    lazy.load_state_dict({"params": state["params"], "opt_state": state["opt_state"]})
    assert lazy.error_feedback.state_dict()["acc"] == {}  # healed without EF: clean


def test_managed_optimizer_ef_abort_keeps_residuals():
    from torchft_tpu_torch.optim import ManagedOptimizer

    opt = ManagedOptimizer(_PortStub([True, False], "int8"),
                           lambda p: torch.optim.SGD(tree_leaves(p), lr=1.0))
    opt.init({"w": torch.zeros(64)})
    g = torch.full((64,), 0.013)
    opt.step({"w": g.clone()})
    acc = opt.error_feedback.state_dict()["acc"]
    w = opt.params["w"].clone()
    opt.step({"w": g.clone()})  # aborted
    assert torch.equal(opt.params["w"], w)
    for k, v in opt.error_feedback.state_dict()["acc"].items():
        assert v.tobytes() == acc[k].tobytes()


def test_error_feedback_false_disables_auto_mode():
    """``error_feedback=False`` keeps a lossy wire uncompensated: no
    accumulator at construction nor after a step; the default makes one."""
    from torchft_tpu_torch.optim import ManagedOptimizer

    sgd = lambda p: torch.optim.SGD(tree_leaves(p), lr=1.0)
    off = ManagedOptimizer(_PortStub([True], "int8"), sgd, error_feedback=False)
    off.init({"w": torch.zeros(64)})
    off.step({"w": torch.full((64,), 0.013)})
    assert off.error_feedback is None
    assert ManagedOptimizer(_PortStub([], "int8"), sgd).error_feedback is not None


def test_diloco_outer_rank_equal_jax():
    """DiLoCo with ``outer_rank=4`` and bf16 error feedback on both
    packages through syncs that commit, abort and commit: ``outer_syncs``
    and the ``lr_ef`` keys equal, the low-rank carries and params within
    rtol 1e-5 (torch's float32 matmul against numpy's, then the outer
    Nesterov step)."""
    from torchft_tpu.local_sgd import DiLoCo as JDiLoCo
    from torchft_tpu_torch.local_sgd import DiLoCo

    fates = [True, False, True]
    rng = np.random.default_rng(21)
    init = {"b": rng.standard_normal(16).astype(np.float32),
            "w": rng.standard_normal((32, 24)).astype(np.float32),
            "z": rng.standard_normal((8, 12)).astype(np.float32)}  # too thin at rank 4
    inner = [{k: v + (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
              for k, v in init.items()} for _ in fates]
    jd = JDiLoCo(_jax_stub(fates, "bfloat16"), optax.sgd(0.7, momentum=0.9, nesterov=True),
                 sync_every=1, outer_rank=4)
    pd = DiLoCo(_PortStub(fates, "bfloat16"),
                lambda ps: torch.optim.SGD(ps, lr=0.7, momentum=0.9, nesterov=True),
                sync_every=1, outer_rank=4)
    jparams = {k: v.copy() for k, v in init.items()}
    pparams = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    jd.save(jparams)
    pd.save(pparams)
    for k_in in inner:
        # each sync starts from the same inner progress relative to init
        jparams = jd.step({k: v.copy() for k, v in k_in.items()})
        for k, v in k_in.items():
            pparams[k].copy_(torch.from_numpy(v))
        pd.step(pparams)
        for k in init:
            np.testing.assert_allclose(pparams[k].numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-5)
    js, ps = jd.state_dict(), pd.state_dict()
    assert ps["outer_syncs"] == js["outer_syncs"] == 2
    assert sorted(ps["lr_ef"]["acc"]) == sorted(js["lr_ef"]["acc"]) == ["l1"]
    np.testing.assert_allclose(ps["lr_ef"]["acc"]["l1"].numpy(), js["lr_ef"]["acc"]["l1"],
                               rtol=1e-5, atol=1e-5)
    assert sorted(ps["ef"]["acc"]) == sorted(js["ef"]["acc"])
    # the heal path: lr_ef reaches a fresh DiLoCo, on its backup's device
    fresh = DiLoCo(_PortStub([], "bfloat16"),
                   lambda ps_: torch.optim.SGD(ps_, lr=0.7, momentum=0.9, nesterov=True),
                   sync_every=1, outer_rank=4)
    fresh.save({k: torch.zeros_like(v) for k, v in pparams.items()})
    fresh.load_state_dict(ps)
    assert fresh._outer_syncs == 2
    assert torch.equal(fresh._lr_ef.state_dict()["acc"]["l1"], ps["lr_ef"]["acc"]["l1"])


# ---------------------------------------------------------------------------
# the loop on two threaded groups over the bf16 wire
# ---------------------------------------------------------------------------


def _two_groups(pkg, grads, init):
    """Two groups (threads; a real lighthouse, stores, managers) step a
    ManagedOptimizer with automatic error feedback through the given
    gradients on the bf16 wire of the native striped plane; returns each
    group's params, residuals and (plane, codec) per step."""
    if pkg == "port":
        from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
        from torchft_tpu_torch.collectives import CollectivesTcp
        from torchft_tpu_torch.coordination import LighthouseServer
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.optim import ManagedOptimizer
        from torchft_tpu_torch.store import StoreServer

        make_opt = lambda m: ManagedOptimizer(m, lambda p: torch.optim.SGD(tree_leaves(p), lr=0.5))
        to_params = lambda d: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
        to_grads = to_params
        host = lambda t: np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
        extra = lambda: {"checkpoint_transport": HTTPTransport(timeout=TIMEOUT, hostname="localhost")}
    else:
        from torchft_tpu.collectives import CollectivesTcp
        from torchft_tpu.coordination import LighthouseServer
        from torchft_tpu.manager import Manager
        from torchft_tpu.optim import ManagedOptimizer
        from torchft_tpu.store import StoreServer

        make_opt = lambda m: ManagedOptimizer(m, optax.sgd(0.5))
        to_params = lambda d: {k: v.copy() for k, v in d.items()}
        to_grads = to_params
        host = np.asarray
        extra = dict
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)

    def group(gid):
        store = StoreServer()
        manager = Manager(
            collectives=CollectivesTcp(timeout=TIMEOUT, wire_dtype="bfloat16", native_plane=True),
            load_state_dict=None, state_dict=None, min_replica_size=2,
            replica_id=f"g{gid}", store_addr=store.address(), rank=0, world_size=1,
            lighthouse_addr=lighthouse.address(), timeout=TIMEOUT, **extra(),
        )
        try:
            opt = make_opt(manager)
            opt.init(to_params(init))
            trail = []
            while manager.current_step() < len(grads[gid]):
                g = grads[gid][manager.current_step()]
                opt.begin_step()
                opt.step(to_grads(g))
                acc = opt.error_feedback.state_dict()["acc"]
                trail.append((manager.current_step(),
                              manager._collectives.plane_info(), manager.wire_codec(),
                              {k: v.tobytes() for k, v in acc.items()},
                              opt.error_feedback.pending_keys()))
            return {k: host(v) for k, v in opt.params.items()}, trail
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        with ThreadPoolExecutor(max_workers=2) as ex:
            return list(ex.map(group, range(2)))
    finally:
        lighthouse.shutdown()


def test_two_groups_on_the_bf16_wire_equal_jax(monkeypatch):
    """Every step commits; the residuals after each commit
    are bitwise the JAX groups' (the same buckets, codec and C++ ring), no
    residual stays pending, and the params agree with JAX's within rtol
    1e-6 and are bitwise equal across the port's two groups."""
    monkeypatch.setenv("TORCHFT_DP_CMA", "0")  # CMA would bypass the codec
    rng = np.random.default_rng(5)
    init = {"b": rng.standard_normal(5).astype(np.float32),
            "w": rng.standard_normal((16, 12)).astype(np.float32)}
    grads = [[{k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32) for k, v in init.items()}
              for _ in range(3)] for _ in range(2)]
    port = _two_groups("port", grads, init)
    ref = _two_groups("jax", grads, init)
    for gid in (0, 1):
        pparams, ptrail = port[gid]
        jparams, jtrail = ref[gid]
        assert [t[:3] for t in ptrail] == [(s, "tcp-striped", "bfloat16") for s in (1, 2, 3)]
        assert ptrail == jtrail
        for k in init:
            np.testing.assert_allclose(pparams[k], jparams[k], rtol=1e-6, atol=1e-7)
    for k in init:
        assert port[0][0][k].tobytes() == port[1][0][k].tobytes()
