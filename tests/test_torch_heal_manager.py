"""The Manager's heal plane in the port: the cases of
``tests/test_manager.py`` for the striped heal (a stripe source stages
without an assigned healer, ``TORCHFT_HEAL_SOURCES=1`` stages nothing,
the heal resolves the cohort and calls ``recv_checkpoint_multi``, the
commit trail is recorded at step boundaries), the single-source path of
a transport without ``recv_checkpoint_multi``, and the speculation fence
over a stripe source under the pipelined commit (with a patched
``ManagerClient``, the harness of ``tests/test_torch_commit_pipeline.py``).

Real groups as threads (lighthouse, stores, CollectivesTcp, HTTP heal):
three groups, one joining late, heal it from two sources
(``nsources == 2``) and end with the params of the same script on the JAX
package, bitwise (numpy state, host averages on the native plane); and a
group that rejoins two steps behind with ``TORCHFT_HEAL_DIFF=1`` heals by
delta, or by the full striped heal when its state no longer matches its
digest, and ends bit-identical to the source.
"""

from __future__ import annotations

import hashlib
import threading
import time
from datetime import timedelta
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from tests.test_torch_commit_pipeline import ManagerHarness, _echo_vote, _reduce, quorum_result
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.store import StoreServer

TIMEOUT = timedelta(seconds=30)


@pytest.fixture
def store_server():
    s = StoreServer()
    yield s
    s.shutdown()


@pytest.fixture
def harness(store_server):
    hs = []

    def make(**kwargs):
        kwargs.setdefault("commit_pipeline", False)
        h = ManagerHarness(store_server, **kwargs)
        hs.append(h)
        return h

    yield make
    for h in hs:
        h.shutdown()


def _stripe_quorum(**kw):
    q = quorum_result(max_rank=1, max_step=7, **kw)
    q.heal_pending = True
    q.recover_src_addresses = ["a0", "a1"]
    return q


def test_stripe_source_stages_without_assigned_healer(harness):
    """When anyone heals this round (heal_pending), every up-to-date member
    stages, not only the assigned source, so the healer can pull a stripe
    from each."""
    h = harness()
    h.client._quorum.return_value = _stripe_quorum()
    h.manager.start_quorum()
    h.manager.wait_quorum()
    h.transport.send_checkpoint.assert_called_once()
    kwargs = h.transport.send_checkpoint.call_args.kwargs
    assert kwargs["dst_ranks"] == [] and kwargs["step"] == 7
    assert kwargs["state_dict"]["user"] == {"user_key": 1}


def test_stripe_source_staging_respects_single_source_knob(harness, monkeypatch):
    monkeypatch.setenv("TORCHFT_HEAL_SOURCES", "1")
    h = harness()
    h.client._quorum.return_value = _stripe_quorum()
    h.manager.start_quorum()
    h.manager.wait_quorum()
    h.transport.send_checkpoint.assert_not_called()


def test_member_past_the_source_cap_skips_staging(harness, monkeypatch):
    """A cohort member the healer never contacts (past its source cap)
    skips the flatten."""
    monkeypatch.setenv("TORCHFT_HEAL_SOURCES", "2")
    h = harness()
    q = _stripe_quorum()
    q.recover_src_addresses = ["a0", "a1", h.manager._manager_addr]
    h.client._quorum.return_value = q
    h.manager.start_quorum()
    h.manager.wait_quorum()
    h.transport.send_checkpoint.assert_not_called()


def test_heal_uses_multi_source_with_cohort(harness):
    """The healer resolves the whole max-step cohort, primary first, and
    hands the transport both sources' metadata."""
    h = harness()
    h.client._quorum.return_value = quorum_result(heal=True, max_step=20, recover_src_rank=0)
    h.client._quorum.return_value.recover_src_addresses = ["peer2 address", "manager address"]
    h.client._checkpoint_metadata.side_effect = ["meta one", "meta two"]
    h.transport.recv_checkpoint.return_value = {
        "user": {"recovered": True},
        "torchft": {"step": 20, "batches_committed": 0},
    }
    h.manager.start_quorum()
    h.manager.wait_quorum()
    assert h.manager._healing and h.manager.current_step() == 20
    call = h.transport.recv_checkpoint_multi.call_args
    assert sorted(call.args[0]) == ["meta one", "meta two"]
    assert call.kwargs["step"] == 20
    # the differential heal is off: no credentials
    assert call.kwargs["own"] is None and call.kwargs["since_step"] is None
    h.transport.recv_checkpoint.assert_not_called()


def test_transport_without_multi_takes_one_source(store_server):
    """A transport without ``recv_checkpoint_multi`` (CollectivesTransport)
    keeps the single-source heal from the primary."""
    transport = MagicMock(spec=CheckpointTransport)
    transport.metadata.return_value = "transport_meta"
    transport.recv_checkpoint.return_value = {
        "user": {"recovered": True},
        "torchft": {"step": 5, "batches_committed": 0},
    }
    h = ManagerHarness(store_server, commit_pipeline=False)
    h.manager._checkpoint_transport = transport
    try:
        h.client._quorum.return_value = quorum_result(heal=True, max_step=5, recover_src_rank=0)
        h.client._checkpoint_metadata.return_value = "primary meta"
        h.manager.start_quorum()
        h.manager.wait_quorum()
        assert transport.recv_checkpoint.call_args.kwargs["metadata"] == "primary meta"
        assert h.manager.current_step() == 5
    finally:
        h.shutdown()


def test_commit_trail_recorded_at_step_boundaries(harness, monkeypatch):
    """TORCHFT_HEAL_DIFF=1: the Manager digests the committed state at each
    start_quorum and shares the trail with the transport."""
    monkeypatch.setenv("TORCHFT_HEAL_DIFF", "1")
    h = harness()
    m = h.manager
    assert m._heal_trail is not None
    assert h.transport.commit_trail is m._heal_trail
    h.client._quorum.return_value = quorum_result(max_rank=1)
    m.start_quorum()
    assert m._heal_trail.steps() == [0]
    h.client.should_commit.return_value = True
    assert m.should_commit()
    m.start_quorum()
    assert m._heal_trail.steps() == [0, 1]
    m.start_quorum()  # a retried step records once
    assert m._heal_trail.steps() == [0, 1]


def test_trail_is_off_by_default(harness):
    assert harness().manager._heal_trail is None


def test_heal_sends_own_digest_when_the_trail_is_on(harness, monkeypatch):
    monkeypatch.setenv("TORCHFT_HEAL_DIFF", "1")
    state = {"w": np.arange(8, dtype=np.float32)}
    h = harness()
    m = h.manager
    m.set_state_dict_fns(MagicMock(), lambda: state)
    m.load_state_dict({"step": 3, "batches_committed": 6})
    h.client._quorum.return_value = quorum_result(heal=True, max_step=5, recover_src_rank=0)
    h.transport.recv_checkpoint.return_value = {
        "user": state, "torchft": {"step": 5, "batches_committed": 10}}
    m.start_quorum()
    m.wait_quorum()
    call = h.transport.recv_checkpoint_multi.call_args
    assert call.kwargs["since_step"] == 3
    buffers, digest = call.kwargs["own"]
    assert digest == m._heal_trail.get(3)["tree"]


class _Committed:
    """A user state that says whether the pipelined vote had resolved when
    it was read."""

    def __init__(self):
        self.resolved = False

    def state_dict(self):
        return {"resolved": self.resolved}


def test_speculation_fence_holds_a_stripe_source(harness):
    """Under the pipelined commit a stripe source stages only after the main
    thread resolved the vote: it never serves a speculative state."""
    h = harness(commit_pipeline=True)
    m = h.manager
    user = _Committed()
    m.set_state_dict_fns(MagicMock(), user.state_dict)
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.side_effect = _echo_vote
    m.start_quorum()
    _reduce(m)
    m.should_commit_async(on_resolved=lambda ok: setattr(user, "resolved", True))

    h.client._quorum.return_value = _stripe_quorum()
    m.start_quorum()
    time.sleep(0.3)
    h.transport.send_checkpoint.assert_not_called()  # parked on the fence
    assert m.resolve_pending_commit() is True
    m.wait_quorum()
    h.transport.send_checkpoint.assert_called_once()
    assert h.transport.send_checkpoint.call_args.kwargs["state_dict"]["user"] == {"resolved": True}
    assert m.errored() is None


def test_speculation_fence_timeout_skips_stripe_staging(harness):
    """A trainer that never resolves its vote: the stripe source stages
    nothing and fails the step."""
    h = harness(commit_pipeline=True, timeout=timedelta(seconds=1))
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.side_effect = _echo_vote
    m.start_quorum()
    _reduce(m)
    m.should_commit_async()
    h.client._quorum.return_value = _stripe_quorum()
    m.start_quorum()
    m.wait_quorum()
    h.transport.send_checkpoint.assert_not_called()
    assert "fence timed out" in str(m.errored())
    assert m.resolve_pending_commit() is True
    assert not m.should_commit()


# ---------------------------------------------------------------------------
# real groups
# ---------------------------------------------------------------------------

K, J = 2, 2  # steps of the first two groups alone, joint steps after the join


def _grad(gid, step):
    return np.random.default_rng([gid, step]).standard_normal(4096).astype(np.float32)


def _three_groups(pkg_name):
    """Groups 0 and 1 take K steps; group 2 (another init) asks for its
    first quorum, then 0 and 1 ask for theirs: one quorum of three, in
    which group 2 heals from both. Then J joint steps. Returns each group's
    step, final state bytes and heal stats."""
    if pkg_name == "port":
        from torchft_tpu_torch.collectives import CollectivesTcp
        from torchft_tpu_torch.coordination import LighthouseServer
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.store import StoreServer as Store

        def transport():
            return {"checkpoint_transport": HTTPTransport(timeout=TIMEOUT, hostname="localhost")}
    else:
        from torchft_tpu.collectives import CollectivesTcp
        from torchft_tpu.coordination import LighthouseServer
        from torchft_tpu.manager import Manager
        from torchft_tpu.store import StoreServer as Store

        def transport():
            return {}

    # a straggler that heartbeats is waited for: the quorum of three forms
    # whatever the threads' timing
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2, join_timeout_ms=30000)
    pair_ready = threading.Barrier(3, timeout=60)
    joiner_asked = threading.Event()
    out, errors = {}, []

    def group(gid):
        if gid == 2:
            pair_ready.wait()
        store = Store()
        m = Manager(
            collectives=CollectivesTcp(timeout=TIMEOUT), load_state_dict=None, state_dict=None,
            min_replica_size=2, replica_id=f"g{gid}", store_addr=store.address(), rank=0,
            world_size=1, lighthouse_addr=lighthouse.address(), timeout=TIMEOUT, **transport(),
        )
        st = {"w": np.full(4096, float(gid), np.float32)}
        m.set_state_dict_fns(lambda state: st.update(w=np.array(state["w"])),
                             lambda: {"w": st["w"].copy()})
        try:
            while True:
                step = m.current_step()
                if gid < 2 and step == K and not joiner_asked.is_set():
                    pair_ready.wait()
                    if not joiner_asked.wait(60):
                        raise TimeoutError("group 2 never asked for a quorum")
                    time.sleep(0.5)  # its request reaches the lighthouse first
                m.start_quorum()
                if gid == 2 and not joiner_asked.is_set():
                    joiner_asked.set()
                (g,) = m.allreduce_many([_grad(gid, step)]).wait()
                committed = m.should_commit()
                if committed:
                    st["w"] += g
                if committed and m.current_step() >= K + J and m.num_participants() == 3:
                    break
            stats = getattr(m._checkpoint_transport, "last_heal_stats", {})
            out[gid] = dict(step=m.current_step(), w=st["w"].tobytes(),
                            nsources=stats.get("nsources"), mode=stats.get("mode"))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            pair_ready.abort()
            joiner_asked.set()
        finally:
            m.shutdown(wait=False)
            store.shutdown()

    threads = [threading.Thread(target=group, args=(g,)) for g in range(3)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(180)
    finally:
        lighthouse.shutdown()
    assert all(not th.is_alive() for th in threads), "a replica group hung"
    if errors:
        raise errors[0]
    return out


def test_three_groups_late_joiner_stripes_from_two_and_matches_jax():
    port = _three_groups("port")
    jax = _three_groups("jax")
    for out in (port, jax):
        assert out[2]["mode"] == "striped" and out[2]["nsources"] == 2, out[2]
        assert len({o["step"] for o in out.values()}) == 1
        assert len({o["w"] for o in out.values()}) == 1, "groups ended with different state"
    assert port[0]["step"] == jax[0]["step"]
    assert port[0]["w"] == jax[0]["w"], "the port's final params differ from the JAX package's"


def _digest(trainer) -> str:
    from torchft_tpu_torch.benchmarks.recovery import _state_digest

    return _state_digest(trainer)


@pytest.mark.parametrize("perturb", [False, True], ids=["delta", "digest-mismatch-full"])
def test_rejoin_two_steps_behind_heals_by_delta(monkeypatch, perturb):
    """TORCHFT_HEAL_DIFF=1, two groups of the tiny transformer. Group 1
    leaves at step 2 (its Manager shut down, its trainer kept), group 0
    takes two steps alone, then group 1 comes back with a new Manager whose
    counters say step 2: it heals by delta from group 0's trail (or, with
    one of its params changed, by the full striped heal) and both end with
    one sha256."""
    from torchft_tpu_torch.benchmarks.recovery import _model_config
    from torchft_tpu_torch.collectives import CollectivesTcp
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep

    monkeypatch.setenv("TORCHFT_HEAL_DIFF", "1")
    cfg, (batch, seq) = _model_config("cpu")
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1, join_timeout_ms=100,
                                  heartbeat_timeout_ms=1000)
    left, back, asked = threading.Event(), threading.Event(), threading.Event()
    out, errors = {}, []

    def manager(gid, store):
        return Manager(
            collectives=CollectivesTcp(timeout=TIMEOUT), load_state_dict=None, state_dict=None,
            min_replica_size=1, replica_id=f"g{gid}_", store_addr=store.address(), rank=0,
            world_size=1, lighthouse_addr=lighthouse.address(), timeout=TIMEOUT,
            checkpoint_transport=HTTPTransport(timeout=TIMEOUT, hostname="localhost"),
        )

    def tokens(gid, step):
        return torch.from_numpy(np.random.default_rng([gid, step]).integers(
            0, cfg.vocab_size, (batch, seq)))

    def group(gid):
        store = StoreServer()
        m = manager(gid, store)
        try:
            trainer = FTTrainer(m, TrainStep(cfg, device="cpu"))
            trainer.init(seed=0)
            while True:
                step = m.current_step()
                if gid == 1 and step == 2 and not left.is_set():
                    m.shutdown(wait=False)
                    left.set()
                    if not back.wait(120):
                        raise TimeoutError("group 0 never took its steps alone")
                    if perturb:
                        with torch.no_grad():
                            next(iter(trainer.params.values())).add_(1.0)
                    m = manager(gid, store)
                    m.load_state_dict({"step": 2, "batches_committed": 4})
                    trainer._manager = m
                    m.set_state_dict_fns(trainer.load_state_dict, trainer.state_dict)
                    ask = m.start_quorum

                    def asked_first(*args, **kwargs):
                        ask(*args, **kwargs)
                        asked.set()

                    m.start_quorum = asked_first
                if gid == 0 and step == 4 and left.is_set() and not back.is_set():
                    # group 0 waits here, two steps ahead, for group 1's
                    # quorum request
                    back.set()
                    if not asked.wait(120):
                        raise TimeoutError("group 1 never came back")
                    time.sleep(0.5)
                _, committed = trainer.step(tokens(gid, step))
                if committed and m.current_step() >= 6 and m.num_participants() == 2:
                    break
            stats = m._checkpoint_transport.last_heal_stats
            out[gid] = dict(step=m.current_step(), digest=_digest(trainer),
                            stats=dict(stats))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            left.set()
            back.set()
            asked.set()
        finally:
            m.shutdown(wait=False)
            store.shutdown()

    threads = [threading.Thread(target=group, args=(g,)) for g in range(2)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(240)
    finally:
        lighthouse.shutdown()
    assert all(not th.is_alive() for th in threads), "a replica group hung"
    if errors:
        raise errors[0]
    assert out[0]["step"] == out[1]["step"] and out[0]["digest"] == out[1]["digest"]
    stats = out[1]["stats"]
    if perturb:
        assert stats["mode"] == "striped"
    else:
        assert stats["mode"] == "delta" and stats["delta"]["since_step"] == 2
        # AdamW changes every leaf each step
        assert 0 < stats["delta"]["changed"] <= stats["delta"]["leaves"]
