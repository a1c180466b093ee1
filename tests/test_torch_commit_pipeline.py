"""The pipelined commit of the port: the cases of
``tests/test_commit_pipeline.py`` against ``torchft_tpu_torch``'s Manager,
with the same harness (a patched ``ManagerClient`` scripting the quorum and
the votes, and a dummy or faulty data plane).

Manager level: the async vote's lifecycle, veto and rollback, a lost vote,
the speculation gates (a healing replica, an error latch), the misuse
guards, a sync quorum resolving the vote first, and a fence timeout.
Wrapper level: ManagedOptimizer's rollback with replay (with a check that
the snapshot is a copy, not a reference), its rollback inside
``begin_step`` under a sync quorum, and a heal that supersedes a pending
replay. Trainer parity: over a schedule with one vetoed vote and one failed
allreduce, a pipelined FTTrainer run ends with the sync run's params and
optimizer state, bit for bit (sha256).

Against the JAX package: the same schedule through the JAX pipelined
FTTrainer and ManagedOptimizer, under the JAX test's harness, from one
numpy init and the same tokens; the per-step losses agree within rtol 1e-4
and the final params within rtol 1e-4, atol 1e-5 (float32: summation order
and the two AdamW formulations' rounding, compounded over the steps). On
both harnesses, the step each Manager reports with a vote in flight.

Real groups (lighthouse, stores, CollectivesTcp, HTTP heal): two pipelined
groups end as the sync run does, with one heal; and with a sync quorum and
the pipeline on, a late joiner heals and ends bit-identical without a
speculation-fence timeout. Exact comparisons throughout, except
ManagedOptimizer's params (rtol 1e-6, as in the JAX test) and the parity
with the JAX package.
"""

import hashlib
import logging
import threading
from datetime import timedelta
from typing import List
from unittest.mock import MagicMock, patch

import numpy as np
import pytest
import torch

from torchft_tpu_torch.collectives import Collectives, PeerGoneError, ReduceOp, Work
from torchft_tpu_torch.coordination import QuorumResult
from torchft_tpu_torch.manager import MANAGER_ADDR_KEY, REPLICA_ID_KEY, Manager
from torchft_tpu_torch.store import StoreClient, StoreServer
from torchft_tpu_torch.utils.tree import tree_leaves


def quorum_result(
    quorum_id=123,
    replica_rank=1,
    replica_world_size=2,
    heal=False,
    max_step=20,
    max_rank=None,
    max_world_size=2,
    recover_src_rank=None,
    recover_dst_ranks=(),
):
    return QuorumResult(
        quorum_id=quorum_id,
        replica_rank=replica_rank,
        replica_world_size=replica_world_size,
        recover_src_manager_address="manager address",
        recover_src_rank=recover_src_rank,
        recover_dst_ranks=list(recover_dst_ranks),
        store_address="store_addr/prefix",
        max_step=max_step,
        max_rank=max_rank,
        max_world_size=max_world_size,
        heal=heal,
        group_heal=heal,
    )


class DummyCollectives(Collectives):
    """One group's data plane: every op completes at once, unchanged."""

    def __init__(self) -> None:
        self.calls = 0

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        pass

    def allreduce(self, arrays: List[np.ndarray], op: ReduceOp = ReduceOp.SUM) -> Work:
        self.calls += 1
        return Work.completed(arrays)

    def allgather(self, arr):
        return Work.completed([arr.copy()])

    def broadcast(self, arr, root=0):
        return Work.completed(arr)

    def reduce_scatter(self, arrays, op=ReduceOp.SUM):
        return Work.completed(arrays[0].copy())

    def alltoall(self, arrays):
        return Work.completed([a.copy() for a in arrays])

    def send(self, arr, dst, tag=0):
        return Work.completed()

    def recv(self, arr, src, tag=0):
        return Work.completed(arr)

    def barrier(self):
        return Work.completed()

    def size(self) -> int:
        return 1

    def rank(self) -> int:
        return 0


class FaultyCollectives(DummyCollectives):
    """Raises PeerGoneError on the scripted (1-based) allreduce calls: the
    failed-op face of a peer dying mid-step."""

    def __init__(self, fault_calls) -> None:
        super().__init__()
        self.fault_calls = set(fault_calls)

    def allreduce(self, arrays, op=ReduceOp.SUM):
        if self.calls + 1 in self.fault_calls:
            self.calls += 1
            raise PeerGoneError(0, f"peer 0 died mid-op (call {self.calls})")
        return super().allreduce(arrays, op)


@pytest.fixture
def store_server():
    s = StoreServer()
    yield s
    s.shutdown()


class ManagerHarness:
    def __init__(self, store_server, collectives=None, **kwargs):
        self.store = StoreClient(store_server.address())
        self.store.set(MANAGER_ADDR_KEY, "dummy")
        self.store.set(REPLICA_ID_KEY, "dummy_id")
        self.collectives = collectives or DummyCollectives()
        self.load_state_dict = MagicMock()
        self.transport = MagicMock()
        self.transport.metadata.return_value = "transport_meta"
        kwargs.setdefault("min_replica_size", 2)
        kwargs.setdefault("timeout", timedelta(seconds=10))
        kwargs.setdefault("commit_pipeline", True)
        # autospec returns one mock instance for every construction, so the
        # votes scripted on self.client also drive the dedicated vote client
        self._patcher = patch("torchft_tpu_torch.manager.ManagerClient", autospec=True)
        self._patcher.start()
        self.manager = Manager(
            collectives=self.collectives,
            load_state_dict=self.load_state_dict,
            state_dict=lambda: {"user_key": 1},
            rank=1,
            world_size=2,
            store_addr=store_server.address(),
            checkpoint_transport=self.transport,
            **kwargs,
        )
        self.client = self.manager._client

    def shutdown(self):
        self.manager.shutdown(wait=False)
        self._patcher.stop()
        self.store.close()


@pytest.fixture
def harness(store_server):
    hs = []

    def make(**kwargs):
        h = ManagerHarness(store_server, **kwargs)
        hs.append(h)
        return h

    yield make
    for h in hs:
        h.shutdown()


def _reduce(m, n=2):
    m.allreduce_many([np.ones(n, dtype=np.float32)]).wait()


def _echo_vote(rank, step, vote, timeout=None, **kw):
    return vote


def test_pipelined_happy_path(harness):
    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.return_value = True

    m.start_quorum()
    m.allreduce_many([np.array([2.0, 4.0], dtype=np.float32)]).wait()
    assert m.speculation_allowed()

    resolved = []
    fut = m.should_commit_async(on_resolved=resolved.append)
    assert m.pending_commit() is fut
    # issue-time disallow: the serving window closes before the overlap
    h.transport.disallow_checkpoint.assert_called_once()
    assert not m.speculation_allowed()  # at most one outstanding

    assert m.resolve_pending_commit() is True
    assert resolved == [True]
    assert m.pending_commit() is None
    assert m.current_step() == 1
    assert m.batches_committed() == 2
    assert m.participating_rank() == 1
    # the vote went through the dedicated vote client (the same mock)
    h.client.should_commit.assert_called_once()


def test_veto_rolls_back(harness):
    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.return_value = False  # a peer rank vetoed

    m.start_quorum()
    _reduce(m)
    resolved = []
    m.should_commit_async(on_resolved=resolved.append)
    assert m.resolve_pending_commit() is False
    assert resolved == [False]  # the restore callback ran
    assert m.current_step() == 0
    assert m.batches_committed() == 0


def test_vote_rpc_failure_restores_and_raises(harness):
    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.side_effect = TimeoutError("vote lost")

    m.start_quorum()
    _reduce(m)
    resolved = []
    m.should_commit_async(on_resolved=resolved.append)
    with pytest.raises(TimeoutError, match="vote lost"):
        m.resolve_pending_commit()
    # the step counts as not applied, and the manager is not wedged
    assert resolved == [False]
    assert m.pending_commit() is None
    assert m.current_step() == 0


def test_healing_replica_never_speculates(harness):
    h = harness(use_async_quorum=True)
    m = h.manager
    h.client._quorum.return_value = quorum_result(
        heal=True, max_step=20, max_rank=None, recover_src_rank=0
    )
    h.transport.recv_checkpoint.return_value = {
        "user": {"recovered": True},
        "torchft": {"step": 20, "batches_committed": 40},
    }

    m.start_quorum()
    m.wait_quorum()
    assert m._healing
    assert m.participating_rank() is None
    assert not m.speculation_allowed()
    with pytest.raises(RuntimeError, match="healing"):
        m.should_commit_async()
    # the sync path still works and lands the staged heal
    h.client.should_commit.return_value = True
    assert m.should_commit()
    h.load_state_dict.assert_called_once_with({"recovered": True})
    assert m.current_step() == 21


def test_errored_latch_blocks_speculation_and_aborts_cleanly(harness):
    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.side_effect = _echo_vote

    # clean step k: speculate
    m.start_quorum()
    _reduce(m)
    m.should_commit_async()

    # step k+1: an error latches during the speculative window
    m.start_quorum()
    m.report_error(RuntimeError("plane torn"))
    # the pending vote (recorded clean at issue time) still commits
    assert m.resolve_pending_commit() is True
    assert m.current_step() == 1
    # the current step is doomed: no speculation, the sync vote aborts
    assert not m.speculation_allowed()
    assert not m.should_commit()
    assert m.current_step() == 1


def test_allreduce_guard_while_pending(harness):
    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.return_value = True

    m.start_quorum()
    _reduce(m)
    m.should_commit_async()
    m.start_quorum()
    with pytest.raises(RuntimeError, match="resolve_pending_commit"):
        _reduce(m)
    m.resolve_pending_commit()
    _reduce(m)  # resolved: collectives run again


def test_should_commit_resolves_stray_pending(harness):
    # LocalSGD-style callers vote synchronously; a stray pending vote from
    # a caller mixing the two paths is resolved first instead of wedging
    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.return_value = True

    m.start_quorum()
    _reduce(m)
    m.should_commit_async()
    m.start_quorum()
    assert m.should_commit()  # resolves the pending vote, then votes
    assert m.pending_commit() is None
    assert m.current_step() == 2
    assert h.client.should_commit.call_count == 2


def test_quorum_reports_the_votes_outcome(harness):
    """With a vote in flight the quorum reports the step as the vote leaves
    it, not the lagging committed count: a committed vote counts, a vetoed
    or lost one does not."""
    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    outcomes = iter([True, False, TimeoutError("vote lost")])

    def vote(rank, step, vote, timeout=None, **kw):
        out = next(outcomes)
        if isinstance(out, Exception):
            raise out
        return out

    h.client.should_commit.side_effect = vote
    reported = []
    for expect in (1, 1, 1):
        m.start_quorum()
        m.wait_quorum()
        reported.append(h.client._quorum.call_args.kwargs["step"])
        if m.pending_commit() is not None:
            try:
                m.resolve_pending_commit()
            except TimeoutError:
                pass
        _reduce(m)
        m.should_commit_async()
    m.start_quorum()
    m.wait_quorum()
    reported.append(h.client._quorum.call_args.kwargs["step"])
    # no vote yet; vote 1 commits (0 -> 1); vote 2 is vetoed; vote 3 is lost
    assert reported == [0, 1, 1, 1]
    with pytest.raises(TimeoutError):
        m.resolve_pending_commit()
    assert m.current_step() == 1


def test_shutdown_releases_the_fence(harness):
    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.return_value = True
    m.start_quorum()
    _reduce(m)
    m.should_commit_async()
    m.shutdown(wait=False)
    assert m.pending_commit() is None
    assert m._await_speculation_settled()  # returns at once


@pytest.mark.parametrize("decision", [True, False])
def test_sync_quorum_resolves_the_pending_vote_first(harness, decision):
    """With a sync quorum, start_quorum resolves an in-flight vote before
    the quorum RPC (the main thread then blocks on the quorum, so it could
    not lift the fence): the rollback runs there, and the quorum reports the
    step the decision leaves."""
    h = harness(use_async_quorum=False)
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.return_value = decision

    m.start_quorum()
    _reduce(m)
    assert m.speculation_allowed()
    resolved = []
    m.should_commit_async(on_resolved=resolved.append)
    m.start_quorum()
    assert resolved == [decision] and m.pending_commit() is None
    assert h.client._quorum.call_args.kwargs["step"] == int(decision)
    assert m.current_step() == int(decision)


def test_fence_timeout_skips_heal_traffic(harness):
    """A trainer that never resolves its vote: the fence times out, the
    quorum thread serves nothing (the snapshot would be one update behind
    the step it reported) and fails the step instead."""
    h = harness(timeout=timedelta(seconds=1))
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    h.client.should_commit.side_effect = _echo_vote
    m.start_quorum()
    _reduce(m)
    m.should_commit_async()

    h.client._quorum.return_value = quorum_result(max_rank=1, recover_dst_ranks=[0])
    m.start_quorum()
    m.wait_quorum()
    h.transport.send_checkpoint.assert_not_called()
    assert "fence timed out" in str(m.errored())
    assert m.resolve_pending_commit() is True
    assert not m.should_commit()  # the latched error fails this step
    assert m.current_step() == 1


def _vetoing(veto_votes):
    votes = {"n": 0}

    def vote_fn(rank, step, vote, timeout=None, **kw):
        votes["n"] += 1
        return vote and votes["n"] not in veto_votes

    return votes, vote_fn


def test_managed_optimizer_pipelined_rollback_replay(harness):
    from torchft_tpu_torch.optim import ManagedOptimizer

    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    _, h.client.should_commit.side_effect = _vetoing({2})  # veto the 2nd vote

    opt = ManagedOptimizer(m, lambda p: torch.optim.SGD(tree_leaves(p), lr=0.1))
    opt.init({"w": torch.ones(4)})

    def grad_fn(params):
        return {"w": torch.ones(4)}

    for _ in range(4):
        opt.begin_step()
        opt.step(grad_fn(opt.params), grad_fn=grad_fn)
    opt.finish()

    assert opt.rollbacks == 1
    assert m.current_step() == 3  # 4 votes, one vetoed
    # sgd(0.1) on grads averaged over n=2 participants: 3 * 0.1 * 0.5
    np.testing.assert_allclose(opt.params["w"].numpy(), np.full(4, 0.85), rtol=1e-6)


def test_sync_quorum_rollback_lands_before_the_gradients(harness):
    """With a sync quorum the veto rolls back inside ``begin_step``, before
    the caller takes the step's gradients: nothing needs replaying, so even
    without ``grad_fn`` no batch is dropped beyond the vetoed one."""
    from torchft_tpu_torch.optim import ManagedOptimizer

    h = harness(use_async_quorum=False)
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    _, h.client.should_commit.side_effect = _vetoing({2})

    opt = ManagedOptimizer(m, lambda p: torch.optim.SGD(tree_leaves(p), lr=0.1))
    opt.init({"w": torch.ones(4)})
    for _ in range(4):
        opt.begin_step()
        assert not opt._replay_needed
        opt.step({"w": torch.ones(4)})
    opt.finish()

    assert opt.rollbacks == 1
    assert m.current_step() == 3
    # as with a replay: three updates of sgd(0.1) on the average over n=2
    np.testing.assert_allclose(opt.params["w"].numpy(), np.full(4, 0.85), rtol=1e-6)


def test_rollback_snapshot_is_a_copy(harness):
    """The live tensors change in place after the snapshot (as a later
    in-place update would); the rollback still restores the committed
    params and the committed moments."""
    from torchft_tpu_torch.optim import ManagedOptimizer

    h = harness()
    m = h.manager
    h.client._quorum.return_value = quorum_result(max_rank=1)
    _, h.client.should_commit.side_effect = _vetoing({2})

    opt = ManagedOptimizer(m, lambda p: torch.optim.AdamW(tree_leaves(p), lr=0.1))
    opt.init({"w": torch.arange(4.0), "b": torch.ones(3)})

    def grads():
        return {"w": torch.full((4,), 0.5), "b": torch.full((3,), -2.0)}

    opt.begin_step()
    opt.step(grads())
    opt.finish()  # the first vote commits
    committed = {k: v.clone() for k, v in opt.params.items()}
    moments = {
        name: [opt.optimizer.state[p][name].clone() for p in tree_leaves(opt.params)]
        for name in ("exp_avg", "exp_avg_sq", "step")
    }

    opt.begin_step()
    opt.step(grads())  # speculative update; its vote will be vetoed
    assert opt._snapshot is not None
    assert not torch.equal(opt.params["w"], committed["w"])
    with torch.no_grad():
        for p in tree_leaves(opt.params):
            p.add_(100.0)
            for name in ("exp_avg", "exp_avg_sq", "step"):
                opt.optimizer.state[p][name].add_(100.0)
    assert opt.finish() is False

    assert opt.rollbacks == 1 and opt._consume_replay()
    for k in committed:
        assert torch.equal(opt.params[k], committed[k])
    for name, values in moments.items():
        for p, v in zip(tree_leaves(opt.params), values):
            assert torch.equal(opt.optimizer.state[p][name], v), name
    # the optimizer still steps the caller's tensors
    assert opt.optimizer.param_groups[0]["params"][0] is tree_leaves(opt.params)[0]


def test_heal_supersedes_pending_replay(harness):
    """A heal that lands after an out-of-band rollback clears the sticky
    replay flag: the next step's gradients are taken on the healed state."""
    from torchft_tpu_torch.optim import ManagedOptimizer

    h = harness()
    opt = ManagedOptimizer(h.manager, lambda p: torch.optim.SGD(tree_leaves(p), lr=0.1))
    opt.init({"w": torch.ones(4)})
    opt._replay_needed = True
    opt._snapshot = ({"w": torch.ones(4)}, opt.optimizer.state_dict())
    opt.load_state_dict({"params": {"w": torch.zeros(4)}, "opt_state": opt.optimizer.state_dict()})
    assert opt._snapshot is None
    assert not opt._consume_replay()
    assert torch.equal(opt.params["w"], torch.zeros(4))


def test_error_feedback_is_refused():
    """No ``error_feedback`` value is refused any more (the wire codecs are
    ported): it resolves as the JAX package's does. Auto mode makes an
    accumulator only on a lossy wire, False never, and an instance is used
    as given."""
    from torchft_tpu.optim import ManagedOptimizer as JManagedOptimizer
    from torchft_tpu_torch.optim import ManagedOptimizer
    from torchft_tpu_torch.wire_codec import ErrorFeedback, get_codec

    shared = ErrorFeedback(get_codec("int8"))
    for codec in ("f32", "bfloat16", "int8"):
        m = MagicMock()
        m.wire_codec.return_value = codec
        for ef in (None, False, shared):
            port = ManagedOptimizer(m, torch.optim.SGD, error_feedback=ef).error_feedback
            ref = JManagedOptimizer(m, None, error_feedback=ef).error_feedback
            assert (port is None) == (ref is None), (codec, ef)
            if ef is shared:
                assert port is shared
            elif port is not None:
                assert port.codec.name == ref.codec.name == codec


# ---------------------------------------------------------------------------
# trainer parity: the pipelined committed state is bit-identical to sync mode
# ---------------------------------------------------------------------------


def _tree_checksum(tree) -> str:
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            h.update(leaf.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


class TestTrainerParity:
    STEPS = 5
    VETO_VOTES = {2}  # 1-based vote index vetoed group-wide
    FAULT_CALLS = {4}  # 1-based data-plane allreduce that dies

    @pytest.fixture(scope="class")
    def train_step(self):
        from torchft_tpu_torch.models.transformer import TransformerConfig
        from torchft_tpu_torch.parallel.train_step import TrainStep

        cfg = TransformerConfig(
            vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64,
            dtype=torch.float32, attention_impl="flash",
        )
        return TrainStep(cfg, device="cpu")

    def _run(self, store_server, train_step, pipelined: bool):
        from torchft_tpu_torch.parallel.ft import FTTrainer

        h = ManagerHarness(
            store_server,
            collectives=FaultyCollectives(self.FAULT_CALLS),
            commit_pipeline=pipelined,
        )
        try:
            m = h.manager
            h.client._quorum.return_value = quorum_result(max_rank=1)
            votes, h.client.should_commit.side_effect = _vetoing(self.VETO_VOTES)
            trainer = FTTrainer(m, train_step)
            trainer.init(seed=0)
            rng = np.random.default_rng(7)
            batches = [
                torch.from_numpy(rng.integers(0, 64, (2, 16))) for _ in range(self.STEPS)
            ]
            for tokens in batches:
                trainer.step(tokens)
            if pipelined:
                trainer.finish()
            return (
                _tree_checksum(trainer.params),
                _tree_checksum(trainer.opt.state_dict()),
                m.current_step(),
                votes["n"],
                trainer.rollbacks,
            )
        finally:
            h.shutdown()

    def test_committed_state_bit_identical(self, store_server, train_step):
        """A veto (rollback + replay) and a mid-run PeerGoneError leave the
        pipelined run's committed params and optimizer state exactly equal
        to sync mode's."""
        p_params, p_opt, p_step, p_votes, p_rb = self._run(store_server, train_step, True)
        s_params, s_opt, s_step, s_votes, s_rb = self._run(store_server, train_step, False)
        assert p_votes == s_votes == self.STEPS  # one vote per step
        assert p_step == s_step == self.STEPS - len(self.VETO_VOTES | self.FAULT_CALLS)
        assert p_rb >= 1 and s_rb == 0  # the veto really exercised the rollback
        assert p_params == s_params
        assert p_opt == s_opt

    def test_heal_supersedes_pending_replay(self, store_server, train_step):
        """FTTrainer.load_state_dict (the heal path) clears the snapshot and
        the sticky replay flag."""
        from torchft_tpu_torch.parallel.ft import FTTrainer

        h = ManagerHarness(store_server, commit_pipeline=True)
        try:
            trainer = FTTrainer(h.manager, train_step)
            trainer.init(seed=0)
            trainer._replay_needed = True
            trainer._take_snapshot()
            state = {"params": trainer.params, "opt_state": trainer.opt.state_dict()}
            trainer.load_state_dict(state)
            assert trainer._snapshot is None
            assert not trainer._consume_replay()
        finally:
            h.shutdown()


def test_two_pipelined_groups_match_the_sync_run():
    """Two real groups (lighthouse, stores, CollectivesTcp, HTTP heal) from
    one seed, pipelined and sync. The first quorum heals one group from
    the other (the step-0 bootstrap), so that group votes synchronously
    once while the other speculates; reporting the vote's outcome to the
    quorum keeps the pipelined groups in step instead of healing each
    other in turn. Both runs end with one sha256 and the same step."""
    from tests.test_torch_ft_slice import TCFG, _run_groups, _tokens
    from tests.test_torch_optim import port_manager
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep

    def run(pipelined):
        lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)

        def group(gid):
            store = StoreServer()
            manager = port_manager(gid, lighthouse, store, min_replica_size=1,
                                   commit_pipeline=pipelined)
            try:
                trainer = FTTrainer(manager, TrainStep(TCFG, device="cpu"))
                trainer.init(seed=3)
                heals = []
                load = trainer.load_state_dict
                manager.set_state_dict_fns(lambda s: (heals.append(1), load(s)),
                                           trainer.state_dict)
                for i in range(5):
                    trainer.step(torch.from_numpy(_tokens(gid, i)))
                trainer.finish()
                return manager.current_step(), _tree_checksum(trainer.params), len(heals)
            finally:
                manager.shutdown(wait=False)
                store.shutdown()

        try:
            return _run_groups(group)
        finally:
            lighthouse.shutdown()

    sync, pipe = run(False), run(True)
    for res in (sync, pipe):
        assert res[0][:2] == res[1][:2]
        assert res[0][2] + res[1][2] == 1  # the bootstrap heal, and no other
    assert sync[0][:2] == pipe[0][:2] == (5, sync[0][1])


# ---------------------------------------------------------------------------
# the pipelined path against the JAX package, on the same inputs
# ---------------------------------------------------------------------------


def _jax_pipelined(loop, np_params, steps, veto_votes, fault_calls):
    """The JAX package's pipelined FTTrainer or ManagedOptimizer under its
    own test harness. Returns (losses, params as numpy, step, rollbacks)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tests.test_commit_pipeline import FaultyDummy
    from tests.test_commit_pipeline import ManagerHarness as JHarness
    from tests.test_commit_pipeline import quorum_result as jquorum_result
    from tests.test_torch_ft_slice import JCFG, _tokens
    from torchft_tpu.optim import ManagedOptimizer as JManagedOptimizer
    from torchft_tpu.parallel.ft import FTTrainer as JFTTrainer
    from torchft_tpu.parallel.mesh import MeshConfig, make_mesh
    from torchft_tpu.parallel.train_step import TrainStep as JTrainStep
    from torchft_tpu.store import StoreServer as JStore

    store = JStore()
    h = JHarness(store, collectives=FaultyDummy(fault_calls, rank=0, world_size=1))
    try:
        m = h.manager
        h.client._quorum.return_value = jquorum_result(max_rank=1)
        _, h.client.should_commit.side_effect = _vetoing(veto_votes)
        tx = optax.adamw(3e-4)
        ts = JTrainStep(JCFG, tx, make_mesh(MeshConfig(), jax.devices()[:1]))
        params = jax.device_put(np_params, ts._param_shardings)
        losses = []
        if loop == "trainer":
            lp = JFTTrainer(m, ts)
            lp.init(jax.random.PRNGKey(0))
            lp._params, lp._opt_state = params, ts.init_opt(params)
            for i in range(steps):
                losses.append(lp.step(jnp.asarray(_tokens(0, i)))[0])
        else:
            lp = JManagedOptimizer(m, tx)
            lp.init(params)
            for i in range(steps):
                tokens = ts.shard_batch(jnp.asarray(_tokens(0, i)))
                lp.begin_step()
                loss, grads = ts.grads(lp.params, tokens)
                lp.step(grads, grad_fn=lambda p, t=tokens: ts.grads(p, t)[1])
                losses.append(float(loss))
        lp.finish()
        out = jax.tree_util.tree_map(np.asarray, lp.params)
        return losses, out, m.current_step(), lp.rollbacks
    finally:
        h.shutdown()
        store.shutdown()


def _port_pipelined(loop, np_params, steps, veto_votes, fault_calls):
    from tests.test_torch_ft_slice import TCFG, _tokens
    from torchft_tpu_torch.models import transformer as T
    from torchft_tpu_torch.optim import ManagedOptimizer
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep

    store = StoreServer()
    h = ManagerHarness(store, collectives=FaultyCollectives(fault_calls))
    try:
        m = h.manager
        h.client._quorum.return_value = quorum_result(max_rank=1)
        _, h.client.should_commit.side_effect = _vetoing(veto_votes)
        ts = TrainStep(TCFG, device="cpu")
        params = T.params_from_jax(np_params, device="cpu")
        losses = []
        if loop == "trainer":
            lp = FTTrainer(m, ts)
            lp.init(params=params)
            for i in range(steps):
                losses.append(lp.step(torch.from_numpy(_tokens(0, i)))[0])
        else:
            lp = ManagedOptimizer(m, ts.init_opt)
            lp.init(params)
            for i in range(steps):
                tokens = torch.from_numpy(_tokens(0, i))
                lp.begin_step()
                loss, grads = ts.grads(lp.params, tokens)
                lp.step(grads, grad_fn=lambda p, t=tokens: ts.grads(p, t)[1])
                losses.append(float(loss))
        lp.finish()
        return losses, lp.params, m.current_step(), lp.rollbacks
    finally:
        h.shutdown()
        store.shutdown()


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("loop", ["trainer", "optimizer"])
def test_pipelined_path_matches_jax(loop):
    """Five pipelined steps with the second vote vetoed (a rollback and a
    replay) and the fourth allreduce failed, through both packages."""
    from tests.test_torch_ft_slice import _np_init

    np_params = _np_init()
    args = (loop, np_params, 5, {2}, {4})
    j_losses, j_params, j_step, j_rb = _jax_pipelined(*args)
    p_losses, p_params, p_step, p_rb = _port_pipelined(*args)
    assert p_step == j_step == 3 and p_rb == j_rb == 1
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)
    port = dict(_flat(p_params))
    for name, want in _flat(j_params):
        np.testing.assert_allclose(port[name].detach().numpy(), want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_quorum_step_with_a_vote_in_flight_against_jax(harness):
    """The protocol difference from the JAX package, on both Managers under
    their own harness: with a committed vote still in flight at the next
    quorum, the JAX Manager reports its committed step (0), one behind a
    group that voted synchronously, and the quorum then heals it from that
    group; the port's reports the step the decision leaves (1), and its two
    pipelined groups heal only at the bootstrap (test above)."""
    from tests.test_commit_pipeline import ManagerHarness as JHarness
    from tests.test_commit_pipeline import quorum_result as jquorum_result
    from torchft_tpu.store import StoreServer as JStore

    def reported(h, qr):
        m = h.manager
        h.client._quorum.return_value = qr(max_rank=1)
        h.client.should_commit.return_value = True
        m.start_quorum()
        _reduce(m)
        m.should_commit_async()
        m.start_quorum()
        m.wait_quorum()
        step = h.client._quorum.call_args.kwargs["step"]
        assert m.resolve_pending_commit() is True
        return step

    jstore = JStore()
    jh = JHarness(jstore)
    try:
        assert reported(jh, jquorum_result) == 0
    finally:
        jh.shutdown()
        jstore.shutdown()
    assert reported(harness(), quorum_result) == 1


def test_sync_quorum_pipelined_late_joiner(caplog):
    """A sync quorum with the pipeline on: start_quorum resolves the vote in
    flight before the quorum, so a group serving a late joiner lifts its
    speculation fence at once (no fence timeout) and serves committed state
    labelled with its step. Both groups speculate, and end bit-identical."""
    from tests.test_torch_ft_slice import TCFG, _run_groups, _tokens
    from tests.test_torch_optim import port_manager
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.parallel.ft import FTTrainer
    from torchft_tpu_torch.parallel.train_step import TrainStep

    caplog.set_level(logging.WARNING, logger="torchft_tpu_torch.manager")
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    first_step = threading.Event()

    def group(gid):
        if gid == 1 and not first_step.wait(timeout=120):
            raise TimeoutError("group 0 never stepped")
        store = StoreServer()
        manager = port_manager(gid, lighthouse, store, min_replica_size=1,
                               use_async_quorum=False, commit_pipeline=True)
        try:
            trainer = FTTrainer(manager, TrainStep(TCFG, device="cpu"))
            trainer.init(seed=10 + gid)  # different inits: the heal must matter
            heals, votes = [], []
            load = trainer.load_state_dict
            manager.set_state_dict_fns(lambda s: (heals.append(1), load(s)),
                                       trainer.state_dict)
            vote_async = manager.should_commit_async
            manager.should_commit_async = lambda **kw: (votes.append(1), vote_async(**kw))[1]
            joint = i = 0
            while joint < 3:
                trainer.step(torch.from_numpy(_tokens(gid, i)))
                i += 1
                if manager.num_participants() == 2:
                    joint += 1
                first_step.set()
            trainer.finish()
            return (manager.current_step(), _tree_checksum(trainer.params),
                    _tree_checksum(trainer.opt.state_dict()), len(heals), len(votes))
        finally:
            first_step.set()
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        (s0, p0, o0, h0, v0), (s1, p1, o1, h1, v1) = (
            r for _, r in sorted(_run_groups(group).items())
        )
    finally:
        lighthouse.shutdown()
    assert (h0, h1) == (0, 1), "group 1 did not heal exactly once"
    assert v0 >= 3 and v1 >= 2, "the groups did not speculate"
    assert "fence timed out" not in caplog.text
    assert s0 == s1 and p0 == p1 and o0 == o1
