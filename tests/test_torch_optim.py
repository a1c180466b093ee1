"""The port's ManagedOptimizer and the Manager's sync quorum.

Two replica groups as threads (a real native lighthouse, stores and
manager servers, CollectivesTcp, the HTTP heal transport) train the tiny
transformer of ``tests/test_torch_ft_slice.py`` through ManagedOptimizer
on both packages, from one ``params_from_jax`` init and the same tokens;
the per-step losses agree within rtol 1e-4 (float32: summation order and
the two AdamW formulations' rounding, compounded over the steps), and the
port's groups end bit-identical.

The sync quorum (``use_async_quorum=False``) heals inside
``start_quorum``, and a healed group is a full participant: it takes the
replica rank and world size, contributes real gradients, and ends
bit-identical to the group it healed from. ``shrink_only`` reaches the
quorum RPC. Everything but the losses is compared exactly.
"""

import threading
from datetime import timedelta
from unittest.mock import MagicMock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_commit_pipeline import ManagerHarness, quorum_result
from tests.test_torch_ft_slice import (
    JCFG,
    STEPS,
    TCFG,
    TIMEOUT,
    _digest,
    _np_init,
    _run_groups,
    _tokens,
)
from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.coordination import LighthouseServer, ManagerClient
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import transformer as T
from torchft_tpu_torch.optim import ManagedOptimizer
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.store import StoreServer


@pytest.fixture
def store_server():
    s = StoreServer()
    yield s
    s.shutdown()


def port_manager(gid, lighthouse, store, min_replica_size, **kwargs):
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

    return Manager(
        collectives=CollectivesTcp(timeout=TIMEOUT, native_plane=True),
        load_state_dict=None,
        state_dict=None,
        min_replica_size=min_replica_size,
        replica_id=f"g{gid}",
        store_addr=store.address(),
        rank=0,
        world_size=1,
        lighthouse_addr=lighthouse.address(),
        timeout=TIMEOUT,
        checkpoint_transport=HTTPTransport(timeout=TIMEOUT, hostname="localhost"),
        **kwargs,
    )


def _port_run(np_params):
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)

    def group(gid):
        store = StoreServer()
        manager = port_manager(gid, lighthouse, store, min_replica_size=2)
        try:
            ts = TrainStep(TCFG, device="cpu")
            opt = ManagedOptimizer(manager, ts.init_opt)
            opt.init(T.params_from_jax(np_params, device="cpu"))
            losses = []
            while manager.current_step() < STEPS:
                tokens = torch.from_numpy(_tokens(gid, manager.current_step()))
                opt.begin_step()
                loss, grads = ts.grads(opt.params, tokens)
                opt.step(grads)
                losses.append(float(loss))
            return losses, _digest(opt.params)
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        return _run_groups(group)
    finally:
        lighthouse.shutdown()


def _jax_run(np_params):
    from torchft_tpu.collectives import CollectivesTcp as JCollectivesTcp
    from torchft_tpu.coordination import LighthouseServer as JLighthouse
    from torchft_tpu.manager import Manager as JManager
    from torchft_tpu.optim import ManagedOptimizer as JManagedOptimizer
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
        )
        try:
            tx = optax.adamw(3e-4)
            ts = JTrainStep(JCFG, tx, make_mesh(MeshConfig(), jax.devices()[:1]))
            opt = JManagedOptimizer(manager, tx)
            opt.init(jax.device_put(np_params, ts._param_shardings))
            losses = []
            while manager.current_step() < STEPS:
                tokens = ts.shard_batch(jnp.asarray(_tokens(gid, manager.current_step())))
                opt.begin_step()
                loss, grads = ts.grads(opt.params, tokens)
                opt.step(grads)
                losses.append(float(loss))
            return losses
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        return _run_groups(group)
    finally:
        lighthouse.shutdown()


def test_managed_optimizer_two_groups_match_jax():
    np_params = _np_init()
    jax_losses = _jax_run(np_params)
    port = _port_run(np_params)
    for gid in (0, 1):
        assert len(port[gid][0]) == STEPS
        np.testing.assert_allclose(port[gid][0], jax_losses[gid], rtol=1e-4)
    assert port[0][1] == port[1][1], "port groups diverged"


def test_sync_quorum_late_joiner_heals_in_start_quorum():
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    first_commit = threading.Event()

    def group(gid):
        if gid == 1 and not first_commit.wait(timeout=120):
            raise TimeoutError("group 0 never committed")
        store = StoreServer()
        manager = port_manager(gid, lighthouse, store, min_replica_size=1,
                               use_async_quorum=False)
        try:
            ts = TrainStep(TCFG, device="cpu")
            opt = ManagedOptimizer(manager, ts.init_opt)
            opt.init(ts.init_params(10 + gid))  # different inits: the heal must matter
            joint = 0
            healed = None
            while joint < 2:
                before = manager.current_step()
                opt.begin_step()
                batches = manager.batches_committed()
                if manager.current_step() > before:
                    # healed inside start_quorum, before the forward pass:
                    # a full participant of this very step
                    healed = (manager.current_step(), manager.is_participating(),
                              manager.participating_rank(), manager.num_participants())
                tokens = torch.from_numpy(_tokens(gid, manager.current_step()))
                _, grads = ts.grads(opt.params, tokens)
                opt.step(grads)
                if manager.num_participants() == 2:
                    # both groups' batches count, the healed group's too
                    assert manager.batches_committed() == batches + 2
                    joint += 1
                first_commit.set()
            return manager.current_step(), _digest(opt.params), healed
        finally:
            first_commit.set()
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        (s0, d0, h0), (s1, d1, healed) = (r for _, r in sorted(_run_groups(group).items()))
    finally:
        lighthouse.shutdown()
    assert h0 is None
    assert healed is not None, "group 1 did not heal"
    step, participating, rank, n = healed
    assert step >= 1 and participating and rank is not None and n == 2
    assert s0 == s1 and d0 == d1


def test_sync_quorum_participants(store_server):
    """Unit view of the participant rule: with sync quorum a healing group
    takes its replica rank and world size and is never zeroed; with
    ``allow_heal=False`` the max-step cohort participates and no heal
    traffic runs."""
    h = ManagerHarness(store_server, use_async_quorum=False, commit_pipeline=False)
    try:
        m = h.manager
        h.client._quorum.return_value = quorum_result(
            heal=True, max_step=20, max_rank=None, max_world_size=1,
            replica_rank=1, replica_world_size=2, recover_src_rank=0,
        )
        h.transport.recv_checkpoint.return_value = {
            "user": {"recovered": True},
            "torchft": {"step": 20, "batches_committed": 40},
        }
        m.start_quorum()
        # the heal landed before start_quorum returned
        h.load_state_dict.assert_called_once_with({"recovered": True})
        assert m.current_step() == 20 and not m._healing
        assert m.is_participating()
        assert (m.participating_rank(), m.num_participants()) == (1, 2)
        grads = np.full(3, 4.0, dtype=np.float32)
        m.allreduce_many([grads]).wait()
        # contributes its own gradients (not zeros), divided by 2
        np.testing.assert_array_equal(grads, np.full(3, 2.0, dtype=np.float32))
        h.client.should_commit.return_value = True
        assert m.should_commit()
        assert m.batches_committed() == 42

        h.transport.recv_checkpoint.reset_mock()
        h.transport.recv_checkpoint_multi.reset_mock()
        h.client._quorum.return_value = quorum_result(
            heal=True, max_step=30, max_rank=None, max_world_size=1,
            recover_src_rank=0, recover_dst_ranks=[0],
        )
        m.start_quorum(allow_heal=False)
        assert m.participating_rank() is None and m.num_participants() == 1
        assert not m.is_participating() and not m._healing
        h.transport.recv_checkpoint.assert_not_called()
        h.transport.recv_checkpoint_multi.assert_not_called()
        h.transport.send_checkpoint.assert_not_called()
    finally:
        h.shutdown()


def test_shrink_only_reaches_the_rpc(store_server):
    # the client puts the caller's value on the wire
    client = ManagerClient.__new__(ManagerClient)
    client._client = MagicMock()
    client._client.call.return_value = {"quorum_id": 7}
    for value in (True, False):
        q = client._quorum(rank=0, step=3, checkpoint_metadata="m", shrink_only=value,
                           timeout=timedelta(seconds=1))
        method, req, _ = client._client.call.call_args[0]
        assert method == "mgr.quorum" and req["shrink_only"] is value
        assert q.quorum_id == 7

    # the Manager and ManagedOptimizer forward it
    h = ManagerHarness(store_server, commit_pipeline=False)
    try:
        h.client._quorum.return_value = quorum_result(max_rank=1)
        opt = ManagedOptimizer(h.manager, lambda p: torch.optim.SGD([p["w"]], lr=0.1))
        opt.init({"w": torch.zeros(2)})
        for value in (True, False):
            opt.begin_step(shrink_only=value)
            h.manager.wait_quorum()
            assert h.client._quorum.call_args.kwargs["shrink_only"] is value
    finally:
        h.shutdown()


# -- optimizer state identity: a heal and a rollback copy in place --------


def _stepped_trainer(seed, steps):
    from torchft_tpu_torch.parallel.ft import FTTrainer

    trainer = FTTrainer(MagicMock(), TrainStep(TCFG, device="cpu"))
    trainer.init(seed=seed)
    ts = trainer._ts
    for i in range(steps):
        _, grads = ts.grads(trainer.params, torch.from_numpy(_tokens(seed, i)))
        ts.apply(trainer.params, trainer.opt, grads)
    return trainer


def _tensors(trainer):
    """Every param and optimizer state tensor, in a fixed order."""
    from torchft_tpu_torch.utils.tree import tree_leaves

    params = tree_leaves(trainer.params)
    return params + [t for p in params for _, t in sorted(trainer.opt.state[p].items())]


def _host_copy(state):
    from torchft_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, state)


@pytest.mark.parametrize("receiver_steps", [1, 0], ids=["stepped", "fresh"])
def test_load_state_dict_keeps_every_tensor(receiver_steps):
    """A heal into a trainer whose optimizer holds state copies into those
    very tensors (same objects, same storage) and leaves the sender's
    values; into an optimizer that never stepped, it creates the state (no
    graph can hold it yet). The step count stays where the receiver keeps
    it (the host, for this non-capturable optimizer)."""
    sender = _stepped_trainer(seed=7, steps=3)
    receiver = _stepped_trainer(seed=8, steps=receiver_steps)
    before = _tensors(receiver)
    ptrs = [t.data_ptr() for t in before]
    receiver.load_state_dict(_host_copy(sender.state_dict()))
    after = _tensors(receiver)
    if receiver_steps:
        assert all(a is b for a, b in zip(after, before))
        assert [t.data_ptr() for t in after] == ptrs
    for got, want in zip(after, _tensors(sender)):
        assert torch.equal(got, want)
    assert all(receiver.opt.state[p]["step"].device.type == "cpu"
               for p in receiver.opt.state)


def test_vetoed_step_rolls_back_in_place():
    """The pipelined commit's rollback: after a speculative update and a
    veto, every param and moment tensor is the same object as before and
    holds the snapshot's values."""
    trainer = _stepped_trainer(seed=9, steps=2)
    before = _tensors(trainer)
    ptrs = [t.data_ptr() for t in before]
    committed = [t.detach().clone() for t in before]
    trainer._take_snapshot()
    ts = trainer._ts
    _, grads = ts.grads(trainer.params, torch.from_numpy(_tokens(9, 5)))
    ts.apply(trainer.params, trainer.opt, grads)
    assert not all(torch.equal(a, b) for a, b in zip(_tensors(trainer), committed))
    trainer._on_vote_resolved(False)
    after = _tensors(trainer)
    assert all(a is b for a, b in zip(after, before))
    assert [t.data_ptr() for t in after] == ptrs
    for got, want in zip(after, committed):
        assert torch.equal(got, want)
    assert trainer.rollbacks == 1 and trainer._consume_replay()


def test_load_optimizer_state_sgd_and_unstepped_sender():
    """SGD's momentum buffers (the CIFAR example's state) are copied into
    in place; a sender whose optimizer never stepped zeroes the receiver's
    state, the state a first step starts from."""
    from torchft_tpu_torch.optim import load_optimizer_state

    params = [torch.zeros(3), torch.zeros(2, 2)]
    opt = torch.optim.SGD(params, lr=0.05, momentum=0.9, dampening=0)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    bufs = [opt.state[p]["momentum_buffer"] for p in params]
    other = [torch.zeros(3), torch.zeros(2, 2)]
    sender = torch.optim.SGD(other, lr=0.05, momentum=0.9, dampening=0)
    for p in other:
        p.grad = torch.full_like(p, 2.0)
    sender.step()
    load_optimizer_state(opt, _host_copy(sender.state_dict()))
    assert all(opt.state[p]["momentum_buffer"] is b for p, b in zip(params, bufs))
    assert all(torch.equal(b, torch.full_like(b, 2.0)) for b in bufs)
    load_optimizer_state(opt, torch.optim.SGD([torch.zeros(3), torch.zeros(2, 2)],
                                              lr=0.05, momentum=0.9).state_dict())
    assert all(opt.state[p]["momentum_buffer"] is b and not b.any()
               for p, b in zip(params, bufs))
    with pytest.raises(ValueError, match="params"):
        load_optimizer_state(opt, torch.optim.SGD([torch.zeros(1)], lr=0.1).state_dict())
