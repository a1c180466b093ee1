"""The slice as a whole: fault-tolerant training of the tiny transformer
with two replica groups as threads, a real native lighthouse, stores and
manager servers, CollectivesTcp and the HTTP heal transport.

The JAX package (its Manager, CollectivesTcp, TrainStep and
``optax.adamw(3e-4)``) and the port (``attention_impl="flash"``, s=128)
run the same protocol on the same numpy init and the same tokens; the
per-step losses agree within rtol 1e-4 (float32 throughout: summation
order and the two AdamW formulations' rounding, compounded over the
steps). The port's groups end bit-identical to each other, and a group
that joins late heals from the other and ends bit-identical too.
"""

import hashlib
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.models import transformer as J
from torchft_tpu_torch import ddp as tddp
from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import transformer as T
from torchft_tpu_torch.parallel.ft import FTTrainer
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.tree import tree_leaves

BASE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, head_dim=8, d_ff=64)
TCFG = T.TransformerConfig(**BASE, dtype=torch.float32, attention_impl="flash")
JCFG = J.TransformerConfig(**BASE, dtype=jnp.float32, attention_impl="flash")
STEPS = 3
TIMEOUT = timedelta(seconds=30)


def _np_init():
    params = J.init_params(jax.random.PRNGKey(0), J.TransformerConfig(**BASE, dtype=jnp.float32))
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(gid: int, step: int) -> np.ndarray:
    return np.random.default_rng(1000 + 17 * gid + step).integers(0, 64, (2, 128)).astype(np.int32)


def _run_groups(target, n=2, timeout=240):
    """Run ``target(gid)`` for each group on its own thread; re-raise the
    first failure."""
    errors, results = [], {}

    def wrap(gid):
        try:
            results[gid] = target(gid)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=wrap, args=(g,)) for g in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout)
    assert all(not th.is_alive() for th in threads), "a replica group hung"
    if errors:
        raise errors[0]
    return results


def _port_manager(gid, lighthouse, store, min_replica_size):
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
    )


def _digest(params) -> str:
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().numpy().tobytes())
    return h.hexdigest()


def _port_run(np_params):
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=2)

    def group(gid):
        store = StoreServer()
        manager = _port_manager(gid, lighthouse, store, min_replica_size=2)
        try:
            trainer = FTTrainer(manager, TrainStep(TCFG, device="cpu"))
            trainer.init(params=T.params_from_jax(np_params, device="cpu"))
            losses = []
            while manager.current_step() < STEPS:
                tokens = torch.from_numpy(_tokens(gid, manager.current_step()))
                loss, committed = trainer.step(tokens)
                assert committed
                losses.append(loss)
            return losses, _digest(trainer.params)
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
    from torchft_tpu.ddp import allreduce_gradients
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
        )
        try:
            ts = JTrainStep(JCFG, optax.adamw(3e-4), make_mesh(MeshConfig(), jax.devices()[:1]))
            st = {"params": jax.device_put(np_params, ts._param_shardings)}
            st["opt_state"] = ts.init_opt(st["params"])

            def load(state):
                st["params"] = jax.device_put(state["params"], ts._param_shardings)
                st["opt_state"] = state["opt_state"]

            manager.set_state_dict_fns(load, lambda: dict(st))
            losses = []
            while manager.current_step() < STEPS:
                tokens = ts.shard_batch(jnp.asarray(_tokens(gid, manager.current_step())))
                manager.start_quorum()
                loss, grads = ts.grads(st["params"], tokens)
                grads = allreduce_gradients(manager, grads)
                assert manager.should_commit()
                st["params"], st["opt_state"] = ts.apply(st["params"], st["opt_state"], grads)
                losses.append(float(loss))
            return losses
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        return _run_groups(group)
    finally:
        lighthouse.shutdown()


def test_two_groups_match_jax_and_each_other():
    np_params = _np_init()
    jax_losses = _jax_run(np_params)
    port = _port_run(np_params)
    for gid in (0, 1):
        np.testing.assert_allclose(port[gid][0], jax_losses[gid], rtol=1e-4)
    assert port[0][1] == port[1][1], "port groups diverged"


def test_late_joiner_heals_bit_identical():
    lighthouse = LighthouseServer(bind="[::]:0", min_replicas=1)
    first_commit = threading.Event()

    def group(gid):
        if gid == 1 and not first_commit.wait(timeout=120):
            raise TimeoutError("group 0 never committed")
        store = StoreServer()
        manager = _port_manager(gid, lighthouse, store, min_replica_size=1)
        try:
            trainer = FTTrainer(manager, TrainStep(TCFG, device="cpu"))
            trainer.init(seed=10 + gid)  # different inits: the heal must matter
            joint = healed_to = 0
            while joint < 2:
                before = manager.current_step()
                _, committed = trainer.step(torch.from_numpy(_tokens(gid, before)))
                if manager.current_step() > before + 1:
                    healed_to = manager.current_step()
                if committed and manager.num_participants() == 2:
                    joint += 1
                if committed:
                    first_commit.set()
            return manager.current_step(), _digest(trainer.params), healed_to
        finally:
            first_commit.set()
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        (s0, d0, _), (s1, d1, healed_to) = (r for _, r in sorted(_run_groups(group).items()))
    finally:
        lighthouse.shutdown()
    assert healed_to >= 1, "group 1 did not heal"
    assert s0 == s1 and d0 == d1


def test_bucket_plan_matches_jax():
    from torchft_tpu.ddp import plan_buckets

    meta = [(np.dtype(np.float32), n) for n in (10, 30, 5, 40, 1, 100)]
    meta.insert(3, (np.dtype(np.float16), 8))
    for bucket_bytes in (16, 45, 1000):
        assert tddp.plan_buckets(meta, bucket_bytes) == plan_buckets(meta, bucket_bytes)


class _OneGroup:
    """Stand-in manager for one participating group (average = identity)."""

    def __init__(self):
        self.calls = 0

    def allreduce_many(self, arrays):
        from torchft_tpu_torch.futures import Future

        self.calls += 1
        return Future.completed(arrays)


def test_allreduce_gradients_buckets_and_owns_memory():
    grads = {"a": torch.randn(4, 5), "b": [torch.randn(7), torch.randn(2, 2)]}
    before = [g.clone() for g in tree_leaves(grads)]
    mgr = _OneGroup()
    out = tddp.allreduce_gradients(mgr, grads, bucket_bytes=100)
    assert mgr.calls == 2  # 80 B + 28 B > 100 B: two buckets
    for o, g, b in zip(tree_leaves(out), tree_leaves(grads), before):
        assert o.shape == g.shape and torch.equal(o, b)
        o.zero_()  # the averaged pieces are views of the bucket, not of the grads
    for g, b in zip(tree_leaves(grads), before):
        assert torch.equal(g, b)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("only meaningful where CUDA is absent")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainStep(TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.params_from_jax(_np_init())
