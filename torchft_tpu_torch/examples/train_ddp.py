"""Fault-tolerant data-parallel training example — the port of
``examples/train_ddp.py`` (the reference's train_ddp.py:34-152).

A two-layer MLP (32 -> 64 -> 10) on a synthetic classification set (the
JAX example's ``make_dataset`` and ``init_params``, made from the same
numpy seeds) trains with Adam(1e-3) through
:class:`~torchft_tpu_torch.optim.ManagedOptimizer`, on the card by default
(``DEVICE=cpu`` for the CPU). One process per replica group, or ``nproc``
per group under the launcher: the ranks of a group join one
``torch.distributed`` group (:func:`~torchft_tpu_torch.parallel.multihost.initialize_group`:
gloo on the CPU, nccl on the card), each takes its share of the group's
batch, and their gradients are averaged in the group before the Manager
averages them across groups. Configure via env:

    TORCHFT_LIGHTHOUSE=host:port   lighthouse address
    REPLICA_GROUP_ID=0             this group's id
    NUM_REPLICA_GROUPS=2           total groups (min replicas = 2 here)
    STEPS=20                       steps to train
    BATCH=64                       the group's batch
    CKPT_DIR=/path                 enable periodic disk checkpoints there
    CKPT_EVERY=5                   checkpoint cadence (committed steps)
    DEVICE=cuda|cpu                where it trains (the card by default)
    TORCHFT_COMMIT_PIPELINE=1      the pipelined commit

``DATA_PLANE=device-dist`` (one runtime across the groups) is not ported
yet (ROADMAP queue 1 item 6).

Run a 2-group session::

    python -m torchft_tpu_torch.launcher --groups 2 -- \\
        python -m torchft_tpu_torch.examples.train_ddp

Kill either trainer mid-run: the launcher respawns it, it rejoins the
quorum and live-heals from the survivor. With CKPT_DIR set, every
CKPT_EVERY committed steps the group's rank 0 writes {manager state,
params + optimizer, sampler position} atomically, and a restarted process
resumes from it before its first quorum, continuing bit-exactly (the
*total*-failure half of recovery). Each group ends with ``done: step=N
param_checksum=X``.
"""

from __future__ import annotations

import logging
import os
import time
from datetime import timedelta
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.data import DistributedSampler
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import ManagedOptimizer
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_leaves

logger = logging.getLogger("train_ddp")

DEVICE_DIST_MISSING = (
    "DATA_PLANE=device-dist (one runtime across the groups, CollectivesDeviceDist) "
    "is not ported yet: ROADMAP queue 1 item 6"
)


def make_dataset(n=4096, d=32, classes=10, seed=7):
    """Synthetic classification set (CIFAR stand-in), identical everywhere:
    the JAX example's, from the same numpy seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w_true = rng.standard_normal((d, classes)).astype(np.float32)
    y = np.argmax(x @ w_true + 0.1 * rng.standard_normal((n, classes)), axis=1)
    return x, y.astype(np.int32)


def init_params(d=32, hidden=64, classes=10, seed=42) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(d)
    return {
        "w1": (scale * rng.standard_normal((d, hidden))).astype(np.float32),
        "b1": np.zeros(hidden, np.float32),
        "w2": (scale * rng.standard_normal((hidden, classes))).astype(np.float32),
        "b2": np.zeros(classes, np.float32),
    }


def to_device(params: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in params.items()}


def loss_fn(params: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    return F.cross_entropy(logits, y)


def value_and_grad(params: Dict[str, torch.Tensor], x: torch.Tensor, y: torch.Tensor):
    """``jax.value_and_grad(loss_fn)``: the loss and a gradient tree of
    ``params``' structure (the params themselves stay leaves without a
    graph)."""
    keys = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    loss = loss_fn(dict(zip(keys, leaves)), x, y)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(keys, grads))


def make_adam(params) -> torch.optim.Adam:
    """``optax.adam(1e-3)``: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, no weight decay."""
    return torch.optim.Adam(tree_leaves(params), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def param_checksum(params) -> float:
    """The JAX example's checksum: each leaf's float32 sum, summed as Python
    floats in sorted-key order."""
    return float(sum(float(p.detach().cpu().numpy().sum()) for p in tree_leaves(params)))


def _average_in_group(grads: Dict[str, torch.Tensor], world: int) -> Dict[str, torch.Tensor]:
    """The group's ranks' mean gradient (``torch.distributed``)."""
    import torch.distributed as dist

    for g in grads.values():
        dist.all_reduce(g)
        g.div_(world)
    return grads


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", 0))
    num_groups = int(os.environ.get("NUM_REPLICA_GROUPS", 2))
    steps = int(os.environ.get("STEPS", 20))
    batch = int(os.environ.get("BATCH", 64))
    ckpt_dir = os.environ.get("CKPT_DIR")
    ckpt_every = int(os.environ.get("CKPT_EVERY", 5))
    device = resolve_device(os.environ.get("DEVICE", "cuda"))
    if os.environ.get("DATA_PLANE", "tcp") == "device-dist":
        raise NotImplementedError(DEVICE_DIST_MISSING)
    if device.type == "cpu":
        torch.set_num_threads(1)  # the groups share the host's cores
    # launcher env contract (torchelastic analogue): a launcher-provided
    # store + RANK / WORLD_SIZE means this process is one rank of a
    # multi-process group; standalone runs make their own 1-rank group
    rank = int(os.environ.get("RANK", 0))
    world_size = int(os.environ.get("WORLD_SIZE", 1))
    store_addr = os.environ.get("TORCHFT_STORE_ADDR")
    store = None
    if store_addr is None:
        store = StoreServer()
        store_addr = store.address()
    # a multi-process group joins its torch.distributed group (a no-op
    # without the launcher's MASTER_ADDR / MASTER_PORT)
    from torchft_tpu_torch.parallel import multihost

    multihost.initialize_group(device=device.type)

    manager = Manager(
        collectives=CollectivesTcp(timeout=timedelta(seconds=30)),
        load_state_dict=None,  # wired by ManagedOptimizer.init
        state_dict=None,
        min_replica_size=min(2, num_groups),
        replica_id=f"train_ddp_{replica_group}",
        store_addr=store_addr,
        rank=rank,
        world_size=world_size,
        timeout=timedelta(seconds=30),
    )

    x_np, y_np = make_dataset()
    x = torch.from_numpy(x_np).to(device)
    y = torch.from_numpy(y_np.astype(np.int64)).to(device)
    opt = ManagedOptimizer(manager, make_adam)
    opt.init(to_device(init_params(), device))
    sampler = DistributedSampler(len(x_np), replica_group=replica_group,
                                 num_replica_groups=num_groups, shuffle=True, seed=0)

    # periodic disk checkpoints (total-failure recovery; live quorum
    # healing covers partial failures): one writer per group, every rank
    # restores from the shared snapshot, restore happens BEFORE the first
    # quorum so a resumed group reports its true step and heals forward
    ckpt = None
    if ckpt_dir:
        from torchft_tpu_torch.checkpointing.disk import DiskCheckpointer

        ckpt = DiskCheckpointer(
            ckpt_dir,
            manager,
            state_dict=lambda: {"opt": opt.state_dict(), "sampler": sampler.state_dict()},
            load_state_dict=lambda s: (opt.load_state_dict(s["opt"]),
                                       sampler.load_state_dict(s["sampler"])),
            every=ckpt_every,
            tag=f"group{replica_group}",
            is_writer=(rank == 0),
        )
        ckpt.restore()

    def steps_in_flight() -> int:
        # committed steps plus the speculative one whose pipelined vote is
        # still in flight — the loop must count it or a pipelined run would
        # train one extra step past STEPS
        return manager.current_step() + (1 if manager.pending_commit() is not None else 0)

    try:
        prev_step = manager.current_step()
        while manager.current_step() < steps:
            while steps_in_flight() < steps:
                # the in-flight count, not current_step(): during
                # speculation the committed counter lags one step, and
                # feeding it to the sampler would phase-shift the batches
                sampler.set_epoch(steps_in_flight())
                idx = np.fromiter(iter(sampler), dtype=np.int64)[:batch]
                if world_size > 1:
                    idx = idx[rank::world_size]  # this rank's share of the group's batch
                ids = torch.from_numpy(idx).to(device)

                opt.begin_step()  # async quorum overlaps the forward pass
                loss, grads = value_and_grad(opt.params, x[ids], y[ids])
                if multihost.is_initialized():
                    grads = _average_in_group(grads, world_size)
                opt.step(grads)
                if manager.current_step() == prev_step and manager.pending_commit() is None:
                    # failed commit (e.g. waiting for enough replicas): back
                    # off instead of hammering the quorum. A pending
                    # pipelined vote is NOT a failed commit.
                    time.sleep(0.2)
                prev_step = manager.current_step()
                logger.info("step=%d batches_committed=%d participants=%d loss=%.4f",
                            manager.current_step(), manager.batches_committed(),
                            manager.num_participants(), float(loss))
                if ckpt is not None:
                    ckpt.maybe_save()
            # pipelined commit: resolve the trailing speculative vote (a
            # no-op in sync mode). A veto leaves current_step < steps and
            # the outer loop trains the missing step(s).
            opt.finish()
        logger.info("done: step=%d param_checksum=%.6f", manager.current_step(),
                    param_checksum(opt.params))
    finally:
        if ckpt is not None:
            ckpt.close()
        manager.shutdown(wait=False)
        if store is not None:
            store.shutdown()
        if multihost.is_initialized():
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
