"""DiLoCo training example — the port of ``examples/train_diloco.py``
(BASELINE.md's "DiLoCo 4 groups" configuration).

Communication-reduced fault-tolerant training (arxiv 2311.08105): each
replica group runs ``SYNC_EVERY`` purely local AdamW(1e-3) steps of
``train_ddp``'s MLP, then the groups average *pseudogradients* through the
quorum and apply an outer Nesterov SGD(0.7, momentum 0.9) step
(:class:`~torchft_tpu_torch.local_sgd.DiLoCo`). On the card by default
(``DEVICE=cpu`` for the CPU).

Env (the launcher's contract, as ``train_ddp``):

    TORCHFT_LIGHTHOUSE=host:port   lighthouse address
    REPLICA_GROUP_ID / NUM_REPLICA_GROUPS (default 4)
    OUTER_STEPS=4                  outer (sync) steps to run
    SYNC_EVERY=8                   inner steps between syncs
    BATCH=64

Run 4 groups under the launcher (``--min-replicas 2`` mirrors the
Manager's ``min_replica_size``, so survivors keep committing while a
killed group is down)::

    python -m torchft_tpu_torch.launcher --groups 4 --min-replicas 2 -- \\
        python -m torchft_tpu_torch.examples.train_diloco

Kill any group mid-run: the survivors' next sync commits without it, and
the respawned group heals params and DiLoCo state at its next sync quorum
— its inner steps are the only work lost. Each group ends with ``done:
outer_step=N param_checksum=X``.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import numpy as np
import torch

from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.data import DistributedSampler
from torchft_tpu_torch.examples.train_ddp import (
    init_params,
    make_dataset,
    param_checksum,
    to_device,
    value_and_grad,
)
from torchft_tpu_torch.local_sgd import DiLoCo
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_leaves

logger = logging.getLogger("train_diloco")


def make_inner(params) -> torch.optim.AdamW:
    """``optax.adamw(1e-3)``: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4."""
    return torch.optim.AdamW(tree_leaves(params), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_outer(backup) -> torch.optim.SGD:
    """``optax.sgd(0.7, momentum=0.9, nesterov=True)``."""
    return torch.optim.SGD(backup, lr=0.7, momentum=0.9, nesterov=True)


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", 0))
    num_groups = int(os.environ.get("NUM_REPLICA_GROUPS", 4))
    outer_steps = int(os.environ.get("OUTER_STEPS", 4))
    sync_every = int(os.environ.get("SYNC_EVERY", 8))
    batch = int(os.environ.get("BATCH", 64))
    device = resolve_device(os.environ.get("DEVICE", "cuda"))
    if device.type == "cpu":
        torch.set_num_threads(1)  # the groups share the host's cores

    store_addr = os.environ.get("TORCHFT_STORE_ADDR")
    store = None
    if store_addr is None:
        store = StoreServer()
        store_addr = store.address()

    manager = Manager(
        collectives=CollectivesTcp(timeout=timedelta(seconds=30)),
        load_state_dict=None,
        state_dict=None,
        min_replica_size=min(2, num_groups),
        # DiLoCo's outer step must start from a fully healed state: the
        # sync quorum heals before the sync math
        use_async_quorum=False,
        replica_id=f"diloco_{replica_group}",
        store_addr=store_addr,
        rank=int(os.environ.get("RANK", 0)),
        world_size=int(os.environ.get("WORLD_SIZE", 1)),
        timeout=timedelta(seconds=30),
        # the quorum interval spans a whole inner loop
        quorum_timeout=timedelta(seconds=120),
    )

    x_np, y_np = make_dataset()
    x = torch.from_numpy(x_np).to(device)
    y = torch.from_numpy(y_np.astype(np.int64)).to(device)
    params = to_device(init_params(), device)
    state = {"inner": make_inner(params)}
    diloco = DiLoCo(manager, make_outer, sync_every=sync_every)
    diloco.save(params)

    # live recovery: a rejoining group receives params and the DiLoCo
    # backup / outer-optimizer state from a survivor at its next sync quorum
    def user_state_dict():
        return {"params": params, "diloco": diloco.state_dict()}

    def user_load_state_dict(s):
        with torch.no_grad():
            for dst, src in zip(tree_leaves(params), tree_leaves(s["params"])):
                dst.copy_(src)
        state["inner"] = make_inner(params)
        diloco.load_state_dict(s["diloco"])

    manager.set_state_dict_fns(user_load_state_dict, user_state_dict)

    data_rng_step = 0
    try:
        while manager.current_step() < outer_steps:
            sampler = DistributedSampler(len(x_np), replica_group=replica_group,
                                         num_replica_groups=num_groups, shuffle=True, seed=0)
            sampler.set_epoch(data_rng_step)
            idx = torch.from_numpy(np.fromiter(iter(sampler), dtype=np.int64)[:batch]).to(device)
            data_rng_step += 1

            loss, grads = value_and_grad(params, x[idx], y[idx])
            inner = state["inner"]
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.grad = g
            inner.step()
            inner.zero_grad(set_to_none=True)
            if diloco.step(params):  # a sync ran (commit or rollback)
                # the inner optimizer restarts from the outer point each
                # round (the paper's setup: fresh inner state per outer step)
                state["inner"] = make_inner(params)
                logger.info("outer step=%d participants=%d inner_loss=%.4f",
                            manager.current_step(), manager.num_participants(), float(loss))
        logger.info("done: outer_step=%d param_checksum=%.6f", manager.current_step(),
                    param_checksum(params))
    finally:
        manager.shutdown(wait=False)
        if store is not None:
            store.shutdown()


if __name__ == "__main__":
    main()
