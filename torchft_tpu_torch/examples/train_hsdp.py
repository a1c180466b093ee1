"""HSDP training example — the port of ``examples/train_hsdp.py``.

Each replica group owns a fixed inner mesh (fsdp x tp over the group's
processes, DTensor placements over ``torch.distributed``), while the
Manager runs the elastic replica axis across groups. Gradients cross it
through ``allreduce_gradients``, each rank averaging its own shards with
its same-rank peers (host TCP). Group membership changes never touch the
mesh; a killed group live-heals its *sharded* params and optimizer state
shard by shard from a survivor (``serialization``'s ``"shards"`` leaves).

One process per in-group rank: under the launcher, ``--nproc`` equal to
the mesh's total (FSDP x TP x SP x PP); a group of one process runs the
same DTensor code on a one-rank mesh. On the card by default (one card a
rank; ``DEVICE=cpu`` for the CPU, gloo between a group's processes).

Env:

    TORCHFT_LIGHTHOUSE=host:port
    REPLICA_GROUP_ID / NUM_REPLICA_GROUPS (default 2)
    MODEL=tiny|llama2-7b           preset (default tiny, float32; llama2-7b
                                   bf16, at full depth more than one card
                                   holds: see ``train`` for a cut depth)
    FSDP/TP/SP/PP                  inner mesh axis sizes (default 2/2/1/1;
                                   SP shards the sequence, ring attention;
                                   PP the layers, the GPipe ring with PP
                                   microbatches a step)
    STEPS=3  BATCH=8  SEQ=16       training shape
    DATA_PLANE=tcp|device          cross-group backend (default tcp;
                                   device = groups as threads of one
                                   process, one rank a group)
    DEVICE=cuda|cpu                where it trains (the card by default)

Run 2 tiny groups of 4 processes on the CPU::

    DEVICE=cpu python -m torchft_tpu_torch.launcher --groups 2 --nproc 4 -- \\
        python -m torchft_tpu_torch.examples.train_hsdp

Each group ends with ``done: step=N param_checksum=X`` on every rank; the
checksums of all ranks of all groups are equal. On the card each rank
also logs its peak device memory and its flash kernels' launches over the
steps it ran (K1-K3: under ``remat "all"`` 2L/L/L a step for L layers); a
group of one process replays its step from CUDA graphs and logs their
captures.
"""

from __future__ import annotations

import json
import logging
import os
import time
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.transformer import TransformerConfig
from torchft_tpu_torch.parallel import multihost
from torchft_tpu_torch.parallel.ft import FTTrainer
from torchft_tpu_torch.parallel.mesh import MeshConfig
from torchft_tpu_torch.parallel.train_step import TrainStep
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_leaves

logger = logging.getLogger("train_hsdp")

PRESETS = {
    # the JAX example's tiny model (head dim 8; the card runs it on K1-K3)
    "tiny": dict(vocab_size=64, d_model=16, n_layers=2, n_heads=2, head_dim=8, d_ff=32),
    # Llama-2-7B's widths (BASELINE.md north-star config), bf16
    "llama2-7b": dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                      head_dim=128, d_ff=11008),
}

SHARDED_DEVICE_PLANE_MISSING = (
    "DATA_PLANE=device on a mesh of more than one rank (the device plane's "
    "sharded-group case) is not ported yet: ROADMAP queue 1 item 7"
)


def preset_config(name: str, **overrides) -> TransformerConfig:
    """A preset as the JAX example builds it (float32 ``tiny``, bf16
    otherwise), with ``overrides`` (e.g. ``n_layers``) applied."""
    dtype = torch.float32 if name == "tiny" else torch.bfloat16
    return TransformerConfig(dtype=dtype, **{**PRESETS[name], **overrides})


def param_checksum(params) -> float:
    """The JAX example's checksum: each leaf's float32 sum, summed as Python
    floats in leaf order. A sharded leaf is gathered first (a collective:
    every rank of the group calls it)."""
    total = 0.0
    for p in tree_leaves(params):
        full = p.full_tensor() if hasattr(p, "full_tensor") else p
        total += float(full.detach().float().sum())
    return total


def train(
    cfg: TransformerConfig,
    mesh_cfg: MeshConfig,
    steps: int = 3,
    batch: int = 8,
    seq: int = 16,
    replica_group: int = 0,
    num_groups: int = 2,
    data_plane: str = "tcp",
    device: str = "cuda",
    graph: Optional[bool] = None,
) -> float:
    """Train ``cfg`` on an inner mesh of ``mesh_cfg`` in one replica group
    until the committed step reaches ``steps``; returns the param checksum
    (logged as ``done: ...``). Reads the launcher's env contract
    (``TORCHFT_STORE_ADDR``, ``RANK`` / ``WORLD_SIZE``, the lighthouse).
    ``graph``: as ``TrainStep``'s (``None``: CUDA graphs on a one-rank mesh
    on the card; ``False`` keeps the step eager, whose memory peak is lower)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the processes share the host's cores
    if data_plane == "device" and mesh_cfg.total > 1:
        raise NotImplementedError(SHARDED_DEVICE_PLANE_MISSING)
    store_addr = os.environ.get("TORCHFT_STORE_ADDR")
    store = None
    if store_addr is None:
        store = StoreServer()
        store_addr = store.address()

    multihost.initialize_group(device=dev.type)  # a no-op for one process
    mesh = multihost.global_mesh(mesh_cfg, dev.type)
    ts = TrainStep(cfg, mesh=mesh, graph=graph)

    if data_plane == "device":
        from torchft_tpu_torch.collectives_device import CollectivesDevice

        collectives = CollectivesDevice(timeout=timedelta(seconds=30))
    else:
        from torchft_tpu_torch.collectives import CollectivesTcp

        collectives = CollectivesTcp(timeout=timedelta(seconds=30))

    manager = Manager(
        collectives=collectives,
        load_state_dict=None,  # wired by FTTrainer.init
        state_dict=None,
        min_replica_size=min(2, num_groups),
        replica_id=f"hsdp_{replica_group}",
        store_addr=store_addr,
        rank=int(os.environ.get("RANK", 0)),
        world_size=int(os.environ.get("WORLD_SIZE", 1)),
        timeout=timedelta(seconds=30),
    )
    try:
        trainer = FTTrainer(manager, ts)
        trainer.init(seed=0)
        n_params = sum(int(np.prod(p.shape)) for p in tree_leaves(trainer.params))
        logger.info("params=%.1fM mesh=%s", n_params / 1e6, mesh_cfg.sizes)

        if dev.type == "cuda":
            from torchft_tpu_torch.ops import flash_attention as fa

            fa.reset_launches()
        runs = 0
        data_rng = np.random.default_rng(1000 + replica_group)
        while manager.current_step() < steps:
            tokens = torch.from_numpy(
                data_rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))
            loss, committed = trainer.step(tokens)
            runs += 1
            if not committed:
                time.sleep(0.2)  # back off while the quorum is short
            logger.info("step=%d committed=%s participants=%d loss=%.4f",
                        manager.current_step(), committed, manager.num_participants(), loss)
        checksum = param_checksum(trainer.params)
        if dev.type == "cuda":
            logger.info("peak device memory %.2f GB",
                        torch.cuda.max_memory_allocated() / 1e9)
            logger.info("flash launches (head dim %d) over %d steps run: %s", cfg.head_dim,
                        runs, json.dumps(dict(fa.LAUNCHES)))
        if ts.graphs is not None:
            logger.info("graph captures: %s", json.dumps(ts.graphs.captures))
        logger.info("done: step=%d param_checksum=%.6f", manager.current_step(), checksum)
        return checksum
    finally:
        manager.shutdown(wait=False)
        if store is not None:
            store.shutdown()
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    mesh_cfg = MeshConfig(
        fsdp=int(os.environ.get("FSDP", 2)),
        tp=int(os.environ.get("TP", 2)),
        sp=int(os.environ.get("SP", 1)),
        pp=int(os.environ.get("PP", 1)),
    )
    train(
        preset_config(os.environ.get("MODEL", "tiny"), pp=mesh_cfg.pp),
        mesh_cfg,
        steps=int(os.environ.get("STEPS", 3)),
        batch=int(os.environ.get("BATCH", 8)),
        seq=int(os.environ.get("SEQ", 16)),
        replica_group=int(os.environ.get("REPLICA_GROUP_ID", 0)),
        num_groups=int(os.environ.get("NUM_REPLICA_GROUPS", 2)),
        data_plane=os.environ.get("DATA_PLANE", "tcp"),
        device=os.environ.get("DEVICE", "cuda"),
    )


if __name__ == "__main__":
    main()
