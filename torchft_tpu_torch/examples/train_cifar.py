"""Fault-tolerant ResNet-18 CIFAR-10 DDP — the port of
``examples/train_cifar.py``.

The model is the port's ResNet (``models/resnet.py``) with functional batch
norm: running stats are explicit state that rides the heal's state dict
(torch DDP likewise keeps BN stats local per replica). A batch's indices
derive from the committed step count (``data.step_indices``), so a kill and
rejoin never skips or double-trains a sample. The step (:class:`CifarStep`)
is the JAX example's ``grads_fn`` / ``apply_fn``: loss, gradients and new
BN stats, then SGD with momentum 0.9 at lr 0.05; on the card each half
replays from a CUDA graph, as ``TrainStep``'s do.

The dataset is a CIFAR-10-shaped ``.npz``: real CIFAR-10 when a copy
exists at DATA_PATH, else a deterministic learnable stand-in with the same
shapes and dtypes generated once from seed 0 (never downloaded) and shared
by every group. It runs in bf16 on the card and in float32 on the CPU.

Env: TORCHFT_LIGHTHOUSE, REPLICA_GROUP_ID, NUM_REPLICA_GROUPS, STEPS,
BATCH, DATA_PATH, TRACE_PATH, DEVICE (``cuda``, the default, or ``cpu``).
CKPT_DIR / CKPT_EVERY (disk checkpoints) are not ported yet.

Run, one process per group::

    python -m torchft_tpu_torch.lighthouse --bind "[::]:29600" --min_replicas 2 &
    REPLICA_GROUP_ID=0 NUM_REPLICA_GROUPS=2 TORCHFT_LIGHTHOUSE=localhost:29600 \\
        python -m torchft_tpu_torch.examples.train_cifar
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from datetime import timedelta
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from torchft_tpu_torch.collectives import CollectivesTcp
from torchft_tpu_torch.data import DistributedSampler, step_indices
from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import resnet
from torchft_tpu_torch.optim import load_optimizer_state
from torchft_tpu_torch.parallel.train_step import GraphedStep
from torchft_tpu_torch.store import StoreServer
from torchft_tpu_torch.utils.platform import resolve_device
from torchft_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

logger = logging.getLogger("train_cifar")


def ensure_dataset(path: str, n: int = 2048):
    """Load (or deterministically create) a CIFAR-10-shaped dataset:
    images uint8 [N,32,32,3], labels uint8 [N]."""
    if not os.path.exists(path):
        rng = np.random.default_rng(0)
        labels = rng.integers(0, 10, n).astype(np.uint8)
        # class-dependent structure (a colored gradient per class) + noise:
        # learnable, so training loss demonstrably falls
        yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
        base = np.stack([xx, yy, 1.0 - xx], axis=-1)  # [32,32,3]
        phase = (labels.astype(np.float32) / 10.0)[:, None, None, None]
        imgs = 127.5 * (1.0 + np.sin(6.28 * (base[None] + phase)))
        imgs = imgs + rng.normal(0, 16.0, imgs.shape)
        imgs = np.clip(imgs, 0, 255).astype(np.uint8)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        np.savez(tmp, images=imgs, labels=labels)
        os.replace(tmp + ".npz", path)  # np.savez appends .npz
    with np.load(path) as z:
        return z["images"], z["labels"]


def augment(imgs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Standard CIFAR augmentation on host: pad-4 random crop + hflip."""
    n = len(imgs)
    padded = np.pad(imgs, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    out = np.empty_like(imgs)
    offs = rng.integers(0, 9, (n, 2))
    flips = rng.random(n) < 0.5
    for i in range(n):
        dy, dx = offs[i]
        crop = padded[i, dy : dy + 32, dx : dx + 32]
        out[i] = crop[:, ::-1] if flips[i] else crop
    return out


class CifarStep(GraphedStep):
    """The example's train step on one device: ``grads`` (loss, gradients
    and new BN stats) and ``apply`` (SGD, ``optax.sgd(0.05, momentum=0.9)``).
    ``graph``: as ``TrainStep``'s (``None``: graphed on a CUDA device, eager
    on the CPU)."""

    def __init__(self, cfg: resnet.ResNetConfig, device: Union[str, torch.device] = "cuda",
                 graph: Optional[bool] = None) -> None:
        super().__init__(device, graph)
        self.cfg = cfg

    def init(self, seed: int = 0) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return resnet.init(torch.Generator().manual_seed(seed), self.cfg, device=self.device)

    def init_opt(self, params: Dict[str, Any]) -> torch.optim.SGD:
        # torch's SGD with dampening 0 is optax's trace: buf = g + 0.9 buf
        return torch.optim.SGD(tree_leaves(params), lr=0.05, momentum=0.9, dampening=0,
                               foreach=True if self.device.type == "cuda" else None)

    def grads(self, params: Dict[str, Any], stats: Dict[str, Any], images: torch.Tensor,
              labels: torch.Tensor) -> Tuple[torch.Tensor, Any, Dict[str, Any]]:
        """(loss, gradient tree, new BN stats) for NHWC float images and int
        labels. Graphed, the gradients and the new stats are the graph's
        static tensors: the next call overwrites them."""
        leaves, treedef = tree_flatten(params)
        stat_leaves, stat_def = tree_flatten(stats)
        for p in leaves:
            p.requires_grad_(True)

        def loss_grads_stats(x, y):
            loss, new_stats = resnet.loss_fn(params, stats, x, y, self.cfg)
            grads = list(torch.autograd.grad(loss, leaves))
            return loss.detach(), grads, tree_leaves(new_stats)

        loss, grads, new = self._compute(loss_grads_stats, leaves + stat_leaves,
                                         [images, labels])
        return loss, tree_unflatten(treedef, grads), tree_unflatten(stat_def, new)


def _copy_tree(dst: Any, src: Any) -> None:
    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            d.copy_(s)


class CifarTrainer:
    """One replica group's loop state: params, SGD and BN stats (the heal
    state, copied into in place so a captured step keeps reading them), the
    sampler and the augmentation's generator."""

    def __init__(self, manager: Manager, step: CifarStep, images: np.ndarray,
                 labels: np.ndarray, replica_group: int, num_groups: int, batch: int,
                 seed: int = 0, trace=None) -> None:
        self.manager, self.ts = manager, step
        self.images, self.labels, self.batch = images, labels, batch
        self.params, self.stats = step.init(seed)
        self.opt = step.init_opt(self.params)
        self.sampler = DistributedSampler(len(images), replica_group=replica_group,
                                          num_replica_groups=num_groups, shuffle=True, seed=0)
        self.aug_rng = np.random.default_rng(1000 + replica_group)
        self.trace = trace
        manager.set_state_dict_fns(self.load_state_dict, self.state_dict)

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.params, "opt_state": self.opt.state_dict(), "bn": self.stats}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _copy_tree(self.params, state["params"])
        load_optimizer_state(self.opt, state["opt_state"])
        _copy_tree(self.stats, state["bn"])

    def step(self) -> Tuple[float, np.ndarray, bool]:
        """One fault-tolerant step; returns (loss, the batch's sample ids,
        committed)."""
        m = self.manager
        step = m.current_step()
        ids = step_indices(self.sampler, step, self.batch)
        x = augment(self.images[ids], self.aug_rng).astype(np.float32) / 255.0
        y = self.labels[ids].astype(np.int64)

        m.start_quorum()
        loss, grads, new_bn = self.ts.grads(self.params, self.stats, torch.from_numpy(x),
                                            torch.from_numpy(y))
        grads = allreduce_gradients(m, grads)
        committed = m.should_commit()
        if committed:
            self.ts.apply(self.params, self.opt, grads)
            if m.is_participating():
                # participants only: on a heal step should_commit just
                # restored the peer's accumulated BN stats, and new_bn came
                # from the pre-heal forward
                _copy_tree(self.stats, new_bn)
                if self.trace is not None:
                    self.trace.write(json.dumps({"step": step, "ids": ids.tolist()}) + "\n")
        return float(loss), ids, committed


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", 0))
    num_groups = int(os.environ.get("NUM_REPLICA_GROUPS", 2))
    steps = int(os.environ.get("STEPS", 20))
    batch = int(os.environ.get("BATCH", 32))
    data_path = os.environ.get(
        "DATA_PATH", os.path.join(tempfile.gettempdir(), "torchft_tpu_cifar.npz"))
    trace_path = os.environ.get("TRACE_PATH")
    device = resolve_device(os.environ.get("DEVICE", "cuda"))
    if os.environ.get("CKPT_DIR"):
        raise NotImplementedError(
            "CKPT_DIR: disk checkpoints are not ported yet (ROADMAP queue 1, "
            "deployment pieces: checkpointing/disk.py)"
        )

    store_addr = os.environ.get("TORCHFT_STORE_ADDR")
    store = None
    if store_addr is None:
        store = StoreServer()
        store_addr = store.address()

    images, labels = ensure_dataset(data_path)
    logger.info("dataset: %d images %s", len(images), images.shape[1:])
    on_card = device.type == "cuda"
    cfg = resnet.ResNetConfig(dtype=torch.bfloat16 if on_card else torch.float32)

    manager = Manager(
        collectives=CollectivesTcp(timeout=timedelta(seconds=30)),
        load_state_dict=None,  # wired by CifarTrainer (params + opt + bn stats)
        state_dict=None,
        min_replica_size=min(2, num_groups),
        replica_id=f"train_cifar_{replica_group}",
        store_addr=store_addr,
        rank=0,
        world_size=1,
        timeout=timedelta(seconds=30),
    )
    trace = open(trace_path, "a", buffering=1) if trace_path else None
    try:
        trainer = CifarTrainer(manager, CifarStep(cfg, device), images, labels, replica_group,
                               num_groups, batch, trace=trace)
        while manager.current_step() < steps:
            loss, _, committed = trainer.step()
            if not committed:
                time.sleep(0.2)  # same batch retries: step didn't advance
            logger.info("step=%d participants=%d loss=%.4f", manager.current_step(),
                        manager.num_participants(), loss)
        checksum = sum(float(p.detach().double().sum()) for p in tree_leaves(trainer.params))
        logger.info("done: step=%d param_checksum=%.6f", manager.current_step(), checksum)
    finally:
        if trace is not None:
            trace.close()
        manager.shutdown(wait=False)
        if store is not None:
            store.shutdown()


if __name__ == "__main__":
    main()
