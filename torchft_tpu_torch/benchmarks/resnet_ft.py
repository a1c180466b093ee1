"""ResNet-18/CIFAR FT-loop row of the bench, in a process of its own — the
port's copy of ``torchft_tpu/benchmarks/resnet_ft.py``.

The port's ResNet-18 CIFAR model (``models/resnet.py``) in bf16 on the card
(float32 on the CPU), a batch of 256 NHWC 32x32x3 images and labels from a
numpy seed, SGD(0.1, momentum 0.9), through the single-group FT loop of
``bench.train_bench`` (quorum, gradients, ``allreduce_gradients``, commit
vote, update; the new BN stats kept on a commit). The step is the CIFAR
example's ``CifarStep``: on the card both halves replay from CUDA graphs.
Median of ``reps`` runs, each in a fresh FT runtime, with the runs and
their spread.

Run: ``python -m torchft_tpu_torch.benchmarks.resnet_ft [--reps 5]``
(the card; ``DEVICE=cpu`` for the CPU); prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

__all__ = ["run"]


def _copy_tree(dst, src) -> None:
    import torch

    from torchft_tpu_torch.utils.tree import tree_leaves

    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            d.copy_(s)


def run(steps: int = 20, warmup: int = 3, batch: int = 256, reps: int = 5,
        cfg: Optional[Any] = None) -> Dict[str, Any]:
    """The ``resnet18_cifar`` row; ``cfg`` defaults to ResNet-18 in bf16 on
    the card, float32 on the CPU (``DEVICE``)."""
    import numpy as np
    import torch

    from torchft_tpu_torch.bench import _device, _single_group_ft_runtime
    from torchft_tpu_torch.ddp import allreduce_gradients
    from torchft_tpu_torch.examples.train_cifar import CifarStep
    from torchft_tpu_torch.models import resnet
    from torchft_tpu_torch.parallel.train_step import synchronize
    from torchft_tpu_torch.utils.tree import tree_leaves

    device = _device()
    on_card = device.type == "cuda"
    if cfg is None:
        cfg = resnet.ResNetConfig(dtype=torch.bfloat16 if on_card else torch.float32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 10, batch)).to(device)
    runs: List[float] = []
    captures: List[Optional[Dict[str, int]]] = []
    committed: List[int] = []
    for _ in range(reps):
        with _single_group_ft_runtime("bench_resnet", device) as manager:
            step = CifarStep(cfg, device=device)
            params, stats = step.init(0)
            opt = torch.optim.SGD(tree_leaves(params), lr=0.1, momentum=0.9, dampening=0,
                                  foreach=True if on_card else None)

            def ft_step():
                manager.start_quorum()
                loss, grads, new_stats = step.grads(params, stats, x, y)
                grads = allreduce_gradients(manager, grads)
                if manager.should_commit():
                    step.apply(params, opt, grads)
                    _copy_tree(stats, new_stats)  # in place: the graph reads them
                return loss

            for _ in range(warmup):
                ft_step()
            synchronize(device)
            t0 = time.perf_counter()
            for _ in range(steps):
                ft_step()
            synchronize(device)
            runs.append(steps / (time.perf_counter() - t0))
            captures.append(dict(step.graphs.captures) if step.graphs is not None else None)
            committed.append(manager.current_step())
    order = sorted(range(reps), key=runs.__getitem__)
    runs = [runs[i] for i in order]
    sps = runs[len(runs) // 2]
    return {
        "steps_per_sec": round(sps, 4),
        "imgs_per_sec": round(sps * batch),
        "runs_steps_per_sec": [round(r, 4) for r in runs],
        "spread_pct": round((runs[-1] - runs[0]) / sps * 100.0, 1),
        "steps": warmup + steps,
        "committed": [committed[i] for i in order],
        "captures": [captures[i] for i in order],
        "config": f"resnet18-cifar NHWC {str(cfg.dtype).replace('torch.', '')} b{batch}, "
        f"SGD(0.1, momentum 0.9), single-group FT loop, "
        f"{'graphed (CUDA graphs)' if on_card else 'eager'}, OWN process, median of {reps}",
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    print(json.dumps(run(reps=ap.parse_args().reps)), flush=True)
