"""Long-context and scale rows of the bench, in a process of their own —
the port's copy of ``torchft_tpu/benchmarks/long_context.py``.

The headline model (``models.transformer.headline_config``, on the flash
kernels) at S 32768, 16384, 8192 and 4096, then the 647M "scale" model
(d2048 L12 h16 head dim 64 ff5632, bf16, ``remat=False``) at batch 4 x seq
1024, each through ``bench.train_bench``: one replica group, the full FT
loop, both halves of the step replayed from CUDA graphs. The lengths run
in descending order: the largest row must not run after the smaller ones'
leftover allocations (the JAX note, ``long_context.py:40-43``); each row
frees the last one's graphs and memory before it starts
(``bench._single_group_ft_runtime``).

Each row carries the JAX row's keys (``steps_per_sec``, ``tokens_per_sec``,
``mfu_pct``, a note; ``n_params`` and ``config`` on the scale row) and the
row's peak device memory, committed steps, flash launches per step and
graph captures.

Run: ``python -m torchft_tpu_torch.benchmarks.long_context`` (the card);
prints one JSON line with a row per variant.
"""

from __future__ import annotations

import json
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = ["run", "LENGTHS", "scale_config", "ROW_KEYS"]

# (seq, batch, steps, warmup), descending (long_context.py:44-46)
LENGTHS = ((32768, 1, 3, 1), (16384, 1, 4, 2), (8192, 1, 6, 2), (4096, 2, 10, 2))
# the scale row: (batch, seq, steps, warmup)
SCALE_SHAPE = (4, 1024, 8, 2)
ROW_KEYS = tuple(f"long_context_s{s}" for s, *_ in LENGTHS) + ("scale_647M",)


def scale_config():
    """The 647M model of ``long_context.py:60-67``: remat off (measured
    faster than remat at this size on the TPU, the opposite of the
    headline)."""
    import torch

    from torchft_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=32000, d_model=2048, n_layers=12, n_heads=16,
                             head_dim=64, d_ff=5632, dtype=torch.bfloat16, remat=False,
                             attention_impl="flash")


def _row(cfg, batch: int, seq: int, steps: int, warmup: int, peak: float) -> Dict[str, Any]:
    from torchft_tpu_torch.bench import _model_flops_per_step, mfu_pct, train_bench

    rec: Dict[str, Any] = {}
    sps, n_params = train_bench(cfg, batch, seq, steps, warmup, averaging=True, record=rec)
    return {
        "steps_per_sec": round(sps, 4),
        "tokens_per_sec": round(sps * batch * seq),
        "mfu_pct": mfu_pct(sps, _model_flops_per_step(cfg, n_params, batch, seq), peak),
        "n_params": n_params,
        "peak_memory_gb": rec["peak_memory_gb"],
        "steps": rec["steps"],
        "committed": rec["committed"],
        "launches": rec["launches"],
        "launches_per_step": rec["launches_per_step"],
        "captures": rec["captures"],
    }


def run(cfg=None, lengths: Sequence[Tuple[int, int, int, int]] = LENGTHS,
        scale: Optional[Tuple[Any, Tuple[int, int, int, int]]] = None) -> Dict[str, Any]:
    """The rows; ``cfg`` (default the headline) runs at ``lengths``, then
    ``scale`` = (config, (batch, seq, steps, warmup)), default the 647M
    model at b4 s1024. The device is ``DEVICE`` (default the card)."""
    import torch

    from torchft_tpu_torch.bench import _device, _peak_flops
    from torchft_tpu_torch.models.transformer import headline_config

    device = _device()
    if device.type == "cuda":
        from torchft_tpu_torch.ops import flash_attention as fa

        fa.build()
    cfg = cfg if cfg is not None else headline_config()
    scale_cfg, (sb, ss, ssteps, swarm) = scale or (scale_config(), SCALE_SHAPE)
    peak = _peak_flops(torch.cuda.get_device_name(device)) if device.type == "cuda" else 0.0
    out: Dict[str, Any] = {}
    for s, b, steps, warmup in lengths:
        try:
            row = _row(cfg, b, s, steps, warmup, peak)
            del row["n_params"]
            row["attention"] = ("flash kernels K1-K3 (csrc/flash_attention.cu), causal; "
                                "OWN process, largest length first")
            row["config"] = f"headline d{cfg.d_model} L{cfg.n_layers} b{b} s{s}"
        except Exception:  # noqa: BLE001 — recorded; bench.main exits 1 on it
            row = {"error": traceback.format_exc()[-1500:]}
        out[f"long_context_s{s}"] = row
    try:
        row = _row(scale_cfg, sb, ss, ssteps, swarm, peak)
        row["config"] = (f"d{scale_cfg.d_model} L{scale_cfg.n_layers} h{scale_cfg.n_heads} "
                         f"b{sb} s{ss} {str(scale_cfg.dtype).replace('torch.', '')}, "
                         f"remat={scale_cfg.remat}; OWN process")
    except Exception:  # noqa: BLE001
        row = {"error": traceback.format_exc()[-1500:]}
    out["scale_647M"] = row
    return out


if __name__ == "__main__":
    print(json.dumps(run()), flush=True)
