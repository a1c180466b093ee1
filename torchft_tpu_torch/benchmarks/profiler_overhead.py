"""The always-on samplers' cost: the headline FT loop with both stack
samplers armed at the default rate and disarmed, in interleaved pairs —
the port's copy of ``torchft_tpu/benchmarks/profiler_overhead.py``.

The diagnosis plane rests on the samplers being cheap enough to leave on
for the life of the trainer; this row measures that. Each leg is the
port's ``bench.train_bench`` (a quorum, the gradients, the cross-group
average and the commit vote through the instrumented Manager) with BOTH
samplers armed at :data:`~torchft_tpu_torch.telemetry.profiler.DEFAULT_HZ`
(the native SIGPROF sampler over the registered native threads, and the
Python ``sys._current_frames`` thread) or disarmed (0 Hz). The legs
alternate, so both see the same drift, and the medians are compared;
``within_gate`` says whether ``overhead_pct`` stayed within
:data:`GATE_PCT`.

Run on the card (the headline, B8 S1024) or with ``DEVICE=cpu`` (B4 S128):
``python -m torchft_tpu_torch.benchmarks.profiler_overhead [--runs N]``;
prints one JSON line, ``{"profiler_overhead": {...}}``. ``bench.py`` runs
it as a row of its own, in a process of its own, so the toggling and its
samples stay out of the bench process's other rows.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

# the budget: the samplers may cost at most this share of the step rate (%)
GATE_PCT = 2.0


def _set_armed(on: bool) -> None:
    from torchft_tpu_torch.telemetry.profiler import DEFAULT_HZ, PROFILER, native_set_hz

    hz = DEFAULT_HZ if on else 0.0
    PROFILER.set_hz(hz)
    native_set_hz(hz)


def measure(runs: int, steps: int, warmup: int, batch: int, seq: int,
            cfg: Optional[Any] = None) -> Dict[str, Any]:
    """``runs`` interleaved pairs of armed and disarmed legs of the
    headline (or ``cfg``) at ``batch`` x ``seq``; the row."""
    from torchft_tpu_torch.bench import train_bench
    from torchft_tpu_torch.models.transformer import headline_config
    from torchft_tpu_torch.telemetry.profiler import DEFAULT_HZ, PROFILER, poll_native_samples

    cfg = cfg if cfg is not None else headline_config()
    armed, disarmed = [], []
    # one throwaway leg first: the first step's set-up (kernel loads,
    # allocator growth, the graphs' captures) lands in neither variant
    _set_armed(False)
    train_bench(cfg, batch, seq, 1, 1, averaging=True)
    for _ in range(runs):  # interleaved: both variants see the same drift
        _set_armed(True)
        armed.append(train_bench(cfg, batch, seq, steps, warmup, averaging=True)[0])
        _set_armed(False)
        disarmed.append(train_bench(cfg, batch, seq, steps, warmup, averaging=True)[0])
    _set_armed(True)  # leave the process in the always-on default
    native_samples = poll_native_samples()
    py_samples = PROFILER.samples_total()
    armed.sort()
    disarmed.sort()
    a, d = armed[len(armed) // 2], disarmed[len(disarmed) // 2]
    overhead = (d - a) / d * 100.0 if d else 0.0
    return {
        "_gate_presence": True,
        "steps_per_sec": round(a, 4),
        "steps_per_sec_disarmed": round(d, 4),
        "overhead_pct": round(overhead, 2),
        "gate_pct": GATE_PCT,
        "within_gate": overhead <= GATE_PCT,
        "hz": DEFAULT_HZ,
        "runs_armed": [round(r, 4) for r in armed],
        "runs_disarmed": [round(r, 4) for r in disarmed],
        "py_samples": int(py_samples),
        "native_samples": int(native_samples),
        "config": {"batch": batch, "seq": seq, "steps": steps, "warmup": warmup, "runs": runs},
        "note": "headline FT leg with both samplers armed at the default rate vs disarmed, "
        "interleaved medians; within_gate reports the budget, nothing holds it. Medians of few "
        "runs move with the host's weather: re-run before believing a breach.",
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=None)
    args = ap.parse_args()
    on_card = os.environ.get("DEVICE", "cuda") != "cpu"
    if on_card:
        from torchft_tpu_torch.ops import flash_attention as fa

        fa.build()  # once, before any timed window
        batch, seq, steps, warmup = 8, 1024, 20, 3
    else:
        batch, seq, steps, warmup = 4, 128, 5, 1
    row = measure(args.runs, args.steps or steps, args.warmup or warmup, batch, seq)
    print(json.dumps({"profiler_overhead": row}), flush=True)


if __name__ == "__main__":
    main()
