"""The bench headline of two checkouts of the port, alternated in fresh processes.

Usage (one NVIDIA GPU): ``python3 scripts/torch_bench_ab.py DIR_A DIR_B [--pairs 5]``

Each DIR is the root of a checkout of the port. Both are built first, in
parallel. Then each of ``--pairs`` rounds runs the headline measurement of
each checkout's ``torchft_tpu_torch.bench`` (``train_bench`` as
``bench.main`` calls it: the headline config, batch 8 x seq 1024, 3
warm-up and 20 timed steps, the cross-group average on) in a process of
its own, A then B in even rounds and B then A in odd ones, so that neither
side always runs first. Prints the card's name and power limit, every
run's steps/s and, per side, the median, min and max and the spread
((max - min) / median).
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

BUILD = ("from torchft_tpu_torch import _native; "
         "from torchft_tpu_torch.ops import flash_attention as fa; "
         "_native.build(); fa.build()")
HEADLINE = ("import logging, torch; logging.basicConfig(level=logging.WARNING); "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "from torchft_tpu_torch import bench; "
            "from torchft_tpu_torch.models.transformer import headline_config; "
            "sps, _ = bench.train_bench(headline_config(), 8, 1024, 20, 3, averaging=True); "
            "print(f'HEADLINE {sps!r}')")


def _run(tree: str, code: str, timeout: float) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True, timeout=timeout, env=dict(os.environ, DEVICE="cuda"))
    if proc.returncode != 0:
        sys.exit(f"{tree}: rc={proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    for side, tree in trees.items():
        print(f"{side}: {tree}", flush=True)

    builds = {side: subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree)
              for side, tree in trees.items()}
    for side, proc in builds.items():
        if proc.wait(timeout=900) != 0:
            sys.exit(f"{side}: build failed (rc={proc.returncode})")

    rates = {"A": [], "B": []}
    for i in range(args.pairs):
        for side in ("AB" if i % 2 == 0 else "BA"):
            out = _run(trees[side], HEADLINE, timeout=600)
            line = [ln for ln in out.splitlines() if ln.startswith("HEADLINE ")]
            if not line:
                sys.exit(f"{side}: no headline line in\n{out[-4000:]}")
            rate = float(line[-1].split()[1])
            rates[side].append(rate)
            print(f"round {i} {side}: {rate} steps/s", flush=True)
    for side, r in rates.items():
        med = statistics.median(r)
        print(f"{side}: median {med} min {min(r)} max {max(r)} spread "
              f"{(max(r) - min(r)) / med * 100:.2f}% steps/s over {len(r)} runs: {r} ({card})",
              flush=True)


if __name__ == "__main__":
    main()
