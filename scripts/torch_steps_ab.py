"""Headline steps/s of two checkouts of the port, alternated in fresh processes.

Usage (one NVIDIA GPU): ``python3 scripts/torch_steps_ab.py DIR_A DIR_B [--pairs 5]``

Each DIR is the root of a checkout that has a ``chip_smoke.py``. Both are
built first, in parallel. Then each of ``--pairs`` rounds runs phase 4 of
each checkout's ``chip_smoke.py`` (2 warm-up and 5 timed steps of the
headline fault-tolerant loop on one replica group) in a process of its
own, A then B in even rounds and B then A in odd ones, so that neither
side always runs first. Prints every run's steps/s and, per side, the
median, min and max.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

BUILD = ("from torchft_tpu_torch import _native; "
         "from torchft_tpu_torch.ops import flash_attention as fa; "
         "_native.build(); fa.build()")
LOOP = ("import torch, chip_smoke; "
        "torch.backends.cuda.matmul.allow_tf32 = False; "
        "chip_smoke.phase_ft_loop()")
# a tree whose phase 4 runs both data planes reports the device plane's
# first run (the headline's wiring; graphed, where the tree has graphed and
# eager arms); an older tree reports its one run
RATE = re.compile(r"headline FT loop(?:, device plane)?(?:, graphed)?: ([0-9.]+) steps/s")


def _run(tree: str, code: str, timeout: float) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True, timeout=timeout)
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
            out = _run(trees[side], LOOP, timeout=600)
            m = RATE.search(out)
            if m is None:
                sys.exit(f"{side}: no steps/s line in\n{out[-4000:]}")
            rates[side].append(float(m.group(1)))
            print(f"round {i} {side}: {m.group(1)} steps/s", flush=True)
    for side, r in rates.items():
        print(f"{side}: median {statistics.median(r)} min {min(r)} max {max(r)} "
              f"steps/s over {len(r)} runs: {r}", flush=True)


if __name__ == "__main__":
    main()
