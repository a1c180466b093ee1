"""Two flash kernels of two checkouts of the port, alternated in fresh processes.

Usage (one NVIDIA GPU):
``python3 scripts/torch_flash_ab.py DIR_A DIR_B [--pairs 3] [--head-dim 128|32]``

Each DIR is the root of a checkout that has a ``chip_smoke.py``. Both
kernel libraries are built first, in parallel. Then each of ``--pairs``
rounds times, in a process of its own per checkout, two kernels at the
shapes of the head dim's path (bf16, causal) by CUDA-graph replay with
the inputs L2-warm (``chip_smoke.py``'s ``gpu_time_ms``, the method of
phase 3's ``ms_graph``), A then B in even rounds and B then A in odd ones:
at head dim 128 the forward (K1) and the dK/dV kernel (K3) at the
Llama-2-7B shapes (B2 S4096 H32 D128), at 32 the dQ kernel (K2) and K3 at
train_bytes' (B8 S128 H4 D32). Prints every run's times and, per side and
kernel, the median, min and max.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

BUILD = "from torchft_tpu_torch.ops import flash_attention as fa; fa.build()"
# the timing process; {shape} and {first} are filled in per head dim
TIMES = """
import torch
import chip_smoke as c
from torchft_tpu_torch.ops import flash_attention as fa
b, s, h, d = c._shape(c.{shape})
q, k, v, do = c._qkv(b, s, h, d, torch.bfloat16, seed=3)
pq, pk, pv, pdo = map(c._pack, (q, k, v, do))
o, lse = fa.fwd_kernel(pq, pk, pv, True)
delta = (pdo.float() * o.float()).sum(-1)
torch.cuda.synchronize()
calls = {{
    "K1": lambda: fa.fwd_kernel(pq, pk, pv, True),
    "K2": lambda: fa.dq_kernel(pq, pk, pv, pdo, lse, delta, True),
}}
first = c.gpu_time_ms(calls["{first}"], graph=True)
k3 = c.gpu_time_ms(lambda: fa.dkv_kernel(pq, pk, pv, pdo, lse, delta, True), graph=True)
print(f"{first} {{first}} K3 {{k3}}")
"""
# head dim: (chip_smoke.py's shape, the kernel timed beside K3)
HEAD_DIMS = {128: ("LLAMA", "K1"), 32: ("BYTES", "K2")}
LINE = re.compile(r"^(K[12]) ([0-9.]+) K3 ([0-9.]+)$", re.M)


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
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--head-dim", type=int, choices=sorted(HEAD_DIMS), default=128)
    args = ap.parse_args()
    shape, first = HEAD_DIMS[args.head_dim]
    code = TIMES.format(shape=shape, first=first)
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    for side, tree in trees.items():
        print(f"{side}: {tree}", flush=True)

    builds = {side: subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree)
              for side, tree in trees.items()}
    for side, proc in builds.items():
        if proc.wait(timeout=900) != 0:
            sys.exit(f"{side}: build failed (rc={proc.returncode})")

    times = {(side, kernel): [] for side in trees for kernel in (first, "K3")}
    for i in range(args.pairs):
        for side in ("AB" if i % 2 == 0 else "BA"):
            out = _run(trees[side], code, timeout=600)
            m = LINE.search(out)
            if m is None:
                sys.exit(f"{side}: no times line in\n{out[-4000:]}")
            times[(side, first)].append(float(m.group(2)))
            times[(side, "K3")].append(float(m.group(3)))
            print(f"round {i} {side}: {first} {m.group(2)} ms, K3 {m.group(3)} ms", flush=True)
    for (side, kernel), t in times.items():
        print(f"{side} {kernel} d{args.head_dim}: median {statistics.median(t)} min {min(t)} max {max(t)} ms "
              f"by graph over {len(t)} runs: {t}", flush=True)


if __name__ == "__main__":
    main()
