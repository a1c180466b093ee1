"""The flash kernels of two checkouts of the port, alternated in fresh processes.

Usage (one NVIDIA GPU):
``python3 scripts/torch_flash_ab.py DIR_A DIR_B [--pairs 3] [--head-dim 32|64|128|256 ...] [--hashes]``

Each DIR is the root of a checkout that has a ``chip_smoke.py``. Both
kernel libraries are built first, in parallel. With ``--hashes``, each
tree then launches K1, K2 and K3 once on the same inputs at six shapes
(head dims 64, 128, 32 and 256, causal and not, ragged lengths among them;
K2's and K3's lse and delta from the plain forward, so that they do not
depend on the tree's K1) and prints a sha256 of each kernel's outputs,
and the script prints which kernels compute bitwise the same in both
trees. Then each of ``--pairs`` rounds times, in a process of its own per
checkout, K1, K2 and K3 at the shapes of each head dim's path (bf16,
causal: B8 S1024 H8 at 64, the Llama-2-7B width's B2 S4096 H32 at 128,
train_bytes' B8 S128 H4 at 32, B2 S2048 H16 at 256; every head dim
unless ``--head-dim`` names some) by CUDA-graph replay with the inputs
L2-warm (``chip_smoke.py``'s ``gpu_time_ms``, the method of phase 3's
``ms_graph``), A then B in even
rounds and B then A in odd ones. Prints every run's times and, per side,
kernel and head dim, the median, min and max.
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

BUILD = "from torchft_tpu_torch.ops import flash_attention as fa; fa.build()"
# the timing process; {dims} is filled in
TIMES = """
import torch
import chip_smoke as c
from torchft_tpu_torch.ops import flash_attention as fa
SHAPES = {{64: c._shape(c.HEADLINE), 128: c._shape(c.LLAMA), 32: c._shape(c.BYTES),
          256: c.SHAPES_TIMED["d256"][0]}}
for d in {dims}:
    b, s, h, _ = SHAPES[d]
    q, k, v, do = c._qkv(b, s, h, d, torch.bfloat16, seed=3)
    pq, pk, pv, pdo = map(c._pack, (q, k, v, do))
    o, lse = fa.fwd_kernel(pq, pk, pv, True)
    delta = (pdo.float() * o.float()).sum(-1)
    torch.cuda.synchronize()
    calls = (lambda: fa.fwd_kernel(pq, pk, pv, True),
             lambda: fa.dq_kernel(pq, pk, pv, pdo, lse, delta, True),
             lambda: fa.dkv_kernel(pq, pk, pv, pdo, lse, delta, True))
    t = [c.gpu_time_ms(fn, graph=True) for fn in calls]
    print(f"d{{d}} K1 {{t[0]}} K2 {{t[1]}} K3 {{t[2]}}")
"""
# the hashing process: each kernel's outputs at six shapes
HASHES = """
import hashlib
import torch
import chip_smoke as c
from torchft_tpu_torch.ops import flash_attention as fa
for seed, (shape, causal) in enumerate({shapes}, start=30):
    q, k, v, do = c._qkv(*shape, torch.bfloat16, seed=seed)
    pq, pk, pv, pdo = map(c._pack, (q, k, v, do))
    o, lse = fa.fwd_plain(pq, pk, pv, causal)
    delta = (pdo.float() * o.float()).sum(-1)
    out = {{"K1": fa.fwd_kernel(pq, pk, pv, causal),
           "K2": (fa.dq_kernel(pq, pk, pv, pdo, lse, delta, causal),),
           "K3": fa.dkv_kernel(pq, pk, pv, pdo, lse, delta, causal)}}
    torch.cuda.synchronize()
    digest = {{n: hashlib.sha256(b"".join(t.cpu().view(torch.uint8).numpy().tobytes()
                                         for t in ts)).hexdigest()[:16]
              for n, ts in out.items()}}
    print(f"HASH d{{shape[3]}} b{{shape[0]}} s{{shape[1]}} h{{shape[2]}} "
          f"{{'causal' if causal else 'non-causal'}} " + " ".join(f"{{n}} {{h}}" for n, h in digest.items()))
"""
HASH_SHAPES = [((8, 1024, 8, 64), True), ((2, 192, 2, 64), False),
               ((2, 1024, 4, 128), True), ((2, 320, 2, 128), False),
               ((8, 128, 4, 32), True), ((2, 1024, 4, 32), False),
               ((1, 1000, 3, 256), True), ((2, 1024, 2, 256), False)]
# the head dims timed, each at chip_smoke.py's shape of its path (256:
# phase 3's SHAPES_TIMED["d256"])
HEAD_DIMS = (64, 128, 32, 256)
LINE = re.compile(r"^d(\d+) K1 ([0-9.]+) K2 ([0-9.]+) K3 ([0-9.]+)$", re.M)
HASH_LINE = re.compile(r"^HASH (.*?) K1 (\w+) K2 (\w+) K3 (\w+)$", re.M)


def _run(tree: str, code: str, timeout: float) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.exit(f"{tree}: rc={proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout


def compare_hashes(trees: dict) -> None:
    found = {}
    for side, tree in trees.items():
        out = _run(tree, HASHES.format(shapes=HASH_SHAPES), timeout=600)
        found[side] = HASH_LINE.findall(out)
        for case in found[side]:
            print(f"{side}: {case[0]} K1 {case[1]} K2 {case[2]} K3 {case[3]}", flush=True)
    for (case, *a), (_, *b) in zip(found["A"], found["B"]):
        same = " ".join(f"{k} {'equal' if x == y else 'DIFFERENT'}"
                        for k, x, y in zip(("K1", "K2", "K3"), a, b))
        print(f"A vs B, {case}: {same}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--head-dim", type=int, choices=sorted(HEAD_DIMS), action="append")
    ap.add_argument("--hashes", action="store_true")
    args = ap.parse_args()
    dims = args.head_dim or list(HEAD_DIMS)
    code = TIMES.format(dims=dims)
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    for side, tree in trees.items():
        print(f"{side}: {tree}", flush=True)

    builds = {side: subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree)
              for side, tree in trees.items()}
    for side, proc in builds.items():
        if proc.wait(timeout=900) != 0:
            sys.exit(f"{side}: build failed (rc={proc.returncode})")
    if args.hashes:
        compare_hashes(trees)

    times = {(side, kernel, d): [] for side in trees for d in dims
             for kernel in ("K1", "K2", "K3")}
    for i in range(args.pairs):
        for side in ("AB" if i % 2 == 0 else "BA"):
            out = _run(trees[side], code, timeout=600)
            lines = LINE.findall(out)
            if len(lines) != len(dims):
                sys.exit(f"{side}: no times lines in\n{out[-4000:]}")
            for d, *ms in lines:
                for kernel, t in zip(("K1", "K2", "K3"), ms):
                    times[(side, kernel, int(d))].append(float(t))
                print(f"round {i} {side} d{d}: K1 {ms[0]} ms, K2 {ms[1]} ms, K3 {ms[2]} ms",
                      flush=True)
    for (side, kernel, d), t in times.items():
        print(f"{side} {kernel} d{d}: median {statistics.median(t)} min {min(t)} max {max(t)} ms "
              f"by graph over {len(t)} runs: {t}", flush=True)


if __name__ == "__main__":
    main()
