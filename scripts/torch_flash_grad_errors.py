"""How far the flash op's bf16 output and gradients lie from plain
attention in float32, over several seeds and shapes.

Usage (repo root, one NVIDIA GPU): ``python3 scripts/torch_flash_grad_errors.py``

For each case it prints the largest error and, for the elementwise bar
``|g - ref| <= rtol * |ref| + atol`` at rtol 2^-7, the least atol that
passes. ``chip_smoke.py``'s ``OP_BAR`` is set from these numbers.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import _op_grads, _plain_grads, _qkv  # noqa: E402

# (B, S, H, D), seed: head dim 64 at the headline's shapes and smaller, 128
# at chip_smoke.py's op shape and the Llama-2-7B width's, 32 at train_bytes'
CASES = (((8, 1024, 8, 64), 1), ((8, 1024, 8, 64), 7), ((2, 256, 2, 64), 2),
         ((1, 256, 64, 64), 1), ((2, 1024, 8, 128), 5), ((2, 1024, 8, 128), 7),
         ((2, 4096, 32, 128), 5), ((8, 128, 4, 32), 7), ((8, 128, 4, 32), 9))
RTOL = 2.0 ** -7


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    for shape, seed in CASES:
        q, k, v, do = _qkv(*shape, torch.bfloat16, seed=seed)
        o_op, *g_op = _op_grads(q, k, v, do, True)
        o_pl, *g_pl = _plain_grads(q, k, v, do, True)
        for name, a, r in zip(("O", "dq", "dk", "dv"), [o_op, *g_op], [o_pl, *g_pl]):
            a, r = a.float(), r.float()
            err = (a - r).abs()
            need = float((err - RTOL * r.abs()).max())
            if name != "O":
                worst = max(worst, need)
            print(f"b{shape[0]} s{shape[1]} h{shape[2]} d{shape[3]} seed {seed} {name}: max err "
                  f"{float(err.max()):.3e}, least atol at rtol 2^-7 {need:.3e}, "
                  f"median|ref| {float(r.abs().median()):.3e}")
    print(f"largest least atol over the gradients: {worst:.3e}")


if __name__ == "__main__":
    main()
