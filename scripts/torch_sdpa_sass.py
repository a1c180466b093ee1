"""Which instructions PyTorch's float32 attention backward runs on the card.

Runs ``scaled_dot_product_attention`` forward and backward once in float32
(causal, the head dim given) under ``torch.profiler``, names the backward
kernels it launched, finds their mangled names in ``libtorch_cuda.so``
(the host side registers each kernel by that name), disassembles each with
``cuobjdump -sass`` for the card's architecture, and prints its
instructions by opcode, with the tensor-core products on TF32 operands
(``HMMA ... TF32``) counted apart from the float32 FMAs (``FFMA``).

    python3 scripts/torch_sdpa_sass.py [--head-dim 128] [--seq 1024]
"""

from __future__ import annotations

import argparse
import mmap
import os
import re
import subprocess
import sys

import torch


def backward_kernels(head_dim: int, seq: int) -> list[str]:
    """The CUDA kernels of one float32 SDPA backward, by their names before
    the argument list."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = (torch.randn(1, 4, seq, head_dim, device="cuda", requires_grad=True)
               for _ in range(3))
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
    w = torch.randn_like(o)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o.backward(w)
        torch.cuda.synchronize()
    names = {e.name.split("(")[0].split(" ")[-1] for e in prof.events()
             if e.device_type.name == "CUDA"}
    return sorted(n for n in names if "fmha" in n or "attention" in n.lower())


def mangled_names(lib: str, base: str) -> list[str]:
    """The mangled names in the library's bytes of the kernels named ``base``."""
    word = re.compile(rb"[A-Za-z0-9_]")
    found = set()
    with open(lib, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        key = base.encode()
        at = m.find(key)
        while at >= 0:
            lo, hi = at, at + len(key)
            while lo > 0 and word.match(m[lo - 1:lo]):
                lo -= 1
            while hi < len(m) and word.match(m[hi:hi + 1]):
                hi += 1
            token = m[lo:hi].decode()
            if re.match(rf"_Z\d+{base}", token):  # the kernel itself, not its host stub
                found.add(token)
            at = m.find(key, hi)
    return sorted(found)


def histogram(sass: str) -> dict[str, int]:
    ops: dict[str, int] = {}
    for line in sass.splitlines():
        found = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not found:
            continue
        full = found.group(1)
        op = full.split(".")[0]
        if op == "HMMA":
            op = "HMMA.TF32" if "TF32" in full else "HMMA.other"
        ops[op] = ops.get(op, 0) + 1
    return ops


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script needs an NVIDIA GPU")
    major, minor = torch.cuda.get_device_capability()
    arch = f"sm_{major}{minor}"
    lib = os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cuda.so")
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    kernels = backward_kernels(args.head_dim, args.seq)
    print(f"float32 SDPA backward at head dim {args.head_dim}, S {args.seq}, causal: "
          f"kernels {kernels}", flush=True)
    for base in kernels:
        for name in mangled_names(lib, base):
            out = subprocess.run([tool, "-sass", "-arch", arch, "-fun", name, lib],
                                 capture_output=True, text=True, timeout=600)
            ops = histogram(out.stdout)
            top = sorted(ops.items(), key=lambda kv: -kv[1])
            print(f"{name} ({arch}): {sum(ops.values())} instructions; HMMA on TF32 "
                  f"{ops.get('HMMA.TF32', 0)}, other HMMA {ops.get('HMMA.other', 0)}, FFMA "
                  f"{ops.get('FFMA', 0)}; " + " ".join(f"{op} {n}" for op, n in top[:16])
                  + (f"; cuobjdump rc {out.returncode}: {out.stderr.strip()[:200]}"
                     if out.returncode else ""), flush=True)


if __name__ == "__main__":
    main()
