"""Variants of the flash kernels beside the source as it is, on one card.

Usage (repo root, one NVIDIA GPU):
``python3 scripts/torch_flash_variants.py [--rounds 3] [NAME ...]``
(no NAME: every variant; ``--list`` prints them)

A variant is ``torchft_tpu_torch/csrc/`` with a few exact pieces of
``flash_attention.cu`` rewritten (the script exits 1 if a piece is not in
the source exactly once). Every variant named, and the source as it is
(``shipped``), is built in parallel with ``nvcc -Xptxas -v``, and the
registers, stack frame, spills and any ptxas warning of the entry it
changes are printed. A variant that computes the kernel's own function is
then held against the plain version (``chip_smoke.KERNEL_BAR``, O and lse
for K1, dQ for K2) and against itself across two launches, at the shapes
phase 2 of ``chip_smoke.py`` gives that head dim; a diagnostic variant
(it computes something else) is only timed. Last, over ``--rounds``
rounds, in one process, each variant and ``shipped`` are timed in turn
(the order reversed every other round) by CUDA-graph replay with the
inputs L2-warm (``chip_smoke.gpu_time_ms``, phase 3's ``ms_graph``) at the
shapes of their head dim's path, and the median, min and max of each are
printed.

The variants (``--list``), each against the shipped source:

- K1 at head dim 32 (timed at B8 S128 H4 D32, train_bytes'):
  ``k1_d32_nc2``, blocks of 128 query rows with two consumer warpgroups
  (384 threads) in place of 64 rows and one; ``k1_d32_kc64``, a consumer
  taking 64 keys at once (two S/P.V rounds a 128-key stage) in place of
  128.
- K1 at head dim 128 (B2 S4096 H32 D128, the Llama-2-7B width's):
  ``k1_d128_softmax``, a diagnostic: S from a pattern of one FFMA an
  element and O a fold of P, so no wgmma runs.
- K2 at head dim 128 (the same shapes): ``k2_d128_pr6``, the layout it
  had before (a producer warpgroup and two consumers, 384 threads at 168
  registers, each 128-key stage taken as two 64-key halves, P by exp2f);
  ``k2_d128_producer``, that layout with the one-MUFU P;
  ``k2_d128_keys64``, the shipped 256-thread block taking 64-key halves;
  ``k2_d128_exp2f``, the shipped kernel with exp2f; and diagnostics of
  the shipped kernel and of ``k2_d128_pr6``: ``*_products`` (dS is the
  bf16 pack of S: no exp2 and no dP arithmetic), ``*_elementwise`` (S and
  dP from a pattern of two FFMAs an element, dQ a fold of dS: no wgmma)
  and ``*_loads`` (both: the TMA ring, barriers and stores remain).
- K2 at head dim 256 (B2 S2048 H16 D256; shipped: one 64-key stage taken
  at once): ``k2_d256_kc32``, the stage taken as two 32-key chunks (S and
  dP 16 registers each in place of 32); ``k2_d256_ring2x32``, a ring of
  two 32-key stages taken whole (the next stage loading under this one's
  products, 192 KB of shared memory); ``k2_d256_ring3x32``, three (224
  KB).
- float32 K1 at head dims 128 and 256 (B2 S4096 H32 D128, B2 S2048 H16
  D256): ``k1_f32_d128_fma`` and ``k1_f32_d256_fma``, the FMA kernel
  (32-row tiles) in place of the register-blocked one;
  ``k1_f32_d128_rw8`` and ``k1_f32_d256_rw8``, the register-blocked
  kernel with 8 query rows a warp (64-row blocks) in place of 16.

``--sass`` prints, for every build, the changed entry's instructions by
opcode (``cuobjdump -sass`` from nvcc's directory).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from torchft_tpu_torch.ops import flash_attention as fa  # noqa: E402
from torchft_tpu_torch.utils.platform import build_dir  # noqa: E402

# pieces of flash_attention.cu, each rewritten by some variants
K1_KEYS = ("constexpr int kFwdKeys = D >= 128 ? 64 : 128;",
           "constexpr int kFwdKeys = D == 64 ? 128 : 64;")
K1_CONS = ("constexpr int kFwdCons = D == 32 ? 1 : 2;", "constexpr int kFwdCons = 2;")
K2_PRODUCER = ("constexpr int kDqProducer = D >= 128 ? 0 : kWg;",
               "constexpr int kDqProducer = D == 256 ? 0 : kWg;")
K2_KEYS64 = ("constexpr int kDqKeys = D == 128 ? 128 : 64;", "constexpr int kDqKeys = 64;")
K2_EXP2F = ("constexpr bool kDqOneMufu = D >= 128;", "constexpr bool kDqOneMufu = D == 256;")
PR6 = (K2_PRODUCER, K2_KEYS64, K2_EXP2F)
# diagnostics: dS = S, rounded (no exp2, no dP arithmetic), in both forms ...
K2_PRODUCTS = (
    ("""              d[e] = exp2_ftz(a) * (dp[4 * cc + e] - dl0);
              d[2 + e] = exp2_ftz(b) * (dp[4 * cc + 2 + e] - dl1);""",
     """              d[e] = s[4 * cc + e];
              d[2 + e] = s[4 * cc + 2 + e];"""),
    ("""              d[e] = exp2f(a - lse0) * (dp[4 * cc + e] - dl0) * scale;
              d[2 + e] = exp2f(b - lse1) * (dp[4 * cc + 2 + e] - dl1) * scale;""",
     """              d[e] = s[4 * cc + e];
              d[2 + e] = s[4 * cc + 2 + e];"""),
)
# ... and S, dP from a pattern of two FFMAs an element (the stage's index
# in it, so that no chunk's can be hoisted), dQ a fold of dS (no wgmma)
K2_NO_S = (
    """            wgmma_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, h + kk);
        }
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t do_desc""",
    """            if (h == 0 && kk == 0)
              for (int i = 0; i < KC / 2; ++i)
                s[i] = fmaf(static_cast<float>(i), scale, dl0 + static_cast<float>(st));
        }
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t do_desc""",
)
K2_NO_DP = (
    "            wgmma_ss(dp, do_desc + 2 * kk, v_desc + 2 * kk, h + kk);",
    """            if (h == 0 && kk == 0)
              for (int i = 0; i < KC / 2; ++i) dp[i] = fmaf(s[i], 0.5f, -1.0f);""",
)
K2_NO_DQ = (
    "            wgmma_rs_tb(dq[h], da[kk], k_desc + kMnStep<D> * kk, 1);",
    "            dq[h][kk] += __uint_as_float(da[kk][0] ^ da[kk][1] ^ da[kk][2] ^ da[kk][3]);",
)
ELEMENTWISE = (K2_NO_S, K2_NO_DP, K2_NO_DQ)
# K2's layout at head dim 256: a ring of 32-key stages, or 64 keys at once
K2_KEYS32 = ("constexpr int kDqStageKeys = D == 256 ? 64 : 128;",
             "constexpr int kDqStageKeys = D == 256 ? 32 : 128;")
K2_RING2 = ("constexpr int kDqStages = D == 256 ? 1 : kStages;",
            "constexpr int kDqStages = kStages;")
K2_RING3 = ("constexpr int kDqStages = D == 256 ? 1 : kStages;",
            "constexpr int kDqStages = D == 256 ? 3 : kStages;")
K2_KC32 = ("constexpr int kDqKeys = D == 128 ? 128 : 64;",
           "constexpr int kDqKeys = D == 128 ? 128 : D == 256 ? 32 : 64;")
# float32 K1 at head dim 128, or 256, on the FMA kernel
K1_F32_128 = ("constexpr bool f32_fwd_blocked(int d) { return d == 128 || d == 256; }",
              "constexpr bool f32_fwd_blocked(int d) { return d == 256; }")
K1_F32_256 = ("constexpr bool f32_fwd_blocked(int d) { return d == 128 || d == 256; }",
              "constexpr bool f32_fwd_blocked(int d) { return d == 128; }")
K1_F32_RW8 = ("constexpr int kF32WarpRows = 16;", "constexpr int kF32WarpRows = 8;")
# K1's softmax alone: S from a pattern of one FFMA an element, O a fold of P
K1_SOFTMAX = (
    ("""col_block<D, QR>(q_rows, h));
          const uint64_t k_desc = desc<D>(col_block<D, KS>(sm.k[st], h) + c * KC * kCol<D>);
#pragma unroll
          for (int kk = 0; kk < kKSteps<D>; ++kk)
            wgmma_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, h + kk);""",
     """col_block<D, QR>(q_rows, h));
          const uint64_t k_desc = desc<D>(col_block<D, KS>(sm.k[st], h) + c * KC * kCol<D>);
#pragma unroll
          for (int kk = 0; kk < kKSteps<D>; ++kk)
            if (h == 0 && kk == 0)
              for (int i = 0; i < KC / 2; ++i)
                s[i] = fmaf(static_cast<float>(i), scale_log2, static_cast<float>(st));"""),
    ("            wgmma_rs_tb(o[h], pa[kk], v_desc + kMnStep<D> * kk, 1);",
     "            o[h][kk] += __uint_as_float(pa[kk][0] ^ pa[kk][1] ^ pa[kk][2] ^ pa[kk][3]);"),
)

# name: (kernel, head dim, rewrites, computes the kernel's function)
VARIANTS = {
    "k1_d32_nc2": ("K1", 32, (K1_CONS,), True),
    "k1_d32_kc64": ("K1", 32, (K1_KEYS,), True),
    "k1_d128_softmax": ("K1", 128, K1_SOFTMAX, False),
    "k2_d128_pr6": ("K2", 128, PR6, True),
    "k2_d128_pr6_products": ("K2", 128, PR6 + K2_PRODUCTS, False),
    "k2_d128_pr6_elementwise": ("K2", 128, PR6 + ELEMENTWISE, False),
    "k2_d128_pr6_loads": ("K2", 128, PR6 + ELEMENTWISE + K2_PRODUCTS, False),
    "k2_d128_keys64": ("K2", 128, (K2_KEYS64,), True),
    "k2_d128_producer": ("K2", 128, (K2_PRODUCER, K2_KEYS64), True),
    "k2_d128_exp2f": ("K2", 128, (K2_EXP2F,), True),
    "k2_d128_products": ("K2", 128, K2_PRODUCTS, False),
    "k2_d128_elementwise": ("K2", 128, ELEMENTWISE, False),
    "k2_d128_loads": ("K2", 128, ELEMENTWISE + K2_PRODUCTS, False),
    "k2_d256_ring2x32": ("K2", 256, (K2_KEYS32, K2_RING2, K2_KC32), True),
    "k2_d256_ring3x32": ("K2", 256, (K2_KEYS32, K2_RING3, K2_KC32), True),
    "k2_d256_kc32": ("K2", 256, (K2_KC32,), True),
    "k1_f32_d128_fma": ("K1f32", 128, (K1_F32_128,), True),
    "k1_f32_d256_fma": ("K1f32", 256, (K1_F32_256,), True),
    "k1_f32_d128_rw8": ("K1f32", 128, (K1_F32_RW8,), True),
    "k1_f32_d256_rw8": ("K1f32", 256, (K1_F32_RW8,), True),
}
# the entry each kernel's variants change, as ptxas names it ("K1f32": K1
# on float32 inputs)
ENTRY = {("K1", 32): "flash_fwd_wgmmaILi32E", ("K1", 128): "flash_fwd_wgmmaILi128E",
         ("K2", 128): "flash_dq_wgmmaILi128E", ("K2", 256): "flash_dq_wgmmaILi256E",
         ("K1f32", 128): "flash_fwd_f32ILi128E", ("K1f32", 256): "flash_fwd_f32ILi256E"}
# the FMA K1 in float32, which the *_fma variants build in its place
ENTRY_OF_VARIANT = {"k1_f32_d128_fma": "flash_fwd_kernelIfLi128E",
                    "k1_f32_d256_fma": "flash_fwd_kernelIfLi256E"}
# timing shapes (the head dim's path) and phase 2's check shapes (causal),
# by (kernel, head dim)
TIMED = {("K1", 32): c._shape(c.BYTES), ("K1", 128): c._shape(c.LLAMA),
         ("K2", 128): c._shape(c.LLAMA), ("K2", 256): c.SHAPES_TIMED["d256"][0],
         ("K1f32", 128): c.SHAPES_TIMED["d128_f32"][0],
         ("K1f32", 256): c.SHAPES_TIMED["d256_f32"][0]}
CHECKS = {
    32: [(c._shape(c.BYTES), True), ((2, 192, 2, 32), False), ((2, 320, 2, 32), True),
         ((2, 1024, 4, 32), True), ((2, 1024, 4, 32), False)],
    128: [((2, 1024, 4, 128), True), ((2, 1024, 4, 128), False), ((2, 192, 2, 128), True),
          ((2, 320, 2, 128), True), ((2, 320, 2, 128), False)],
    256: [((2, 1024, 2, 256), True), ((2, 1024, 2, 256), False), ((1, 200, 3, 256), True),
          ((1, 2048, 16, 256), True), ((1, 1000, 3, 256), False)],
}
# (reps, inner) of a timing: a few at float32's tens of ms a launch
TIMING_REPS = {"K1f32": (5, 1)}


def start_build(root: str, name: str, rewrites) -> tuple[str, subprocess.Popen]:
    csrc = os.path.join(root, name)
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(fa.CSRC_DIR, csrc)
    src = os.path.join(csrc, "flash_attention.cu")
    with open(src) as f:
        text = f.read()
    for old, new in rewrites:
        if text.count(old) != 1:
            sys.exit(f"{name}: {old!r} is not in the source exactly once")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(csrc, "libtft_flash.so")
    proc = subprocess.Popen(fa.nvcc_command(out, csrc), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc


def report(name: str, log: str, entry: str) -> None:
    for section in log.split("Compiling entry function")[1:]:
        lines = section.splitlines()
        if entry not in lines[0]:
            continue
        stats = [ln.strip() for ln in lines[1:] if ln.strip()]
        found = re.search(r"(flash_\w+?wgmma)(I.*?E)E", lines[0])
        print(f"[{name}] {found.group(1) if found else entry}{found.group(2) if found else ''}: "
              + " | ".join(stats), flush=True)
    for line in log.splitlines():
        if ("warning" in line or "Performance" in line) and "Compiling" not in line:
            print(f"[{name}] warning: {line.strip()}", flush=True)


def sass_histogram(name: str, lib: str, entry: str) -> None:
    """The entry's instructions in the built library by opcode (cuobjdump
    -sass, from nvcc's directory), most frequent first."""
    tool = os.path.join(os.path.dirname(fa.nvcc_command("")[0]), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    for section in out.split("Function : ")[1:]:
        if entry not in section.splitlines()[0]:
            continue
        ops: dict[str, int] = {}
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", section):
            op = m.group(1).split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        top = sorted(ops.items(), key=lambda kv: -kv[1])
        print(f"[{name}] sass {sum(ops.values())} instructions: "
              + " ".join(f"{op} {n}" for op, n in top[:24]), flush=True)


def dtype_of(kernel: str) -> torch.dtype:
    return torch.float32 if kernel.endswith("f32") else torch.bfloat16


def call(kernel: str, inputs, causal: bool):
    pq, pk, pv, pdo, lse, delta = inputs
    if kernel.startswith("K1"):
        return fa.fwd_kernel(pq, pk, pv, causal)
    return (fa.dq_kernel(pq, pk, pv, pdo, lse, delta, causal),)


def make_inputs(shape, causal: bool, seed: int, dtype=torch.bfloat16):
    q, k, v, do = c._qkv(*shape, dtype, seed=seed)
    pq, pk, pv, pdo = map(c._pack, (q, k, v, do))
    o, lse = fa.fwd_plain(pq, pk, pv, causal)
    delta = (pdo.float() * o.float()).sum(-1)
    return pq, pk, pv, pdo, lse, delta


def hold(name: str, kernel: str, d: int) -> bool:
    """The variant against the plain version at phase 2's shapes of head dim
    d (bf16 at KERNEL_BAR and LSE_TOL, float32 at F32_O_BAR and
    F32_LSE_TOL), and bitwise across two launches. Returns whether every
    case held."""
    ok = True
    f32 = dtype_of(kernel) == torch.float32
    bar = c.F32_O_BAR if f32 else c.KERNEL_BAR
    for seed, (shape, causal) in enumerate(CHECKS[d], start=20):
        x = make_inputs(shape, causal, seed, dtype_of(kernel))
        got = call(kernel, x, causal)
        again = call(kernel, x, causal)
        if kernel.startswith("K1"):
            o_ref, lse_ref = fa.fwd_plain(*x[:3], causal)
            pairs = [("O", got[0], o_ref)]
            lse_err = float((got[1] - lse_ref).abs().max())
        else:
            pairs = [("dQ", got[0], fa.dq_plain(*x, causal))]
            lse_err = 0.0
        worst = 0.0
        for _, a, r in pairs:
            a, r = a.float(), r.float()
            scale = r.abs() + (r.pow(2).mean(-1, keepdim=True).sqrt() if bar["row_scaled"] else 0)
            worst = max(worst, float(((a - r).abs() / (bar["rtol"] * scale + bar["atol"])).max()))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        held = worst <= 1.0 and lse_err <= (c.F32_LSE_TOL if f32 else c.LSE_TOL) and same
        ok &= held
        print(f"[{name}] {kernel} {shape} {'causal' if causal else 'non-causal'}: worst "
              f"err/bar {worst:.3f}, max|lse-ref| {lse_err:.3e}, bitwise across two "
              f"launches {same}: {'held' if held else 'FAILED'}", flush=True)
    return ok


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--sass", action="store_true",
                    help="print each changed entry's SASS instructions by opcode")
    args = ap.parse_args()
    if args.list:
        for name, (kernel, d, _, exact) in VARIANTS.items():
            print(f"{name}: {kernel} at head dim {d}{'' if exact else ' (diagnostic)'}")
        return
    names = args.names or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        sys.exit(f"unknown variants {unknown}; --list prints them")
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    root = build_dir("flash_variants")
    builds = {name: start_build(root, name, VARIANTS[name][2]) for name in names}
    shipped = fa.build()
    libs = {"shipped": fa.bind(shipped)}
    for entry in sorted({ENTRY[VARIANTS[n][:2]] for n in names}):
        report("shipped", fa.build_log(), entry)
    failed = []
    for name, (out, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(log[-6000:])
            sys.exit(f"[{name}] nvcc failed (rc={proc.returncode})")
        entry = ENTRY_OF_VARIANT.get(name, ENTRY[VARIANTS[name][:2]])
        report(name, log, entry)
        libs[name] = fa.bind(out)
        if args.sass:
            sass_histogram(name, out, entry)
    if args.sass:
        for entry in sorted({ENTRY[VARIANTS[n][:2]] for n in names}):
            sass_histogram("shipped", shipped, entry)

    # (kernel, head dim) -> the libraries timed there, "shipped" first
    groups: dict[tuple[str, int], list[str]] = {}
    for name in names:
        groups.setdefault(VARIANTS[name][:2], ["shipped"]).append(name)
    for (kernel, d), members in groups.items():
        for name in members:
            fa._lib = libs[name]
            if (name == "shipped" or VARIANTS[name][3]) and not hold(name, kernel, d):
                failed.append(name)
        inputs = make_inputs(TIMED[(kernel, d)], True, 3, dtype_of(kernel))
        reps, inner = TIMING_REPS.get(kernel, (25, 5))
        times = {name: [] for name in members}
        for r in range(args.rounds):
            for name in (members if r % 2 == 0 else members[::-1]):
                fa._lib = libs[name]
                t = c.gpu_time_ms(lambda: call(kernel, inputs, True), reps=reps, inner=inner,
                                  graph=True)
                times[name].append(t)
                print(f"round {r} {kernel} d{d} {name}: {t:.5f} ms", flush=True)
        for name, t in times.items():
            print(f"{kernel} d{d} {name}: median {statistics.median(t):.5f} min {min(t):.5f} "
                  f"max {max(t):.5f} ms by graph over {len(t)} rounds", flush=True)
    fa._lib = libs["shipped"]
    if failed:
        sys.exit(f"failed to hold: {failed}")


if __name__ == "__main__":
    main()
