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
(it computes something else) is only timed. At head dim 128 the checks
include the timed B2 S4096 H32, causal. Last, over ``--rounds``
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
- float32 K2 and K3 at head dims 128 and 256 (the same shapes, both
  kernels timed and held: dQ, dK and dV at F32_GRAD_BAR):
  ``k23_f32_d128_fma`` and ``k23_f32_d256_fma``, the FMA kernels (32-row
  tiles) in place of the 3xTF32 ones; ``k23_f32_d128_fmablock`` and
  ``k23_f32_d256_fmablock``, the 3xTF32 kernels' layout with its products
  as register-blocked FMAs (a lane computes its own C fragments: 2 x 2 NT
  of S a float4 step, the score tile's rows from its quad by shuffles for
  dQ, dK and dV); ``k23_f32_d128_direct``, dQ, dK and dV's products added
  straight into their accumulators, which the tensor cores' float32 sums
  truncate (held at B2 S4096 H32 among the checks), in place of a k step's
  products summed from zero and added once.
- K2 and K3 at head dims 8 and 16, both dtypes (timed at the tiny
  preset's B8 S16 H2 and at B8 S48 H2 and B8 S200 H2, held at phase 2's
  ``SMALL_HELD`` shapes and the tiles' edges): ``k23_d8_tile64`` and
  ``k23_d16_tile64``, the 64-row FMA kernels (``flash_dq_kernel`` and
  ``flash_dkv_kernel``) in place of ``flash_dq_small`` and
  ``flash_dkv_small``; ``k23_f32_d8_rolled`` and ``k23_f32_d16_rolled``,
  the float32 small kernels with their loops over a step's keys (K2) and
  queries (K3) rolled (less code) in place of unrolled; ``k23_d16_nobounds``,
  both small kernels without their ``__launch_bounds__``. Each of these
  groups also times
  ``scaled_dot_product_attention``'s backward (forward and backward less
  the forward, by graph) at its shapes, a yardstick the port never calls.

The FMA kernels at float32 head dims 128 and 256 are no longer in the
source: the ``*_fma`` variants build ``csrc/`` as of ``FMA_REVISION``,
the last revision that held them, and the ``*_tile64`` variants as of
``TILE64_REVISION`` (the last with the FMA K2 and K3 at head dims 8 and
16), which the script unpacks with ``git archive`` into
``build/csrc_<revision>/``. A copy of the repo without its git history
needs those directories made beforehand, from a checkout that has it:
``mkdir -p build/csrc_672292b && git archive 672292b
torchft_tpu_torch/csrc | tar -x -C build/csrc_672292b`` (and the same for
a812130).

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
# float32 K1 at head dim 128, or 256, on the FMA kernel (FMA_REVISION's source)
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

# the last revision with the FMA kernels at float32 head dims 128 and 256
# (32-row tiles), which the *_fma variants build
FMA_REVISION = "672292b"
# the last revision with K2 and K3 at head dims 8 and 16 on the 64-row FMA
# kernels, which the *_tile64 variants build
TILE64_REVISION = "a812130"
# the 3xTF32 kernels' layout with register-blocked FMA products: stages left
# as they land (split_rows does nothing), and each lane computes its own C
# fragments (mma_rows: rows g, g + 8 against B rows 8n + 2t, 8n + 2t + 1 by
# float4 steps; mma_cols: the score tile's rows 2t, 2t + 1, 8 + 2t, 9 + 2t
# from the lanes that hold them, by shuffles, against X's columns 16m + 2g,
# + 1)
SPLIT_ROWS = """  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < R * kChunks; i += kF32Threads) {
    const int off = (i / kChunks) * (D + 4) + 4 * (i % kChunks);
    float x[4];
    load<4>(x, hi + off);
    const Split<4> f = split<4>(x);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(f.lo[0], f.lo[1], f.lo[2], f.lo[3]);
  }"""
ROWS_MMA = """  constexpr int LD = D + 4, LQ = 2 * D + 8;
  const int off = g * LD + 8 * t;
  // k step s of chunk c takes pair c / 2 + 4t + s, at slot (4t + s) ^ (t >> 1) past c / 2
  const float* ae = a + g * LQ + 16 * t + 4 * (t >> 1);  // even s
  const float* ao = a + g * LQ + 16 * t - 4 * (t >> 1);  // odd s
#pragma unroll 1
  for (int c = 0; c < DC; c += 32) {
    Split<4> fa[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float x[4];
      load<4>(x, (s % 2 ? ao : ae) + 2 * c + 4 * s);
      fa[s] = split<4>(x);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float z[8];
      load<8>(z, b + off + 8 * n * LD + c);
      if constexpr (kPre) {
        // the three products in three accumulators: chains of 4 mma, not 12
        // (faster here; in the other path, K2's, one chain is)
        float zl[8], d[3][4] = {};
        load<8>(zl, bl + off + 8 * n * LD + c);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const Split<2> fb = presplit<2>({z[2 * s], z[2 * s + 1]}, {zl[2 * s], zl[2 * s + 1]});
          mma_tf32(d[0], fa[s].lo, fb.hi);
          mma_tf32(d[1], fa[s].hi, fb.lo);
          mma_tf32(d[2], fa[s].hi, fb.hi);
        }
        add4(d[0], d[1]);
        add4(d[0], d[2]);
        add4(acc[n], d[0]);
      } else {
        float d[4] = {};
#pragma unroll
        for (int s = 0; s < 4; ++s) mma3(d, fa[s], split<2>({z[2 * s], z[2 * s + 1]}));
        add4(acc[n], d);
      }
    }
  }"""
ROWS_FMA = """  constexpr int LD = D + 4, LQ = 2 * D + 8;
  const float* aq = a + g * LQ;  // the tile's quad-row g (load_tiles)
  const float* br = b + 2 * t * LD;
#pragma unroll 4
  for (int c = 0; c < DC; c += 4) {
    const int p = c / 2, swz = (p >> 3) & 1;
    const float4 q0 = *reinterpret_cast<const float4*>(aq + 4 * (p ^ swz));
    const float4 q1 = *reinterpret_cast<const float4*>(aq + 4 * ((p + 1) ^ swz));
    const float4 x = make_float4(q0.x, q0.z, q1.x, q1.z);  // row g, columns c .. c + 3
    const float4 y = make_float4(q0.y, q0.w, q1.y, q1.w);  // row g + 8
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 z = *reinterpret_cast<const float4*>(br + (8 * n + e) * LD + c);
        acc[n][e] = fmaf(x.x, z.x, fmaf(x.y, z.y, fmaf(x.z, z.z, fmaf(x.w, z.w, acc[n][e]))));
        acc[n][2 + e] =
            fmaf(y.x, z.x, fmaf(y.y, z.y, fmaf(y.z, z.z, fmaf(y.w, z.w, acc[n][2 + e]))));
      }
  }"""
COLS_MMA = """  constexpr int LD = D + 4;
  const Split<2> bp[2] = {split<2>({p[0], p[1]}), split<2>({p[2], p[3]})};
  const Split<2> bq[2] = {split<2>({q[0], q[1]}), split<2>({q[2], q[3]})};
  const int off = 2 * t * LD + 2 * g;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    Split<4> a[2];  // k steps over rows 2t, 2t + 1 and 8 + 2t, 9 + 2t
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* r = x + off + 8 * k * LD + 16 * m;
      const float2 u = *reinterpret_cast<const float2*>(r);
      const float2 w = *reinterpret_cast<const float2*>(r + LD);
      if constexpr (kPre) {
        const float* rl = xl + off + 8 * k * LD + 16 * m;
        const float2 ul = *reinterpret_cast<const float2*>(rl);
        const float2 wl = *reinterpret_cast<const float2*>(rl + LD);
        a[k] = presplit<4>({u.x, u.y, w.x, w.y}, {ul.x, ul.y, wl.x, wl.y});
      } else {
        a[k] = split<4>({u.x, u.y, w.x, w.y});
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float d[4] = {};
      mma3(d, a[0], bp[u]);
      mma3(d, a[1], bq[u]);
      add4(acc[m][u], d);
    }
  }"""
COLS_FMA = """  constexpr int LD = D + 4;
  float pr[4][16];  // the score tile's rows 2t, 2t + 1, 8 + 2t, 9 + 2t
#pragma unroll
  for (int tt = 0; tt < 4; ++tt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int src = 4 * (2 * t + h) + tt;
      pr[h][2 * tt] = __shfl_sync(0xffffffffu, p[0], src);
      pr[h][2 * tt + 1] = __shfl_sync(0xffffffffu, p[1], src);
      pr[h][8 + 2 * tt] = __shfl_sync(0xffffffffu, q[0], src);
      pr[h][9 + 2 * tt] = __shfl_sync(0xffffffffu, q[1], src);
      pr[2 + h][2 * tt] = __shfl_sync(0xffffffffu, p[2], src);
      pr[2 + h][2 * tt + 1] = __shfl_sync(0xffffffffu, p[3], src);
      pr[2 + h][8 + 2 * tt] = __shfl_sync(0xffffffffu, q[2], src);
      pr[2 + h][9 + 2 * tt] = __shfl_sync(0xffffffffu, q[3], src);
    }
  const float* xr = x + 2 * g;
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const float2 xv = *reinterpret_cast<const float2*>(xr + kk * LD + 16 * m);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][u][e] = fmaf(pr[2 * u + (e & 1)][kk], e < 2 ? xv.x : xv.y, acc[m][u][e]);
    }"""
K23_FMABLOCK = ((SPLIT_ROWS, "  (void)hi, (void)lo;"), (ROWS_MMA, ROWS_FMA), (COLS_MMA, COLS_FMA))
# mma_cols' products added straight into the accumulators (whose float32
# sums the tensor cores truncate), in place of summed from zero over two k
# steps and then added
K23_DIRECT = (("""      float d[4] = {};
      mma3(d, a[0], bp[u]);
      mma3(d, a[1], bq[u]);
      add4(acc[m][u], d);""", """      mma3(acc[m][u], a[0], bp[u]);
      mma3(acc[m][u], a[1], bq[u]);"""),)
# the small kernels' float32 loops over a step's keys (K2) and queries (K3)
# rolled, one key or query an iteration, in place of unrolled: less code
SMALL_F32_ROLLED = tuple(
    ("#pragma unroll\n        for (int h = 0; h < 2; ++h)\n#pragma unroll\n"
     "          for (int e = 0; e < 2; ++e) {\n"
     "            const int c = 16 * st + 8 * h + 2 * t + e" + tail,
     "#pragma unroll 1\n        for (int h = 0; h < 2; ++h)\n#pragma unroll 1\n"
     "          for (int e = 0; e < 2; ++e) {\n"
     "            const int c = 16 * st + 8 * h + 2 * t + e" + tail)
    for tail in (";  // the key's row in the tile", ", qp = q0 + c;  // the query's row in the tile"))
# the small kernels without their launch bounds (2 TR threads, one block an SM)
SMALL_NO_BOUNDS = tuple((f"__launch_bounds__(2 * TR, 1)\n    {n}(", f"\n    {n}(")
                        for n in ("flash_dq_small", "flash_dkv_small"))
# name: (kernel or kernels, head dim, rewrites, computes the kernels' function)
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
    "k23_f32_d128_fma": (("K2f32", "K3f32"), 128, (), True),
    "k23_f32_d256_fma": (("K2f32", "K3f32"), 256, (), True),
    "k23_f32_d128_fmablock": (("K2f32", "K3f32"), 128, K23_FMABLOCK, True),
    "k23_f32_d256_fmablock": (("K2f32", "K3f32"), 256, K23_FMABLOCK, True),
    "k23_f32_d128_direct": (("K2f32", "K3f32"), 128, K23_DIRECT, True),
    "k23_d8_tile64": (("K2", "K3", "K2f32", "K3f32"), 8, (), True),
    "k23_d16_tile64": (("K2", "K3", "K2f32", "K3f32"), 16, (), True),
    "k23_d16_nobounds": (("K2", "K3", "K2f32", "K3f32"), 16, SMALL_NO_BOUNDS, True),
    "k23_f32_d8_rolled": (("K2f32", "K3f32"), 8, SMALL_F32_ROLLED, True),
    "k23_f32_d16_rolled": (("K2f32", "K3f32"), 16, SMALL_F32_ROLLED, True),
}
# the revision a variant builds csrc/ from, by its name's suffix (else the
# source as it is)
REVISION_OF_SUFFIX = {"_fma": FMA_REVISION, "_tile64": TILE64_REVISION}


def kinds(name: str) -> list[tuple[str, int]]:
    """The (kernel, head dim) groups a variant is held and timed in."""
    kernel, d = VARIANTS[name][:2]
    return [(k, d) for k in (kernel if isinstance(kernel, tuple) else (kernel,))]


# the entry each kernel's variants change, as ptxas names it ("K1f32": K1
# on float32 inputs)
ENTRY = {("K1", 32): "flash_fwd_wgmmaILi32E", ("K1", 128): "flash_fwd_wgmmaILi128E",
         ("K2", 128): "flash_dq_wgmmaILi128E", ("K2", 256): "flash_dq_wgmmaILi256E",
         ("K1f32", 128): "flash_fwd_f32ILi128E", ("K1f32", 256): "flash_fwd_f32ILi256E",
         **{(f"K{i}f32", d): f"flash_{n}_f32ILi{d}E" for i, n in ((2, "dq"), (3, "dkv"))
            for d in (128, 256)},
         # the small kernels at every tile (the piece names all three)
         **{(f"K{i}{k}", d): f"flash_{n}_smallI{m}Li{d}E" for i, n in ((2, "dq"), (3, "dkv"))
            for k, m in (("", "13__nv_bfloat16"), ("f32", "f")) for d in (8, 16)}}
# the FMA kernels in float32, which the *_fma variants build in their place,
# by (variant, kernel)
ENTRY_OF_VARIANT = {("k1_f32_d128_fma", "K1f32"): "flash_fwd_kernelIfLi128E",
                    ("k1_f32_d256_fma", "K1f32"): "flash_fwd_kernelIfLi256E",
                    **{(f"k23_f32_d{d}_fma", f"K{i}f32"): f"flash_{n}_kernelIfLi{d}E"
                       for i, n in ((2, "dq"), (3, "dkv")) for d in (128, 256)},
                    # the 64-row FMA K2 and K3 at 8 and 16
                    **{(f"k23_d{d}_tile64", f"K{i}{k}"): f"flash_{n}_kernelI{m}Li{d}E"
                       for i, n in ((2, "dq"), (3, "dkv"))
                       for k, m in (("", "13__nv_bfloat16"), ("f32", "f")) for d in (8, 16)}}
# timing shapes (the head dim's path), one or a list, and phase 2's check
# shapes (causal), by (kernel, head dim)
TIMED = {("K1", 32): c._shape(c.BYTES), ("K1", 128): c._shape(c.LLAMA),
         ("K2", 128): c._shape(c.LLAMA), ("K2", 256): c.SHAPES_TIMED["d256"][0],
         **{(k, d): c.SHAPES_TIMED[f"d{d}_f32"][0] for k in ("K1f32", "K2f32", "K3f32")
            for d in (128, 256)},
         # the tiny preset's B8 S16 H2, and S 48 and 200 at its batch
         **{(k, d): [(8, s, 2, d) for s in (16, 48, 200)]
            for k in ("K2", "K3", "K2f32", "K3f32") for d in (8, 16)}}
CHECKS = {
    32: [(c._shape(c.BYTES), True), ((2, 192, 2, 32), False), ((2, 320, 2, 32), True),
         ((2, 1024, 4, 32), True), ((2, 1024, 4, 32), False)],
    128: [((2, 1024, 4, 128), True), ((2, 1024, 4, 128), False), ((2, 192, 2, 128), True),
          ((2, 320, 2, 128), True), ((2, 320, 2, 128), False), ((2, 4096, 32, 128), True)],
    256: [((2, 1024, 2, 256), True), ((2, 1024, 2, 256), False), ((1, 200, 3, 256), True),
          ((1, 2048, 16, 256), True), ((1, 1000, 3, 256), False)],
    # SMALL_HELD, S 48 non-causal, and the tiles' edges at an odd BH
    **{d: [((b, s, h, d), True) for b, s, h in c.SMALL_HELD] + [((2, 48, 2, d), False)]
       + [((1, s, 3, d), causal) for s in (1, 15, 17, 33, 64) for causal in (True, False)]
       for d in (8, 16)},
}
# (reps, inner) of a timing: a few at float32's milliseconds a launch
TIMING_REPS = {"K1f32": (5, 1), "K2f32": (10, 2), "K3f32": (10, 2)}


def revision_csrc(rev: str) -> str:
    """``csrc/`` as of ``rev``, unpacked by ``git archive`` under the repo's
    ignored ``build/`` (a copy without git history needs it there already)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dest = os.path.join(repo, "build", f"csrc_{rev}")
    csrc = os.path.join(dest, "torchft_tpu_torch", "csrc")
    if not os.path.isdir(csrc):
        if not os.path.isdir(os.path.join(repo, ".git")):
            sys.exit(f"{csrc} is missing and there is no git history to unpack it from: "
                     f"mkdir -p {dest} && git archive {rev} torchft_tpu_torch/csrc | "
                     f"tar -x -C {dest}")
        os.makedirs(dest, exist_ok=True)
        tar = subprocess.run(["git", "-C", repo, "archive", rev, "torchft_tpu_torch/csrc"],
                             capture_output=True, check=True).stdout
        subprocess.run(["tar", "-x", "-C", dest], input=tar, check=True)
    return csrc


def start_build(root: str, name: str, rewrites) -> tuple[str, subprocess.Popen]:
    csrc = os.path.join(root, name)
    shutil.rmtree(csrc, ignore_errors=True)
    # the *_fma variants: the FMA kernels at float32 head dims 128 and 256
    rev = next((r for suffix, r in REVISION_OF_SUFFIX.items() if name.endswith(suffix)), None)
    shutil.copytree(revision_csrc(rev) if rev else fa.CSRC_DIR, csrc)
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
        found = re.search(r"(flash_(?:fwd|dq|dkv)_\w*?(?:wgmma|small|kernel|f32))(I.*?E)E",
                          lines[0])
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
    if kernel.startswith("K3"):
        return fa.dkv_kernel(pq, pk, pv, pdo, lse, delta, causal)
    return (fa.dq_kernel(pq, pk, pv, pdo, lse, delta, causal),)


def make_inputs(shape, causal: bool, seed: int, dtype=torch.bfloat16):
    q, k, v, do = c._qkv(*shape, dtype, seed=seed)
    pq, pk, pv, pdo = map(c._pack, (q, k, v, do))
    o, lse = fa.fwd_plain(pq, pk, pv, causal)
    delta = (pdo.float() * o.float()).sum(-1)
    return pq, pk, pv, pdo, lse, delta


def sdpa_backward(shape, dtype) -> None:
    """Print ``scaled_dot_product_attention``'s backward at ``shape``
    (causal): forward and backward less the forward, each by graph (phase
    3's method), a yardstick the port never calls."""
    import torch.nn.functional as F

    q, k, v, do = (x.transpose(1, 2).contiguous() for x in c._qkv(*shape, dtype, seed=3))
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(o, (qg, kg, vg), do)

    f, fb = (c.gpu_time_ms(fn, graph=True) for fn in (fwd, fwd_bwd))
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    print(f"sdpa {tag} b{shape[0]} s{shape[1]} h{shape[2]} d{shape[3]}: forward {f:.5f} ms, "
          f"forward+backward {fb:.5f} ms, backward alone {fb - f:.5f} ms by graph", flush=True)


def hold(name: str, kernel: str, d: int) -> bool:
    """The variant against the plain version at phase 2's shapes of head dim
    d (bf16 at KERNEL_BAR and LSE_TOL, float32 at F32_O_BAR and
    F32_LSE_TOL, float32 gradients at F32_GRAD_BAR), and bitwise across two
    launches. Returns whether every case held."""
    ok = True
    f32 = dtype_of(kernel) == torch.float32
    bar = (c.KERNEL_BAR if not f32 else c.F32_O_BAR if kernel.startswith("K1")
           else c.F32_GRAD_BAR)
    for seed, (shape, causal) in enumerate(CHECKS[d], start=20):
        x = make_inputs(shape, causal, seed, dtype_of(kernel))
        got = call(kernel, x, causal)
        again = call(kernel, x, causal)
        if kernel.startswith("K1"):
            o_ref, lse_ref = fa.fwd_plain(*x[:3], causal)
            pairs = [("O", got[0], o_ref)]
            lse_err = float((got[1] - lse_ref).abs().max())
        elif kernel.startswith("K3"):
            pairs = list(zip(("dK", "dV"), got, fa.dkv_plain(*x, causal)))
            lse_err = 0.0
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
            kernels = "+".join(kernel) if isinstance(kernel, tuple) else kernel
            print(f"{name}: {kernels} at head dim {d}{'' if exact else ' (diagnostic)'}")
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
    changed = sorted({ENTRY[kd] for n in names for kd in kinds(n)})
    for entry in changed:
        report("shipped", fa.build_log(), entry)
    failed = []
    for name, (out, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(log[-6000:])
            sys.exit(f"[{name}] nvcc failed (rc={proc.returncode})")
        libs[name] = fa.bind(out)
        for kd in kinds(name):
            entry = ENTRY_OF_VARIANT.get((name, kd[0]), ENTRY[kd])
            report(name, log, entry)
            if args.sass:
                sass_histogram(name, out, entry)
    if args.sass:
        for entry in changed:
            sass_histogram("shipped", shipped, entry)

    # (kernel, head dim) -> the libraries timed there, "shipped" first
    groups: dict[tuple[str, int], list[str]] = {}
    for name in names:
        for kd in kinds(name):
            groups.setdefault(kd, ["shipped"]).append(name)
    for (kernel, d), members in groups.items():
        for name in members:
            fa._lib = libs[name]
            if (name == "shipped" or VARIANTS[name][3]) and not hold(name, kernel, d):
                failed.append(name)
        shapes = TIMED[(kernel, d)]
        for shape in shapes if isinstance(shapes, list) else [shapes]:
            inputs = make_inputs(shape, True, 3, dtype_of(kernel))
            # a few launches at float32's milliseconds (head dims 128, 256)
            reps, inner = TIMING_REPS.get(kernel, (25, 5)) if d >= 128 else (25, 5)
            at = f"{kernel} d{d} b{shape[0]} s{shape[1]} h{shape[2]}"
            times = {name: [] for name in members}
            for r in range(args.rounds):
                for name in (members if r % 2 == 0 else members[::-1]):
                    fa._lib = libs[name]
                    t = c.gpu_time_ms(lambda: call(kernel, inputs, True), reps=reps, inner=inner,
                                      graph=True)
                    times[name].append(t)
                    print(f"round {r} {at} {name}: {t:.5f} ms", flush=True)
            for name, t in times.items():
                print(f"{at} {name}: median {statistics.median(t):.5f} min {min(t):.5f} "
                      f"max {max(t):.5f} ms by graph over {len(t)} rounds", flush=True)
            if d <= 16 and kernel.startswith("K3"):
                sdpa_backward(shape, dtype_of(kernel))
    fa._lib = libs["shipped"]
    if failed:
        sys.exit(f"failed to hold: {failed}")


if __name__ == "__main__":
    main()
