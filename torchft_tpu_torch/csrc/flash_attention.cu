// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of
// torchft_tpu/ops/pallas/flash_attention.py:
//   K1 forward  <- _fwd_kernel  (lines 67-109, pallas_call at 115)
//   K2 dQ       <- _dq_kernel   (lines 145-174, pallas_call at 219)
//   K3 dK/dV    <- _dkv_kernel  (lines 177-210, pallas_call at 238)
// bf16 is all wgmma: flash_fwd_wgmma, flash_dq_wgmma and flash_dkv_wgmma
// (TMA, mbarriers, wgmma; their notes below). float32 is the FMA path,
// flash_fwd_kernel, flash_dq_kernel and flash_dkv_kernel, kept because its
// float32 products hold the parity tests at the JAX bars.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are [BH, S, D] row-major; lse and
// delta are [BH, S] float32 (the TPU's 8-sublane broadcast and 128-lane
// m/l padding are gone).
//
// Design. The TPU kernels carry their accumulators (acc/m/l, dQ, dK/dV)
// in VMEM across the innermost grid axis, which works because a TPU grid
// runs in order. GPU blocks run in parallel and in no order, so that axis
// is a loop inside each block: K1 and K2 run one block per (bh, q-tile)
// and loop over k-tiles; K3 runs one block per (bh, k-tile) and loops over
// q-tiles. Nothing crosses blocks, so there are no atomics and every
// result is deterministic.
//
// FMA kernels (float32): a block has 4 warps; warp w owns rows
// [16w, 16w+16) of a 64-row tile, for the matrix products and for the
// row-wise softmax, so most steps need only a warp barrier. Tiles, score
// tiles and accumulators live in shared memory; they pass 48 KB, so shared
// memory is dynamic (cudaFuncSetAttribute). They do not try to reach
// either bound.
//
// Numerics kept from the TPU kernels: mask value -1e30 where
// k_pos > q_pos; blocks above the causal diagonal skipped
// (j*bk <= i*bq+bq-1); l clamped at 1e-30; P cast to V's dtype before
// P.V; dS cast to K's / Q's dtype before its products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;     // rows of every Q / K / V tile
constexpr int kHeadDim = 64;  // the head dim the kernels take
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// Shared-memory row stride (floats) of the FMA kernels' tiles: odd, so
// that a warp reading a column touches 32 banks.
constexpr int kLd = 65;
constexpr size_t kTileBytes = sizeof(float) * kTile * kLd;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy one [kTile x kHeadDim] tile (global row stride kHeadDim) into
// shared memory (row stride kLd). All threads take part.
__device__ void load_tile(float* dst, const float* __restrict__ src) {
  for (int i = threadIdx.x; i < kTile * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    dst[r * kLd + c] = src[r * kHeadDim + c];
  }
}

// The calling warp's stripe of a product: C[16 x 64] (+)= A[16 x K] B[K x 64].
// A_T: A(m, k) is stored at A[k * lda + m] (a transposed operand);
// B_T: B(k, n) is stored at B[n * ldb + k]. Row stride of C: ldc.
template <bool A_T, bool B_T>
__device__ void warp_mm(const float* A, int lda, const float* B, int ldb, float* C,
                        int ldc, int K, bool accumulate) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    float c0 = accumulate ? C[r * ldc + lane] : 0.0f;
    float c1 = accumulate ? C[r * ldc + lane + 32] : 0.0f;
    for (int k = 0; k < K; ++k) {
      const float a = A_T ? A[k * lda + r] : A[r * lda + k];
      const float b0 = B_T ? B[lane * ldb + k] : B[k * ldb + lane];
      const float b1 = B_T ? B[(lane + 32) * ldb + k] : B[k * ldb + lane + 32];
      c0 = fmaf(a, b0, c0);
      c1 = fmaf(a, b1, c1);
    }
    C[r * ldc + lane] = c0;
    C[r * ldc + lane + 32] = c1;
  }
  __syncwarp();
}

// masked, scaled score of row `row` (q position qp) and column c (k position kp)
__device__ __forceinline__ float masked(float dot, float scale, int causal, int qp, int kp) {
  const float s = dot * scale;
  return (causal && kp > qp) ? kNegInf : s;
}

// ---------------------------------------------------------------------------
// K1: forward, float32. One block per (q-tile, bh); online softmax over
// k-tiles.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sP = sV + kTile * kLd;
  float* sS = sP + kTile * kLd;
  float* sO = sS + kTile * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const int qi = blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kHeadDim;

  load_tile(sQ, q + base + static_cast<size_t>(qi) * kTile * kHeadDim);
  for (int i = threadIdx.x; i < kTile * kLd; i += kThreads) sO[i] = 0.0f;
  float m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }

  const int nk = causal ? qi + 1 : seq / kTile;
  for (int j = 0; j < nk; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile(sK, k + base + static_cast<size_t>(j) * kTile * kHeadDim);
    load_tile(sV, v + base + static_cast<size_t>(j) * kTile * kHeadDim);
    __syncthreads();
    warp_mm<false, true>(sQ + r0 * kLd, kLd, sK, kLd, sS + r0 * kLd, kLd, kHeadDim, false);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, qp = qi * kTile + row;
      const float s0 = masked(sS[row * kLd + lane], scale, causal, qp, j * kTile + lane);
      const float s1 = masked(sS[row * kLd + lane + 32], scale, causal, qp, j * kTile + lane + 32);
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
      sP[row * kLd + lane] = p0;
      sP[row * kLd + lane + 32] = p1;
      sO[row * kLd + lane] *= corr;
      sO[row * kLd + lane + 32] *= corr;
    }
    warp_mm<false, false>(sP + r0 * kLd, kLd, sV, kLd, sO + r0 * kLd, kLd, kTile, true);
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const float lr = fmaxf(l[r], 1e-30f);
    float* orow = o + base + static_cast<size_t>(qi * kTile + row) * kHeadDim;
    orow[lane] = sO[row * kLd + lane] / lr;
    orow[lane + 32] = sO[row * kLd + lane + 32] / lr;
    if (lane == 0) lse[static_cast<size_t>(blockIdx.y) * seq + qi * kTile + row] = m[r] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ, float32. One block per (q-tile, bh); loops over k-tiles.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int seq, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + kTile * kLd;
  float* sK = sDO + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sDS = sV + kTile * kLd;
  float* sS = sDS + kTile * kLd;
  float* sDP = sS + kTile * kLd;
  float* sAcc = sDP + kTile * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const int qi = blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kHeadDim;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * seq + qi * kTile;

  load_tile(sQ, q + base + static_cast<size_t>(qi) * kTile * kHeadDim);
  load_tile(sDO, dout + base + static_cast<size_t>(qi) * kTile * kHeadDim);
  for (int i = threadIdx.x; i < kTile * kLd; i += kThreads) sAcc[i] = 0.0f;
  float lse_r[16], delta_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    lse_r[r] = lse[rbase + r0 + r];
    delta_r[r] = delta[rbase + r0 + r];
  }

  const int nk = causal ? qi + 1 : seq / kTile;
  for (int j = 0; j < nk; ++j) {
    __syncthreads();
    load_tile(sK, k + base + static_cast<size_t>(j) * kTile * kHeadDim);
    load_tile(sV, v + base + static_cast<size_t>(j) * kTile * kHeadDim);
    __syncthreads();
    warp_mm<false, true>(sQ + r0 * kLd, kLd, sK, kLd, sS + r0 * kLd, kLd, kHeadDim, false);
    warp_mm<false, true>(sDO + r0 * kLd, kLd, sV, kLd, sDP + r0 * kLd, kLd, kHeadDim, false);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, qp = qi * kTile + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const float s = masked(sS[row * kLd + c], scale, causal, qp, j * kTile + c);
        const float p = expf(s - lse_r[r]);
        sDS[row * kLd + c] = p * (sDP[row * kLd + c] - delta_r[r]) * scale;
      }
    }
    warp_mm<false, false>(sDS + r0 * kLd, kLd, sK, kLd, sAcc + r0 * kLd, kLd, kTile, true);
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    float* out = dq + base + static_cast<size_t>(qi * kTile + row) * kHeadDim;
    out[lane] = sAcc[row * kLd + lane];
    out[lane + 32] = sAcc[row * kLd + lane + 32];
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV, float32. One block per (k-tile, bh); loops over q-tiles.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int seq, float scale,
                     int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + kTile * kLd;
  float* sQ = sV + kTile * kLd;
  float* sDO = sQ + kTile * kLd;
  float* sP = sDO + kTile * kLd;
  float* sDS = sP + kTile * kLd;
  float* sS = sDS + kTile * kLd;
  float* sDP = sS + kTile * kLd;
  float* sDK = sDP + kTile * kLd;
  float* sDV = sDK + kTile * kLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const int kj = blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kHeadDim;

  load_tile(sK, k + base + static_cast<size_t>(kj) * kTile * kHeadDim);
  load_tile(sV, v + base + static_cast<size_t>(kj) * kTile * kHeadDim);
  for (int i = threadIdx.x; i < kTile * kLd; i += kThreads) {
    sDK[i] = 0.0f;
    sDV[i] = 0.0f;
  }

  const int nq = seq / kTile;
  for (int i = causal ? kj : 0; i < nq; ++i) {
    __syncthreads();  // every warp is done with the previous Q/dO/P/dS tiles
    load_tile(sQ, q + base + static_cast<size_t>(i) * kTile * kHeadDim);
    load_tile(sDO, dout + base + static_cast<size_t>(i) * kTile * kHeadDim);
    __syncthreads();
    // warp w: q rows [r0, r0+16) of this q-tile
    warp_mm<false, true>(sQ + r0 * kLd, kLd, sK, kLd, sS + r0 * kLd, kLd, kHeadDim, false);
    warp_mm<false, true>(sDO + r0 * kLd, kLd, sV, kLd, sDP + r0 * kLd, kLd, kHeadDim, false);
    const size_t rbase = static_cast<size_t>(blockIdx.y) * seq + i * kTile + r0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, qp = i * kTile + row;
      const float lse_r = lse[rbase + r], delta_r = delta[rbase + r];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const float s = masked(sS[row * kLd + c], scale, causal, qp, kj * kTile + c);
        const float p = expf(s - lse_r);
        sP[row * kLd + c] = p;
        sDS[row * kLd + c] = p * (sDP[row * kLd + c] - delta_r) * scale;
      }
    }
    __syncthreads();  // P and dS of all q rows are in place
    // warp w: k rows [r0, r0+16): dV += P^T dO, dK += dS^T Q
    warp_mm<true, false>(sP + r0, kLd, sDO, kLd, sDV + r0 * kLd, kLd, kTile, true);
    warp_mm<true, false>(sDS + r0, kLd, sQ, kLd, sDK + r0 * kLd, kLd, kTile, true);
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const size_t off = base + static_cast<size_t>(kj * kTile + row) * kHeadDim;
    dk[off + lane] = sDK[row * kLd + lane];
    dk[off + lane + 32] = sDK[row * kLd + lane + 32];
    dv[off + lane] = sDV[row * kLd + lane];
    dv[off + lane + 32] = sDV[row * kLd + lane + 32];
  }
}

// ---------------------------------------------------------------------------
// bf16 K1, K2 and K3 for Hopper: TMA, mbarriers and wgmma, warp-specialised.
//
// A block is three warpgroups. Warpgroup 0 is the producer: it gives up its
// registers (setmaxnreg) and one of its threads keeps a ring of
// kStages tiles in flight with TMA, each stage completed on a "full"
// mbarrier and handed back on an "empty" one. Warpgroups 1 and 2 are the
// consumers: each owns 64 rows of the block's 128-row tile, runs wgmma on
// the tiles that have arrived, and keeps its accumulators, running max and
// sum in registers for the whole loop. Tiles are 128-byte swizzled (see
// hopper.cuh); Q/K/V/dO rows are 128 bytes, one swizzle span, so one tensor
// map format (box 64 x 64) serves every tensor.
//
// Fragments: the wgmma accumulator of a 64 x N product gives thread
// (warp w, lane l) rows 16w + l/4 and 16w + l/4 + 8 of its warpgroup's 64;
// register 4c + e (e = 0, 1) is the first row's column 8c + 2(l%4) + e and
// 4c + 2 + e the second row's. Row sums therefore reduce over the 4 lanes
// of a quad (shuffles xor 1 and 2), and registers 8kk..8kk+7, rounded to
// bf16 in pairs, are exactly the A fragment of the k16 step kk of a
// product with this accumulator as its left operand (P.V, dS.K, P^T.dO,
// dS^T.Q).
//
// Determinism: every output element is computed by one block in a fixed
// order, with no split over keys and no atomics.
// ---------------------------------------------------------------------------

constexpr int kWg = 128;           // threads of a warpgroup
constexpr int kHThreads = 3 * kWg;  // producer + two consumers
constexpr int kBox = 64;           // rows of one TMA box
constexpr int kBoxElems = kBox * kHeadDim;
constexpr uint32_t kBoxBytes = kBoxElems * sizeof(bf16);  // 8 KB
constexpr int kStages = 2;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// Round a warpgroup's 64 x 64 float32 accumulator to bf16 and write it to
// `tile` in the 128-byte swizzled layout that a TMA store reads.
__device__ __forceinline__ void stage_tile(bf16* tile, const float (&acc)[32], float s0,
                                           float s1, int r0) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int off = ((c ^ (r0 & 7)) << 4) + (t << 2);
    *reinterpret_cast<uint32_t*>(base + r0 * 128 + off) =
        hopper::pack_bf16(acc[4 * c] * s0, acc[4 * c + 1] * s0);
    *reinterpret_cast<uint32_t*>(base + (r0 + 8) * 128 + off) =
        hopper::pack_bf16(acc[4 * c + 2] * s1, acc[4 * c + 3] * s1);
  }
}

// ---------------------------------------------------------------------------
// K1 forward, bf16. Replaces _fwd_kernel, torchft_tpu/ops/pallas/
// flash_attention.py:67 (pallas_call at :115).
//
// Bound at the headline shapes (B8 S1024 H8 D64, causal): 33.8 MB moved,
// 0.010 ms at 3.35 TB/s; 8.6 GFLOP of causal products, 0.0087 ms at
// 989 TFLOP/s: the two are close, so the kernel has to keep both the
// tensor cores and the loads busy. The design: one block per (bh, 128-row
// q-tile); Q loaded once; K/V streamed by TMA through a two-stage ring, so
// the next tile loads while this one is computed; S = Q.K^T (m64n128k16,
// both operands K-major in shared memory) and O += P.V (P from registers,
// V MN-major) on wgmma, with S, P, O, the running max and sum all in
// registers (no score tile in shared memory); exp2 with scale.log2(e)
// folded into one multiply; only the first tile visited (the diagonal, or
// the ragged last one) pays for the mask, tiles above the diagonal are
// never loaded; the heaviest q-tiles (most key tiles) are scheduled first;
// O leaves through shared memory and a TMA store.
// ---------------------------------------------------------------------------

struct FwdSmem {
  alignas(1024) bf16 q[2 * kBoxElems];  // rows 0-63: consumer 0, 64-127: consumer 1
  alignas(1024) bf16 k[kStages][2 * kBoxElems];
  alignas(1024) bf16 v[kStages][2 * kBoxElems];
  uint64_t q_full;
  uint64_t kv_full[kStages];
  uint64_t kv_empty[kStages];
};

__global__ void __launch_bounds__(kHThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o, float* __restrict__ lse,
                    int seq, float scale_log2, int causal) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = aligned_smem<FwdSmem>(smem_raw);
  const int bh = blockIdx.x;
  const int ntiles = (seq + 127) / 128;
  const int qi = ntiles - 1 - static_cast<int>(blockIdx.y);  // heaviest first
  const int nk = causal ? qi + 1 : ntiles;                   // key tiles to visit
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.kv_empty[s], 2 * kWg);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q once, then K/V tiles from the diagonal down ----
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&map_q);
      tma_prefetch(&map_k);
      tma_prefetch(&map_v);
      mbar_expect_tx(&sm.q_full, 2 * kBoxBytes);
      tma_load(sm.q, &map_q, qi * 128, bh, &sm.q_full);
      tma_load(sm.q + kBoxElems, &map_q, qi * 128 + kBox, bh, &sm.q_full);
      for (int it = 0; it < nk; ++it) {
        const int j = nk - 1 - it, st = it % kStages;
        mbar_wait(&sm.kv_empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.kv_full[st], 4 * kBoxBytes);
        tma_load(sm.k[st], &map_k, j * 128, bh, &sm.kv_full[st]);
        tma_load(sm.k[st] + kBoxElems, &map_k, j * 128 + kBox, bh, &sm.kv_full[st]);
        tma_load(sm.v[st], &map_v, j * 128, bh, &sm.kv_full[st]);
        tma_load(sm.v[st] + kBoxElems, &map_v, j * 128 + kBox, bh, &sm.kv_full[st]);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    regs_alloc<kConsumerRegs>();
    const int cw = wg - 1, tid = threadIdx.x % kWg;
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int r0 = warp * 16 + lane / 4;          // rows r0 and r0 + 8 of the 64
    const int qrow = qi * 128 + cw * kBox + r0;   // sequence position of row r0
    bf16* q_half = sm.q + cw * kBoxElems;
    const uint64_t q_desc = desc_sw128(q_half);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;  // l: this thread's part

    mbar_wait(&sm.q_full, 0);
    for (int it = 0; it < nk; ++it) {
      const int j = nk - 1 - it, st = it % kStages;
      mbar_wait(&sm.kv_full[st], (it / kStages) & 1);

      float s[64];
      const uint64_t k_desc = desc_sw128(sm.k[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_m64n128(s, q_desc + 2 * kk, k_desc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // scale (log2 domain), mask the first tile visited, running max
      const bool mask = it == 0 && (causal || (j + 1) * 128 > seq);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = s[4 * c + e] * scale_log2, b = s[4 * c + 2 + e] * scale_log2;
          if (mask) {
            const int col = j * 128 + 8 * c + 2 * t + e;
            if (col >= seq || (causal && col > qrow)) a = kNegInf;
            if (col >= seq || (causal && col > qrow + 8)) b = kNegInf;
          }
          s[4 * c + e] = a;
          s[4 * c + 2 + e] = b;
          mx0 = fmaxf(mx0, a);
          mx1 = fmaxf(mx1, b);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // P = exp2(s - m) in float32 for the sum, bf16 for P.V
      uint32_t pa[8][4];
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p0 = exp2f(s[4 * c] - mn0), p1 = exp2f(s[4 * c + 1] - mn0);
        const float p2 = exp2f(s[4 * c + 2] - mn1), p3 = exp2f(s[4 * c + 3] - mn1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        pa[c / 2][(c % 2) * 2] = pack_bf16(p0, p1);
        pa[c / 2][(c % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        o[4 * c] *= corr0;
        o[4 * c + 1] *= corr0;
        o[4 * c + 2] *= corr1;
        o[4 * c + 3] *= corr1;
      }

      const uint64_t v_desc = desc_sw128(sm.v[st]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_rs_m64n64_tb(o, pa[kk], v_desc + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&sm.kv_empty[st]);
    }

    // ---- epilogue: O / l through shared memory (this warpgroup's Q rows,
    // no longer read) and a TMA store, which drops rows past seq; lse ----
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    warpgroup_sync(1 + cw);
    stage_tile(q_half, o, 1.0f / l0, 1.0f / l1, r0);
    fence_async_smem();
    warpgroup_sync(1 + cw);
    if (tid == 0) {
      tma_store(&map_o, q_half, qi * 128 + cw * kBox, bh);
      tma_store_wait();
    }
    if (t == 0) {
      float* out = lse + static_cast<size_t>(bh) * seq;
      if (qrow < seq) out[qrow] = m0 * kLn2 + logf(l0);
      if (qrow + 8 < seq) out[qrow + 8] = m1 * kLn2 + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 dQ, bf16. Replaces _dq_kernel, torchft_tpu/ops/pallas/
// flash_attention.py:145 (pallas_call at :219).
//
// Bound at the headline shapes: 12.9 GFLOP of causal products (three per
// (q, k) pair), 0.0130 ms at 989 TFLOP/s, over 42.5 MB (0.0127 ms): the
// two are close. The design is K1's: one block per (bh, 128-row q-tile),
// the heaviest first; Q and dO loaded once; K and V streamed by TMA
// through a two-stage ring from the diagonal down (tiles above it are
// never loaded). Each consumer (64 query rows) takes a stage's 128 keys
// in two halves of 64 (the registers of a whole stage's S, dP and dQ
// spill) and skips a half that lies past seq or, under the causal mask,
// past all of its rows. Per half it computes S = Q.K^T and dP = dO.V^T on
// wgmma (m64n64, both operands K-major), then
// P = exp2(S.scale.log2(e) - lse.log2(e)) and dS = P (dP - delta) scale in
// registers, with lse and delta of its two rows held for the whole loop;
// dS is rounded to bf16 and packed straight into the A fragments of
// dQ += dS.K, which reads K MN-major from the same stage (the layout K1
// uses for V). Neither S, dP, dS nor dQ touches shared memory until dQ
// leaves through the warpgroup's own Q rows and a TMA store. Only the
// first tile visited (the diagonal, or the ragged last one) is masked.
// No split over keys and no atomics: dQ is bitwise reproducible.
// ---------------------------------------------------------------------------

struct DqSmem {
  alignas(1024) bf16 q[2 * kBoxElems];  // rows 0-63: consumer 0, 64-127: consumer 1
  alignas(1024) bf16 dout[2 * kBoxElems];
  alignas(1024) bf16 k[kStages][2 * kBoxElems];
  alignas(1024) bf16 v[kStages][2 * kBoxElems];
  uint64_t qdo_full;
  uint64_t kv_full[kStages];
  uint64_t kv_empty[kStages];
};

__global__ void __launch_bounds__(kHThreads, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_dq,
                   const float* __restrict__ lse, const float* __restrict__ delta, int seq,
                   float scale, float scale_log2, int causal) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);
  const int bh = blockIdx.x;
  const int ntiles = (seq + 127) / 128;
  const int qi = ntiles - 1 - static_cast<int>(blockIdx.y);  // heaviest first
  const int nk = causal ? qi + 1 : ntiles;                   // key tiles to visit
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.kv_empty[s], 2 * kWg);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q and dO once, then K/V tiles from the diagonal down ----
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&map_q);
      tma_prefetch(&map_do);
      tma_prefetch(&map_k);
      tma_prefetch(&map_v);
      mbar_expect_tx(&sm.qdo_full, 4 * kBoxBytes);
      tma_load(sm.q, &map_q, qi * 128, bh, &sm.qdo_full);
      tma_load(sm.q + kBoxElems, &map_q, qi * 128 + kBox, bh, &sm.qdo_full);
      tma_load(sm.dout, &map_do, qi * 128, bh, &sm.qdo_full);
      tma_load(sm.dout + kBoxElems, &map_do, qi * 128 + kBox, bh, &sm.qdo_full);
      for (int it = 0; it < nk; ++it) {
        const int j = nk - 1 - it, st = it % kStages;
        mbar_wait(&sm.kv_empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.kv_full[st], 4 * kBoxBytes);
        tma_load(sm.k[st], &map_k, j * 128, bh, &sm.kv_full[st]);
        tma_load(sm.k[st] + kBoxElems, &map_k, j * 128 + kBox, bh, &sm.kv_full[st]);
        tma_load(sm.v[st], &map_v, j * 128, bh, &sm.kv_full[st]);
        tma_load(sm.v[st] + kBoxElems, &map_v, j * 128 + kBox, bh, &sm.kv_full[st]);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    regs_alloc<kConsumerRegs>();
    const int cw = wg - 1, tid = threadIdx.x % kWg;
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int r0 = warp * 16 + lane / 4;          // rows r0 and r0 + 8 of the 64
    const int qrow = qi * 128 + cw * kBox + r0;   // sequence position of row r0
    bf16* q_half = sm.q + cw * kBoxElems;
    const uint64_t q_desc = desc_sw128(q_half);
    const uint64_t do_desc = desc_sw128(sm.dout + cw * kBoxElems);

    // lse (log2 domain) and delta of the thread's two rows; rows past seq
    // are not read (their Q and dO rows are zero-filled and their dQ rows
    // are dropped by the store)
    const float* lse_bh = lse + static_cast<size_t>(bh) * seq;
    const float* delta_bh = delta + static_cast<size_t>(bh) * seq;
    const float lse0 = qrow < seq ? lse_bh[qrow] * kLog2e : 0.0f;
    const float lse1 = qrow + 8 < seq ? lse_bh[qrow + 8] * kLog2e : 0.0f;
    const float dl0 = qrow < seq ? delta_bh[qrow] : 0.0f;
    const float dl1 = qrow + 8 < seq ? delta_bh[qrow + 8] : 0.0f;

    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.0f;

    mbar_wait(&sm.qdo_full, 0);
    for (int it = 0; it < nk; ++it) {
      const int j = nk - 1 - it, st = it % kStages;
      mbar_wait(&sm.kv_full[st], (it / kStages) & 1);
      const bool mask = it == 0 && (causal || (j + 1) * 128 > seq);

      // the stage's 128 keys in two halves of 64: S, dP and dQ of a whole
      // stage (160 accumulator registers) do not fit ptxas' 168 without
      // spills; a half needs 96
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key0 = j * 128 + h * kBox;  // first key of the half
        // every key past seq, or past every query row of this consumer
        if (key0 >= seq || (causal && key0 > qi * 128 + cw * kBox + kBox - 1)) continue;
        const uint64_t k_desc = desc_sw128(sm.k[st] + h * kBoxElems);
        const uint64_t v_desc = desc_sw128(sm.v[st] + h * kBoxElems);
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_m64n64(s, q_desc + 2 * kk, k_desc + 2 * kk, kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_m64n64(dp, do_desc + 2 * kk, v_desc + 2 * kk, kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // dS = exp2(s.scale.log2(e) - lse.log2(e)) (dP - delta) scale,
        // rounded to bf16 in pairs: the A fragments of dS.K; the first
        // tile visited is masked (keys past seq, and past the query under
        // the causal mask)
        uint32_t da[4][4];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float a = s[4 * c + e] * scale_log2, b = s[4 * c + 2 + e] * scale_log2;
            if (mask) {
              const int col = key0 + 8 * c + 2 * t + e;
              if (col >= seq || (causal && col > qrow)) a = kNegInf;
              if (col >= seq || (causal && col > qrow + 8)) b = kNegInf;
            }
            d[e] = exp2f(a - lse0) * (dp[4 * c + e] - dl0) * scale;
            d[2 + e] = exp2f(b - lse1) * (dp[4 * c + 2 + e] - dl1) * scale;
          }
          da[c / 2][(c % 2) * 2] = pack_bf16(d[0], d[1]);
          da[c / 2][(c % 2) * 2 + 1] = pack_bf16(d[2], d[3]);
        }

        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_m64n64_tb(dq, da[kk], k_desc + 128 * kk, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      mbar_arrive(&sm.kv_empty[st]);
    }

    // ---- epilogue: dQ through this warpgroup's Q rows (no longer read)
    // and a TMA store, which drops rows past seq ----
    warpgroup_sync(1 + cw);
    stage_tile(q_half, dq, 1.0f, 1.0f, r0);
    fence_async_smem();
    warpgroup_sync(1 + cw);
    if (tid == 0) {
      tma_store(&map_dq, q_half, qi * 128 + cw * kBox, bh);
      tma_store_wait();
    }
  }
}

// ---------------------------------------------------------------------------
// K3 dK/dV, bf16. Replaces _dkv_kernel, torchft_tpu/ops/pallas/
// flash_attention.py:177 (pallas_call at :238).
//
// Bound at the headline shapes: 17.2 GFLOP of causal products (four per
// (q, k) pair), 0.0174 ms at 989 TFLOP/s, over 50.9 MB (0.0152 ms): bound
// by operations. The design: one block per (bh, 128-key tile), K and V
// resident in shared memory; the producer streams 64-row Q and dO tiles
// and their 64 lse and delta values through a two-stage ring; each
// consumer (64 keys) computes the transposed scores S^T = K.Q^T and
// dP^T = V.dO^T on wgmma (both operands K-major), so P^T and dS^T land in
// registers with rows = keys, the rows its dK and dV accumulators own;
// then dV += P^T.dO and dK += dS^T.Q take P^T and dS^T from registers and
// dO / Q MN-major from shared memory. Neither P nor dS touches shared
// memory. The loop starts at the diagonal q-tile; the heaviest key tiles
// (the first ones, under the causal mask) are scheduled first. dQ stays in
// K2: folding it in with atomic adds would make the result depend on the
// order of arrival.
// ---------------------------------------------------------------------------

struct DkvSmem {
  alignas(1024) bf16 k[2 * kBoxElems];  // keys 0-63: consumer 0, 64-127: consumer 1
  alignas(1024) bf16 v[2 * kBoxElems];
  alignas(1024) bf16 q[kStages][kBoxElems];
  alignas(1024) bf16 dout[kStages][kBoxElems];
  float lse[kStages][kBox];
  float delta[kStages][kBox];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

__global__ void __launch_bounds__(kHThreads, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_dk,
                    const __grid_constant__ CUtensorMap map_dv,
                    const float* __restrict__ lse, const float* __restrict__ delta, int seq,
                    float scale, float scale_log2, int causal) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem& sm = aligned_smem<DkvSmem>(smem_raw);
  const int bh = blockIdx.x;
  const int kj = blockIdx.y;  // under the causal mask the first key tiles are the heaviest
  const int nq = seq / kBox;
  const int i0 = causal ? 2 * kj : 0;  // first q-tile that sees these keys
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * kWg);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&map_q);
      tma_prefetch(&map_do);
      mbar_expect_tx(&sm.kv_full, 4 * kBoxBytes);
      tma_load(sm.k, &map_k, kj * 128, bh, &sm.kv_full);
      tma_load(sm.k + kBoxElems, &map_k, kj * 128 + kBox, bh, &sm.kv_full);
      tma_load(sm.v, &map_v, kj * 128, bh, &sm.kv_full);
      tma_load(sm.v + kBoxElems, &map_v, kj * 128 + kBox, bh, &sm.kv_full);
      const float* lse_bh = lse + static_cast<size_t>(bh) * seq;
      const float* delta_bh = delta + static_cast<size_t>(bh) * seq;
      for (int i = i0; i < nq; ++i) {
        const int it = i - i0, st = it % kStages;
        mbar_wait(&sm.empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * kBoxBytes + 2 * kBox * sizeof(float));
        tma_load(sm.q[st], &map_q, i * kBox, bh, &sm.full[st]);
        tma_load(sm.dout[st], &map_do, i * kBox, bh, &sm.full[st]);
        bulk_load(sm.lse[st], lse_bh + i * kBox, kBox * sizeof(float), &sm.full[st]);
        bulk_load(sm.delta[st], delta_bh + i * kBox, kBox * sizeof(float), &sm.full[st]);
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();
    const int cw = wg - 1, tid = threadIdx.x % kWg;
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int r0 = warp * 16 + lane / 4;           // key rows r0 and r0 + 8 of the 64
    bf16* k_half = sm.k + cw * kBoxElems;
    bf16* v_half = sm.v + cw * kBoxElems;
    const uint64_t k_desc = desc_sw128(k_half), v_desc = desc_sw128(v_half);
    const int diag = 2 * kj + cw;  // the q-tile holding the same positions as these keys

    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;

    mbar_wait(&sm.kv_full, 0);
    for (int i = i0; i < nq; ++i) {
      const int it = i - i0, st = it % kStages;
      mbar_wait(&sm.full[st], (it / kStages) & 1);
      if (causal && i < diag) {  // every key here comes after every query
        mbar_arrive(&sm.empty[st]);
        continue;
      }
      float s[32], dp[32];
      const uint64_t q_desc = desc_sw128(sm.q[st]), do_desc = desc_sw128(sm.dout[st]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_m64n64(s, k_desc + 2 * kk, q_desc + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_m64n64(dp, v_desc + 2 * kk, do_desc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp2(s.scale.log2(e) - lse.log2(e)), dS^T = P^T (dP^T - delta) scale,
      // columns are queries
      const bool mask = causal && i == diag;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = 8 * c + 2 * t + e;
          const float lse2 = sm.lse[st][qc] * kLog2e, dl = sm.delta[st][qc];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int idx = 4 * c + 2 * h + e;
            float a = s[idx] * scale_log2;
            if (mask && r0 + 8 * h > qc) a = kNegInf;
            p[2 * h + e] = exp2f(a - lse2);
            d[2 * h + e] = p[2 * h + e] * (dp[idx] - dl) * scale;
          }
        }
        pa[c / 2][(c % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[c / 2][(c % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        da[c / 2][(c % 2) * 2] = pack_bf16(d[0], d[1]);
        da[c / 2][(c % 2) * 2 + 1] = pack_bf16(d[2], d[3]);
      }

      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_m64n64_tb(dv, pa[kk], do_desc + 128 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_m64n64_tb(dk, da[kk], q_desc + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      mbar_arrive(&sm.empty[st]);
    }

    // ---- epilogue: dK, dV through this warpgroup's K/V rows and TMA stores
    // (rows past seq are dropped) ----
    warpgroup_sync(1 + cw);
    stage_tile(k_half, dk, 1.0f, 1.0f, r0);
    stage_tile(v_half, dv, 1.0f, 1.0f, r0);
    fence_async_smem();
    warpgroup_sync(1 + cw);
    if (tid == 0) {
      tma_store(&map_dk, k_half, kj * 128 + cw * kBox, bh);
      tma_store(&map_dv, v_half, kj * 128 + cw * kBox, bh);
      tma_store_wait();
    }
  }
}


// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool shape_ok(int bh, int seq, int d) {
  return bh > 0 && bh <= 65535 && seq > 0 && seq % kTile == 0 && d == kHeadDim;
}

// Opt a kernel into its dynamic shared memory once per process.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

// cuTensorMapEncodeTiled is a driver entry point; it is taken through the
// runtime so that the library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A [BH, S, 64] bf16 tensor as the 3-D map {64, S, BH} with box {64, 64, 1}
// and the 128-byte swizzle. The map holds the base pointer, so it is made
// per launch and passed by value (__grid_constant__).
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int bh, int seq) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {kHeadDim, static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {kHeadDim * sizeof(bf16),
                                 static_cast<cuuint64_t>(seq) * kHeadDim * sizeof(bf16)};
  const cuuint32_t box[3] = {kHeadDim, kBox, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr float kLog2eHost = 1.4426950408889634f;

int fwd_hopper(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
               int seq, float scale, int causal, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = sizeof(FwdSmem) + 1024;  // + room to align the base to 1024
  cudaError_t err = allow_smem(flash_fwd_wgmma, smem, &ready);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mo;
  if ((err = tensor_map(&mq, q, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mk, k, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mv, v, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mo, o, bh, seq)) != cudaSuccess)
    return err;
  flash_fwd_wgmma<<<dim3(bh, (seq + 127) / 128), kHThreads, smem, stream>>>(
      mq, mk, mv, mo, lse, seq, scale * kLog2eHost, causal);
  return cudaGetLastError();
}

int dq_hopper(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dqp, int bh, int seq, float scale,
              int causal, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = sizeof(DqSmem) + 1024;
  cudaError_t err = allow_smem(flash_dq_wgmma, smem, &ready);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if ((err = tensor_map(&mq, q, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mk, k, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mv, v, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mdo, dout, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mdq, dqp, bh, seq)) != cudaSuccess)
    return err;
  flash_dq_wgmma<<<dim3(bh, (seq + 127) / 128), kHThreads, smem, stream>>>(
      mq, mk, mv, mdo, mdq, lse, delta, seq, scale, scale * kLog2eHost, causal);
  return cudaGetLastError();
}

int dkv_hopper(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dkp, void* dvp, int bh, int seq,
               float scale, int causal, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = sizeof(DkvSmem) + 1024;
  cudaError_t err = allow_smem(flash_dkv_wgmma, smem, &ready);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if ((err = tensor_map(&mq, q, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mk, k, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mv, v, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mdo, dout, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mdk, dkp, bh, seq)) != cudaSuccess ||
      (err = tensor_map(&mdv, dvp, bh, seq)) != cudaSuccess)
    return err;
  flash_dkv_wgmma<<<dim3(bh, (seq + 127) / 128), kHThreads, smem, stream>>>(
      mq, mk, mv, mdo, mdk, mdv, lse, delta, seq, scale, scale * kLog2eHost, causal);
  return cudaGetLastError();
}

int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
            int seq, float scale, int causal, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = 6 * kTileBytes;
  cudaError_t err = allow_smem(flash_fwd_kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<<<dim3(seq / kTile, bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq, scale, causal);
  return cudaGetLastError();
}

int dq_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dqp, int bh, int seq, float scale, int causal,
           cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = 8 * kTileBytes;
  cudaError_t err = allow_smem(flash_dq_kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<<<dim3(seq / kTile, bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dqp), seq, scale, causal);
  return cudaGetLastError();
}

int dkv_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dkp, void* dvp, int bh, int seq, float scale,
            int causal, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = 10 * kTileBytes;
  cudaError_t err = allow_smem(flash_dkv_kernel, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<<<dim3(seq / kTile, bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dkp), static_cast<float*>(dvp), seq, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Every entry point returns a cudaError_t (0 = launched).
extern "C" {

int tft_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int seq, int d, float scale, int causal,
                  void* stream) {
  if (!shape_ok(bh, seq, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_f32(q, k, v, o, lse, bh, seq, scale, causal, st);
  if (dtype == 1) return fwd_hopper(q, k, v, o, lse, bh, seq, scale, causal, st);
  return cudaErrorInvalidValue;
}

int tft_flash_dq(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta, void* dqp,
                 int bh, int seq, int d, float scale, int causal, void* stream) {
  if (!shape_ok(bh, seq, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dq_f32(q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal, st);
  if (dtype == 1)
    return dq_hopper(q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal, st);
  return cudaErrorInvalidValue;
}

int tft_flash_dkv(int dtype, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta, void* dkp,
                  void* dvp, int bh, int seq, int d, float scale, int causal,
                  void* stream) {
  if (!shape_ok(bh, seq, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dkv_f32(q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale, causal, st);
  if (dtype == 1)
    return dkv_hopper(q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale, causal, st);
  return cudaErrorInvalidValue;
}

const char* tft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
