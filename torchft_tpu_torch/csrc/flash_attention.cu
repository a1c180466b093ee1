// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of
// torchft_tpu/ops/pallas/flash_attention.py:
//   K1 forward  <- _fwd_kernel  (lines 67-109, pallas_call at 115)
//   K2 dQ       <- _dq_kernel   (lines 145-174, pallas_call at 219)
//   K3 dK/dV    <- _dkv_kernel  (lines 177-210, pallas_call at 238)
// The Pallas kernels take any head dim D; these are instantiated at D 8,
// 16, 32, 64, 128 and 256 in float32 and bf16, at any S, and the op
// (torchft_tpu_torch/ops/flash_attention.py) pads every other D up to 256
// with zero columns to the next of them, passing the true D's scale (a
// zero column adds an exact 0 to every dot product). tft_flash_supported
// states what the op takes, and D above 256 stays refused. bf16 at D 128
// and 256 (any S) and at D 32 and 64 (S a multiple of 64) runs on wgmma:
// flash_fwd_wgmma, flash_dq_wgmma and flash_dkv_wgmma (TMA, mbarriers,
// wgmma; their notes below), templated on D; they mask the last tile.
// Float32 K1 at D 128 and 256 runs on flash_fwd_f32 (register-blocked FMAs
// fed by cp.async; its note below). The FMA path, flash_fwd_kernel,
// flash_dq_kernel and flash_dkv_kernel, templated on the element type and
// D, takes the rest: float32 at every D (K1 at 128 and 256 aside), and
// bf16 at D 8 and 16 (wgmma's K of 16 bf16 values does not fit D 8, and
// these are the tiny models' shapes) and at D 32 and 64 where S is not a
// multiple of 64.
// It masks the last tile's rows and columns, so it takes any S; its
// float32 products hold the parity tests at the JAX bars. At D 128 and 256
// its tiles are 32 rows, so that K3's six float32 tiles of D columns fit
// the 227 KB of shared memory (201 KB at D 256).
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
// FMA kernels (float32, and bf16 loaded into float32): a block has 4
// warps; warp w owns rows [16w, 16w+16) of a 64-row tile at D <= 64, and
// [8w, 8w+8) of a 32-row tile at D 128 and 256 (Fma<D>), for the matrix
// products and for the row-wise softmax, so most steps need only a warp
// barrier. Tiles are converted to float32 as they are loaded, rows past S
// as zeros; keys past S are masked like keys past the query, and query
// rows past S are neither written nor summed into dK and dV. Tiles, score
// tiles and accumulators live in shared memory; they pass 48 KB, so
// shared memory is dynamic (cudaFuncSetAttribute). Every product is a
// chain of serial FMAs from shared memory: the kernels do not try to reach
// either bound (at D 8 and 16 a product of a 16-row stripe keeps 8 or 16
// lanes to a row, 4 or 2 rows at once). At D 128 and 256 they are bound by
// shared-memory loads (one or two a FMA): 2-8 TFLOP/s on the card against
// its 67 in float32 (PERF.md), first kernels that are right.
//
// Numerics kept from the TPU kernels: mask value -1e30 where
// k_pos > q_pos; blocks above the causal diagonal skipped
// (j*bk <= i*bq+bq-1); l clamped at 1e-30; in the wgmma kernels P cast to
// V's dtype before P.V and dS cast to K's / Q's dtype before its products
// (the float32 FMA kernels keep them in float32).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;     // rows of the wgmma kernels' boxes: S up to 65535 of them
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// The FMA kernels' tile geometry by head dim. A tile is TR rows; warp w of
// the block's 4 owns rows [RW w, RW w + RW) of it. At D <= 64, TR = 64 and
// every tile has the row stride 65. At D 128 and 256, TR = 32: a 64-row
// float32 tile of 128 columns is 33 KB, and K3 keeps six of them, so the
// tiles are halved, with a stride of D + 1 for the D-column tiles (Q, K, V,
// dO and the accumulators) and TR + 1 for the score tiles (S, P, dP, dS).
// Odd strides: a warp reading a column touches 32 banks.
template <int D>
struct Fma {
  static constexpr int TR = D <= 64 ? 64 : 32;  // rows of every tile
  static constexpr int RW = TR / 4;             // rows a warp owns
  static constexpr int CL = TR / 32;            // score columns a lane owns in a row
  static constexpr int LD = (D > TR ? D : TR) + 1;
  static constexpr int LS = TR + 1;
  static constexpr size_t kD = sizeof(float) * TR * LD;  // bytes of a D-column tile
  static constexpr size_t kS = sizeof(float) * TR * LS;  // bytes of a score tile
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

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

// Copy the tile of [TR x D] rows starting at `row0` (global row stride D,
// `seq` rows in all) into shared memory as float32 (row stride LD); rows
// past `seq` read as zeros. All threads take part.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int seq) {
  constexpr int TR = Fma<D>::TR, LD = Fma<D>::LD;
  const int rows = min(TR, seq - row0);
  src += static_cast<size_t>(row0) * D;
  for (int i = threadIdx.x; i < TR * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r < rows ? to_f32(src[r * D + c]) : 0.0f;
  }
}

// The calling warp's stripe of a product: C[M x N] (+)= A[M x K] B[K x N],
// N 8, 16 or a multiple of 32: min(N, 32) lanes share a row (lane l owns
// columns l % N, + 32, ...) and 32 / min(N, 32) rows go at once.
// A_T: A(m, k) is stored at A[k * lda + m] (a transposed operand);
// B_T: B(k, n) is stored at B[n * ldb + k]. Row stride of C: ldc.
template <bool A_T, bool B_T, int M, int N>
__device__ __forceinline__ void warp_mm(const float* A, int lda, const float* B, int ldb,
                                        float* C, int ldc, int K, bool accumulate) {
  constexpr int kLanes = N < 32 ? N : 32;  // lanes on one row
  constexpr int kRows = 32 / kLanes;       // rows a pass covers
  constexpr int NC = N < 32 ? 1 : N / 32;
  const int lane = threadIdx.x & 31;
  const int col = lane % kLanes;
  __syncwarp();
  for (int r0 = 0; r0 < M; r0 += kRows) {
    const int r = r0 + lane / kLanes;
    float c[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) c[j] = accumulate ? C[r * ldc + col + 32 * j] : 0.0f;
    for (int k = 0; k < K; ++k) {
      const float a = A_T ? A[k * lda + r] : A[r * lda + k];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int n = col + 32 * j;
        c[j] = fmaf(a, B_T ? B[n * ldb + k] : B[k * ldb + n], c[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) C[r * ldc + col + 32 * j] = c[j];
  }
  __syncwarp();
}

// masked, scaled score of q position qp against k position kp: keys past
// the query (causal) and past the sequence are masked
__device__ __forceinline__ float masked(float dot, float scale, int causal, int qp, int kp,
                                        int seq) {
  const float s = dot * scale;
  return ((causal && kp > qp) || kp >= seq) ? kNegInf : s;
}

template <int D>
__host__ __device__ __forceinline__ int tiles(int seq) {
  return (seq + Fma<D>::TR - 1) / Fma<D>::TR;
}

// The FMA grids are (bh, y, z): tile y + z * gridDim.y of S (a grid's y
// extent stops at 65535, short of S / 32 at the longest S); blocks past the
// last tile return at once.
__device__ __forceinline__ int tile_index() {
  return static_cast<int>(blockIdx.y + blockIdx.z * gridDim.y);
}

// ---------------------------------------------------------------------------
// K1: forward, FMA. One block per (bh, q-tile); online softmax over k-tiles.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale, int causal) {
  using F = Fma<D>;
  constexpr int TR = F::TR, RW = F::RW, CL = F::CL, LD = F::LD, LS = F::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + TR * LD;
  float* sV = sK + TR * LD;
  float* sO = sV + TR * LD;
  float* sS = sO + TR * LD;  // the scores, then P in place
  float* sP = sS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * RW;
  const int qi = tile_index();
  if (qi >= tiles<D>(seq)) return;
  const size_t base = static_cast<size_t>(blockIdx.x) * seq * D;

  load_tile<D>(sQ, q + base, qi * TR, seq);
  for (int i = threadIdx.x; i < TR * LD; i += kThreads) sO[i] = 0.0f;
  float m[RW], l[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }

  const int nk = causal ? qi + 1 : tiles<D>(seq);
  for (int j = 0; j < nk; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<D>(sK, k + base, j * TR, seq);
    load_tile<D>(sV, v + base, j * TR, seq);
    __syncthreads();
    warp_mm<false, true, RW, TR>(sQ + r0 * LD, LD, sK, LD, sS + r0 * LS, LS, D, false);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = r0 + r, qp = qi * TR + row;
      float s[CL], mx = kNegInf;
#pragma unroll
      for (int h = 0; h < CL; ++h) {
        const int c = lane + 32 * h;
        s[h] = masked(sS[row * LS + c], scale, causal, qp, j * TR + c, seq);
        mx = fmaxf(mx, s[h]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float corr = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int h = 0; h < CL; ++h) {
        const float p = expf(s[h] - m_new);
        sum += p;
        sP[row * LS + lane + 32 * h] = p;
      }
      l[r] = l[r] * corr + warp_sum(sum);
      m[r] = m_new;
      for (int c = lane; c < D; c += 32) sO[row * LD + c] *= corr;
    }
    warp_mm<false, false, RW, D>(sP + r0 * LS, LS, sV, LD, sO + r0 * LD, LD, TR, true);
  }

  __syncwarp();
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = r0 + r, qp = qi * TR + row;
    if (qp >= seq) break;  // rows past S: the rest of the stripe too
    const float lr = fmaxf(l[r], 1e-30f);
    T* orow = o + base + static_cast<size_t>(qp) * D;
    for (int c = lane; c < D; c += 32) orow[c] = from_f32<T>(sO[row * LD + c] / lr);
    if (lane == 0) lse[static_cast<size_t>(blockIdx.x) * seq + qp] = m[r] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// K1: forward, float32, register-blocked (flash_fwd_f32), at head dims 128
// and 256. Replaces _fwd_kernel, torchft_tpu/ops/pallas/flash_attention.py:67
// (pallas_call at :115), for float32 at those head dims.
//
// Bound at B2 S2048 H16 D256 (causal): 68.7 GFLOP of products, 1.03 ms at
// the card's 67 float32 TFLOP/s, over 134 MB (0.04 ms): bound by
// operations. Float32 keeps float32 arithmetic (TF32 would miss the JAX
// bars), so the products are FMAs, and the design is about feeding them
// from shared memory, whose 128 bytes a cycle serve a warp's float4 load
// in four cycles against its FMA's quarter cycle: a lane must do about
// four FMAs per float it loads. A block is 256 threads (8 warps) over a
// q-tile of 8 RW rows (RW = kF32WarpRows, 16: 128 rows); Q stays in shared
// memory; K and V arrive in 32-key stages by cp.async, one buffer each, K
// of the next stage loading under this stage's softmax and P.V and V under
// the next stage's S (Q 128 rows, K, V and P^T: 212 KB at D 256, 116 KB
// at 128). Warp w owns query rows [RW w, RW w + RW) for everything, so
// nothing but K and V crosses warps:
//   S = Q.K^T: lane (y, x) = (lane / 8, lane % 8) computes the warp's rows
//   y, y + 4, ... (RW / 4 of them) against keys x, x + 8, x + 16, x + 24
//   from float4 loads along D (RW / 4 + 4 loads for 4 RW FMAs; 16-byte-odd
//   row strides keep neighbouring rows and keys on distinct banks); the
//   row's max and sum reduce over
//   its 8 lanes by shuffles, and P goes to shared memory transposed
//   ([key][row]);
//   O += P.V: lane l owns the warp's RW rows x columns 4l + 128h + e (h <
//   D / 128, e < 4), O in registers (128 a thread at D 256); a key costs
//   RW / 4 broadcast float4 loads of P and D / 128 float4 loads of V for
//   RW D / 32 FMAs; the rows' corrections come by shuffles.
// expf and the mask follow the FMA kernel (scale, then -1e30 where k_pos >
// q_pos or k_pos >= S; l clamped at 1e-30); tiles above the diagonal are
// never loaded; the heaviest q-tiles go first; rows and keys past S load
// as zeros (cp.async's source size 0) and rows past S are not written.
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 32;    // keys of a K or V stage
constexpr int kF32Threads = 256;
constexpr int kF32WarpRows = 16;  // query rows a warp owns (a block: 8 of it)

template <int D>
struct F32Fwd {
  static constexpr int RW = kF32WarpRows;
  static constexpr int ROWS = 8 * RW;           // query rows of a block
  static constexpr int SR = RW / 4;             // S rows a lane computes
  static constexpr int LD = D + 4;              // row stride of Q, K and V (floats)
  static constexpr int LP = ROWS + 4;           // row stride of P^T
  static constexpr int NV = D / 128;            // float4 column groups of O a lane owns
  static constexpr size_t kBytes =
      sizeof(float) * (ROWS * LD + 2 * kF32Keys * LD + kF32Keys * LP);
};

// 16 bytes from global to shared memory, asynchronously; `bytes` 0 fills
// the 16 bytes with zeros (a row past S)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + R) of a [S, D] float32 head into `dst` (row stride
// F32Fwd<D>::LD), rows past S as zeros; every thread of the block issues
// its share.
template <int D, int R>
__device__ __forceinline__ void f32_rows_async(float* dst, const float* __restrict__ src,
                                               int row0, int seq) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * kChunks; i += kF32Threads) {
    const int r = i / kChunks, c = 4 * (i % kChunks);
    const bool live = row0 + r < seq;
    cp_async16(dst + r * F32Fwd<D>::LD + c,
               src + (live ? static_cast<size_t>(row0 + r) * D + c : 0), live ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int seq, float scale, int causal) {
  using F = F32Fwd<D>;
  constexpr int RW = F::RW, ROWS = F::ROWS, SR = F::SR, LD = F::LD, LP = F::LP, NV = F::NV;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;                  // [ROWS][LD]
  float* sK = sQ + ROWS * LD;            // [kF32Keys][LD]
  float* sV = sK + kF32Keys * LD;        // [kF32Keys][LD]
  float* sPt = sV + kF32Keys * LD;       // [kF32Keys][LP]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int y = lane / 8, x = lane % 8;
  const int qi = (seq + ROWS - 1) / ROWS - 1 - static_cast<int>(blockIdx.y);
  const int q0 = qi * ROWS;                      // the tile's first row
  const int ra = RW * warp + y;                  // S rows ra + 4r (r < SR) of the tile
  const size_t base = static_cast<size_t>(blockIdx.x) * seq * D;
  const int last = (seq + kF32Keys - 1) / kF32Keys;
  const int nk = causal ? min((q0 + ROWS - 1) / kF32Keys + 1, last) : last;

  // cp.async groups, in order: {Q, K0}, {V0}, then for each stage j {K(j +
  // 1)} once every warp has its S and {V(j + 1)} once every warp has its
  // P.V (empty past the last stage): K loads under the softmax and P.V, V
  // under the next S
  f32_rows_async<D, ROWS>(sQ, q + base, q0, seq);
  f32_rows_async<D, kF32Keys>(sK, k + base, 0, seq);
  cp_async_commit();
  f32_rows_async<D, kF32Keys>(sV, v + base, 0, seq);
  cp_async_commit();

  float acc[RW][4 * NV];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < 4 * NV; ++c) acc[r][c] = 0.0f;
  float m[SR], l[SR];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
  }

  for (int j = 0; j < nk; ++j) {
    const int key0 = j * kF32Keys;
    cp_async_wait<1>();  // K(j) has landed (V(j) may still be in flight)
    __syncthreads();

    // S for rows ra + 4r and keys x + 8i
    float s[SR][4];
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[r][i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[SR];
#pragma unroll
      for (int r = 0; r < SR; ++r)
        a[r] = *reinterpret_cast<const float4*>(sQ + (ra + 4 * r) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + (x + 8 * i) * LD + d);
#pragma unroll
        for (int r = 0; r < SR; ++r)
          s[r][i] = fmaf(a[r].x, kv.x,
                         fmaf(a[r].y, kv.y, fmaf(a[r].z, kv.z, fmaf(a[r].w, kv.w, s[r][i]))));
      }
    }
    __syncthreads();  // every warp is done with K(j)
    if (j + 1 < nk) f32_rows_async<D, kF32Keys>(sK, k + base, key0 + kF32Keys, seq);
    cp_async_commit();

    // scale and mask (the diagonal's tiles and the ragged last one); the
    // rows' max and sum over their 8 lanes; P^T
    const bool mask = key0 + kF32Keys > seq || (causal && key0 + kF32Keys - 1 > q0);
    float corr[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const int qp = q0 + ra + 4 * r;
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = key0 + x + 8 * i;
        s[r][i] *= scale;
        if (mask && (kp >= seq || (causal && kp > qp))) s[r][i] = kNegInf;
        mx = fmaxf(mx, s[r][i]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      corr[r] = expf(m[r] - mn);
      m[r] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[r][i] - mn);
        sum += p;
        sPt[(x + 8 * i) * LP + ra + 4 * r] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr[r] + sum;
    }

    // O: the warp's RW rows (row g + 4r is S row r of lanes 8g),
    // corrected, += P.V
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float c = __shfl_sync(0xffffffffu, corr[r], 8 * g);
#pragma unroll
        for (int e = 0; e < 4 * NV; ++e) acc[g + 4 * r][e] *= c;
      }
    cp_async_wait<1>();  // V(j) has landed (K(j + 1) may still be in flight)
    __syncthreads();     // every thread's V(j) copies; P^T in place
    const float* pw = sPt + RW * warp;
#pragma unroll 2
    for (int kk = 0; kk < kF32Keys; ++kk) {
      float p[RW];
#pragma unroll
      for (int r4 = 0; r4 < RW / 4; ++r4) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + kk * LP + 4 * r4);
        p[4 * r4] = pv.x;
        p[4 * r4 + 1] = pv.y;
        p[4 * r4 + 2] = pv.z;
        p[4 * r4 + 3] = pv.w;
      }
#pragma unroll
      for (int h = 0; h < NV; ++h) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + kk * LD + 4 * lane + 128 * h);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          acc[r][4 * h] = fmaf(p[r], vv.x, acc[r][4 * h]);
          acc[r][4 * h + 1] = fmaf(p[r], vv.y, acc[r][4 * h + 1]);
          acc[r][4 * h + 2] = fmaf(p[r], vv.z, acc[r][4 * h + 2]);
          acc[r][4 * h + 3] = fmaf(p[r], vv.w, acc[r][4 * h + 3]);
        }
      }
    }
    __syncthreads();  // every warp is done with V(j) and P^T
    if (j + 1 < nk) f32_rows_async<D, kF32Keys>(sV, v + base, key0 + kF32Keys, seq);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // O / l and lse; rows past S are not written
  float lr[SR];
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    lr[r] = fmaxf(l[r], 1e-30f);
    if (x == 0 && q0 + ra + 4 * r < seq)
      lse[static_cast<size_t>(blockIdx.x) * seq + q0 + ra + 4 * r] = m[r] + logf(lr[r]);
  }
#pragma unroll
  for (int r = 0; r < SR; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float inv = 1.0f / __shfl_sync(0xffffffffu, lr[r], 8 * g);
      const int qp = q0 + RW * warp + g + 4 * r;
      if (qp >= seq) continue;
      float* orow = o + base + static_cast<size_t>(qp) * D;
#pragma unroll
      for (int h = 0; h < NV; ++h)
        *reinterpret_cast<float4*>(orow + 4 * lane + 128 * h) =
            make_float4(acc[g + 4 * r][4 * h] * inv, acc[g + 4 * r][4 * h + 1] * inv,
                        acc[g + 4 * r][4 * h + 2] * inv, acc[g + 4 * r][4 * h + 3] * inv);
    }
}

// ---------------------------------------------------------------------------
// K2: dQ, FMA. One block per (bh, q-tile); loops over k-tiles.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int seq, float scale, int causal) {
  using F = Fma<D>;
  constexpr int TR = F::TR, RW = F::RW, CL = F::CL, LD = F::LD, LS = F::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = sQ + TR * LD;
  float* sK = sDO + TR * LD;
  float* sV = sK + TR * LD;
  float* sAcc = sV + TR * LD;
  float* sS = sAcc + TR * LD;  // the scores, then dS in place
  float* sDS = sS;
  float* sDP = sS + TR * LS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * RW;
  const int qi = tile_index();
  if (qi >= tiles<D>(seq)) return;
  const size_t base = static_cast<size_t>(blockIdx.x) * seq * D;
  const size_t rbase = static_cast<size_t>(blockIdx.x) * seq;

  load_tile<D>(sQ, q + base, qi * TR, seq);
  load_tile<D>(sDO, dout + base, qi * TR, seq);
  for (int i = threadIdx.x; i < TR * LD; i += kThreads) sAcc[i] = 0.0f;

  const int nk = causal ? qi + 1 : tiles<D>(seq);
  for (int j = 0; j < nk; ++j) {
    __syncthreads();
    load_tile<D>(sK, k + base, j * TR, seq);
    load_tile<D>(sV, v + base, j * TR, seq);
    __syncthreads();
    warp_mm<false, true, RW, TR>(sQ + r0 * LD, LD, sK, LD, sS + r0 * LS, LS, D, false);
    warp_mm<false, true, RW, TR>(sDO + r0 * LD, LD, sV, LD, sDP + r0 * LS, LS, D, false);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = r0 + r, qp = qi * TR + row;
      // rows past S: zero dO, so zero dS (and never written)
      const float lse_r = qp < seq ? lse[rbase + qp] : 0.0f;
      const float delta_r = qp < seq ? delta[rbase + qp] : 0.0f;
#pragma unroll
      for (int h = 0; h < CL; ++h) {
        const int c = lane + 32 * h;
        const float s = masked(sS[row * LS + c], scale, causal, qp, j * TR + c, seq);
        const float p = expf(s - lse_r);
        sDS[row * LS + c] = p * (sDP[row * LS + c] - delta_r) * scale;
      }
    }
    warp_mm<false, false, RW, D>(sDS + r0 * LS, LS, sK, LD, sAcc + r0 * LD, LD, TR, true);
  }

  __syncwarp();
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = r0 + r, qp = qi * TR + row;
    if (qp >= seq) break;
    T* out = dq + base + static_cast<size_t>(qp) * D;
    for (int c = lane; c < D; c += 32) out[c] = from_f32<T>(sAcc[row * LD + c]);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV, FMA. One block per (bh, k-tile); loops over q-tiles.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int seq, float scale,
                     int causal) {
  using F = Fma<D>;
  constexpr int TR = F::TR, RW = F::RW, CL = F::CL, LD = F::LD, LS = F::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + TR * LD;
  float* sQ = sV + TR * LD;
  float* sDO = sQ + TR * LD;
  float* sDK = sDO + TR * LD;
  float* sDV = sDK + TR * LD;
  // P overwrites the scores and dS overwrites dP in place (each element
  // read and written by one thread): two score tiles, so that two blocks
  // fit an SM at D 128 (107 KB each)
  float* sS = sDV + TR * LD;
  float* sP = sS;
  float* sDP = sS + TR * LS;
  float* sDS = sDP;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * RW;
  const int kj = tile_index();
  const int nq = tiles<D>(seq);
  if (kj >= nq) return;
  const size_t base = static_cast<size_t>(blockIdx.x) * seq * D;

  load_tile<D>(sK, k + base, kj * TR, seq);
  load_tile<D>(sV, v + base, kj * TR, seq);
  for (int i = threadIdx.x; i < TR * LD; i += kThreads) {
    sDK[i] = 0.0f;
    sDV[i] = 0.0f;
  }

  for (int i = causal ? kj : 0; i < nq; ++i) {
    __syncthreads();  // every warp is done with the previous Q/dO/P/dS tiles
    load_tile<D>(sQ, q + base, i * TR, seq);
    load_tile<D>(sDO, dout + base, i * TR, seq);
    __syncthreads();
    // warp w: q rows [r0, r0 + RW) of this q-tile
    warp_mm<false, true, RW, TR>(sQ + r0 * LD, LD, sK, LD, sS + r0 * LS, LS, D, false);
    warp_mm<false, true, RW, TR>(sDO + r0 * LD, LD, sV, LD, sDP + r0 * LS, LS, D, false);
    const size_t rbase = static_cast<size_t>(blockIdx.x) * seq;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = r0 + r, qp = i * TR + row;
      // a query row past S adds nothing to dK and dV
      const bool live = qp < seq;
      const float lse_r = live ? lse[rbase + qp] : 0.0f;
      const float delta_r = live ? delta[rbase + qp] : 0.0f;
#pragma unroll
      for (int h = 0; h < CL; ++h) {
        const int c = lane + 32 * h;
        const float s = masked(sS[row * LS + c], scale, causal, qp, kj * TR + c, seq);
        const float p = live ? expf(s - lse_r) : 0.0f;
        sP[row * LS + c] = p;
        sDS[row * LS + c] = p * (sDP[row * LS + c] - delta_r) * scale;
      }
    }
    __syncthreads();  // P and dS of all q rows are in place
    // warp w: k rows [r0, r0 + RW): dV += P^T dO, dK += dS^T Q
    warp_mm<true, false, RW, D>(sP + r0, LS, sDO, LD, sDV + r0 * LD, LD, TR, true);
    warp_mm<true, false, RW, D>(sDS + r0, LS, sQ, LD, sDK + r0 * LD, LD, TR, true);
  }

  __syncwarp();
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = r0 + r, kp = kj * TR + row;
    if (kp >= seq) break;
    const size_t off = base + static_cast<size_t>(kp) * D;
    for (int c = lane; c < D; c += 32) {
      dk[off + c] = from_f32<T>(sDK[row * LD + c]);
      dv[off + c] = from_f32<T>(sDV[row * LD + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 K1, K2 and K3 for Hopper: TMA, mbarriers and wgmma, warp-specialised,
// templated on the head dim D (32, 64, 128 and 256).
//
// A block is consumer warpgroups (two, but one for K1 at D 32) and, but
// for K2 and K3 at D 128 and K1-K3 at D 256, a producer warpgroup that
// gives up its registers (setmaxnreg). One of the producer's threads (in
// the others, whichever consumer warp releases a stage last:
// release_stage) keeps a ring of tiles in flight with TMA, each
// stage completed on a "full" mbarrier and handed back on an "empty" one.
// Each consumer owns 64 rows of the block's tile, runs wgmma on the tiles
// that have arrived, and keeps its accumulators, running max and sum in
// registers for the whole loop. Tiles are stored as D/C column blocks of
// C columns ([D/C][rows][C], C = kCol<D>): C = 64 (128-byte rows, the
// 128-byte swizzle) at D 64, 128 and 256, C = 32 (64-byte rows, the 64-byte
// swizzle) at D 32, where a row is 64 bytes (see hopper.cuh); one tensor
// map format per head dim (box C x 64; K2's 32-key stages, a variant at
// D 256, take boxes of 32 rows) serves every tensor. A product
// over D (Q.K^T, dO.V^T) steps its K through the column blocks, one
// descriptor each, C/16 k16 steps of 32 bytes inside a row; a product
// whose N is D (P.V, dS.K, P^T.dO, dS^T.Q) is one m64nC product per
// column block (B MN-major, the transpose bit), each with an accumulator
// of its own.
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
// Registers: an SM's 65536 registers are four banks of 16384, one per
// scheduler, and warp w of a block runs on scheduler w % 4; ptxas holds a
// thread to what the fullest bank allows: 168 for 384 threads (3 warps a
// bank) and for 288 (warps 0, 4 and 8 share one), 255 for 256, setmaxnreg's
// 232 for the consumers notwithstanding (scripts/torch_regs_probe.py:
// wider variants spill at 168). At D 128 the accumulators of N = D double
// (O and dQ: 64 registers; dK and dV: 128), so K1 takes a stage's keys 64
// at a time (384 threads), while K2 and K3 are blocks of two consumer
// warpgroups and nothing else (256 threads), their consumer warps issuing
// the TMA loads: K3 at 250 registers, K2 taking a stage's 128 keys at once
// (S 64 + dP 64 + dQ 64 + dS 32 registers). A K1 of 256 threads taking 128
// keys at once was no faster on the card (PERF.md). At D 256 O alone is
// 128 registers and dK + dV 256: K1 takes D 128's layout in 256 threads
// with 64-key stages (the ring and 128 query rows fill 192 KB), K2 takes
// 128 query rows of Q and dO (128 KB) and one 64-key stage (see K2), and
// K3's two consumers split D (each owns the block's 64 keys and half of
// dK's and dV's columns: dkv_tile). At D 32 registers are
// no limit (O and dQ 16, dK and dV 32) and the path's S of 128 gives a
// block one or two tiles to visit, so the ring never fills and a block's
// time is its chain of latencies: K2 and K3 keep D 64's layout (384
// threads), whose producer issues every load of such a block before the
// consumers' first wgmma, and K1 is one consumer of 64 query rows. K3 in
// D 128's 256 threads (the first consumer thread loading) and K2 taking
// 128 keys at once (spills at 168 registers) were both slower at D 32 on
// the card (PERF.md).
//
// Determinism: every output element is computed by one block in a fixed
// order, with no split over keys and no atomics.
// ---------------------------------------------------------------------------

constexpr int kWg = 128;           // threads of a warpgroup
constexpr int kBox = 64;           // rows of one TMA box
constexpr int kStages = 2;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// Columns of one column block (and of one TMA box): 64 bf16, 128-byte rows
// under the 128-byte swizzle, at head dims 64 and 128; 32 bf16, 64-byte
// rows under the 64-byte swizzle, at 32 (see hopper.cuh).
template <int D>
constexpr int kCol = D == 32 ? 32 : 64;
// k16 steps of a K-major product over one column block
template <int D>
constexpr int kKSteps = kCol<D> / 16;
// descriptor advance (16-byte units) of an MN-major operand per k16 step:
// 16 rows of one column block
template <int D>
constexpr int kMnStep = 16 * kCol<D> * static_cast<int>(sizeof(bf16)) / 16;

// Column block h of a tile of R rows: R rows of kCol<D> bf16.
template <int D, int R>
__device__ __forceinline__ bf16* col_block(bf16* tile, int h) {
  return tile + h * R * kCol<D>;
}

// wgmma descriptor of a tile in head dim D's swizzle
template <int D>
__device__ __forceinline__ uint64_t desc(const void* p) {
  return D == 32 ? hopper::desc_sw64(p) : hopper::desc_sw128(p);
}

// Bytes of R rows of a [BH, S, D] bf16 tensor.
template <int D, int R>
constexpr uint32_t kRowsBytes = R * D * sizeof(bf16);

// Rows of the TMA box of a map whose tiles are R rows: 64 (kBox), or R
// where a tile is shorter (K2's 32-key stages at head dim 256).
template <int R>
constexpr int kBoxRows = R < kBox ? R : kBox;

// TMA-load rows [row0, row0 + R) of a [BH, S, D] tensor into `tile`
// (R/BR boxes of BR rows per column block; the map's box has BR rows),
// completing kRowsBytes<D, R> on `bar`.
template <int D, int R, int BR = kBox>
__device__ __forceinline__ void load_rows(bf16* tile, const CUtensorMap* map, int row0, int bh,
                                          uint64_t* bar) {
  static_assert(R % BR == 0, "a tile is whole boxes");
#pragma unroll
  for (int h = 0; h < D / kCol<D>; ++h)
#pragma unroll
    for (int b = 0; b < R / BR; ++b)
      hopper::tma_load(col_block<D, R>(tile, h) + b * BR * kCol<D>, map, h * kCol<D>,
                       row0 + b * BR, bh, bar);
}

// TMA-store 64 rows (`rows`: their place in column block 0 of an R-row
// tile) to rows [row0, row0 + 64) of a [BH, S, D] tensor.
template <int D, int R>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, bf16* rows, int row0,
                                           int bh) {
#pragma unroll
  for (int h = 0; h < D / kCol<D>; ++h)
    hopper::tma_store(map, col_block<D, R>(rows, h), h * kCol<D>, row0, bh);
}

// Round a warpgroup's 64 x C float32 accumulator (N = C/2 registers; C 64
// or 32, a column block) to bf16 and write it to `tile` in the swizzled
// layout that a TMA store reads: 16-byte chunk c of row r at c ^ (r % 8)
// in 128-byte rows, at c ^ ((r / 2) % 4) in 64-byte rows (rows r0 and
// r0 + 8 share it in both).
template <int N>
__device__ __forceinline__ void stage_tile(bf16* tile, const float (&acc)[N], float s0,
                                           float s1, int r0) {
  constexpr int kRowBytes = 2 * N * static_cast<int>(sizeof(bf16));
  static_assert(kRowBytes == 128 || kRowBytes == 64, "a column block is 64 or 32 bf16");
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  const int t = threadIdx.x % 4;
  const int sw = kRowBytes == 128 ? (r0 & 7) : ((r0 >> 1) & 3);
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const int off = ((c ^ sw) << 4) + (t << 2);
    *reinterpret_cast<uint32_t*>(base + r0 * kRowBytes + off) =
        hopper::pack_bf16(acc[4 * c] * s0, acc[4 * c + 1] * s0);
    *reinterpret_cast<uint32_t*>(base + (r0 + 8) * kRowBytes + off) =
        hopper::pack_bf16(acc[4 * c + 2] * s1, acc[4 * c + 3] * s1);
  }
}

// Hand a ring stage back where the consumer warps load the ring themselves
// (no producer warpgroup): each warp arrives once on the stage's "empty"
// barrier, and the last of the block's kWarps warps to do so (a shared
// count of the stage's releases, ever) issues its next load: that whole
// warp calls `refill(lane)`.
template <int kWarps, typename Refill>
__device__ __forceinline__ void release_stage(uint64_t* empty, uint32_t* released,
                                              Refill&& refill) {
  __syncwarp();
  uint32_t last = 0;
  if (threadIdx.x % 32 == 0) {
    hopper::mbar_arrive(empty);
    last = atomicAdd(released, 1u) % kWarps == kWarps - 1;
  }
  if (__shfl_sync(0xffffffffu, last, 0)) refill(static_cast<int>(threadIdx.x % 32));
  __syncwarp();
}

// ---------------------------------------------------------------------------
// K1 forward, bf16. Replaces _fwd_kernel, torchft_tpu/ops/pallas/
// flash_attention.py:67 (pallas_call at :115).
//
// Bound at the headline shapes (B8 S1024 H8 D64, causal): 33.8 MB moved,
// 0.010 ms at 3.35 TB/s; 8.6 GFLOP of causal products, 0.0087 ms at
// 989 TFLOP/s: the two are close. At the Llama-2-7B shapes (B2 S4096 H32
// D128) the products are 275 GFLOP (0.278 ms) over 134 MB: bound by
// operations. At train_bytes' (B8 S128 H4 D32) 1.07 MB (0.0003 ms) over
// 0.03 GFLOP: bound by bytes, and so small that a block's chain of
// latencies sets the time. The design: one block per (bh, q-tile of 64
// rows per consumer warpgroup); Q loaded once; K/V streamed by TMA
// through a two-stage ring of 128-key tiles, so the next tile loads while
// this one is computed; S = Q.K^T (K-major operands in shared memory;
// m64n128 at D 32 and 64, two m64n64 key halves at D 128) and O += P.V
// (P from registers, V MN-major) on wgmma, with S, P, O, the running max
// and sum all in registers (no score tile in shared memory); exp2 with
// scale.log2(e) folded into one multiply; only the first tile visited (the
// diagonal, or the ragged last one) pays for the mask, tiles above the
// diagonal are never loaded and key halves above a consumer's rows are
// skipped; the heaviest q-tiles (most key tiles) are scheduled first; O
// leaves through shared memory and a TMA store. Two consumers (128-row
// q-tiles) at D 64 and 128; one at D 32, where S 128 leaves a block one
// K/V tile: 64-row blocks (twice the blocks, 256 threads) each run one
// Q load, one K/V load, one S, one softmax, one P.V and the store, and
// were 15% faster than 128-row ones on the card (PERF.md). At D 256 (B2
// S2048 H16: 68.7 GFLOP of causal products, 0.0695 ms, over 134 MB) O is
// 128 registers, S 32 and P's fragments 16: a producer warpgroup's 168
// would spill, so the block is the two consumers alone (256 threads, the
// last warp to release a stage loading its next tile, as K2 at D 128),
// and a stage holds 64 keys (Q's 128 rows and two stages of K and V are
// 192 KB). A stage of 64 keys makes the diagonal two tiles, so the mask
// is chosen per chunk: one that holds a key past S or past one of the
// consumer's rows.
// ---------------------------------------------------------------------------

// keys a consumer takes at once (S holds KC/2 registers); the consumer
// warpgroups of a block (64 query rows each); the keys of a ring stage;
// the threads of the producer warpgroup (0: the consumer warps load the
// ring)
template <int D>
constexpr int kFwdKeys = D >= 128 ? 64 : 128;
template <int D>
constexpr int kFwdCons = D == 32 ? 1 : 2;
template <int D>
constexpr int kFwdStageKeys = D == 256 ? 64 : 128;
template <int D>
constexpr int kFwdProducer = D == 256 ? 0 : kWg;

template <int D, int QR>
struct FwdSmem {
  static constexpr int KS = kFwdStageKeys<D>;
  alignas(1024) bf16 q[QR * D];  // rows 64c..64c+63: consumer c
  alignas(1024) bf16 k[kStages][KS * D];
  alignas(1024) bf16 v[kStages][KS * D];
  uint64_t q_full;
  uint64_t kv_full[kStages];
  uint64_t kv_empty[kStages];
  uint32_t released[kStages];  // warps that released the stage, ever (no producer)
};

template <int D, int KC = kFwdKeys<D>, int NC = kFwdCons<D>>
__global__ void __launch_bounds__(NC * kWg + kFwdProducer<D>, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o, float* __restrict__ lse,
                    int seq, float scale_log2, int causal) {
  using namespace hopper;
  // QR: the block's query rows; KS: a stage's keys
  constexpr int NH = D / kCol<D>, QR = NC * kBox, KS = kFwdStageKeys<D>;
  constexpr int kPT = kFwdProducer<D>;
  // the "empty" barriers count consumer threads, or warps where the
  // consumers load
  constexpr int kWarps = NC * kWg / 32;
  extern __shared__ unsigned char smem_raw[];
  FwdSmem<D, QR>& sm = aligned_smem<FwdSmem<D, QR>>(smem_raw);
  const int bh = blockIdx.x;
  const int qi = (seq + QR - 1) / QR - 1 - static_cast<int>(blockIdx.y);  // heaviest first
  // key tiles (KS keys) to visit: up to the one holding the last query row
  // (causal), and none wholly past seq
  const int last = (seq + KS - 1) / KS;
  const int nk = causal ? min((qi * QR + QR - 1) / KS + 1, last) : last;
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.kv_empty[s], kPT > 0 ? NC * kWg : kWarps);
      sm.released[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Q once; the it-th K/V tile visited (tile nk - 1 - it, from the
  // diagonal down) into stage it % kStages, once the consumers have
  // released the tile kStages before it
  const auto load_q = [&] {
    tma_prefetch(&map_q);
    tma_prefetch(&map_k);
    tma_prefetch(&map_v);
    mbar_expect_tx(&sm.q_full, kRowsBytes<D, QR>);
    load_rows<D, QR>(sm.q, &map_q, qi * QR, bh, &sm.q_full);
  };
  const auto load_kv = [&](int it) {
    const int j = nk - 1 - it, st = it % kStages;
    mbar_wait(&sm.kv_empty[st], ((it / kStages) & 1) ^ 1);
    mbar_expect_tx(&sm.kv_full[st], 2 * kRowsBytes<D, KS>);
    load_rows<D, KS>(sm.k[st], &map_k, j * KS, bh, &sm.kv_full[st]);
    load_rows<D, KS>(sm.v[st], &map_v, j * KS, bh, &sm.kv_full[st]);
  };

  if (kPT > 0 && wg == 0) {
    // ---- producer warpgroup: every load from its first thread ----
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      load_q();
      for (int it = 0; it < nk; ++it) load_kv(it);
    }
  } else {
    // ---- consumers: 64 query rows each ----
    if constexpr (kPT > 0) regs_alloc<kConsumerRegs>();
    const int cw = kPT > 0 ? wg - 1 : wg, tid = threadIdx.x % kWg;
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int r0 = warp * 16 + lane / 4;          // rows r0 and r0 + 8 of the 64
    const int row0 = qi * QR + cw * kBox;         // sequence position of the first row
    const int qrow = row0 + r0;                   // sequence position of row r0
    bf16* q_rows = sm.q + cw * kBox * kCol<D>;
    // without a producer, the first thread loads Q and the ring's first
    // stages, and each stage is refilled by the last warp to release it
    if (kPT == 0 && threadIdx.x == 0) {
      load_q();
      for (int it = 0; it < min(nk, kStages); ++it) load_kv(it);
    }

    float o[NH][kCol<D> / 2];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < kCol<D> / 2; ++i) o[h][i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;  // l: this thread's part

    mbar_wait(&sm.q_full, 0);
    for (int it = 0; it < nk; ++it) {
      const int j = nk - 1 - it, st = it % kStages;
      mbar_wait(&sm.kv_full[st], (it / kStages) & 1);

#pragma unroll
      for (int c = 0; c < KS / KC; ++c) {
        const int key0 = j * KS + c * KC;  // first key of the chunk
        // every key past seq, or past every query row of this consumer; the
        // first chunk taken always holds a key each row may see
        if (key0 >= seq || (causal && key0 > row0 + kBox - 1)) continue;
        // scale (log2 domain); mask a chunk that holds a key past seq or
        // (causal) past one of this consumer's rows: the diagonal's, or
        // the ragged last one, which is the first visited
        const bool mask = key0 + KC > seq || (causal && key0 + KC - 1 > row0);
        float s[KC / 2];
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t q_desc = desc<D>(col_block<D, QR>(q_rows, h));
          const uint64_t k_desc = desc<D>(col_block<D, KS>(sm.k[st], h) + c * KC * kCol<D>);
#pragma unroll
          for (int kk = 0; kk < kKSteps<D>; ++kk)
            wgmma_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, h + kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int cc = 0; cc < KC / 8; ++cc) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float a = s[4 * cc + e] * scale_log2, b = s[4 * cc + 2 + e] * scale_log2;
            if (mask) {
              const int col = key0 + 8 * cc + 2 * t + e;
              if (col >= seq || (causal && col > qrow)) a = kNegInf;
              if (col >= seq || (causal && col > qrow + 8)) b = kNegInf;
            }
            s[4 * cc + e] = a;
            s[4 * cc + 2 + e] = b;
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
        uint32_t pa[KC / 16][4];
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int cc = 0; cc < KC / 8; ++cc) {
          const float p0 = exp2f(s[4 * cc] - mn0), p1 = exp2f(s[4 * cc + 1] - mn0);
          const float p2 = exp2f(s[4 * cc + 2] - mn1), p3 = exp2f(s[4 * cc + 3] - mn1);
          sum0 += p0 + p1;
          sum1 += p2 + p3;
          pa[cc / 2][(cc % 2) * 2] = pack_bf16(p0, p1);
          pa[cc / 2][(cc % 2) * 2 + 1] = pack_bf16(p2, p3);
        }
        l0 = l0 * corr0 + sum0;
        l1 = l1 * corr1 + sum1;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
#pragma unroll
          for (int c8 = 0; c8 < kCol<D> / 8; ++c8) {
            o[h][4 * c8] *= corr0;
            o[h][4 * c8 + 1] *= corr0;
            o[h][4 * c8 + 2] *= corr1;
            o[h][4 * c8 + 3] *= corr1;
          }
          fence_regs(o[h]);
        }

        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t v_desc = desc<D>(col_block<D, KS>(sm.v[st], h) + c * KC * kCol<D>);
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk)
            wgmma_rs_tb(o[h], pa[kk], v_desc + kMnStep<D> * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < NH; ++h) fence_regs(o[h]);
      }
      if constexpr (kPT > 0) {
        mbar_arrive(&sm.kv_empty[st]);
      } else {
        release_stage<kWarps>(&sm.kv_empty[st], &sm.released[st], [&](int l) {
          if (l == 0 && it + kStages < nk) load_kv(it + kStages);
        });
      }
    }

    // ---- epilogue: O / l through shared memory (this warpgroup's Q rows,
    // no longer read) and TMA stores, which drop rows past seq; lse ----
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    warpgroup_sync(1 + cw);
#pragma unroll
    for (int h = 0; h < NH; ++h)
      stage_tile(col_block<D, QR>(q_rows, h), o[h], 1.0f / l0, 1.0f / l1, r0);
    fence_async_smem();
    warpgroup_sync(1 + cw);
    if (tid == 0) {
      store_rows<D, QR>(&map_o, q_rows, row0, bh);
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
// two are close; at the Llama-2-7B shapes 412 GFLOP (0.417 ms), bound by
// operations; at train_bytes' (B8 S128 H4 D32) 1.34 MB (0.0004 ms) over 0.05
// GFLOP: bound by bytes, and so small that a block's chain of latencies
// (TMA round trips, barrier handoffs, a few wgmmas, the store) sets the
// time. The design is K1's: one block per (bh, 128-row q-tile), the
// heaviest first; Q and dO loaded once; K and V streamed by TMA through a
// two-stage ring from the diagonal down (tiles above it are never loaded).
// Each consumer (64 query rows) takes a stage's keys KC at a time and
// skips a chunk that lies past seq or, under the causal mask, past all of
// its rows. Per chunk it computes S = Q.K^T and dP = dO.V^T on wgmma (both
// operands K-major), then P = exp2(S.scale.log2(e) - lse.log2(e)) and
// dS = P (dP - delta) scale in registers, with lse and delta of its two
// rows held for the whole loop; dS is rounded to bf16 and packed straight
// into the A fragments of dQ += dS.K, which reads K MN-major from the same
// stage (the layout K1 uses for V). Neither S, dP, dS nor dQ touches
// shared memory until dQ leaves through the warpgroup's own Q rows and TMA
// stores. Only the first tile visited (the diagonal, or the ragged last
// one) is masked. No split over keys and no atomics: dQ is bitwise
// reproducible.
//
// At D 32 and 64 a block is a producer warpgroup and two consumers (384
// threads, 168 registers), and a consumer takes 64 keys at once. At D 128,
// where dQ alone is 64 registers, a block is the two consumers alone (256
// threads, the last warp to release a stage loading its next tile), each
// taking a stage's 128 keys at once (m64n128 products for S and dP: half
// the tensor-core drains of 64-key halves), and P.scale is one FFMA and
// one MUFU. On the card (PERF.md, scripts/torch_flash_variants.py) its
// time sits well above the products alone and the elementwise work
// alone, each near a "loads alone" floor of the TMA ring, barriers and
// stores; Q and dO as register operands, three consumers, 64-key stages,
// clusters sharing K/V by multicast, turns between the consumers, one
// commit group for a chunk's products and the previous chunk's dQ, and
// dS computed under a wgmma in flight (which ptxas serialised) were each
// no faster.
//
// At D 256 (B2 S2048 H16: 103 GFLOP of causal products, 0.104 ms at 989
// TFLOP/s, over 168 MB) dQ is 128 registers a thread, so the block is the
// two consumers alone as at 128, and shared memory sets the rest: Q and dO
// of 128 query rows are 128 KB and a K+V stage of 64 keys 64 KB, so two
// such stages (256 KB) do not fit the 227 KB. The ring is one 64-key stage
// (192 KB), refilled by the last warp to release it, and a consumer takes
// its 64 keys at once (S and dP m64n64, 32 registers each; 220 in all, 0
// spills). A chunk holding a key past S or past one of the consumer's rows
// is masked (the diagonal spans two stages). On the card
// (scripts/torch_flash_variants.py, PERF.md) the stage taken as two
// 32-key chunks was 10% slower, and rings of two or three 32-key stages,
// whose next stage loads under this one's products, 18%.
// ---------------------------------------------------------------------------

// K2's layout, by head dim: the threads of the producer warpgroup (0: the
// consumer warps load the K/V ring), the keys of a ring stage and the
// ring's stages, the keys a consumer takes at once (S and dP hold KC/2
// registers each), and whether P.scale is one FFMA and one MUFU an element
// (the scale folded into the exponent, results below 2^-126 flushed to
// zero; D 32 and 64 keep exp2f and their numerics).
template <int D>
constexpr int kDqProducer = D >= 128 ? 0 : kWg;
template <int D>
constexpr int kDqStageKeys = D == 256 ? 64 : 128;
template <int D>
constexpr int kDqStages = D == 256 ? 1 : kStages;
template <int D>
constexpr int kDqKeys = D == 128 ? 128 : 64;
template <int D>
constexpr bool kDqOneMufu = D >= 128;

template <int D, int KS = kDqStageKeys<D>, int NS = kDqStages<D>>
struct DqSmem {
  alignas(1024) bf16 q[128 * D];  // rows 0-63: consumer 0, 64-127: consumer 1
  alignas(1024) bf16 dout[128 * D];
  alignas(1024) bf16 k[NS][KS * D];
  alignas(1024) bf16 v[NS][KS * D];
  uint64_t qdo_full;
  uint64_t kv_full[NS];
  uint64_t kv_empty[NS];
  uint32_t released[NS];  // warps that released the stage, ever (no producer)
};

template <int D, int KC = kDqKeys<D>, int KS = kDqStageKeys<D>, int NS = kDqStages<D>>
__global__ void __launch_bounds__(2 * kWg + kDqProducer<D>, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_dq,
                   const float* __restrict__ lse, const float* __restrict__ delta, int seq,
                   float scale, float scale_log2, int causal) {
  using namespace hopper;
  constexpr int NH = D / kCol<D>, kPT = kDqProducer<D>;
  // the "empty" barriers count consumer threads, or warps where the
  // consumers load
  constexpr int kWarps = 2 * kWg / 32;
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D, KS, NS>& sm = aligned_smem<DqSmem<D, KS, NS>>(smem_raw);
  const int bh = blockIdx.x;
  const int qi = (seq + 127) / 128 - 1 - static_cast<int>(blockIdx.y);  // heaviest first
  // key tiles (KS keys) to visit: up to the one holding the last query row
  // (causal), and none wholly past seq
  const int last = (seq + KS - 1) / KS;
  const int nk = causal ? min((qi * 128 + 127) / KS + 1, last) : last;
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qdo_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.kv_empty[s], kPT > 0 ? 2 * kWg : kWarps);
      sm.released[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Q and dO once; the it-th K/V tile visited (tile nk - 1 - it, from the
  // diagonal down) into stage it % NS, once the consumers have released
  // the tile NS before it (K and V maps with boxes of min(KS, 64) rows)
  const auto load_qdo = [&] {
    tma_prefetch(&map_q);
    tma_prefetch(&map_do);
    tma_prefetch(&map_k);
    tma_prefetch(&map_v);
    mbar_expect_tx(&sm.qdo_full, 2 * kRowsBytes<D, 128>);
    load_rows<D, 128>(sm.q, &map_q, qi * 128, bh, &sm.qdo_full);
    load_rows<D, 128>(sm.dout, &map_do, qi * 128, bh, &sm.qdo_full);
  };
  const auto load_kv = [&](int it) {
    const int j = nk - 1 - it, st = it % NS;
    mbar_wait(&sm.kv_empty[st], ((it / NS) & 1) ^ 1);
    mbar_expect_tx(&sm.kv_full[st], 2 * kRowsBytes<D, KS>);
    load_rows<D, KS, kBoxRows<KS>>(sm.k[st], &map_k, j * KS, bh, &sm.kv_full[st]);
    load_rows<D, KS, kBoxRows<KS>>(sm.v[st], &map_v, j * KS, bh, &sm.kv_full[st]);
  };

  if (kPT > 0 && wg == 0) {
    // ---- producer warpgroup: every load from its first thread ----
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      load_qdo();
      for (int it = 0; it < nk; ++it) load_kv(it);
    }
  } else {
    // ---- consumers: 64 query rows each ----
    if constexpr (kPT > 0) regs_alloc<kConsumerRegs>();
    const int cw = kPT > 0 ? wg - 1 : wg, tid = threadIdx.x % kWg;
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
    const int r0 = warp * 16 + lane / 4;          // rows r0 and r0 + 8 of the 64
    const int row0 = qi * 128 + cw * kBox;        // sequence position of the first row
    const int qrow = row0 + r0;                   // sequence position of row r0
    bf16* q_rows = sm.q + cw * kBox * kCol<D>;
    bf16* do_rows = sm.dout + cw * kBox * kCol<D>;
    // without a producer, the first thread loads Q, dO and the ring's first
    // stages, and each stage is refilled by the last warp to release it
    if (kPT == 0 && threadIdx.x == 0) {
      load_qdo();
      for (int it = 0; it < min(nk, NS); ++it) load_kv(it);
    }
    const auto release = [&](int it) {
      const int st = it % NS;
      if constexpr (kPT > 0) {
        mbar_arrive(&sm.kv_empty[st]);
      } else {
        release_stage<kWarps>(&sm.kv_empty[st], &sm.released[st], [&](int l) {
          if (l == 0 && it + NS < nk) load_kv(it + NS);
        });
      }
    };

    // lse (log2 domain) and delta of the thread's two rows; rows past seq
    // are not read (their Q and dO rows are zero-filled and their dQ rows
    // are dropped by the store)
    const float* lse_bh = lse + static_cast<size_t>(bh) * seq;
    const float* delta_bh = delta + static_cast<size_t>(bh) * seq;
    const float lse0 = qrow < seq ? lse_bh[qrow] * kLog2e : 0.0f;
    const float lse1 = qrow + 8 < seq ? lse_bh[qrow + 8] * kLog2e : 0.0f;
    const float dl0 = qrow < seq ? delta_bh[qrow] : 0.0f;
    const float dl1 = qrow + 8 < seq ? delta_bh[qrow + 8] : 0.0f;
    // the one-MUFU form's exponent offsets: lse.log2(e) - log2(scale)
    const float lsc0 = lse0 - log2f(scale), lsc1 = lse1 - log2f(scale);

    float dq[NH][kCol<D> / 2];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < kCol<D> / 2; ++i) dq[h][i] = 0.0f;

    mbar_wait(&sm.qdo_full, 0);
    for (int it = 0; it < nk; ++it) {
      const int j = nk - 1 - it, st = it % NS;
      mbar_wait(&sm.kv_full[st], (it / NS) & 1);

#pragma unroll
      for (int c = 0; c < KS / KC; ++c) {
        const int key0 = j * KS + c * KC;  // first key of the chunk
        // every key past seq, or past every query row of this consumer
        if (key0 >= seq || (causal && key0 > row0 + kBox - 1)) continue;
        // mask a chunk that holds a key past seq or (causal) past one of
        // this consumer's rows: the diagonal's, or the ragged last one
        const bool mask = key0 + KC > seq || (causal && key0 + KC - 1 > row0);
        float s[KC / 2], dp[KC / 2];
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t q_desc = desc<D>(col_block<D, 128>(q_rows, h));
          const uint64_t k_desc = desc<D>(col_block<D, KS>(sm.k[st], h) + c * KC * kCol<D>);
#pragma unroll
          for (int kk = 0; kk < kKSteps<D>; ++kk)
            wgmma_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, h + kk);
        }
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t do_desc = desc<D>(col_block<D, 128>(do_rows, h));
          const uint64_t v_desc = desc<D>(col_block<D, KS>(sm.v[st], h) + c * KC * kCol<D>);
#pragma unroll
          for (int kk = 0; kk < kKSteps<D>; ++kk)
            wgmma_ss(dp, do_desc + 2 * kk, v_desc + 2 * kk, h + kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // dS = exp2(s.scale.log2(e) - lse.log2(e)) (dP - delta) scale,
        // rounded to bf16 in pairs: the A fragments of dS.K; the first
        // tile visited is masked (keys past seq, and past the query under
        // the causal mask)
        uint32_t da[KC / 16][4];
#pragma unroll
        for (int cc = 0; cc < KC / 8; ++cc) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (kDqOneMufu<D>) {
              float a = fmaf(s[4 * cc + e], scale_log2, -lsc0);
              float b = fmaf(s[4 * cc + 2 + e], scale_log2, -lsc1);
              if (mask) {
                const int col = key0 + 8 * cc + 2 * t + e;
                if (col >= seq || (causal && col > qrow)) a = kNegInf;
                if (col >= seq || (causal && col > qrow + 8)) b = kNegInf;
              }
              d[e] = exp2_ftz(a) * (dp[4 * cc + e] - dl0);
              d[2 + e] = exp2_ftz(b) * (dp[4 * cc + 2 + e] - dl1);
            } else {
              float a = s[4 * cc + e] * scale_log2, b = s[4 * cc + 2 + e] * scale_log2;
              if (mask) {
                const int col = key0 + 8 * cc + 2 * t + e;
                if (col >= seq || (causal && col > qrow)) a = kNegInf;
                if (col >= seq || (causal && col > qrow + 8)) b = kNegInf;
              }
              d[e] = exp2f(a - lse0) * (dp[4 * cc + e] - dl0) * scale;
              d[2 + e] = exp2f(b - lse1) * (dp[4 * cc + 2 + e] - dl1) * scale;
            }
          }
          da[cc / 2][(cc % 2) * 2] = pack_bf16(d[0], d[1]);
          da[cc / 2][(cc % 2) * 2 + 1] = pack_bf16(d[2], d[3]);
        }

#pragma unroll
        for (int h = 0; h < NH; ++h) fence_regs(dq[h]);
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t k_desc = desc<D>(col_block<D, KS>(sm.k[st], h) + c * KC * kCol<D>);
#pragma unroll
          for (int kk = 0; kk < KC / 16; ++kk)
            wgmma_rs_tb(dq[h], da[kk], k_desc + kMnStep<D> * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int h = 0; h < NH; ++h) fence_regs(dq[h]);
      }
      release(it);
    }

    // ---- epilogue: dQ through this warpgroup's Q rows (no longer read)
    // and TMA stores, which drop rows past seq ----
    warpgroup_sync(1 + cw);
#pragma unroll
    for (int h = 0; h < NH; ++h)
      stage_tile(col_block<D, 128>(q_rows, h), dq[h], 1.0f, 1.0f, r0);
    fence_async_smem();
    warpgroup_sync(1 + cw);
    if (tid == 0) {
      store_rows<D, 128>(&map_dq, q_rows, qi * 128 + cw * kBox, bh);
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
// by operations; at the Llama-2-7B shapes 550 GFLOP (0.556 ms); at
// train_bytes' (B8 S128 H4 D32) 1.61 MB (0.0005 ms) over 0.07 GFLOP: bound
// by bytes, and as for K2 a block's chain of latencies sets the time. The
// design: one block per (bh, key tile of 64 keys per consumer), K and V
// resident in shared memory; 64-row Q and dO tiles and their 64 lse and
// delta values stream through a ring (at D 32 and 64 the producer
// warpgroup loads it, two stages; at D 128 see below); each
// consumer (64 keys) computes the transposed scores S^T = K.Q^T and
// dP^T = V.dO^T on wgmma (both operands K-major), a tile's 64 queries at
// once, so P^T and dS^T land in registers
// with rows = keys, the rows its dK and dV accumulators own; then
// dV += P^T.dO and dK += dS^T.Q take P^T and dS^T from registers and dO /
// Q MN-major from shared memory. Neither P nor dS touches shared memory.
// The loop starts at the diagonal q-tile; the heaviest key tiles (the
// first ones, under the causal mask) are scheduled first. dQ stays in K2:
// folding it in with atomic adds would make the result depend on the
// order of arrival.
//
// At D 128 dK and dV alone are 128 registers a thread (250 in all at 64
// queries a product), so the block is the two consumers alone (256
// threads, up to 255 registers each): the last warp to release a stage of
// the three-stage ring loads its next tile, and P^T is one FFMA and one
// MUFU an element (at D 32 too). A block owns 128
// keys, and each Q/dO tile streamed serves both consumers; while one
// consumer computes P^T and dS^T, the other's products keep the tensor
// cores busy. Where 128 does not divide S, the last block's keys run past
// S (its second consumer may have none): TMA zero-fills them and drops
// their stores. At D 128 any S is taken: the q-tiles number ceil(S / 64),
// and the last one's queries past S have zero Q and dO rows and lse 1e30
// (load_qdo), so they add exactly nothing.
//
// At D 256 (B2 S2048 H16: 137 GFLOP of causal products, 0.139 ms) dK and
// dV of 64 keys are 256 registers a thread: one warpgroup cannot hold
// them. The two consumers split D instead (kDkvSplit): both own the
// block's 64 keys (the grid is BH x ceil(S / 64), the heaviest first),
// consumer c the columns [128c, 128c + 128) of dK and dV (128 registers).
// Both compute S^T and dP^T over all 256 columns, 1.5 times the block's
// products but no exchange between them (dkv_tile); K and V are 64
// KB and the two-stage Q/dO ring 128 KB. The epilogue waits for both
// consumers before it overwrites K and V with dK and dV.
// ---------------------------------------------------------------------------

// The block's consumer warpgroups (64 keys each); the queries a consumer
// takes at once (S^T and dP^T hold kDkvQueries/2 registers each); the
// threads of the producer warpgroup (0: the consumer warps load); the
// stages of the Q/dO ring.
// At D 256 the two consumers split D (kDkvSplit): both own the block's
// 64 keys, consumer c the dK and dV columns [128c, 128c + 128).
constexpr int kDkvCons = 2;
constexpr int kDkvQueries = 64;
static_assert(kDkvQueries == kBox, "a q-tile of the ring is one product's queries");
template <int D>
constexpr bool kDkvSplit = D == 256;
template <int D>
constexpr int kDkvKeys = kDkvSplit<D> ? kBox : kDkvCons * kBox;  // the block's keys
template <int D>
constexpr int kDkvProducer = D >= 128 ? 0 : kWg;
template <int D>
constexpr int kDkvStages = D == 128 ? 3 : kStages;

template <int D>
struct DkvSmem {
  alignas(1024) bf16 k[kDkvKeys<D> * D];  // keys 64c..64c+63: consumer c (split: all)
  alignas(1024) bf16 v[kDkvKeys<D> * D];
  alignas(1024) bf16 q[kDkvStages<D>][kBox * D];
  alignas(1024) bf16 dout[kDkvStages<D>][kBox * D];
  float lse[kDkvStages<D>][kBox];
  float delta[kDkvStages<D>][kBox];
  uint64_t kv_full;
  uint64_t full[kDkvStages<D>];
  uint64_t empty[kDkvStages<D>];
  uint32_t released[kDkvStages<D>];  // warps that released the stage, ever (no producer)
};

// One q-tile of K3 for one consumer: S^T = K.Q^T and dP^T = V.dO^T over
// all D columns of the consumer's 64 keys (k and v: their column blocks of
// KB rows), then the consumer's column blocks [ho, ho + NO) of
// dV += P^T.dO and dK += dS^T.Q (split D: each consumer computes S^T and
// dP^T in full, no exchange between them, 1.5 times the block's products;
// else ho 0 and NO every block). P^T is formed in place in S^T's registers.
// Split, the products run in three commit groups (kStaged): S^T; then dV
// with dP^T, so that S^T, dP^T and both fragments are never live at once
// (dK 64 + dV 64 + P^T 32 + dP^T 32 + one fragment 16 registers at the
// peak); then dK. Otherwise in two: S^T with dP^T, then dV with dK, P^T
// and dS^T formed in one pass (three groups at D 64 spill under the
// producer warpgroup's 168 registers, and were 4-6% slower at D 32 and
// 64 on the card; PERF.md).
template <int D, int KB, int NO>
__device__ __forceinline__ void dkv_tile(bf16* k, bf16* v, bf16* q, bf16* dout,
                                         const float* lse, const float* delta,
                                         float (&dk)[NO][kCol<D> / 2],
                                         float (&dv)[NO][kCol<D> / 2], int ho, int r0, int t,
                                         bool mask, float scale, float scale_log2) {
  using namespace hopper;
  constexpr int NH = D / kCol<D>, NQ = kDkvQueries;
  constexpr bool kStaged = kDkvSplit<D>;
  float s[NQ / 2], dp[NQ / 2];
  uint32_t pa[NQ / 16][4], da[NQ / 16][4];
  // dP^T = V.dO^T (K-major)
  const auto mma_dp = [&] {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const uint64_t v_desc = desc<D>(col_block<D, KB>(v, h));
      const uint64_t do_desc = desc<D>(col_block<D, kBox>(dout, h));
#pragma unroll
      for (int kk = 0; kk < kKSteps<D>; ++kk)
        wgmma_ss(dp, v_desc + 2 * kk, do_desc + 2 * kk, h + kk);
    }
  };
  // dV += P^T.dO (dO MN-major)
  const auto mma_dv = [&] {
#pragma unroll
    for (int h = 0; h < NO; ++h) {
      const uint64_t do_desc = desc<D>(col_block<D, kBox>(dout, ho + h));
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk)
        wgmma_rs_tb(dv[h], pa[kk], do_desc + kMnStep<D> * kk, 1);
    }
  };
  // dS^T = P^T (dP^T - delta) scale in place of dP^T, rounded to bf16 in
  // pairs: the queries of column group cc
  const auto form_ds = [&](int cc) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dl = delta[8 * cc + 2 * t + e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * cc + 2 * h + e;
        dp[idx] = s[idx] * (dp[idx] - dl) * scale;
      }
    }
    da[cc / 2][(cc % 2) * 2] = pack_bf16(dp[4 * cc], dp[4 * cc + 1]);
    da[cc / 2][(cc % 2) * 2 + 1] = pack_bf16(dp[4 * cc + 2], dp[4 * cc + 3]);
  };

  wgmma_fence();
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const uint64_t k_desc = desc<D>(col_block<D, KB>(k, h));
    const uint64_t q_desc = desc<D>(col_block<D, kBox>(q, h));
#pragma unroll
    for (int kk = 0; kk < kKSteps<D>; ++kk) wgmma_ss(s, k_desc + 2 * kk, q_desc + 2 * kk, h + kk);
  }
  if constexpr (!kStaged) mma_dp();
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  if constexpr (!kStaged) fence_regs(dp);

  // P^T = exp2(s.scale.log2(e) - lse.log2(e)) in place, one FFMA and one
  // MUFU an element (D 64: exp2f of the scaled score less lse.log2(e), its
  // first design's numerics); masked: 0 (columns are queries)
#pragma unroll
  for (int cc = 0; cc < NQ / 8; ++cc) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qcol = 8 * cc + 2 * t + e;
      const float lse2 = lse[qcol] * kLog2e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = 4 * cc + 2 * h + e;
        if constexpr (D != 64) {
          s[idx] = mask && r0 + 8 * h > qcol ? 0.0f : exp2_ftz(fmaf(s[idx], scale_log2, -lse2));
        } else {
          float a = s[idx] * scale_log2;
          if (mask && r0 + 8 * h > qcol) a = kNegInf;
          s[idx] = exp2f(a - lse2);
        }
      }
    }
    pa[cc / 2][(cc % 2) * 2] = pack_bf16(s[4 * cc], s[4 * cc + 1]);
    pa[cc / 2][(cc % 2) * 2 + 1] = pack_bf16(s[4 * cc + 2], s[4 * cc + 3]);
    if constexpr (!kStaged) form_ds(cc);
  }

  if constexpr (kStaged) {
#pragma unroll
    for (int h = 0; h < NO; ++h) fence_regs(dv[h]);
    wgmma_fence();
    mma_dv();
    mma_dp();
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int h = 0; h < NO; ++h) fence_regs(dv[h]);
#pragma unroll
    for (int cc = 0; cc < NQ / 8; ++cc) form_ds(cc);
  }

  // dK += dS^T.Q (Q MN-major), after dV in the same group unless staged
#pragma unroll
  for (int h = 0; h < NO; ++h) {
    fence_regs(dk[h]);
    if constexpr (!kStaged) fence_regs(dv[h]);
  }
  wgmma_fence();
  if constexpr (!kStaged) mma_dv();
#pragma unroll
  for (int h = 0; h < NO; ++h) {
    const uint64_t q_desc = desc<D>(col_block<D, kBox>(q, ho + h));
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk) wgmma_rs_tb(dk[h], da[kk], q_desc + kMnStep<D> * kk, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NO; ++h) {
    fence_regs(dk[h]);
    if constexpr (!kStaged) fence_regs(dv[h]);
  }
}

template <int D>
__global__ void __launch_bounds__(kDkvCons * kWg + kDkvProducer<D>, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_dk,
                    const __grid_constant__ CUtensorMap map_dv,
                    const float* __restrict__ lse, const float* __restrict__ delta, int seq,
                    float scale, float scale_log2, int causal) {
  using namespace hopper;
  constexpr int kCons = kDkvCons, kPT = kDkvProducer<D>, kSt = kDkvStages<D>;
  constexpr bool kSplit = kDkvSplit<D>;
  // KB: the block's keys; NO: the column blocks of dK and dV a consumer owns
  constexpr int NH = D / kCol<D>, KB = kDkvKeys<D>, NO = kSplit ? NH / kCons : NH;
  // the "empty" barriers count consumer threads, or warps where the
  // consumers load
  constexpr int kWarps = kCons * kWg / 32;
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D>& sm = aligned_smem<DkvSmem<D>>(smem_raw);
  const int bh = blockIdx.x;
  const int kj = blockIdx.y;  // under the causal mask the first key tiles are the heaviest
  const int nq = (seq + kBox - 1) / kBox;  // q-tiles, the last one ragged where 64 does not divide S
  const int i0 = causal ? kj * (KB / kBox) : 0;  // first q-tile that sees these keys
  const int wg = threadIdx.x / kWg;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kPT > 0 ? kCons * kWg : kWarps);
      sm.released[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Q, dO, lse and delta of the n-th q-tile visited into stage n % kSt, once
  // the consumers have released the tile kSt before it; called by a whole
  // warp, whose lane 0 waits, arms the barrier and issues the copies. lse
  // and delta come by bulk copy where the tile's 64 lie inside S and start
  // on 16 bytes (S a multiple of 4); else the warp's lanes copy them, a
  // query past S as lse 1e30 and delta 0, so its P^T and dS^T are 0 (its Q
  // and dO rows are zero-filled too).
  const float* lse_bh = lse + static_cast<size_t>(bh) * seq;
  const float* delta_bh = delta + static_cast<size_t>(bh) * seq;
  const auto load_qdo = [&](int n, int lane) {
    const int i = i0 + n, st = n % kSt;
    const bool bulk = seq % 4 == 0 && (i + 1) * kBox <= seq;
    if (lane == 0) mbar_wait(&sm.empty[st], ((n / kSt) & 1) ^ 1);
    if (!bulk) {
      __syncwarp();
      for (int r = lane; r < kBox; r += 32) {
        const int qp = i * kBox + r;
        sm.lse[st][r] = qp < seq ? lse_bh[qp] : 1e30f;
        sm.delta[st][r] = qp < seq ? delta_bh[qp] : 0.0f;
      }
      __threadfence_block();  // the lanes' stores before lane 0's arrival (a release)
      __syncwarp();
    }
    if (lane == 0) {
      mbar_expect_tx(&sm.full[st],
                     2 * kRowsBytes<D, kBox> + (bulk ? 2 * kBox * sizeof(float) : 0));
      load_rows<D, kBox>(sm.q[st], &map_q, i * kBox, bh, &sm.full[st]);
      load_rows<D, kBox>(sm.dout[st], &map_do, i * kBox, bh, &sm.full[st]);
      if (bulk) {
        bulk_load(sm.lse[st], lse_bh + i * kBox, kBox * sizeof(float), &sm.full[st]);
        bulk_load(sm.delta[st], delta_bh + i * kBox, kBox * sizeof(float), &sm.full[st]);
      }
    }
  };
  // K and V once, then the first `tiles` q-tiles of the ring (a whole warp)
  const auto load_first = [&](int tiles, int lane) {
    if (lane == 0) {
      tma_prefetch(&map_q);
      tma_prefetch(&map_do);
      mbar_expect_tx(&sm.kv_full, 2 * kRowsBytes<D, KB>);
      load_rows<D, KB>(sm.k, &map_k, kj * KB, bh, &sm.kv_full);
      load_rows<D, KB>(sm.v, &map_v, kj * KB, bh, &sm.kv_full);
    }
    for (int n = 0; n < tiles; ++n) load_qdo(n, lane);
  };

  if (kPT > 0 && wg == 0) {
    // ---- producer warpgroup: every load from its first warp ----
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) load_first(nq - i0, threadIdx.x);
  } else {
    if constexpr (kPT > 0) regs_alloc<kConsumerRegs>();
    const int cw = kPT > 0 ? wg - 1 : wg, tid = threadIdx.x % kWg;
    const int warp = tid / 32, lane = tid % 32, t = lane % 4;
    // without a producer, the first warp loads K, V and the ring's first
    // stages, and each stage is refilled by the last warp to release it
    if (kPT == 0 && threadIdx.x < 32) load_first(nq - i0 < kSt ? nq - i0 : kSt, lane);
    const auto release = [&](int st, int it) {
      if constexpr (kPT > 0) {
        mbar_arrive(&sm.empty[st]);
      } else {
        release_stage<kWarps>(&sm.empty[st], &sm.released[st], [&](int l) {
          if (it + kSt < nq - i0) load_qdo(it + kSt, l);
        });
      }
    };
    const int r0 = warp * 16 + lane / 4;           // key rows r0 and r0 + 8 of the 64
    const int krow = kSplit ? 0 : cw * kBox;       // the consumer's first key of the block's
    bf16* k_rows = sm.k + krow * kCol<D>;
    bf16* v_rows = sm.v + krow * kCol<D>;
    const int ho = kSplit ? cw * NO : 0;           // its first column block of dK and dV
    const int diag = kj * (KB / kBox) + krow / kBox;  // the q-tile holding these keys' positions

    float dk[NO][kCol<D> / 2], dv[NO][kCol<D> / 2];
#pragma unroll
    for (int h = 0; h < NO; ++h)
#pragma unroll
      for (int i = 0; i < kCol<D> / 2; ++i) dk[h][i] = dv[h][i] = 0.0f;

    mbar_wait(&sm.kv_full, 0);
    for (int i = i0; i < nq; ++i) {
      const int it = i - i0, st = it % kSt;
      mbar_wait(&sm.full[st], (it / kSt) & 1);
      if (causal && i < diag) {  // every key here comes after every query
        release(st, it);
        continue;
      }
      dkv_tile<D, KB, NO>(k_rows, v_rows, sm.q[st], sm.dout[st], sm.lse[st], sm.delta[st],
                          dk, dv, ho, r0, t, causal && i == diag, scale, scale_log2);
      release(st, it);
    }

    // ---- epilogue: dK, dV through this warpgroup's K/V rows (split: its
    // column blocks of them, once both consumers are done reading K and V)
    // and TMA stores (rows past seq are dropped) ----
    if constexpr (kSplit) __syncthreads();
    else warpgroup_sync(1 + cw);
#pragma unroll
    for (int h = 0; h < NO; ++h) {
      stage_tile(col_block<D, KB>(k_rows, ho + h), dk[h], 1.0f, 1.0f, r0);
      stage_tile(col_block<D, KB>(v_rows, ho + h), dv[h], 1.0f, 1.0f, r0);
    }
    fence_async_smem();
    warpgroup_sync(1 + cw);
    if (tid == 0) {
#pragma unroll
      for (int h = ho; h < ho + NO; ++h) {
        tma_store(&map_dk, col_block<D, KB>(k_rows, h), h * kCol<D>, kj * KB + krow, bh);
        tma_store(&map_dv, col_block<D, KB>(v_rows, h), h * kCol<D>, kj * KB + krow, bh);
      }
      tma_store_wait();
    }
  }
}


// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// What the op takes (dtype 0 = float32, 1 = bfloat16): the single
// statement of it, mirrored by torchft_tpu_torch.ops.flash_attention.supported:
// any head dim up to 256 (the op pads it with zeros to the next of the
// instantiated ones, kHeadDims) and any S up to 65535 tiles of 64.
constexpr int kMaxSeq = 65535 * kTile;
constexpr int kMaxHeadDim = 256;
bool supported(int dtype, int d, int seq) {
  return seq > 0 && seq <= kMaxSeq && d > 0 && d <= kMaxHeadDim && (dtype == 0 || dtype == 1);
}

// The head dims the launches take (the op pads the others up to one)
bool instantiated(int d) {
  return d == 8 || d == 16 || d == 32 || d == 64 || d == 128 || d == 256;
}

// The bf16 head dims at which the kernels run on wgmma at every S (the last
// tile masked): 128 and 256. The single statement of the routing: on_wgmma
// and the FMA instantiations (fma_at) both follow it.
constexpr bool wgmma_at_every_seq(int d) { return d == 128 || d == 256; }

// The float32 head dims at which K1 runs on the register-blocked kernel
// (flash_fwd_f32); fma_at follows it too.
constexpr bool f32_fwd_blocked(int d) { return d == 128 || d == 256; }

// bf16 runs on wgmma at those head dims and at 32 and 64 where S is a
// multiple of 64; the rest on the FMA kernels
bool on_wgmma(int dtype, int d, int seq) {
  return dtype == 1 && (wgmma_at_every_seq(d) || ((d == 32 || d == 64) && seq % kTile == 0));
}

bool shape_ok(int dtype, int bh, int seq, int d) {
  return bh > 0 && instantiated(d) && supported(dtype, d, seq);
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

// A [BH, S, D] bf16 tensor as the 3-D map {D, S, BH} with box
// {kCol<D>, rows, 1} (rows 64, or 32 for K2's 32-key stages at head dim
// 256) and the swizzle of that row width (128 bytes at head dims 64, 128
// and 256, 64 at 32). The map holds the base pointer, so it is made per
// launch and passed by value (__grid_constant__).
template <int D>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int bh, int seq, int rows = kBox) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {D * sizeof(bf16),
                                 static_cast<cuuint64_t>(seq) * D * sizeof(bf16)};
  const cuuint32_t box[3] = {kCol<D>, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      kCol<D> == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr float kLog2eHost = 1.4426950408889634f;

template <int D>
int fwd_hopper(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
               int seq, float scale, int causal, cudaStream_t stream) {
  constexpr int kRows = kFwdCons<D> * kBox;  // query rows of a block
  static bool ready = false;
  const size_t smem = sizeof(FwdSmem<D, kRows>) + 1024;  // + room to align the base to 1024
  cudaError_t err = allow_smem(flash_fwd_wgmma<D>, smem, &ready);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mo;
  if ((err = tensor_map<D>(&mq, q, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mk, k, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mv, v, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mo, o, bh, seq)) != cudaSuccess)
    return err;
  flash_fwd_wgmma<D><<<dim3(bh, (seq + kRows - 1) / kRows), kFwdCons<D> * kWg + kFwdProducer<D>,
                       smem, stream>>>(mq, mk, mv, mo, lse, seq, scale * kLog2eHost, causal);
  return cudaGetLastError();
}

template <int D>
int dq_hopper(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dqp, int bh, int seq, float scale,
              int causal, cudaStream_t stream) {
  constexpr int kKvBox = kBoxRows<kDqStageKeys<D>>;  // rows of a K/V box
  static bool ready = false;
  const size_t smem = sizeof(DqSmem<D>) + 1024;
  cudaError_t err = allow_smem(flash_dq_wgmma<D>, smem, &ready);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if ((err = tensor_map<D>(&mq, q, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mk, k, bh, seq, kKvBox)) != cudaSuccess ||
      (err = tensor_map<D>(&mv, v, bh, seq, kKvBox)) != cudaSuccess ||
      (err = tensor_map<D>(&mdo, dout, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mdq, dqp, bh, seq)) != cudaSuccess)
    return err;
  flash_dq_wgmma<D><<<dim3(bh, (seq + 127) / 128), 2 * kWg + kDqProducer<D>, smem, stream>>>(
      mq, mk, mv, mdo, mdq, lse, delta, seq, scale, scale * kLog2eHost, causal);
  return cudaGetLastError();
}

template <int D>
int dkv_hopper(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dkp, void* dvp, int bh, int seq,
               float scale, int causal, cudaStream_t stream) {
  constexpr int kKeys = kDkvKeys<D>;
  static bool ready = false;
  const size_t smem = sizeof(DkvSmem<D>) + 1024;
  cudaError_t err = allow_smem(flash_dkv_wgmma<D>, smem, &ready);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if ((err = tensor_map<D>(&mq, q, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mk, k, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mv, v, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mdo, dout, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mdk, dkp, bh, seq)) != cudaSuccess ||
      (err = tensor_map<D>(&mdv, dvp, bh, seq)) != cudaSuccess)
    return err;
  flash_dkv_wgmma<D><<<dim3(bh, (seq + kKeys - 1) / kKeys), kDkvCons * kWg + kDkvProducer<D>,
                       smem, stream>>>(mq, mk, mv, mdo, mdk, mdv, lse, delta, seq, scale,
                                 scale * kLog2eHost, causal);
  return cudaGetLastError();
}

// An FMA grid: (bh, y, z) blocks covering `n` tiles of S (tile_index).
dim3 fma_grid(int bh, int n) {
  const int y = n < 65535 ? n : 65535;
  return dim3(bh, y, (n + y - 1) / y);
}

template <typename T, int D>
int fwd_fma(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
            int seq, float scale, int causal, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = 4 * Fma<D>::kD + Fma<D>::kS;
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<fma_grid(bh, tiles<D>(seq)), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq, scale, causal);
  return cudaGetLastError();
}

template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int seq,
            float scale, int causal, cudaStream_t stream) {
  using F = F32Fwd<D>;
  static bool ready = false;
  const size_t smem = F::kBytes;
  cudaError_t err = allow_smem(flash_fwd_f32<D>, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_fwd_f32<D><<<dim3(bh, (seq + F::ROWS - 1) / F::ROWS), kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, seq, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
int dq_fma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dqp, int bh, int seq, float scale, int causal,
           cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = 5 * Fma<D>::kD + 2 * Fma<D>::kS;
  cudaError_t err = allow_smem(flash_dq_kernel<T, D>, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T, D><<<fma_grid(bh, tiles<D>(seq)), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dqp), seq, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
int dkv_fma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
            const float* delta, void* dkp, void* dvp, int bh, int seq, float scale,
            int causal, cudaStream_t stream) {
  static bool ready = false;
  // 201 KB at D 256 (six 32 x 257 tiles and two 32 x 33), the most of any
  const size_t smem = 6 * Fma<D>::kD + 2 * Fma<D>::kS;
  cudaError_t err = allow_smem(flash_dkv_kernel<T, D>, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T, D><<<fma_grid(bh, tiles<D>(seq)), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dkp), static_cast<T*>(dvp),
      seq, scale, causal);
  return cudaGetLastError();
}

// The FMA launches as functors of (element type, head dim), so that one
// switch over the head dim serves all three
struct FwdFma {
  template <typename T, int D, typename... A>
  static int run(A... a) { return fwd_fma<T, D>(a...); }
};
struct DqFma {
  template <typename T, int D, typename... A>
  static int run(A... a) { return dq_fma<T, D>(a...); }
};
struct DkvFma {
  template <typename T, int D, typename... A>
  static int run(A... a) { return dkv_fma<T, D>(a...); }
};

// An FMA launch at head dim D, instantiated for float32 and for bf16 where
// on_wgmma leaves it some S: both types at 8, 16, 32 and 64, float32 alone
// at 128 and 256 (K1 there on flash_fwd_f32); no bf16 kernel at 128 or
// 256.
template <typename T, typename Launch, int D>
constexpr bool on_fma = std::is_same_v<T, float>
                            ? !(std::is_same_v<Launch, FwdFma> && f32_fwd_blocked(D))
                            : !wgmma_at_every_seq(D);

template <typename T, typename Launch, int D, typename... A>
int fma_at(A... a) {
  if constexpr (on_fma<T, Launch, D>)
    return Launch::template run<T, D>(a...);
  else
    return cudaErrorInvalidValue;
}

template <typename T, typename Launch, typename... A>
int by_head_dim(int d, A... a) {
  switch (d) {
    case 8: return fma_at<T, Launch, 8>(a...);
    case 16: return fma_at<T, Launch, 16>(a...);
    case 32: return fma_at<T, Launch, 32>(a...);
    case 64: return fma_at<T, Launch, 64>(a...);
    case 128: return fma_at<T, Launch, 128>(a...);
    case 256: return fma_at<T, Launch, 256>(a...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Every launching entry point returns a cudaError_t (0 = launched).
extern "C" {

int tft_flash_supported(int dtype, int d, int seq) { return supported(dtype, d, seq); }

int tft_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int seq, int d, float scale, int causal,
                  void* stream) {
  if (!shape_ok(dtype, bh, seq, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (on_wgmma(dtype, d, seq)) {
    if (d == 32) return fwd_hopper<32>(q, k, v, o, lse, bh, seq, scale, causal, st);
    if (d == 64) return fwd_hopper<64>(q, k, v, o, lse, bh, seq, scale, causal, st);
    if (d == 256) return fwd_hopper<256>(q, k, v, o, lse, bh, seq, scale, causal, st);
    return fwd_hopper<128>(q, k, v, o, lse, bh, seq, scale, causal, st);
  }
  if (dtype == 0 && f32_fwd_blocked(d)) {
    if (d == 128) return fwd_f32<128>(q, k, v, o, lse, bh, seq, scale, causal, st);
    return fwd_f32<256>(q, k, v, o, lse, bh, seq, scale, causal, st);
  }
  if (dtype == 0) return by_head_dim<float, FwdFma>(d, q, k, v, o, lse, bh, seq, scale, causal, st);
  return by_head_dim<bf16, FwdFma>(d, q, k, v, o, lse, bh, seq, scale, causal, st);
}

int tft_flash_dq(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta, void* dqp,
                 int bh, int seq, int d, float scale, int causal, void* stream) {
  if (!shape_ok(dtype, bh, seq, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (on_wgmma(dtype, d, seq)) {
    if (d == 32)
      return dq_hopper<32>(q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal, st);
    if (d == 64)
      return dq_hopper<64>(q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal, st);
    if (d == 256)
      return dq_hopper<256>(q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal, st);
    return dq_hopper<128>(q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal, st);
  }
  if (dtype == 0)
    return by_head_dim<float, DqFma>(d, q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal,
                                     st);
  return by_head_dim<bf16, DqFma>(d, q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal,
                                  st);
}

int tft_flash_dkv(int dtype, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta, void* dkp,
                  void* dvp, int bh, int seq, int d, float scale, int causal,
                  void* stream) {
  if (!shape_ok(dtype, bh, seq, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (on_wgmma(dtype, d, seq)) {
    if (d == 32)
      return dkv_hopper<32>(q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale, causal, st);
    if (d == 64)
      return dkv_hopper<64>(q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale, causal, st);
    if (d == 256)
      return dkv_hopper<256>(q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale, causal, st);
    return dkv_hopper<128>(q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale, causal, st);
  }
  if (dtype == 0)
    return by_head_dim<float, DkvFma>(d, q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale,
                                      causal, st);
  return by_head_dim<bf16, DkvFma>(d, q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale,
                                   causal, st);
}

const char* tft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
