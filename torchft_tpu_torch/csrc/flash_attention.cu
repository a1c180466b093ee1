// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of
// torchft_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel  (lines 67-109, pallas_call at 115)
//   flash_dq_kernel   <- _dq_kernel   (lines 145-174, pallas_call at 219)
//   flash_dkv_kernel  <- _dkv_kernel  (lines 177-210, pallas_call at 238)
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
// A block has 4 warps; warp w owns rows [16w, 16w+16) of a 64-row tile,
// for the matrix products and for the row-wise softmax, so most steps
// need only a warp barrier. Products run on the tensor cores through WMMA
// (bf16 operands, f32 accumulation) for bf16 inputs and on FMA loops for
// float32 inputs (which keeps float32 exact enough for the parity tests).
// Score tiles and accumulators live in shared memory in float32; tiles
// pass 48 KB, so shared memory is dynamic (cudaFuncSetAttribute).
//
// Bound on an H100 at the headline shapes (B8 S1024 H8 D64, causal,
// bf16): each kernel is a few GFLOP of matrix products over a few tens of
// MB, so it sits near the line between the two bounds (chip_smoke.py
// prints both per kernel). This version does not try to reach either:
// WMMA through shared memory, no TMA, no wgmma, no pipelining of tile
// loads. Making it fast is later work.
//
// Numerics kept from the TPU kernels: mask value -1e30 where
// k_pos > q_pos; blocks above the causal diagonal skipped
// (j*bk <= i*bq+bq-1); l clamped at 1e-30; P cast to V's dtype before
// P.V; dS cast to K's / Q's dtype before its products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;     // rows of every Q / K / V tile
constexpr int kHeadDim = 64;  // the head dim the kernels take
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// Shared-memory row strides (elements). bf16: a multiple of 8 for WMMA,
// padded off 64 to spread banks; float32 accumulators: a multiple of 4
// for WMMA. The float32-input path uses odd strides (no WMMA there).
template <typename T>
struct Layout;
template <>
struct Layout<bf16> {
  static constexpr int kLdT = 72;
  static constexpr int kLdF = 68;
};
template <>
struct Layout<float> {
  static constexpr int kLdT = 65;
  static constexpr int kLdF = 65;
};

template <typename T>
constexpr size_t tile_bytes() {
  return sizeof(T) * kTile * Layout<T>::kLdT;
}
template <typename T>
constexpr size_t ftile_bytes() {
  return sizeof(float) * kTile * Layout<T>::kLdF;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

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
// shared memory (row stride Layout<T>::kLdT). All threads take part.
template <typename T>
__device__ void load_tile(T* dst, const T* __restrict__ src) {
  constexpr int ld = Layout<T>::kLdT;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int kVec = 8;  // 16 bytes
    for (int i = threadIdx.x; i < kTile * kHeadDim / kVec; i += kThreads) {
      const int r = i / (kHeadDim / kVec), c = (i % (kHeadDim / kVec)) * kVec;
      *reinterpret_cast<uint4*>(dst + r * ld + c) =
          *reinterpret_cast<const uint4*>(src + r * kHeadDim + c);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kHeadDim; i += kThreads) {
      const int r = i / kHeadDim, c = i % kHeadDim;
      dst[r * ld + c] = src[r * kHeadDim + c];
    }
  }
}

// The calling warp's stripe of a product: C[16 x 64] (+)= A[16 x K] B[K x 64].
// A_T: A(m, k) is stored at A[k * lda + m] (a transposed operand);
// B_T: B(k, n) is stored at B[n * ldb + k]. C is float32, row stride ldc.
template <bool A_T, bool B_T>
__device__ void warp_mm(const bf16* A, int lda, const bf16* B, int ldb, float* C,
                        int ldc, int K, bool accumulate) {
  using namespace nvcuda;
  using LA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using LB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
  __syncwarp();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (accumulate)
      wmma::load_matrix_sync(acc[n], C + 16 * n, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc[n], 0.0f);
  }
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
    wmma::load_matrix_sync(a, A_T ? A + kk * lda : A + kk, lda);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(b, B_T ? B + 16 * n * ldb + kk : B + kk * ldb + 16 * n, ldb);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(C + 16 * n, acc[n], ldc, wmma::mem_row_major);
  __syncwarp();
}

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
// K1: forward. One block per (q-tile, bh); online softmax over k-tiles.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale, int causal) {
  constexpr int LT = Layout<T>::kLdT, LF = Layout<T>::kLdF;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kTile * LT;
  T* sV = sK + kTile * LT;
  T* sP = sV + kTile * LT;
  float* sS = reinterpret_cast<float*>(sP + kTile * LT);
  float* sO = sS + kTile * LF;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const int qi = blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kHeadDim;

  load_tile(sQ, q + base + static_cast<size_t>(qi) * kTile * kHeadDim);
  for (int i = threadIdx.x; i < kTile * LF; i += kThreads) sO[i] = 0.0f;
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
    warp_mm<false, true>(sQ + r0 * LT, LT, sK, LT, sS + r0 * LF, LF, kHeadDim, false);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, qp = qi * kTile + row;
      const float s0 = masked(sS[row * LF + lane], scale, causal, qp, j * kTile + lane);
      const float s1 = masked(sS[row * LF + lane + 32], scale, causal, qp, j * kTile + lane + 32);
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
      sP[row * LT + lane] = from_f<T>(p0);
      sP[row * LT + lane + 32] = from_f<T>(p1);
      sO[row * LF + lane] *= corr;
      sO[row * LF + lane + 32] *= corr;
    }
    warp_mm<false, false>(sP + r0 * LT, LT, sV, LT, sO + r0 * LF, LF, kTile, true);
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const float lr = fmaxf(l[r], 1e-30f);
    T* orow = o + base + static_cast<size_t>(qi * kTile + row) * kHeadDim;
    orow[lane] = from_f<T>(sO[row * LF + lane] / lr);
    orow[lane + 32] = from_f<T>(sO[row * LF + lane + 32] / lr);
    if (lane == 0) lse[static_cast<size_t>(blockIdx.y) * seq + qi * kTile + row] = m[r] + logf(lr);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ. One block per (q-tile, bh); loops over k-tiles.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int seq, float scale, int causal) {
  constexpr int LT = Layout<T>::kLdT, LF = Layout<T>::kLdF;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + kTile * LT;
  T* sK = sDO + kTile * LT;
  T* sV = sK + kTile * LT;
  T* sDS = sV + kTile * LT;
  float* sS = reinterpret_cast<float*>(sDS + kTile * LT);
  float* sDP = sS + kTile * LF;
  float* sAcc = sDP + kTile * LF;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const int qi = blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kHeadDim;
  const size_t rbase = static_cast<size_t>(blockIdx.y) * seq + qi * kTile;

  load_tile(sQ, q + base + static_cast<size_t>(qi) * kTile * kHeadDim);
  load_tile(sDO, dout + base + static_cast<size_t>(qi) * kTile * kHeadDim);
  for (int i = threadIdx.x; i < kTile * LF; i += kThreads) sAcc[i] = 0.0f;
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
    warp_mm<false, true>(sQ + r0 * LT, LT, sK, LT, sS + r0 * LF, LF, kHeadDim, false);
    warp_mm<false, true>(sDO + r0 * LT, LT, sV, LT, sDP + r0 * LF, LF, kHeadDim, false);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, qp = qi * kTile + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const float s = masked(sS[row * LF + c], scale, causal, qp, j * kTile + c);
        const float p = expf(s - lse_r[r]);
        const float ds = p * (sDP[row * LF + c] - delta_r[r]) * scale;
        sDS[row * LT + c] = from_f<T>(ds);
      }
    }
    warp_mm<false, false>(sDS + r0 * LT, LT, sK, LT, sAcc + r0 * LF, LF, kTile, true);
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    T* out = dq + base + static_cast<size_t>(qi * kTile + row) * kHeadDim;
    out[lane] = from_f<T>(sAcc[row * LF + lane]);
    out[lane + 32] = from_f<T>(sAcc[row * LF + lane + 32]);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV. One block per (k-tile, bh); loops over q-tiles.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int seq, float scale,
                     int causal) {
  constexpr int LT = Layout<T>::kLdT, LF = Layout<T>::kLdF;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * LT;
  T* sQ = sV + kTile * LT;
  T* sDO = sQ + kTile * LT;
  T* sP = sDO + kTile * LT;
  T* sDS = sP + kTile * LT;
  float* sS = reinterpret_cast<float*>(sDS + kTile * LT);
  float* sDP = sS + kTile * LF;
  float* sDK = sDP + kTile * LF;
  float* sDV = sDK + kTile * LF;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;
  const int kj = blockIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * kHeadDim;

  load_tile(sK, k + base + static_cast<size_t>(kj) * kTile * kHeadDim);
  load_tile(sV, v + base + static_cast<size_t>(kj) * kTile * kHeadDim);
  for (int i = threadIdx.x; i < kTile * LF; i += kThreads) {
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
    warp_mm<false, true>(sQ + r0 * LT, LT, sK, LT, sS + r0 * LF, LF, kHeadDim, false);
    warp_mm<false, true>(sDO + r0 * LT, LT, sV, LT, sDP + r0 * LF, LF, kHeadDim, false);
    const size_t rbase = static_cast<size_t>(blockIdx.y) * seq + i * kTile + r0;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r, qp = i * kTile + row;
      const float lse_r = lse[rbase + r], delta_r = delta[rbase + r];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const float s = masked(sS[row * LF + c], scale, causal, qp, kj * kTile + c);
        const float p = expf(s - lse_r);
        const float ds = p * (sDP[row * LF + c] - delta_r) * scale;
        sP[row * LT + c] = from_f<T>(p);
        sDS[row * LT + c] = from_f<T>(ds);
      }
    }
    __syncthreads();  // P and dS of all q rows are in place
    // warp w: k rows [r0, r0+16): dV += P^T dO, dK += dS^T Q
    warp_mm<true, false>(sP + r0, LT, sDO, LT, sDV + r0 * LF, LF, kTile, true);
    warp_mm<true, false>(sDS + r0, LT, sQ, LT, sDK + r0 * LF, LF, kTile, true);
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const size_t off = base + static_cast<size_t>(kj * kTile + row) * kHeadDim;
    dk[off + lane] = from_f<T>(sDK[row * LF + lane]);
    dk[off + lane + 32] = from_f<T>(sDK[row * LF + lane + 32]);
    dv[off + lane] = from_f<T>(sDV[row * LF + lane]);
    dv[off + lane + 32] = from_f<T>(sDV[row * LF + lane + 32]);
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

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
        int seq, float scale, int causal, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = 4 * tile_bytes<T>() + 2 * ftile_bytes<T>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T><<<dim3(seq / kTile, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const float* lse, const float* delta, void* dqp, int bh, int seq, float scale,
       int causal, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = 5 * tile_bytes<T>() + 3 * ftile_bytes<T>();
  cudaError_t err = allow_smem(flash_dq_kernel<T>, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T><<<dim3(seq / kTile, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dqp), seq, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dkp, void* dvp, int bh, int seq,
        float scale, int causal, cudaStream_t stream) {
  static bool ready = false;
  const size_t smem = 6 * tile_bytes<T>() + 4 * ftile_bytes<T>();
  cudaError_t err = allow_smem(flash_dkv_kernel<T>, smem, &ready);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T><<<dim3(seq / kTile, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dkp),
      static_cast<T*>(dvp), seq, scale, causal);
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
  if (dtype == 0) return fwd<float>(q, k, v, o, lse, bh, seq, scale, causal, st);
  if (dtype == 1) return fwd<bf16>(q, k, v, o, lse, bh, seq, scale, causal, st);
  return cudaErrorInvalidValue;
}

int tft_flash_dq(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta, void* dqp,
                 int bh, int seq, int d, float scale, int causal, void* stream) {
  if (!shape_ok(bh, seq, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dq<float>(q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal, st);
  if (dtype == 1) return dq<bf16>(q, k, v, dout, lse, delta, dqp, bh, seq, scale, causal, st);
  return cudaErrorInvalidValue;
}

int tft_flash_dkv(int dtype, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta, void* dkp,
                  void* dvp, int bh, int seq, int d, float scale, int causal,
                  void* stream) {
  if (!shape_ok(bh, seq, d)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dkv<float>(q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale, causal, st);
  if (dtype == 1)
    return dkv<bf16>(q, k, v, dout, lse, delta, dkp, dvp, bh, seq, scale, causal, st);
  return cudaErrorInvalidValue;
}

const char* tft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
