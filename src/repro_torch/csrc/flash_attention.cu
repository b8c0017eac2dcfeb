// Causal GQA flash attention (online softmax) on Hopper's CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py (body `_flash_kernel`).
//
// What is computed, for q (BH, Sq, dh) and k, v (BH / group, Skv, dh), all
// float32 or all bfloat16, query head bh reading KV head bh / group:
//   s[i, j] = (q[i] . k[j]) * scale            (float32, scale = dh^-0.5)
//   s[i, j] = -1e30 where causal and i < j     (absolute positions,
//                                               top-left aligned)
//   o[i]    = sum_j softmax_j(s[i]) v[j]
// by the reference kernel's online softmax, tile by tile over the keys:
//   m_new = max(m, rowmax(s)); p = s > -1e30/2 ? exp(s - m_new) : 0;
//   alpha = exp(min(m - m_new, 0)); l = l * alpha + rowsum(p);
//   acc = acc * alpha + round_to_v_dtype(p) . v    (float32 accumulation)
//   o = acc / max(l, 1e-30), cast to q's dtype.
// -1e30 is a finite fill, as in the reference, so a masked score takes part
// in the row maximum and the guard on p keeps exp from seeing it.
//
// Tiles wholly above the diagonal are skipped.  That is exact: key 0 is
// live for every row (top-left alignment) and sits in the first tile, so a
// later tile whose keys are all masked leaves m (alpha = 1), l and acc
// unchanged.
//
// What bounds it on this card: operations.  At the LM's prefill shape
// (B = 1, S = 4,096, H = 32, dh = 128, causal) the two products are
// 2 * S^2 * dh * H = 137 GFLOP, 0.14 ms at the bf16 tensor-core rate,
// against 75 MB of q, k, v and o, 0.02 ms at 3.35 TB/s.  This first kernel
// runs the products on the CUDA cores in float32 (both dtypes: a bf16
// product is exact in float32), so it is held by the float32 rate and by
// shared-memory loads; tensor-core tiles (`mma.sync`, then `wgmma` fed by
// TMA) are the route to the bound.
//
// Design: one block of 256 threads per (q head, 64-row query tile), the
// longest causal rows scheduled first.  The query tile is staged once in
// shared memory as float32; each 64-key tile of K, then of V, is staged
// through one shared buffer (rows padded by one float, so the strided
// reads of K hit distinct banks).  A 16 x 16 thread grid gives each thread
// 4 query rows x 4 keys of the score tile and 4 rows x ceil(dh / 16)
// columns of the output accumulator, in registers; row max and row sum
// are shuffle reductions over the 16 threads of a row group.  The rounded
// probabilities go through shared memory to the P . V product.  Ragged
// Sq and Skv (a tile past the end) are masked in the kernel: rows past Sq
// are not stored, keys past Skv count as masked.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int TX = 16;          // threads along the keys / output columns
constexpr int THREADS = 256;    // 16 x 16
constexpr int ROWS = BQ / (THREADS / TX);   // query rows per thread (4)
constexpr int COLS = BK / TX;               // keys per thread (4)
constexpr int LDP = BK + 1;     // row stride of the probability tile
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "stage() moves tiles of BQ == BK rows");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);                 // round to nearest even
}

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int n_rows, int dh, int ld) {
  // rows [row0, row0 + BQ) of a (n_rows, dh) matrix into a (BQ, ld) tile,
  // zeros past n_rows
  for (int i = threadIdx.x; i < BQ * dh; i += THREADS) {
    const int r = i / dh, c = i - r * dh;
    dst[r * ld + c] = (row0 + r < n_rows)
        ? to_f(src[(long long)(row0 + r) * dh + c]) : 0.f;
  }
}

template <typename T, int NJ>   // NJ: output columns per thread, >= dh / 16
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int BH, int Sq,
             int Skv, int dh, int group, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* sQ = smem;                 // BQ x ld
  float* sKV = sQ + BQ * ld;        // BK x ld: K, then V
  float* sP = sKV + BK * ld;        // BQ x LDP

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)(blockIdx.x / BH);   // longest rows first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qi * BQ;
  const T* kp = k + (long long)(bh / group) * Skv * dh;
  const T* vp = v + (long long)(bh / group) * Skv * dh;

  stage(sQ, q + (long long)bh * Sq * dh, q0, Sq, dh, ld);

  float m[ROWS], l[ROWS], acc[ROWS][NJ];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int nk = (kv_end + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    __syncthreads();                // the last tile's V and P reads are done
    stage(sKV, kp, k0, Skv, dh, ld);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = sQ[(ty * ROWS + i) * ld + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = sKV[(tx + j * TX) * ld + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + ty * ROWS + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kpos = k0 + tx + j * TX;
        const bool live = kpos < Skv && (!causal || qpos >= kpos);
        s[i][j] = live ? s[i][j] * scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xFFFFFFFFu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(fminf(m[i] - m_new, 0.f));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float p = s[i][j] > NEG_INF / 2 ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(ty * ROWS + i) * LDP + tx + j * TX] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xFFFFFFFFu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();                // every K read is done; P is written
    stage(sKV, vp, k0, Skv, dh, ld);
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + j * TX;
        vv[j] = c < dh ? sKV[kk * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = sP[(ty * ROWS + i) * LDP + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = q0 + ty * ROWS + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)bh * Sq + r) * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + j * TX;
      if (c < dh) orow[c] = from_f<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Skv, int dh, int group, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (dh + 1) + (size_t)BQ * LDP);
  auto kern = flash_kernel<T, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nq = (Sq + BQ - 1) / BQ;
  const long long blocks = nq * BH;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), BH, Sq, Skv, dh, group,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH,
             int Sq, int Skv, int dh, int group, int causal, float scale,
             cudaStream_t stream) {
  if (dh <= 16)
    return launch<T, 1>(q, k, v, o, BH, Sq, Skv, dh, group, causal, scale,
                        stream);
  if (dh <= 32)
    return launch<T, 2>(q, k, v, o, BH, Sq, Skv, dh, group, causal, scale,
                        stream);
  if (dh <= 64)
    return launch<T, 4>(q, k, v, o, BH, Sq, Skv, dh, group, causal, scale,
                        stream);
  if (dh <= 128)
    return launch<T, 8>(q, k, v, o, BH, Sq, Skv, dh, group, causal, scale,
                        stream);
  return launch<T, 16>(q, k, v, o, BH, Sq, Skv, dh, group, causal, scale,
                       stream);
}

}  // namespace

// q (BH, Sq, dh), k and v (BH / group, Skv, dh), o (BH, Sq, dh): device
// pointers, row-major and contiguous, all float32 (dtype 0) or all
// bfloat16 (dtype 1).  1 <= dh <= 256.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int Sq,
                                      int Skv, int dh, int group, int causal,
                                      float scale, int dtype, void* stream) {
  if (BH < 1 || Sq < 1 || Skv < 1 || dh < 1 || dh > 256 || group < 1 ||
      BH % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, BH, Sq, Skv, dh, group, causal, scale,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, dh, group, causal,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}
