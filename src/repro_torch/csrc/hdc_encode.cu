// Fused HDC random-projection encode + Z-score quantize on Hopper.
//
// Replaces the Pallas TPU kernel `hdc_encode` of
// src/repro/kernels/hdc_encode/kernel.py (body `_encode_kernel`).
//
// What is computed, for X (B, n) and P (n, D), float32, row-major:
//   H[b, j]  = sum_k X[b, k] * P[k, j]                  (full fp32)
//   norm[b]  = sqrtf(sum_k X[b, k]^2 + 1e-12f)
//   code[b, j] = #{ t : H[b, j] > thr[t] * norm[b] }    (int32)
// The comparison is exactly `h > t * norm`, as in the TPU kernel; written
// as `h / norm > t` it would move codes that sit on a threshold.
//
// What bounds it on this card: operations.  At the ISOLET shape
// (B = 6,238, n = 617, D = 4,096) the product is 2*B*n*D = 31.5 GFLOP,
// about 0.47 ms at the H100 SXM's 67 TFLOP/s of fp32 on the CUDA cores,
// while the bytes (X, P read once, codes written once: 128 MB) take about
// 0.04 ms at 3.35 TB/s.  The product stays in full fp32 on the CUDA cores,
// not TF32 on the tensor cores: the reference tolerance (under 0.5 % of
// codes differ, none by more than one level) was set for summation-order
// differences only.  An error-compensated tensor-core product is the route
// to a faster kernel and is left to a later change.
//
// Design: a classic register-blocked SGEMM.  A block of 256 threads owns a
// 128 x 128 tile of H and walks n in steps of BK = 16, staging a 128 x 16
// tile of X (transposed) and a 16 x 128 tile of P in shared memory; each
// thread accumulates an 8 x 8 sub-tile in registers.  The block's 128 row
// norms are summed from the same staged X tiles (every block along D
// repeats that work, which is cheap: n per row, against n*D for the
// product).  The epilogue bucketizes against the thresholds, which arrive
// as a small device array.  Ragged B, n and D are masked in the kernel:
// out-of-range loads read 0, which adds nothing to the product or the norm,
// and out-of-range codes are not stored.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;          // rows of X (and H) per block
constexpr int BN = 128;          // columns of P (and H) per block
constexpr int BK = 16;           // depth of one staged step
constexpr int TM = 8;            // rows per thread
constexpr int TN = 8;            // columns per thread (two runs of 4)
constexpr int THREADS = 256;     // 16 x 16 threads
constexpr int MAX_THR = 255;     // thresholds: bits <= 8

__global__ void __launch_bounds__(THREADS)
hdc_encode_kernel(const float* __restrict__ x, const float* __restrict__ p,
                  const float* __restrict__ thr, int32_t* __restrict__ out,
                  int B, int n, int D, int n_thr) {
  // X tile, transposed; rows padded by 4 floats so that the transposing
  // stores of 16 consecutive k spread over the banks (rows stay 16-byte
  // aligned for the float4 reads)
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ps[BK][BN];   // P tile
  __shared__ float norm_s[BM];
  __shared__ float thr_s[MAX_THR];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  for (int t = tid; t < n_thr; t += THREADS) thr_s[t] = thr[t];

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float sumsq = 0.f;              // row (row0 + tid) of this block, tid < BM

  for (int k0 = 0; k0 < n; k0 += BK) {
    // X tile: BM x BK, 8 loads a thread; 16 consecutive threads read 16
    // consecutive floats of one row
#pragma unroll
    for (int v = 0; v < (BM * BK) / THREADS; ++v) {
      const int idx = tid + v * THREADS;
      const int r = idx / BK, k = idx % BK;
      const int gr = row0 + r, gk = k0 + k;
      xs[k][r] = (gr < B && gk < n) ? x[(size_t)gr * n + gk] : 0.f;
    }
    // P tile: BK x BN, coalesced along D
#pragma unroll
    for (int v = 0; v < (BK * BN) / THREADS; ++v) {
      const int idx = tid + v * THREADS;
      const int k = idx / BN, c = idx % BN;
      const int gk = k0 + k, gc = col0 + c;
      ps[k][c] = (gk < n && gc < D) ? p[(size_t)gk * D + gc] : 0.f;
    }
    __syncthreads();

    if (tid < BM) {
#pragma unroll
      for (int k = 0; k < BK; ++k) sumsq += xs[k][tid] * xs[k][tid];
    }

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ps[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ps[k][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  if (tid < BM) norm_s[tid] = sqrtf(sumsq + 1e-12f);
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i, gr = row0 + r;
    if (gr >= B) continue;
    const float nrm = norm_s[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gc >= D) continue;
      const float h = acc[i][j];
      int code = 0;
      for (int t = 0; t < n_thr; ++t) code += h > thr_s[t] * nrm ? 1 : 0;
      out[(size_t)gr * D + gc] = code;
    }
  }
}

}  // namespace

// x (B, n), p (n, D), thr (n_thr,) float32; out (B, D) int32; all device
// pointers, row-major and contiguous.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int hdc_encode_launch(const void* x, const void* p,
                                 const void* thr, void* out, int B, int n,
                                 int D, int n_thr, void* stream) {
  if (B < 1 || n < 1 || D < 1 || n_thr < 0 || n_thr > MAX_THR ||
      (B + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((D + BN - 1) / BN, (B + BM - 1) / BM);
  hdc_encode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(p),
      static_cast<const float*>(thr), static_cast<int32_t*>(out), B, n, D,
      n_thr);
  return (int)cudaGetLastError();
}
