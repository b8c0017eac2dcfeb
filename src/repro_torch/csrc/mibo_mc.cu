// Monte-Carlo MIBO matchline currents (Fig. 9 at scale) on Hopper.
//
// Replaces the Pallas TPU kernel `mibo_mc` of
// src/repro/kernels/mibo_mc/kernel.py (body `_mibo_mc_kernel`).
//
// What is computed, for noised threshold voltages VTH1, VTH2 (S, C) and
// gate voltages G1, G2 (C,), float32:
//   f(g, v)  = exp(log_off + (log_on - log_off) * sigmoid((g - v) / ss))
//              * (1 + overdrive * max(g - v, 0))
//   I[s, c]  = f(G1[c], VTH1[s, c]) + f(G2[c], VTH2[s, c])
//   out[s]   = sum over c with I[s, c] > i_thresh of I[s, c]
// The device constants come from the port's `fefet` and `mibo` modules
// and are passed as arguments.  Each step rounds as the reference's
// float32 ops do: `expf` (no fast-math intrinsics: the exponent is
// log_off + 13.8 * sigmoid, so an error in the sigmoid is multiplied by
// about 13.8 before `exp`, and the tolerance is rtol 1e-5), IEEE division,
// and the multiply-add in the exponent kept as two rounded operations.
//
// What bounds it on this card: bytes.  At S = 2^20 samples of C = 64 cells
// the two V_TH planes are 512 MiB, read once: about 0.16 ms at 3.35 TB/s.
// The arithmetic (three exponentials, one reciprocal and one division
// per FeFET) is some 30 float32 operations a cell, about 0.03 ms at the
// fp32 rate, so one pass over the planes at full bandwidth is the aim.
//
// Design: one warp per sample row, eight rows per block of 256 threads,
// blocks striding over the samples.  The lanes walk the row's C cells
// 32 at a time (coalesced, 128 bytes per load), each keeping a partial sum
// of its mismatched cells; a warp shuffle reduction then sums the row.
// Ragged S and C need no padding: rows past S are never visited and lanes
// past C add nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

struct Device {
  float log_on, log_off, ss_v, overdrive;
};

__device__ __forceinline__ float fefet_current(float g, float v,
                                               const Device& d) {
  const float dv = g - v;
  const float s = 1.f / (1.f + expf(-(dv / d.ss_v)));
  const float i = expf(__fadd_rn(d.log_off,
                                 __fmul_rn(d.log_on - d.log_off, s)));
  return i * (1.f + d.overdrive * fmaxf(dv, 0.f));
}

__global__ void __launch_bounds__(THREADS)
mibo_mc_kernel(const float* __restrict__ vth1, const float* __restrict__ vth2,
               const float* __restrict__ g1, const float* __restrict__ g2,
               float* __restrict__ out, int S, int C, Device d,
               float i_thresh) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (long long s = (long long)blockIdx.x * ROWS_PER_BLOCK + warp; s < S;
       s += (long long)gridDim.x * ROWS_PER_BLOCK) {
    const float* r1 = vth1 + s * C;
    const float* r2 = vth2 + s * C;
    float part = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float i = fefet_current(g1[c], r1[c], d)
                      + fefet_current(g2[c], r2[c], d);
      if (i > i_thresh) part += i;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xFFFFFFFFu, part, off);
    if (lane == 0) out[s] = part;
  }
}

}  // namespace

// vth1, vth2 (S, C), g1, g2 (C,) float32; out (S,) float32; all device
// pointers, row-major and contiguous.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int mibo_mc_launch(const void* vth1, const void* vth2,
                              const void* g1, const void* g2, void* out,
                              int S, int C, float log_on, float log_off,
                              float ss_v, float overdrive, float i_thresh,
                              void* stream) {
  if (S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (S + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int blocks = (int)(need < 8LL * sms ? need : 8LL * sms);
  const Device d{log_on, log_off, ss_v, overdrive};
  mibo_mc_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vth1), static_cast<const float*>(vth2),
      static_cast<const float*>(g1), static_cast<const float*>(g2),
      static_cast<float*>(out), S, C, d, i_thresh);
  return (int)cudaGetLastError();
}
