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
// and are passed as arguments; log_on - log_off arrives rounded once from
// double, as the reference's static Python floats are.  Each step rounds
// as the reference's float32 ops do: `expf` (no fast-math intrinsics: the
// exponent is log_off + 13.8 * sigmoid, so an error in the sigmoid is
// multiplied by about 13.8 before `exp`, and the tolerance is rtol 1e-5),
// the IEEE division of the sigmoid, and the multiply-add in the exponent
// kept as two rounded operations.  The one departure: (g - v) / ss is
// taken as (g - v) * (1 / ss), with 1 / ss rounded once on the host; it
// moves x by at most an ulp, and every gate (rtol 1e-5, atol 1e-12, at
// 2^20 x 64 too) holds with it.
//
// What bounds it on this card.  At S = 2^20 samples of C = 64 cells the
// two V_TH planes are 512 MiB, read once: 0.16 ms at 3.35 TB/s.  The
// arithmetic is close behind: per FeFET one IEEE division and two `expf`,
// three special-function (MUFU) operations among some 35 instructions, so
// about 75 instructions a cell, near 0.15 ms of issue at the CUDA cores'
// rate.  A kernel that reads the planes at full rate must keep the loads
// in flight while that arithmetic runs.
//
// Design: a row is read by a group of `lanes` threads (C/4 rounded up to a
// power of two, at most 32), each owning 4 consecutive cells and reading
// them as one 16-byte vector from each plane (when C % 4 == 0 and the
// planes are 16-byte aligned; otherwise 1 cell and 4-byte loads).  A
// thread loads its cells' gate voltages once, then takes ROWS rows at a
// time: it issues all their loads before any arithmetic, so 2 x ROWS
// vectors are in flight per thread while other warps compute.  A row of
// more than 32 vectors is taken in chunks of 32, the gate voltages
// reloaded per chunk.  A row's sum is a `shfl_xor` reduction within its
// group.  The grid covers the rows once (no cap on blocks per SM), so
// every SM holds as many warps as its registers allow.  Ragged S and C
// need no padding: rows past S and cells past C add nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 2;                // rows a thread loads before computing

struct Device {
  float log_off, log_span, inv_ss_v, overdrive;
};

template <int W> struct Vec;
template <> struct Vec<4> { using type = float4; };
template <> struct Vec<1> { using type = float; };

__device__ __forceinline__ float fefet_current(float g, float v,
                                               const Device& d) {
  const float dv = g - v;
  const float x = dv * d.inv_ss_v;
  const float s = 1.f / (1.f + expf(-x));
  const float i = expf(__fadd_rn(d.log_off, __fmul_rn(d.log_span, s)));
  return i * (1.f + d.overdrive * fmaxf(dv, 0.f));
}

__device__ __forceinline__ float cell(float g1, float g2, float v1, float v2,
                                      const Device& d, float i_thresh) {
  const float i = fefet_current(g1, v1, d) + fefet_current(g2, v2, d);
  return i > i_thresh ? i : 0.f;
}

__device__ __forceinline__ float cells(float4 g1, float4 g2, float4 v1,
                                       float4 v2, const Device& d,
                                       float i_thresh) {
  float s = cell(g1.x, g2.x, v1.x, v2.x, d, i_thresh);
  s += cell(g1.y, g2.y, v1.y, v2.y, d, i_thresh);
  s += cell(g1.z, g2.z, v1.z, v2.z, d, i_thresh);
  s += cell(g1.w, g2.w, v1.w, v2.w, d, i_thresh);
  return s;
}

__device__ __forceinline__ float cells(float g1, float g2, float v1, float v2,
                                       const Device& d, float i_thresh) {
  return cell(g1, g2, v1, v2, d, i_thresh);
}

// W: cells per load (4: 16-byte vectors; 1: scalars).  A row wider than
// `lanes` vectors is taken in chunks of `lanes`, with the gate voltages
// reloaded per chunk.
template <int W>
__global__ void __launch_bounds__(THREADS)
mibo_mc_kernel(const float* __restrict__ vth1, const float* __restrict__ vth2,
               const float* __restrict__ g1, const float* __restrict__ g2,
               float* __restrict__ out, int S, int C, int lanes, Device d,
               float i_thresh) {
  using V = typename Vec<W>::type;
  const V* r1 = reinterpret_cast<const V*>(vth1);
  const V* r2 = reinterpret_cast<const V*>(vth2);
  const V* gv1 = reinterpret_cast<const V*>(g1);
  const V* gv2 = reinterpret_cast<const V*>(g2);
  const int nv = C / W;                          // vectors per row
  const int q = threadIdx.x & (lanes - 1);       // this thread's first one
  const int per_block = THREADS / lanes;         // row groups per block
  const long long groups = (long long)gridDim.x * per_block;
  const long long grp =
      (long long)blockIdx.x * per_block + threadIdx.x / lanes;
  const bool chunked = nv > lanes;

  V gc1, gc2;
  if (!chunked && q < nv) {
    gc1 = gv1[q];
    gc2 = gv2[q];
  }

  for (long long s0 = 0; s0 < S; s0 += groups * ROWS) {
    float part[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) part[r] = 0.f;
    for (int base = 0; base < nv; base += lanes) {
      const int v = base + q;
      if (chunked && v < nv) {
        gc1 = gv1[v];
        gc2 = gv2[v];
      }
      V a1[ROWS], a2[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const long long s = s0 + r * groups + grp;
        if (s < S && v < nv) {
          a1[r] = __ldcs(r1 + s * nv + v);
          a2[r] = __ldcs(r2 + s * nv + v);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const long long s = s0 + r * groups + grp;
        if (s < S && v < nv)
          part[r] += cells(gc1, gc2, a1[r], a2[r], d, i_thresh);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float p = part[r];
      for (int off = lanes / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xFFFFFFFFu, p, off);
      const long long s = s0 + r * groups + grp;
      if (q == 0 && s < S) out[s] = p;
    }
  }
}

template <int W>
int launch(const float* vth1, const float* vth2, const float* g1,
           const float* g2, float* out, int S, int C, int lanes,
           const Device& d, float i_thresh, cudaStream_t stream) {
  const long long rows = (long long)THREADS / lanes * ROWS;
  const long long blocks = (S + rows - 1) / rows;   // no cap per SM
  mibo_mc_kernel<W><<<(unsigned)blocks, THREADS, 0, stream>>>(
      vth1, vth2, g1, g2, out, S, C, lanes, d, i_thresh);
  return (int)cudaGetLastError();
}

}  // namespace

// vth1, vth2 (S, C), g1, g2 (C,) float32; out (S,) float32; all device
// pointers, row-major and contiguous.  log_span is log_on - log_off.
// Returns the CUDA error of the launch (0 on success).
extern "C" int mibo_mc_launch(const void* vth1, const void* vth2,
                              const void* g1, const void* g2, void* out,
                              int S, int C, float log_off, float log_span,
                              float ss_v, float overdrive, float i_thresh,
                              void* stream) {
  if (S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = C % 4 == 0 && aligned(vth1) && aligned(vth2) &&
                   aligned(g1) && aligned(g2);
  const int nv = vec ? C / 4 : C;
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes *= 2;
  const Device d{log_off, log_span, (float)(1.0 / ss_v), overdrive};
  const auto* v1 = static_cast<const float*>(vth1);
  const auto* v2 = static_cast<const float*>(vth2);
  const auto* a = static_cast<const float*>(g1);
  const auto* b = static_cast<const float*>(g2);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<4>(v1, v2, a, b, o, S, C, lanes, d, i_thresh, s)
             : launch<1>(v1, v2, a, b, o, S, C, lanes, d, i_thresh, s);
}
