// Fused HDC random-projection encode + Z-score quantize on Hopper.
//
// Replaces the Pallas TPU kernel `hdc_encode` of
// src/repro/kernels/hdc_encode/kernel.py (body `_encode_kernel`).
//
// What is computed, for X (B, n) and P (n, D), float32, row-major:
//   H[b, j]  = sum_k X[b, k] * P[k, j]       (float32-accurate, 3xTF32)
//   norm[b]  = sqrtf(sum_k X[b, k]^2 + 1e-12f)      (float32, CUDA cores)
//   code[b, j] = #{ t : H[b, j] > thr[t] * norm[b] }    (int32)
// The comparison is exactly `h > t * norm`, as in the TPU kernel; written
// as `h / norm > t` it would move codes that sit on a threshold.
//
// The product runs on the tensor cores as 3xTF32: each operand is split
// into hi = tf32(a) and lo = tf32(a - hi) (round to nearest, ties away, on
// the float32 bit pattern, as `cvt.rna.tf32.f32` rounds; without the split
// the tensor cores drop the low 13 bits of each float), and each 8-deep
// step accumulates lo_x*hi_p, hi_x*lo_p and then hi_x*hi_p into float32
// (lo*lo, below 2^-22 of the product, is dropped).  The tensor cores'
// float32 accumulation truncates, so on the Table III stand-ins 1e-6 to
// 6e-6 of the codes differ from the plain float32 product's (1e-7 to 5e-7
// for an SGEMM on the CUDA cores); `chip_smoke.py` holds that fraction
// under ENCODE_FP32_FRACTION (1e-5) at the four path shapes, which a
// single TF32 product (5e-4) fails.
//
// What bounds it on this card: three TF32 products at 495 TFLOP/s against
// the bytes at 3.35 TB/s (X and P read once, codes written once).  At
// ISOLET (B = 6,238, n = 617) that is 0.048 ms at D = 1,024 and 0.191 ms
// at D = 4,096, operations; at PAMAP (B = 61,114, n = 75, D = 1,024) the
// 250 MB of int32 codes take 0.080 ms, bytes.  The same product in float32
// on the CUDA cores could not pass 0.119 / 0.476 ms at ISOLET.  What holds
// this kernel near 2x its bound at ISOLET is shared memory: `wgmma` reads
// the B planes (4 KB per warpgroup and product), and splitting P into
// them moves about as many bytes again through shared memory per tile
// (PERF.md).
//
// Design: a block of two warpgroups owns a 128 x 128 tile of H, each
// warpgroup 64 rows as one `wgmma.m64n128k8` TF32 accumulator (64 floats a
// thread).  k advances 16 at a time through a 3-stage `cp.async` ring of
// raw X and P tiles, so the next tiles' copies overlap this tile's work.
// X rows are never 16-byte aligned at the datasets' odd n, so X comes in
// 4-byte copies (16 consecutive floats of a row per half warp); P in
// 16-byte copies when D % 4 == 0.  TF32 `wgmma` takes B only K-major from
// shared memory, while P is stored D-major: per tile the block splits the
// raw P tile into hi and lo planes, K-major in 8 x 4 core matrices (one
// 16-byte store per 4 k of a column), and each warp reads its A fragments
// (the `mma.m16n8k8` layout) from the raw X tile and splits them in
// registers.  The warps sum x^2 from the same fragments, on the CUDA cores
// in float32.  A row stride of 20 floats (X) and 136 (P) keeps those reads
// free of bank conflicts.  The epilogue multiplies thr[t] * norm once per
// row, counts, swaps pairs of codes with the neighbouring lane and stores
// 16-byte vectors along D.  Ragged B, n and D are masked in the kernel:
// copies past an edge fill zeros (nothing added to the product or the
// norm), codes past an edge are not stored.  Two blocks fit an SM (72 KB
// of shared memory each, <= 128 registers a thread), so one block's
// splitting and epilogue overlap the other's products.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;               // rows of X (and H) per block
constexpr int BN = 128;               // columns of P (and H) per block
constexpr int BK = 16;                // depth of one staged tile
constexpr int STAGES = 3;             // cp.async ring over k
constexpr int THREADS = 256;          // 2 warpgroups, 64 rows each
constexpr int XS = BK + 4;            // X tile row stride, floats
constexpr int PS = BN + 8;            // P tile row stride, floats
constexpr int STAGE_FLOATS = BM * XS + BK * PS;
// B operand planes: per 8-deep step, hi and lo, BN x 8 floats each, K-major
// in 8 x 4 core matrices (128 bytes): element (n, k) at float
// (n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + k % 4
constexpr int PLANE = BN * 8;
constexpr int PLANE_FLOATS = (BK / 8) * 2 * PLANE;
constexpr int SMEM_BYTES = (STAGES * STAGE_FLOATS + PLANE_FLOATS) * 4;
constexpr int MAX_THR = 255;          // thresholds: bits <= 8
constexpr int FEW_THR = 7;            // kept scaled in registers: bits <= 3

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4- and 16-byte copies to shared memory; a copy with `ok` false reads
// nothing and fills zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a rounded to TF32 (10 fraction bits), to nearest with ties away from
// zero: the rounding of `cvt.rna.tf32.f32` on finite floats, in two
// integer operations (ptxas expands the `cvt` into four, with a guard for
// Inf and NaN that finite features and projections never need)
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// a = hi + lo + (below 2^-22 |a|), hi and lo TF32 values in float32 bits
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(__fsub_rn(a, __uint_as_float(hi)));
}

// wgmma descriptor of a B plane (K-major, no swizzle): its shared-memory
// address, the byte step between core matrices along K (leading: 128) and
// along N (stride: 256)
__device__ __forceinline__ uint64_t desc(const float* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// d (64 x 128 per warpgroup) += a (64 x 8, registers) * b (8 x 128, smem)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stage k tile [k0, k0 + BK) of the block's X rows and P columns.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* xs, float* ps,
                                          const float* __restrict__ x,
                                          const float* __restrict__ p,
                                          int B, int n, int D, int row0,
                                          int col0, int k0, int tid) {
  // X: one column k of the tile, rows tid / BK + v * RSTEP
  constexpr int RSTEP = THREADS / BK;
  const int kx = tid % BK, rx = tid / BK, gkx = k0 + kx;
  const float* src = x + (size_t)(row0 + rx) * n + gkx;
  const uint32_t dst = smem_u32(xs + rx * XS + kx);
#pragma unroll
  for (int v = 0; v < BM / RSTEP; ++v) {
    const bool ok = row0 + rx + v * RSTEP < B && gkx < n;
    cp_async4(dst + v * RSTEP * XS * 4,
              ok ? src + (size_t)v * RSTEP * n : x, ok);
  }
  if constexpr (VEC) {
#pragma unroll
    for (int v = 0; v < BK * BN / 4 / THREADS; ++v) {
      const int idx = tid + v * THREADS;
      const int k = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      const int gk = k0 + k, gc = col0 + c;
      const bool ok = gk < n && gc < D;     // D % 4 == 0: all 4 or none
      cp_async16(smem_u32(ps + k * PS + c), ok ? p + (size_t)gk * D + gc : p,
                 ok);
    }
  } else {
#pragma unroll
    for (int v = 0; v < BK * BN / THREADS; ++v) {
      const int idx = tid + v * THREADS;
      const int k = idx / BN, c = idx % BN;
      const int gk = k0 + k, gc = col0 + c;
      const bool ok = gk < n && gc < D;
      cp_async4(smem_u32(ps + k * PS + c), ok ? p + (size_t)gk * D + gc : p,
                ok);
    }
  }
}

// VEC: D % 4 == 0 and P, out 16-byte aligned (16-byte P copies and code
// stores).  FEW: n_thr <= FEW_THR, the thresholds times the row norm kept
// in registers (past n_thr: +inf, which no value exceeds).
template <bool VEC, bool FEW>
__global__ void __launch_bounds__(THREADS, 2)
hdc_encode_kernel(const float* __restrict__ x, const float* __restrict__ p,
                  const float* __restrict__ thr, int32_t* __restrict__ out,
                  int B, int n, int D, int n_thr) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float norm_s[BM];
  __shared__ float thr_s[MAX_THR];
  float* planes = smem + STAGES * STAGE_FLOATS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;       // fragment coordinates
  const int wrow = warp * 16;                 // this warp's 16 rows
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  for (int u = tid; u < n_thr; u += THREADS) thr_s[u] = thr[u];

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  float sq[2] = {0.f, 0.f};       // rows g and g + 8

  const int ktiles = (n + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      float* st = smem + s * STAGE_FLOATS;
      load_tile<VEC>(st, st + BM * XS, x, p, B, n, D, row0, col0, s * BK,
                     tid);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed (this thread's part)
    __syncthreads();               // ... everyone's; slot kt - 1 and the
                                   // planes are free
    {
      const int nk = kt + STAGES - 1;
      if (nk < ktiles) {
        float* st = smem + (nk % STAGES) * STAGE_FLOATS;
        load_tile<VEC>(st, st + BM * XS, x, p, B, n, D, row0, col0, nk * BK,
                       tid);
      }
      cp_async_commit();
    }
    const float* xs = smem + (kt % STAGES) * STAGE_FLOATS + wrow * XS;
    const float* ps = smem + (kt % STAGES) * STAGE_FLOATS + BM * XS;
    // P tile -> hi and lo planes, K-major: 4 consecutive k of one column
    // per 16-byte store
#pragma unroll
    for (int v = 0; v < BK * BN / 4 / THREADS; ++v) {
      const int kg = tid / BN + v * (THREADS / BN), nn = tid % BN;
      uint4 hi, lo;
      split_tf32(ps[(kg * 4 + 0) * PS + nn], hi.x, lo.x);
      split_tf32(ps[(kg * 4 + 1) * PS + nn], hi.y, lo.y);
      split_tf32(ps[(kg * 4 + 2) * PS + nn], hi.z, lo.z);
      split_tf32(ps[(kg * 4 + 3) * PS + nn], hi.w, lo.w);
      float* dst = planes + (kg / 2) * 2 * PLANE + (nn / 8) * 64 +
                   (kg % 2) * 32 + (nn % 8) * 4;
      *reinterpret_cast<uint4*>(dst) = hi;
      *reinterpret_cast<uint4*>(dst + PLANE) = lo;
    }
    fence_async_smem();
    __syncthreads();
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const float* xr = xs + g * XS + s * 8 + t;
      const float a[4] = {xr[0], xr[8 * XS], xr[4], xr[8 * XS + 4]};
      sq[0] += a[0] * a[0];
      sq[0] += a[2] * a[2];
      sq[1] += a[1] * a[1];
      sq[1] += a[3] * a[3];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[s][e], al[s][e]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const float* pl = planes + s * 2 * PLANE;
      wgmma_tf32(acc, al[s], desc(pl));           // lo_x * hi_p
      wgmma_tf32(acc, ah[s], desc(pl + PLANE));   // hi_x * lo_p
      wgmma_tf32(acc, ah[s], desc(pl));           // hi_x * hi_p
    }
    wgmma_commit();
    wgmma_wait0();                 // the planes are free for the next tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = sq[h];
    s += __shfl_xor_sync(0xFFFFFFFFu, s, 1);
    s += __shfl_xor_sync(0xFFFFFFFFu, s, 2);
    if (t == 0) norm_s[wrow + h * 8 + g] = sqrtf(s + 1e-12f);
  }
  __syncwarp();

  const bool odd = t & 1;
  const int r = wrow + g;                     // rows r and r + 8
  const float nrm[2] = {norm_s[r], norm_s[r + 8]};
  float tn[2][FEW ? FEW_THR : 1];
  if constexpr (FEW) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < FEW_THR; ++u)
        tn[h][u] = u < n_thr ? thr_s[u] * nrm[h] : __int_as_float(0x7f800000);
  }
  const int gr = row0 + r + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    int c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hv = acc[4 * j + e];
      int code = 0;
      if constexpr (FEW) {
#pragma unroll
        for (int u = 0; u < FEW_THR; ++u) code += hv > tn[e / 2][u] ? 1 : 0;
      } else {
        for (int u = 0; u < n_thr; ++u)
          code += hv > thr_s[u] * nrm[e / 2] ? 1 : 0;
      }
      c[e] = code;
    }
    // lane t even keeps row r, cols 2t..2t+3; its odd neighbour row r + 8
    const int s0 = odd ? c[0] : c[2], s1 = odd ? c[1] : c[3];
    const int r0 = __shfl_xor_sync(0xFFFFFFFFu, s0, 1);
    const int r1 = __shfl_xor_sync(0xFFFFFFFFu, s1, 1);
    const int4 v = odd ? make_int4(r0, r1, c[2], c[3])
                       : make_int4(c[0], c[1], r0, r1);
    const int gc = col0 + j * 8 + (t & 2) * 2;
    if (gr >= B) continue;
    int32_t* o = out + (size_t)gr * D + gc;
    if constexpr (VEC) {
      if (gc < D) *reinterpret_cast<int4*>(o) = v;
    } else {
      if (gc < D) o[0] = v.x;
      if (gc + 1 < D) o[1] = v.y;
      if (gc + 2 < D) o[2] = v.z;
      if (gc + 3 < D) o[3] = v.w;
    }
  }
}

template <bool VEC, bool FEW>
int launch(const float* x, const float* p, const float* thr, int32_t* out,
           int B, int n, int D, int n_thr, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      hdc_encode_kernel<VEC, FEW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((D + BN - 1) / BN, (B + BM - 1) / BM);
  hdc_encode_kernel<VEC, FEW><<<grid, THREADS, SMEM_BYTES, stream>>>(
      x, p, thr, out, B, n, D, n_thr);
  return (int)cudaGetLastError();
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
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* pf = static_cast<const float*>(p);
  const auto* tf = static_cast<const float*>(thr);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool few = n_thr <= FEW_THR;
  if (vec)
    return few ? launch<true, true>(xf, pf, tf, o, B, n, D, n_thr, s)
               : launch<true, false>(xf, pf, tf, o, B, n, D, n_thr, s);
  return few ? launch<false, true>(xf, pf, tf, o, B, n, D, n_thr, s)
             : launch<false, false>(xf, pf, tf, o, B, n, D, n_thr, s);
}
