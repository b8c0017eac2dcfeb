// Causal GQA flash attention (online softmax) on Hopper: bfloat16 on the
// tensor cores, float32 on the CUDA cores.
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
// in the row maximum and the guard on p keeps exp from seeing it.  l sums
// the float32 p, before p is rounded for the product with V.
//
// Tiles wholly above the diagonal are skipped.  That is exact: key 0 is
// live for every row (top-left alignment) and sits in the first tile, so a
// later tile whose keys are all masked leaves m (alpha = 1), l and acc
// unchanged.
//
// The dtype picks the kernel; neither is a fallback for the other.
//
// bfloat16 (`tc::flash_bf16_kernel`).  What bounds it on this card:
// operations.  At the LM's prefill shape (B = 1, S = 4,096, H = 32,
// dh = 128, causal) the two products are 2 * S^2 * dh * H = 137 GFLOP,
// 0.14 ms at the 989 TFLOP/s bf16 tensor-core rate, against 75 MB of q, k,
// v and o, 0.02 ms at 3.35 TB/s.  The float32 CUDA-core kernel below ran
// this at about 19 TFLOP/s: two shared loads per four FMAs, probabilities
// through shared memory, synchronous tile loads.  This kernel follows
// FlashAttention-2: a block of 4 warps owns 64 query rows of one head (16
// a warp), longest causal rows first.  Q is loaded once and kept as
// `mma.sync` A fragments in registers (in shared memory at dh > 128, where
// the 16 x 256 float32 accumulator alone takes 128 registers a thread).
// K and V tiles of 64 keys go through a two-stage `cp.async` ring, the
// next tile in flight while this one is computed, with one barrier per
// tile; at dh <= 128 the ring is all the shared memory (64 KB), so three
// blocks share an SM.  Rows are XOR-swizzled so that `ldmatrix` (K) and
// `ldmatrix.trans` (V) are free of bank conflicts.
// S = Q . K^T and O += P . V run as m16n8k16 bf16 products with float32
// accumulation; the scores, the softmax statistics (two quad shuffles per
// row) and O stay in registers, and P is rounded to bf16 and repacked from
// the accumulator layout into A fragments in registers.  dh is zero-padded
// in shared memory to 16, 32, 64, 128 or 256; zero columns of Q and K add
// nothing to s, and padded columns of O are not stored.  The tile shape is
// `Tile<HD>`: of the shapes scripts/kernel_variants.py times at dh = 128
// (32 rows a warp, 32-key tiles, Q in shared memory, 2-4 blocks per SM),
// this one is the fastest (PERF.md).  It reaches about a sixth of the
// tensor-core rate: every 64-key tile a warp waits on its own chain of
// products, softmax (the accurate expf, kept for the reference's
// semantics) and products again, with three warps per scheduler to hide it.
// The next step is `wgmma` fed by TMA with a producer warp, the softmax of
// one tile overlapping the products of the next.
//
// float32 (`flash_kernel`).  Runs the products on the CUDA cores in
// float32, held by the float32 rate and by shared-memory loads; it stays
// there because TF32 tensor cores would break the 2e-5 tolerance of the
// reference test.  One block of 256 threads per (q head, 64-row query
// tile), the longest causal rows scheduled first.  The query tile is
// staged once in shared memory as float32; each 64-key tile of K, then of
// V, is staged through one shared buffer (rows padded by one float, so the
// strided reads of K hit distinct banks).  A 16 x 16 thread grid gives each
// thread 4 query rows x 4 keys of the score tile and 4 rows x
// ceil(dh / 16) columns of the output accumulator, in registers; row max
// and row sum are shuffle reductions over the 16 threads of a row group.
// The probabilities go through shared memory to the P . V product.
//
// Both mask ragged Sq and Skv (a tile past the end) in the kernel: rows
// past Sq are not stored, keys past Skv count as masked.

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

__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int n_rows, int dh, int ld) {
  // rows [row0, row0 + BQ) of a (n_rows, dh) matrix into a (BQ, ld) tile,
  // zeros past n_rows
  for (int i = threadIdx.x; i < BQ * dh; i += THREADS) {
    const int r = i / dh, c = i - r * dh;
    dst[r * ld + c] = (row0 + r < n_rows)
        ? src[(long long)(row0 + r) * dh + c] : 0.f;
  }
}

template <int NJ>   // NJ: output columns per thread, >= dh / 16
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int BH,
             int Sq, int Skv, int dh, int group, int causal, float scale) {
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
  const float* kp = k + (long long)(bh / group) * Skv * dh;
  const float* vp = v + (long long)(bh / group) * Skv * dh;

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
        sP[(ty * ROWS + i) * LDP + tx + j * TX] = p;
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
    float* orow = o + ((long long)bh * Sq + r) * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + j * TX;
      if (c < dh) orow[c] = acc[i][j] / den;
    }
  }
}

template <int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Skv, int dh, int group, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (dh + 1) + (size_t)BQ * LDP);
  auto kern = flash_kernel<NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nq = (Sq + BQ - 1) / BQ;
  const long long blocks = nq * BH;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, Sq, Skv, dh,
      group, causal, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 int BH, int Sq, int Skv, int dh, int group, int causal,
                 float scale, cudaStream_t stream) {
#define REPRO_F32(NJ)                                                        \
  return launch<NJ>(q, k, v, o, BH, Sq, Skv, dh, group, causal, scale, stream)
  if (dh <= 16) REPRO_F32(1);
  if (dh <= 32) REPRO_F32(2);
  if (dh <= 64) REPRO_F32(4);
  if (dh <= 128) REPRO_F32(8);
  REPRO_F32(16);
#undef REPRO_F32
}


// ---------------------------------------------------------------------------
// bfloat16: the products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// The tile shape at head width HD: MT 16-row m tiles per warp (BQ = 64 MT
// query rows per block), BK keys per K/V tile, Q kept as A fragments in
// registers or read from shared memory on every tile, and the blocks per
// SM the register budget is set for.
template <int HD>
struct Tile {
  static constexpr int MT = 1;
  static constexpr int BK = 64;
  static constexpr bool Q_IN_REGS = HD <= 128;
  static constexpr int MIN_BLOCKS = HD <= 128 ? 3 : 1;
  static constexpr int BQ = 16 * WARPS * MT;
};

// Index of the 16-byte chunk holding (row r, logical chunk c) of a tile
// whose rows are C chunks long.  Rows are XOR-swizzled so that the eight
// row addresses of one ldmatrix phase (rows 8i..8i+7, one logical chunk)
// fall into eight distinct 16-byte bank groups at every width.
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (C >= 8) return r * C + (c ^ (r & 7));
  else return r * C + (c ^ ((r / (8 / C)) & (C - 1)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

// c += a . b for one 16 x 8 x 16 tile: a (16 x 16, row-major fragment),
// b (16 x 8, column-major fragment), c float32.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to nearest-even bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [row0, row0 + R) of a row-major (n_rows, dh) bf16 matrix into a
// swizzled (R, HD) tile; columns past dh and rows past n_rows read as 0.
// `vec`: dh % 8 == 0 and 16-byte aligned bases, so each chunk is one
// asynchronous 16-byte copy; otherwise the chunk is gathered in place.
template <int HD, int R>
__device__ __forceinline__ void load_tile(uint4* tile,
                                          const __nv_bfloat16* src, int row0,
                                          int n_rows, int dh, bool vec) {
  constexpr int C = HD / 8;
  for (int i = threadIdx.x; i < R * C; i += THREADS) {
    const int r = i / C, c = i % C;
    const int row = row0 + r, col = c * 8;
    uint4* dst = tile + swz<C>(r, c);
    if (row < n_rows && col < dh) {
      const __nv_bfloat16* p = src + (long long)row * dh + col;
      if (vec) {
        cp_async16(smem_u32(dst), p);
        continue;
      }
      const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = col + 2 * e < dh ? ps[2 * e] : 0u;
        const uint32_t hi = col + 2 * e + 1 < dh ? ps[2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *dst = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      *dst = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Shared memory of the kernel at width HD: a two-stage ring, each stage a
// K tile then a V tile, and a Q tile of its own where Q is read from
// shared memory on every tile.  Where Q lives in registers it passes
// through the ring's second stage before the first prefetch.
template <int HD>
constexpr size_t smem_bytes() {
  using T = Tile<HD>;
  return (size_t)(4 * T::BK + (T::Q_IN_REGS ? 0 : T::BQ)) * HD *
         sizeof(__nv_bfloat16);
}

template <int HD>   // HD: dh padded to 16, 32, 64, 128 or 256
__global__ void __launch_bounds__(THREADS, Tile<HD>::MIN_BLOCKS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int BH, int Sq, int Skv,
                  int dh, int group, int causal, float scale, int vec) {
  using T = Tile<HD>;
  constexpr int MT = T::MT, BK = T::BK, BQ = T::BQ;
  constexpr bool Q_IN_REGS = T::Q_IN_REGS;
  constexpr int C = HD / 8;            // 16-byte chunks per row
  constexpr int KS = HD / 16;          // 16-wide steps of Q . K^T
  constexpr int NT = BK / 8;           // 8-key column tiles of a score tile
  constexpr int STAGE = 2 * BK * C;    // chunks of one ring stage
  static_assert(!Q_IN_REGS || BQ <= 2 * BK, "Q passes through a stage");
  extern __shared__ uint4 smem_tc[];
  uint4* sQ = Q_IN_REGS ? smem_tc + STAGE : smem_tc + 2 * STAGE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;    // row group, thread in group
  const int nq = (Sq + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)(blockIdx.x / BH);   // longest rows first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qi * BQ;
  const int kvh = bh / group;
  const __nv_bfloat16* kp = k + (long long)kvh * Skv * dh;
  const __nv_bfloat16* vp = v + (long long)kvh * Skv * dh;

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int nk = (kv_end + BK - 1) / BK;

  load_tile<HD, BQ>(sQ, q + (long long)bh * Sq * dh, q0, Sq, dh, vec);
  load_tile<HD, BK>(smem_tc, kp, 0, Skv, dh, vec);
  load_tile<HD, BK>(smem_tc + BK * C, vp, 0, Skv, dh, vec);
  cp_async_commit();

  // ldmatrix row/chunk offsets of this lane
  const int a_row = warp * 16 * MT + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_chunk = lane >> 4;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_chunk = (lane >> 3) & 1;
  const int vb_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vb_chunk = lane >> 4;

  float acc[MT][HD / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = NEG_INF;
      l[mt][r] = 0.f;
    }
  uint32_t qf[Q_IN_REGS ? MT : 1][Q_IN_REGS ? KS : 1][4];
  // this thread's rows: row_lo + 16 mt + {0, 8}
  const int row_lo = q0 + warp * 16 * MT + g;

  cp_async_wait<0>();
  __syncthreads();
  if constexpr (Q_IN_REGS) {           // Q to registers, freeing its stage
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(smem_u32(sQ + swz<C>(a_row + 16 * mt, 2 * kk + a_chunk)),
                qf[mt][kk][0], qf[mt][kk][1], qf[mt][kk][2], qf[mt][kk][3]);
    __syncthreads();
  }

  for (int kt = 0; kt < nk; ++kt) {
    const uint4* cK = smem_tc + (kt & 1) * STAGE;
    const uint4* cV = cK + BK * C;
    if (kt > 0) {
      cp_async_wait<0>();              // this tile has landed, and every
      __syncthreads();                 // warp is done with the last one
    }
    if (kt + 1 < nk) {                 // the next tile flies during this one
      uint4* nK = smem_tc + ((kt + 1) & 1) * STAGE;
      load_tile<HD, BK>(nK, kp, (kt + 1) * BK, Skv, dh, vec);
      load_tile<HD, BK>(nK + BK * C, vp, (kt + 1) * BK, Skv, dh, vec);
      cp_async_commit();
    }

    // s = Q . K^T for the warp's 16 MT rows x BK keys, float32 in
    // registers; each K fragment serves the warp's MT m tiles
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kk][e];
        } else {
          ldsm_x4(smem_u32(sQ + swz<C>(a_row + 16 * mt, 2 * kk + a_chunk)),
                  a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
        }
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(cK + swz<C>(np * 16 + kb_row, 2 * kk + kb_chunk)),
                b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][2 * np], a[mt], b0, b1);
          mma16816(s[mt][2 * np + 1], a[mt], b2, b3);
        }
      }
    }

    // scale, mask (the diagonal and ragged tiles only), online softmax;
    // a row's four threads (t4 = 0..3) reduce with two shuffles
    const int kbase = kt * BK;
    const bool edge = kbase + BK > Skv || (causal && kbase + BK - 1 > q0);
    uint32_t pa[MT][BK / 16][4];       // P as A fragments of P . V
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e] * scale;
          if (edge) {
            const int kpos = kbase + j * 8 + 2 * t4 + (e & 1);
            const int qpos = row_lo + 16 * mt + (e >> 1) * 8;
            const bool keep = kpos < Skv && (!causal || qpos >= kpos);
            x = keep ? x : NEG_INF;
          }
          s[mt][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], m_new[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 2));
        m_new[r] = fmaxf(m[mt][r], mx[r]);
        alpha[r] = expf(fminf(m[mt][r] - m_new[r], 0.f));
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          p[e] = s[mt][j][e] > NEG_INF / 2 ? expf(s[mt][j][e] - m_new[r])
                                           : 0.f;
          rs[r] += p[e];               // l sums the float32 p
        }
        pa[mt][j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[mt][j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xFFFFFFFFu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xFFFFFFFFu, rs[r], 2);
        l[mt][r] = l[mt][r] * alpha[r] + rs[r];
        m[mt][r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= alpha[e >> 1];
    }

    // acc += P . V, V's B fragments through ldmatrix.trans, each serving
    // the warp's MT m tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(smem_u32(cV + swz<C>(kk * 16 + vb_row, 2 * dp + vb_chunk)),
                  b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * dp], pa[mt][kk], b0, b1);
          mma16816(acc[mt][2 * dp + 1], pa[mt][kk], b2, b3);
        }
      }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 16 * mt + r * 8;
      if (row >= Sq) continue;
      const float den = fmaxf(l[mt][r], 1e-30f);
      __nv_bfloat16* orow = o + ((long long)bh * Sq + row) * dh;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int col = n * 8 + 2 * t4;
        if (col < dh) orow[col] = __float2bfloat16(acc[mt][n][2 * r] / den);
        if (col + 1 < dh)
          orow[col + 1] = __float2bfloat16(acc[mt][n][2 * r + 1] / den);
      }
    }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int BH,
                int Sq, int Skv, int dh, int group, int causal, float scale,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  auto kern = flash_bf16_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nq = (Sq + Tile<HD>::BQ - 1) / Tile<HD>::BQ;
  const long long blocks = nq * BH;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const int vec = dh % 8 == 0 && bases % 16 == 0;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      BH, Sq, Skv, dh, group, causal, scale, vec);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  int BH, int Sq, int Skv, int dh, int group, int causal,
                  float scale, cudaStream_t stream) {
#define REPRO_BF16(HD)                                                     \
  return launch_bf16<HD>(q, k, v, o, BH, Sq, Skv, dh, group, causal, scale, \
                         stream)
  if (dh <= 16) REPRO_BF16(16);
  if (dh <= 32) REPRO_BF16(32);
  if (dh <= 64) REPRO_BF16(64);
  if (dh <= 128) REPRO_BF16(128);
  REPRO_BF16(256);
#undef REPRO_BF16
}

}  // namespace tc

}  // namespace

// q (BH, Sq, dh), k and v (BH / group, Skv, dh), o (BH, Sq, dh): device
// pointers, row-major and contiguous, all float32 (dtype 0: the CUDA-core
// kernel) or all bfloat16 (dtype 1: the tensor-core kernel).
// 1 <= dh <= 256.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH, int Sq,
                                      int Skv, int dh, int group, int causal,
                                      float scale, int dtype, void* stream) {
  if (BH < 1 || Sq < 1 || Skv < 1 || dh < 1 || dh > 256 || group < 1 ||
      BH % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(q, k, v, o, BH, Sq, Skv, dh, group, causal, scale, s);
  if (dtype == 1)
    return tc::dispatch_bf16(q, k, v, o, BH, Sq, Skv, dh, group, causal,
                             scale, s);
  return (int)cudaErrorInvalidValue;
}
