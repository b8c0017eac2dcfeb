// Multi-bit CAM search on Hopper: the dense and the fused top-k tier.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/cam_search/
// kernel.py: `cam_search` (dense (Q, N) mismatch counts) and
// `cam_search_topk` (streaming per-query top-k with an in-kernel
// `valid_rows` mask and an optional threshold count).
//
// What is computed (bit for bit the one-hot Gram rule of the TPU kernels):
//   unmasked: mismatches(q, t) = D - #{d : q_d == t_d and 0 <= q_d < levels}
//   masked:   mismatches(q, t) = #{d : care_d != 0 and 0 <= q_d < levels
//                                     and q_d != t_d}
// over int8 symbols.  Instead of one-hot products on a matrix unit, each
// thread compares 4 symbols per 32-bit word with byte-wise bit tricks and
// counts with __popc; counts accumulate in int32.
//
// What bounds it on this card: at the serving shape (Q = 64 queries,
// N = 2^20 rows, D = 256) the table is 256 MiB of int8, read once; that
// read is the bound (about 80 us at 3.35 TB/s).  The symbol compares run on
// the integer ALUs, about six instructions per 4 symbols, which makes this
// simple version compute-bound well above that; tensor-core one-hot
// products are the route to the bound and are left to a later change.
//
// Design.  A block owns BQ queries and walks table tiles of BN rows,
// loading D in 64-byte chunks into shared memory.  The dense kernel writes
// each tile's counts out.  The fused kernel cannot carry a running top-k
// across blocks (blocks run in parallel and in no order), so it runs in two
// passes: pass 1 splits N over blocks; each block keeps, per query, a
// sorted list of the k smallest packed keys (distance << 32 | row) of its
// own split in shared memory, plus a per-query threshold count; pass 2
// merges the splits' lists into (Q, k) and sums the counts (no atomics, so
// the result is deterministic).  Keys are unique per row, so the list
// order is exactly ascending (distance, row): ties go to the lowest row,
// and rows at index >= valid_rows carry distance 0xFFFFFFFF (+inf) with
// their own row index.  Unfilled slots hold (+inf, 2^31 - 1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 128;          // table rows per tile
constexpr int DC = 64;           // D bytes per shared-memory chunk
constexpr int DCW = DC / 4;      // 32-bit words per chunk row
constexpr int LDW = DCW + 1;     // padded shared row stride, in words
constexpr int THREADS = 256;     // a 16 x 16 grid of threads
constexpr int TN = BN / 16;      // table rows per thread
constexpr int MAX_K = 256;       // largest k of the fused tier
constexpr int MERGE_WARPS = 4;   // queries per block in the merge pass
constexpr uint64_t SENTINEL = 0xFFFFFFFF7FFFFFFFull;   // (+inf, 2^31 - 1)

// 0x80 in every byte of x that is nonzero, 0 elsewhere.  No carry crosses
// a byte: (x & 0x7F) + 0x7F <= 0xFE.
__device__ __forceinline__ uint32_t nonzero80(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// 0x80 in every byte b of q with 0 <= (int8)b < lim, where lim <= 128 and
// lim_add = (128 - lim) * 0x01010101.
__device__ __forceinline__ uint32_t in_range80(uint32_t q, uint32_t lim_add) {
  return ~((((q & 0x7F7F7F7Fu) + lim_add) | q)) & 0x80808080u;
}

// Copy rows [r0, r0 + R) and bytes [d0, d0 + DC) of a row-major
// (rows, D) int8 matrix into shared words dst[R][LDW]; cells outside the
// matrix read as 0.  D is a multiple of 16 and the base is 16-byte aligned.
__device__ __forceinline__ void load_chunk(uint32_t* dst, const int8_t* src,
                                           int r0, int R, int rows, int D,
                                           int d0) {
  constexpr int VPR = DC / 16;
  for (int v = threadIdx.x; v < R * VPR; v += THREADS) {
    const int r = v / VPR, part = v % VPR;
    const int row = r0 + r, col = d0 + part * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && col < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * D + col);
    uint32_t* p = dst + r * LDW + part * 4;
    p[0] = val.x; p[1] = val.y; p[2] = val.z; p[3] = val.w;
  }
}

// Mismatch counts of queries [q0, q0 + BQ) against rows [n0, n0 + BN).
// Thread (ty, tx) owns queries q0 + ty * TQ + i and rows n0 + tx + 16 * j.
// Unmasked it leaves #matches in acc (the caller finalises D - acc);
// masked it leaves #mismatches.
template <int BQ, bool MASKED>
__device__ __forceinline__ void tile_counts(
    int (&acc)[BQ / 16][TN], const int8_t* __restrict__ q,
    const int8_t* __restrict__ t, const int8_t* __restrict__ care, int q0,
    int Q, int n0, int N, int D, uint32_t lim_add, uint32_t* qs,
    uint32_t* ts, uint32_t* cs) {
  constexpr int TQ = BQ / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  for (int d0 = 0; d0 < D; d0 += DC) {
    load_chunk(qs, q, q0, BQ, Q, D, d0);
    load_chunk(ts, t, n0, BN, N, D, d0);
    if (MASKED) load_chunk(cs, care, n0, BN, N, D, d0);
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < DCW; ++w) {
      uint32_t qw[TQ], qv[TQ];
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        qw[i] = qs[(ty * TQ + i) * LDW + w];
        qv[i] = in_range80(qw[i], lim_add);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const uint32_t tw = ts[(tx + 16 * j) * LDW + w];
        const uint32_t cw = MASKED ? nonzero80(cs[(tx + 16 * j) * LDW + w]) : 0u;
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const uint32_t ne = nonzero80(qw[i] ^ tw);
          const uint32_t m = MASKED ? (ne & qv[i] & cw) : (~ne & qv[i]);
          acc[i][j] += __popc(m);
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ uint32_t lim_add_of(int levels) {
  const uint32_t lim = levels < 128 ? (uint32_t)levels : 128u;
  return (128u - lim) * 0x01010101u;
}

template <int BQ, bool MASKED>
__global__ void __launch_bounds__(THREADS)
cam_search_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                  const int8_t* __restrict__ care, int32_t* __restrict__ out,
                  int Q, int N, int D, int levels) {
  constexpr int TQ = BQ / 16;
  __shared__ uint32_t qs[BQ * LDW];
  __shared__ uint32_t ts[BN * LDW];
  __shared__ uint32_t cs[MASKED ? BN * LDW : 1];
  const int n0 = blockIdx.x * BN, q0 = blockIdx.y * BQ;
  int acc[TQ][TN];
  tile_counts<BQ, MASKED>(acc, q, t, care, q0, Q, n0, N, D,
                          lim_add_of(levels), qs, ts, cs);
  const int dtot = (D + DC - 1) / DC * DC;   // zero-filled cells all match
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qq = q0 + ty * TQ + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = n0 + tx + 16 * j;
      if (qq < Q && r < N)
        out[(size_t)qq * N + r] = MASKED ? acc[i][j] : dtot - acc[i][j];
    }
  }
}

// Offer `key` (from every lane where `want` holds) to the sorted list
// L[0, k) that one warp shares in shared memory; the list keeps the k
// smallest keys.  Warp-uniform control flow throughout.
__device__ __forceinline__ void warp_insert(uint64_t* L, int k, uint64_t key,
                                            bool want, int lane) {
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, want);
  while (ballot) {
    const int src = __ffs(ballot) - 1;
    ballot &= ballot - 1;
    const uint64_t kk = __shfl_sync(0xFFFFFFFFu, key, src);
    if (kk < L[k - 1]) {
      int below = 0;
      for (int i = lane; i < k; i += 32) below += L[i] < kk;
      below = __reduce_add_sync(0xFFFFFFFFu, below);
      uint64_t moved[MAX_K / 32];
#pragma unroll
      for (int s = 0; s < MAX_K / 32; ++s) {
        const int i = lane + 32 * s;
        moved[s] = (i >= below && i < k - 1) ? L[i] : 0ull;
      }
      __syncwarp();
#pragma unroll
      for (int s = 0; s < MAX_K / 32; ++s) {
        const int i = lane + 32 * s;
        if (i >= below && i < k - 1) L[i + 1] = moved[s];
      }
      if (lane == 0) L[below] = kk;
      __syncwarp();
    }
  }
}

// Pass 1: block (split, query tile) -> the k smallest keys of its rows for
// each of its queries, in part_keys[q][split][0, k), and its threshold
// count in part_counts[q][split].
template <int BQ, bool MASKED, bool COUNTED>
__global__ void __launch_bounds__(THREADS)
cam_topk_partial_kernel(const int8_t* __restrict__ q,
                        const int8_t* __restrict__ t,
                        const int8_t* __restrict__ care,
                        const int32_t* __restrict__ valid_rows,
                        const float* __restrict__ count_le,
                        uint64_t* __restrict__ part_keys,
                        int32_t* __restrict__ part_counts, int Q, int N,
                        int D, int levels, int k, int splits,
                        int rows_per_split) {
  constexpr int TQ = BQ / 16;
  constexpr int WARPS = THREADS / 32;
  constexpr int QPW = BQ / WARPS;            // queries per warp
  extern __shared__ uint64_t smem[];
  uint64_t* lists = smem;                                  // [BQ][k]
  uint32_t* dist = reinterpret_cast<uint32_t*>(lists + BQ * k);  // [BQ][BN]
  uint32_t* qs = dist + BQ * BN;
  uint32_t* ts = qs + BQ * LDW;
  uint32_t* cs = ts + BN * LDW;

  const int split = blockIdx.x, q0 = blockIdx.y * BQ;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  const int vr = min(*valid_rows, N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int dtot = (D + DC - 1) / DC * DC;
  const uint32_t lim_add = lim_add_of(levels);

  for (int i = threadIdx.x; i < BQ * k; i += THREADS) lists[i] = SENTINEL;
  int cnt[QPW];
  float thr[QPW];
#pragma unroll
  for (int s = 0; s < QPW; ++s) {
    const int qq = q0 + warp + WARPS * s;
    cnt[s] = 0;
    thr[s] = (COUNTED && qq < Q) ? count_le[qq] : 0.0f;
  }
  __syncthreads();

  for (int n0 = r_begin; n0 < r_end; n0 += BN) {
    int acc[TQ][TN];
    tile_counts<BQ, MASKED>(acc, q, t, care, q0, Q, n0, N, D, lim_add, qs,
                            ts, cs);
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        dist[(ty * TQ + i) * BN + tx + 16 * j] =
            MASKED ? acc[i][j] : dtot - acc[i][j];
    __syncthreads();
#pragma unroll
    for (int s = 0; s < QPW; ++s) {
      const int ql = warp + WARPS * s;
      if (q0 + ql >= Q) continue;              // warp-uniform
      uint64_t* L = lists + ql * k;
      for (int c = lane; c < BN; c += 32) {
        const int r = n0 + c;
        const bool real = r < r_end;
        const bool live = r < vr;
        const uint32_t dc = dist[ql * BN + c];
        if (COUNTED && real)
          cnt[s] += (live ? (float)dc : __int_as_float(0x7F800000)) <= thr[s];
        const uint64_t key =
            ((uint64_t)(live ? dc : 0xFFFFFFFFu) << 32) | (uint32_t)r;
        warp_insert(L, k, key, real && key < L[k - 1], lane);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < QPW; ++s) {
    const int ql = warp + WARPS * s, qq = q0 + ql;
    if (qq >= Q) continue;
    uint64_t* dst = part_keys + ((size_t)qq * splits + split) * k;
    for (int i = lane; i < k; i += 32) dst[i] = lists[ql * k + i];
    if (COUNTED) {
      const int c = __reduce_add_sync(0xFFFFFFFFu, cnt[s]);
      if (lane == 0) part_counts[(size_t)qq * splits + split] = c;
    }
  }
}

// Pass 2: one warp per query merges its splits' lists into the final
// (k,) rows and distances and sums the splits' threshold counts.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
cam_topk_merge_kernel(const uint64_t* __restrict__ part_keys,
                      const int32_t* __restrict__ part_counts,
                      int32_t* __restrict__ out_idx,
                      float* __restrict__ out_dist,
                      int32_t* __restrict__ out_count, int Q, int k,
                      int splits) {
  extern __shared__ uint64_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qq = blockIdx.x * MERGE_WARPS + warp;
  if (qq >= Q) return;                          // warp-uniform
  uint64_t* L = smem + warp * k;
  for (int i = lane; i < k; i += 32) L[i] = SENTINEL;
  __syncwarp();
  const uint64_t* src = part_keys + (size_t)qq * splits * k;
  const int total = splits * k;
  for (int base = 0; base < total; base += 32) {
    const int c = base + lane;
    const uint64_t key = c < total ? src[c] : SENTINEL;
    warp_insert(L, k, key, key < L[k - 1], lane);
  }
  for (int i = lane; i < k; i += 32) {
    const uint64_t key = L[i];
    const uint32_t dk = (uint32_t)(key >> 32);
    out_idx[(size_t)qq * k + i] = (int32_t)(uint32_t)key;
    out_dist[(size_t)qq * k + i] =
        dk == 0xFFFFFFFFu ? __int_as_float(0x7F800000) : (float)dk;
  }
  if (out_count != nullptr) {
    int c = 0;
    for (int s = lane; s < splits; s += 32)
      c += part_counts[(size_t)qq * splits + s];
    c = __reduce_add_sync(0xFFFFFFFFu, c);
    if (lane == 0) out_count[qq] = c;
  }
}

template <int BQ, bool MASKED>
cudaError_t launch_dense(const int8_t* q, const int8_t* t, const int8_t* care,
                         int32_t* out, int Q, int N, int D, int levels,
                         cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (Q + BQ - 1) / BQ);
  cam_search_kernel<BQ, MASKED>
      <<<grid, THREADS, 0, stream>>>(q, t, care, out, Q, N, D, levels);
  return cudaGetLastError();
}

template <int BQ, bool MASKED, bool COUNTED>
cudaError_t launch_partial(const int8_t* q, const int8_t* t,
                           const int8_t* care, const int32_t* vr,
                           const float* count_le, uint64_t* part_keys,
                           int32_t* part_counts, int Q, int N, int D,
                           int levels, int k, int splits, int rows_per_split,
                           cudaStream_t stream) {
  const size_t smem = (size_t)BQ * k * sizeof(uint64_t) +
                      (size_t)BQ * BN * sizeof(uint32_t) +
                      (size_t)(BQ + BN + (MASKED ? BN : 0)) * LDW *
                          sizeof(uint32_t);
  auto kernel = cam_topk_partial_kernel<BQ, MASKED, COUNTED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, (Q + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(q, t, care, vr, count_le, part_keys,
                                          part_counts, Q, N, D, levels, k,
                                          splits, rows_per_split);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t launch_partial_bq(bool masked, bool counted, const int8_t* q,
                              const int8_t* t, const int8_t* care,
                              const int32_t* vr, const float* count_le,
                              uint64_t* part_keys, int32_t* part_counts,
                              int Q, int N, int D, int levels, int k,
                              int splits, int rows_per_split,
                              cudaStream_t stream) {
#define REPRO_PARTIAL(M, C)                                                   \
  return launch_partial<BQ, M, C>(q, t, care, vr, count_le, part_keys,       \
                                  part_counts, Q, N, D, levels, k, splits,   \
                                  rows_per_split, stream)
  if (masked) {
    if (counted) REPRO_PARTIAL(true, true);
    REPRO_PARTIAL(true, false);
  }
  if (counted) REPRO_PARTIAL(false, true);
  REPRO_PARTIAL(false, false);
#undef REPRO_PARTIAL
}

}  // namespace

// (Q, D) queries, (N, D) table [, (N, D) care] int8 -> (Q, N) int32.
// Pointers are device pointers; `care` may be null.  `tile_q` (16 or 64)
// is the queries per block.  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int cam_search_launch(const void* q, const void* t,
                                 const void* care, void* out, int Q, int N,
                                 int D, int levels, int tile_q,
                                 void* stream) {
  if (tile_q != 16 && tile_q != 64) return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* tp = static_cast<const int8_t*>(t);
  const auto* cp = static_cast<const int8_t*>(care);
  auto* op = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (tile_q == 16)
    return cp ? launch_dense<16, true>(qp, tp, cp, op, Q, N, D, levels, s)
              : launch_dense<16, false>(qp, tp, cp, op, Q, N, D, levels, s);
  return cp ? launch_dense<64, true>(qp, tp, cp, op, Q, N, D, levels, s)
            : launch_dense<64, false>(qp, tp, cp, op, Q, N, D, levels, s);
}

// Fused top-k, both passes.  `care` and `count_le` may be null; with
// `count_le`, `part_counts` ((Q, splits) int32) and `out_count` ((Q,)
// int32) must be given.  `part_keys` is (Q, splits, k) uint64 scratch.
// `valid_rows` is a device int32 the kernel reads itself.  `tile_q` (16
// or 64) is the queries per block of pass 1.
extern "C" int cam_search_topk_launch(
    const void* q, const void* t, const void* care, const void* valid_rows,
    const void* count_le, void* part_keys, void* part_counts, void* out_idx,
    void* out_dist, void* out_count, int Q, int N, int D, int levels, int k,
    int splits, int rows_per_split, int tile_q, void* stream) {
  if (k < 1 || k > MAX_K || (tile_q != 16 && tile_q != 64))
    return (int)cudaErrorInvalidValue;
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* tp = static_cast<const int8_t*>(t);
  const auto* cp = static_cast<const int8_t*>(care);
  const auto* vr = static_cast<const int32_t*>(valid_rows);
  const auto* thr = static_cast<const float*>(count_le);
  auto* pk = static_cast<uint64_t*>(part_keys);
  auto* pc = static_cast<int32_t*>(part_counts);
  auto s = static_cast<cudaStream_t>(stream);
  const bool masked = cp != nullptr, counted = thr != nullptr;
  cudaError_t err =
      tile_q == 16
          ? launch_partial_bq<16>(masked, counted, qp, tp, cp, vr, thr, pk, pc,
                                  Q, N, D, levels, k, splits, rows_per_split,
                                  s)
          : launch_partial_bq<64>(masked, counted, qp, tp, cp, vr, thr, pk, pc,
                                  Q, N, D, levels, k, splits, rows_per_split,
                                  s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Q + MERGE_WARPS - 1) / MERGE_WARPS;
  const size_t smem = (size_t)MERGE_WARPS * k * sizeof(uint64_t);
  cam_topk_merge_kernel<<<blocks, MERGE_WARPS * 32, smem, s>>>(
      pk, pc, static_cast<int32_t*>(out_idx), static_cast<float*>(out_dist),
      counted ? static_cast<int32_t*>(out_count) : nullptr, Q, k, splits);
  return (int)cudaGetLastError();
}
