// Multi-bit CAM search on Hopper: the dense and the fused top-k tier, on
// bit-planes.
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
// over int8 symbols: a query symbol outside [0, levels) matches nothing, a
// table symbol outside it differs from every in-range query symbol.
//
// Bit-planes.  `cam_pack_kernel` turns each row of 32 symbols (a group)
// into P value planes (bit b of every symbol, P = 1, 3 or 7, enough bits
// for min(levels, 128) values) and one in-range plane (0 <= x < levels),
// and a care plane into one word (care != 0) per group; groups past D are
// zero, so their symbols count as out of range.  For in-range q and t,
// q == t iff their low P bits are equal, so per group
//   matches    = popc(qv & tv & ~X),   X = OR_b (q_b ^ t_b)
//   mismatches = popc(care & qv & (X | ~tv))
// and the unmasked count is D - matches.  At 3 bits that is four logic
// instructions (merged into LOP3s), one popc and one add per 32 symbol
// pairs, where the byte-wise compare of the first version of this kernel
// took about 48 integer instructions and eight popc.  An L1 search of
// level codes packs their thermometer expansion at one bit instead,
// straight from the codes (`cam_pack_l1_kernel`).
//
// What bounds it on this card: integer instruction issue, then the top-k
// bookkeeping.  At the main path's shape (Q = 1,024 queries, N = 2^20
// rows, D = 256, 3 bits) the compare is 2^30 row pairs x 8 groups x ~6
// instructions, about 3.5 ms at the H100's ~1.5e13 INT32 operations/s,
// against a table read of 256 MiB (0.08 ms at 3.35 TB/s) and Q * N * D int8
// operations (0.14 ms at the int8 tensor-core rate).  One-hot products on
// the tensor cores would widen the contraction by `levels` (8x at 3 bits);
// the planes widen it by log2(levels).  The pack costs one pass over the
// inputs per call (about 0.2 ms at 2^20 x 256), which spares every block
// from converting again.  scripts/kernel_variants.py times ablations of
// this kernel (PERF.md).
//
// Design.  A block owns BQ queries and walks table tiles of BN rows,
// loading CW packed words per row at a time into shared memory (rows
// padded to 144 bytes so the 16-byte loads of eight rows hit eight bank
// groups).  Thread (ty, tx) of a 16 x 16 grid holds BQ / 16 queries and 8
// rows; queries are read once per block when a row fits one chunk.  The
// dense kernel writes each tile's counts out.  The fused kernel cannot
// carry a running top-k across blocks (blocks run in parallel and in no
// order), so it runs in two passes: pass 1 splits N over blocks (the query
// tiles of one split side by side, so that they share its rows in L2);
// each block keeps, per query, a sorted list of the k smallest packed keys
// (distance << 32 | row) of its own split in shared memory, plus a
// per-query threshold count; pass 2 merges the splits' lists into (Q, k)
// and sums the counts (no atomics, so the result is deterministic).  Per
// tile and query, one vote skips the tile when no row beats the list's
// largest key.  A vote that passes offers the tile's rows below that key to
// the list.  A list of k <= 32 fits one register a lane and takes the keys
// one after another there (a ballot finds a key's slot, a shuffle moves the
// larger keys up), reading and writing shared memory once a call; a merge
// would spend about as much a key and more on the list.  Longer lists take
// all of a tile's candidates (up to 128) in one warp-wide merge
// (warp_merge): each candidate is broadcast once and counted against the
// list keys a lane holds in registers (2, 4 or 8, by k) and against the
// other candidates, and every key is then written once to its new slot.
// What bounds it is the instructions run a candidate: the broadcast, a
// 64-bit compare for each of a lane's list keys and its own 4 candidates,
// and one warp reduction (ballots in place of the reduction, fewer waits
// but more instructions, ran slower); the list is read and written once a
// merge.  An insert a candidate would shift the list in shared memory
// instead: a chain of dependent loads, stores and barriers a key.  The
// merge pass folds the splits' lists through the same two routines.  Keys
// are unique per row, so the list order is exactly ascending (distance,
// row): ties go to the lowest row, and rows at index >= valid_rows carry
// distance 0xFFFFFFFF (+inf) with their own row index.  Unfilled slots hold
// (+inf, 2^31 - 1).  A traced copy of pass 1 (unmasked, uncounted only)
// also counts its votes, inserts, offered keys and clock cycles (TopkStat)
// for src/repro_torch/obs.py; the untraced pass is compiled without them.
// A table of at most 32 rows takes the few-row pass 1 (the same pass at
// another tile shape: one 32-row tile, 16 queries a block, the next chunk
// fetched while one is compared, one row a lane in the vote; its note is
// at `cam_topk_partial_few_kernel`).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 128;          // table rows per tile
constexpr int FEW_BN = 32;       // rows per tile of the few-row partial pass
constexpr int FEW_BQ = 16;       // queries per block of the few-row pass
constexpr int CW = 32;           // packed words per row per shared chunk
constexpr int LDW = CW + 4;      // padded shared row stride, in words
constexpr int THREADS = 256;     // a 16 x 16 grid of threads
constexpr int MAX_K = 256;       // largest k of the fused tier
constexpr int MERGE_WARPS = 4;   // queries per block in the merge pass
constexpr int PACK_THREADS = 256;
constexpr uint64_t SENTINEL = 0xFFFFFFFF7FFFFFFFull;   // (+inf, 2^31 - 1)

// The packed layout of one row: groups of 32 symbols, each W = P + 1
// words (P value planes, then the in-range plane).  Bit 8j + i of a
// group's words holds symbol 4i + j of the group.  Rows hold a multiple of
// four words (groups rounded up to two at P = 1) so that they stay 16-byte
// aligned; a chunk of CW words holds GC whole groups, and a step of the
// compare loop SW words (whole 16-byte loads), GS groups.
template <int P>
struct Layout {
  static constexpr int W = P + 1;
  static constexpr int GC = CW / W;
  static constexpr int LDC = GC + 1;    // shared stride of the care words
  static constexpr int SW = W < 4 ? 4 : W;
  static constexpr int GS = SW / W;
};

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

__host__ __device__ inline uint32_t lim_add_of(int levels) {
  const uint32_t lim = levels < 128 ? (uint32_t)levels : 128u;
  return (128u - lim) * 0x01010101u;
}

// Thread i packs group i % GP of row i / GP of [queries; table]: the
// queries' P + 1 words to qp, the table's to tp, and with a care plane
// the group's care word to cp.  D is a multiple of 16 and the inputs are
// 16-byte aligned.
template <int P>
__global__ void __launch_bounds__(PACK_THREADS)
cam_pack_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                const int8_t* __restrict__ care, uint32_t* __restrict__ qp,
                uint32_t* __restrict__ tp, uint32_t* __restrict__ cp, int Q,
                int N, int D, int GP, uint32_t lim_add) {
  constexpr int W = Layout<P>::W;
  const long long i = (long long)blockIdx.x * PACK_THREADS + threadIdx.x;
  if (i >= (long long)(Q + N) * GP) return;
  int row = (int)(i / GP);
  const int g = (int)(i - (long long)row * GP);
  const bool tab = row >= Q;
  if (tab) row -= Q;
  const int8_t* src = (tab ? t : q) + (size_t)row * D + g * 32;
  const bool with_care = tab && care != nullptr;
  uint32_t planes[W], cw = 0u;
#pragma unroll
  for (int b = 0; b < W; ++b) planes[b] = 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {            // two 16-byte halves of a group
    if (g * 32 + 16 * h >= D) continue;
    const uint4 x4 = *reinterpret_cast<const uint4*>(src + 16 * h);
    uint4 c4 = make_uint4(0u, 0u, 0u, 0u);
    if (with_care)
      c4 = *reinterpret_cast<const uint4*>(care + (size_t)row * D + g * 32 +
                                           16 * h);
    const uint32_t xs[4] = {x4.x, x4.y, x4.z, x4.w};
    const uint32_t cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int wi = 4 * h + s;            // word of the group: symbols 4wi..
      const uint32_t x = xs[s];
#pragma unroll
      for (int b = 0; b < P; ++b)
        planes[b] |= ((x >> b) & 0x01010101u) << wi;
      planes[P] |= (in_range80(x, lim_add) >> 7) << wi;
      if (with_care) cw |= (nonzero80(cs[s]) >> 7) << wi;
    }
  }
  uint32_t* dst = (tab ? tp : qp) + ((size_t)row * GP + g) * W;
  if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(planes[0], planes[1]);
  } else {
#pragma unroll
    for (int u = 0; u < W / 4; ++u)
      reinterpret_cast<uint4*>(dst)[u] =
          make_uint4(planes[4 * u], planes[4 * u + 1], planes[4 * u + 2],
                     planes[4 * u + 3]);
  }
  if (with_care) cp[(size_t)row * GP + g] = cw;
}

// The L1 pack.  An L1 search of b-bit level codes compares their
// thermometer expansions by Hamming distance: code c becomes M1 = 2^b - 1
// one-bit symbols, rung r (1 <= r <= M1) set iff clamp(c, 0, M1) >= r, so
// |a - c| is the number of rungs that differ.  `cam_pack_l1_kernel` writes
// the P = 1 words of that expansion (zero-padded to DP, a multiple of 16
// symbols) straight from the D-wide int8 codes, bit for bit what
// `cam_pack_kernel` makes at levels = 2 of the expanded int8 matrix, and
// with a care plane one word a group with every rung of a cared code set.
//
// Replaces, on the L1 path, the expansion into a (rows, D * M1) tensor
// (an int64 compare, an int32 and an int8 copy) and `cam_pack` over it;
// the TPU reference has no counterpart (its thermometer is plain JAX).
// Bound: bytes, (Q + N) D codes [+ N D care] in, (Q + N) GP * 8 [+ N GP *
// 4] out; at Q = 4,096, N = 26, D = 4,096, 3 bits 16.9 MB in and 29.5 MB
// out, 0.014 ms at 3.35 TB/s.  How it meets it: a thread makes one group
// (32 expanded symbols) and stores its two words in one 8-byte store; it
// reads the ceil(32 / M1) + 1 codes the group touches once, as bytes that
// its warp's neighbours share, and makes the rungs in registers: below 32
// rungs a code, (1 << c) - 1 of each code into a 64-bit window that one
// shift aligns; at 63 and 127 rungs, two codes at most, as two ranges.
// `to_layout` then moves symbol s = 4i + j of the group to bit 8j + i.

// x with its bits in the index-bit positions a < b swapped (bits whose
// index has a set and b clear trade places with their partner d above).
__device__ __forceinline__ uint32_t swap_index_bits(uint32_t x, uint32_t m,
                                                    int d) {
  const uint32_t t = ((x >> d) ^ x) & m;
  return x ^ t ^ (t << d);
}

// Bit s = 4i + j of a group in symbol order -> bit 8j + i, the packed
// layout: the index bits (j0 j1 i0 i1 i2) rotate to (i0 i1 i2 j0 j1), by
// four swaps of index bits (0, 2), (1, 3), (2, 4) and (3, 4).
__device__ __forceinline__ uint32_t to_layout(uint32_t x) {
  x = swap_index_bits(x, 0x0A0A0A0Au, 3);
  x = swap_index_bits(x, 0x00CC00CCu, 6);
  x = swap_index_bits(x, 0x0000F0F0u, 12);
  return swap_index_bits(x, 0x0000FF00u, 8);
}

__device__ __forceinline__ uint32_t low_bits(int n) {   // 0 <= n <= 32
  return __funnelshift_lc(0xFFFFFFFFu, 0u, (unsigned)n);
}

// Thread i packs group i % GP of row i / GP of [queries; table], as
// `cam_pack_kernel` does; codes are (rows, D) int8 with no alignment.
template <int M1>
__global__ void __launch_bounds__(PACK_THREADS)
cam_pack_l1_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ t,
                   const int8_t* __restrict__ care, uint32_t* __restrict__ qp,
                   uint32_t* __restrict__ tp, uint32_t* __restrict__ cp,
                   int Q, int N, int D, int DP, int GP) {
  const long long i = (long long)blockIdx.x * PACK_THREADS + threadIdx.x;
  if (i >= (long long)(Q + N) * GP) return;
  int row = (int)(i / GP);
  const int g = (int)(i - (long long)row * GP);
  const bool tab = row >= Q;
  if (tab) row -= Q;
  const int8_t* src = (tab ? t : q) + (size_t)row * D;
  const int8_t* csrc = tab && care ? care + (size_t)row * D : nullptr;
  const int base = 32 * g, d0 = base / M1, off = base - d0 * M1;
  uint32_t lin = 0u, clin = 0u;     // bit s: expanded symbol base + s
  if constexpr (M1 < 32) {
    // codes d0 .. d0 + K - 1 hold rungs off .. off + 31 of the window
    constexpr int K = (2 * M1 + 30) / M1;
    uint64_t win = 0u, cwin = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (d0 + k < D) {
        const int c = min(max((int)src[d0 + k], 0), M1);
        win |= (uint64_t)((1u << c) - 1u) << (k * M1);
        if (csrc && csrc[d0 + k])
          cwin |= (uint64_t)((1u << M1) - 1u) << (k * M1);
      }
    }
    lin = (uint32_t)(win >> off);
    clin = (uint32_t)(cwin >> off);
  } else {
    // a group touches code d0 from rung off + 1 and, past its first s1
    // symbols, code d0 + 1
    const int s1 = M1 - off;
    if (d0 < D) {
      lin = low_bits(min(max(min((int)src[d0], M1) - off, 0), 32));
      if (csrc && csrc[d0]) clin = low_bits(min(s1, 32));
    }
    if (s1 < 32 && d0 + 1 < D) {
      lin |= low_bits(min(max((int)src[d0 + 1], 0), 32 - s1)) << s1;
      if (csrc && csrc[d0 + 1]) clin |= 0xFFFFFFFFu << s1;
    }
  }
  // DP and base are multiples of 16: the group is in range whole, by half
  // (symbols 0-15: i < 4, bits 0-3 of each byte) or not at all
  const int left = DP - base;
  const uint32_t in_range =
      left >= 32 ? 0xFFFFFFFFu : (left > 0 ? 0x0F0F0F0Fu : 0u);
  uint32_t* dst = (tab ? tp : qp) + ((size_t)row * GP + g) * 2;
  *reinterpret_cast<uint2*>(dst) = make_uint2(to_layout(lin), in_range);
  if (csrc) cp[(size_t)row * GP + g] = to_layout(clin);
}

// Words [w0, w0 + CW) of rows [r0, r0 + R) of a packed (rows, RW) matrix
// into shared dst[R][LDW]; words outside the matrix read as 0.
__device__ __forceinline__ void load_words(uint32_t* dst, const uint32_t* src,
                                           int r0, int R, int rows, int RW,
                                           int w0) {
  constexpr int VPR = CW / 4;
  for (int v = threadIdx.x; v < R * VPR; v += THREADS) {
    const int r = v / VPR, part = v % VPR;
    const int row = r0 + r, w = w0 + 4 * part;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && w < RW)
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * RW + w);
    *reinterpret_cast<uint4*>(dst + r * LDW + 4 * part) = val;
  }
}

// The few-row pass's loads, in two halves so that a chunk's words are in
// flight while the one before is compared: item e = threadIdx.x + THREADS
// * i of the chunk's BQ query rows, then its TR table rows, VPR 16-byte
// items a row, fetched into registers (0 outside the matrices) and stored
// where load_words stores them.
template <int BQ, int TR, int NL>
__device__ __forceinline__ void fetch_words(uint4 (&v)[NL],
                                            const uint32_t* qp,
                                            const uint32_t* tp, int q0,
                                            int Q, int n0, int N, int RW,
                                            int w0) {
  constexpr int VPR = CW / 4;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int e = threadIdx.x + THREADS * i, r = e / VPR;
    const int w = w0 + 4 * (e % VPR);
    const bool tab = r >= BQ;
    const int row = tab ? n0 + r - BQ : q0 + r;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < BQ + TR && row < (tab ? N : Q) && w < RW)
      v[i] = *reinterpret_cast<const uint4*>((tab ? tp : qp) +
                                             (size_t)row * RW + w);
  }
}

template <int BQ, int TR, int NL>
__device__ __forceinline__ void stash_words(const uint4 (&v)[NL],
                                            uint32_t* qs, uint32_t* ts) {
  constexpr int VPR = CW / 4;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int e = threadIdx.x + THREADS * i, r = e / VPR;
    if (r < BQ + TR)
      *reinterpret_cast<uint4*>((r < BQ ? qs + r * LDW : ts + (r - BQ) * LDW)
                                + 4 * (e % VPR)) = v[i];
  }
}

// Care words of groups [g0, g0 + GC) of table rows [n0, n0 + TR).
template <int P, int TR>
__device__ __forceinline__ void load_care(uint32_t* dst, const uint32_t* cp,
                                          int n0, int N, int GP, int g0) {
  constexpr int GC = Layout<P>::GC, LDC = Layout<P>::LDC;
  for (int v = threadIdx.x; v < TR * GC; v += THREADS) {
    const int r = v / GC, gi = v % GC;
    const int row = n0 + r, g = g0 + gi;
    dst[r * LDC + gi] = (row < N && g < GP) ? cp[(size_t)row * GP + g] : 0u;
  }
}

// One group of one (query, row) pair: the bits to count.  Unmasked, the
// in-range matches; masked, the cared-for mismatches of in-range queries.
template <int P, bool MASKED>
__device__ __forceinline__ uint32_t group_bits(const uint32_t* qw,
                                               const uint32_t* tw,
                                               uint32_t care) {
  uint32_t x = qw[0] ^ tw[0];
#pragma unroll
  for (int b = 1; b < P; ++b) x |= qw[b] ^ tw[b];
  if (MASKED) return qw[P] & care & (x | ~tw[P]);
  return qw[P] & tw[P] & ~x;
}

// The compare of one chunk of words in shared memory (qs, ts, cs): adds
// each (query, row) pair's count over the chunk's groups to acc, thread
// (ty, tx) owning queries ty * TQ + i and rows tx + 16 * j of the tile.
template <int P, int BQ, int TR, bool MASKED>
__device__ __forceinline__ void chunk_counts(int (&acc)[BQ / 16][TR / 16],
                                             const uint32_t* qs,
                                             const uint32_t* ts,
                                             const uint32_t* cs, int tx,
                                             int ty) {
  using L = Layout<P>;
  constexpr int TQ = BQ / 16, TN = TR / 16, W = L::W, SW = L::SW,
                GS = L::GS;
#pragma unroll 2
  for (int s = 0; s < CW / SW; ++s) {
    uint32_t qw[TQ][SW];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int u = 0; u < SW / 4; ++u) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            qs + (ty * TQ + i) * LDW + s * SW + 4 * u);
        qw[i][4 * u] = v.x; qw[i][4 * u + 1] = v.y;
        qw[i][4 * u + 2] = v.z; qw[i][4 * u + 3] = v.w;
      }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = tx + 16 * j;
      uint32_t tw[SW], cw[GS];
#pragma unroll
      for (int u = 0; u < SW / 4; ++u) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(ts + r * LDW + s * SW + 4 * u);
        tw[4 * u] = v.x; tw[4 * u + 1] = v.y;
        tw[4 * u + 2] = v.z; tw[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int gs = 0; gs < GS; ++gs)
        cw[gs] = MASKED ? cs[r * L::LDC + s * GS + gs] : 0u;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        int c = 0;
#pragma unroll
        for (int gs = 0; gs < GS; ++gs)
          c += __popc(group_bits<P, MASKED>(&qw[i][gs * W], &tw[gs * W],
                                            cw[gs]));
        acc[i][j] += c;
      }
    }
  }
}

// Counts of queries [q0, q0 + BQ) against rows [n0, n0 + TR), a tile of
// TR rows (BN, or FEW_BN in the few-row pass), chunk by chunk of CW words
// (chunk_counts).  Unmasked it leaves #matches in acc (the caller
// finalises D - acc); masked it leaves #mismatches.  `load_q`: (re)load
// the query words; a caller whose rows fit one chunk loads them for its
// first tile only.  The few-row pass compares few pairs a chunk (32 popc a
// thread against 512 in a 128-row tile of 64 queries), too few to cover a
// chunk's load: it fetches the next chunk into registers while it compares
// this one, and (its one tile the split) always reloads the queries.
template <int P, int BQ, int TR, bool MASKED>
__device__ __forceinline__ void tile_counts(
    int (&acc)[BQ / 16][TR / 16], const uint32_t* __restrict__ qp,
    const uint32_t* __restrict__ tp, const uint32_t* __restrict__ cp, int q0,
    int Q, int n0, int N, int GP, bool load_q, uint32_t* qs, uint32_t* ts,
    uint32_t* cs) {
  constexpr int TQ = BQ / 16, TN = TR / 16, W = Layout<P>::W;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int RW = GP * W;
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  if constexpr (TR == FEW_BN) {
    constexpr int NL = ((BQ + TR) * (CW / 4) + THREADS - 1) / THREADS;
    uint4 next[NL];
    fetch_words<BQ, TR>(next, qp, tp, q0, Q, n0, N, RW, 0);
    for (int w0 = 0; w0 < RW; w0 += CW) {
      stash_words<BQ, TR>(next, qs, ts);
      if (MASKED) load_care<P, TR>(cs, cp, n0, N, GP, w0 / W);
      __syncthreads();
      if (w0 + CW < RW)
        fetch_words<BQ, TR>(next, qp, tp, q0, Q, n0, N, RW, w0 + CW);
      chunk_counts<P, BQ, TR, MASKED>(acc, qs, ts, cs, tx, ty);
      __syncthreads();
    }
  } else {
    for (int w0 = 0; w0 < RW; w0 += CW) {
      if (load_q) load_words(qs, qp, q0, BQ, Q, RW, w0);
      load_words(ts, tp, n0, TR, N, RW, w0);
      if (MASKED) load_care<P, TR>(cs, cp, n0, N, GP, w0 / W);
      __syncthreads();
      chunk_counts<P, BQ, TR, MASKED>(acc, qs, ts, cs, tx, ty);
      __syncthreads();
    }
  }
}

template <int P, int BQ, bool MASKED>
__global__ void __launch_bounds__(THREADS)
cam_search_kernel(const uint32_t* __restrict__ qp,
                  const uint32_t* __restrict__ tp,
                  const uint32_t* __restrict__ cp, int32_t* __restrict__ out,
                  int Q, int N, int D, int GP) {
  constexpr int TQ = BQ / 16, TN = BN / 16;
  __shared__ __align__(16) uint32_t qs[BQ * LDW];
  __shared__ __align__(16) uint32_t ts[BN * LDW];
  __shared__ uint32_t cs[MASKED ? BN * Layout<P>::LDC : 1];
  const int n0 = blockIdx.x * BN, q0 = blockIdx.y * BQ;
  int acc[TQ][TN];
  tile_counts<P, BQ, BN, MASKED>(acc, qp, tp, cp, q0, Q, n0, N, GP, true, qs,
                                 ts, cs);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qq = q0 + ty * TQ + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = n0 + tx + 16 * j;
      if (qq < Q && r < N)
        out[(size_t)qq * N + r] = MASKED ? acc[i][j] : D - acc[i][j];
    }
  }
}

// Offer `key` (from every lane where `want` holds) to the sorted list
// L[0, k), k <= 32, that one warp shares in shared memory; the list keeps
// the k smallest keys.  Warp-uniform control flow throughout.  The list is
// worked on in registers, one key a lane: a ballot finds where a key goes
// and one shuffle moves the larger keys up.  Returns the keys offered.
__device__ __forceinline__ int warp_insert(uint64_t* L, int k, uint64_t key,
                                           bool want, int lane) {
  unsigned ballot = __ballot_sync(0xFFFFFFFFu, want);
  if (ballot == 0u) return 0;
  const int offered = __popc(ballot);
  uint64_t mine = lane < k ? L[lane] : SENTINEL;     // sorted over 32 lanes
  while (ballot) {
    const int src = __ffs(ballot) - 1;
    ballot &= ballot - 1;
    const uint64_t kk = __shfl_sync(0xFFFFFFFFu, key, src);
    const int pos = __ffs(__ballot_sync(0xFFFFFFFFu, mine > kk)) - 1;
    const uint64_t up = __shfl_up_sync(0xFFFFFFFFu, mine, 1);
    if (pos >= 0 && pos < k && lane >= pos) mine = lane == pos ? kk : up;
  }
  if (lane < k) L[lane] = mine;
  __syncwarp();
  return offered;
}

// Merge the keys c[0..3] of every lane that lie below the list's largest
// key (the candidates, up to 128) into the sorted list L[0, k), k > 32,
// that one warp shares in shared memory, keeping the k smallest, in one
// step: lane l holds list slots l + 32 s, s < NS, in registers.  Each
// candidate in turn is broadcast once; every lane counts it against its
// list keys (`above`: the candidates below each, a byte a slot) and adds up
// the keys of the list and the candidates below it, which one reduction
// turns into the candidate's new slot.  List key i moves to slot
// i + above_i.  Keys are unique (unfilled list slots hold SENTINEL, above
// every candidate), so the new slots are a permutation of [0, k + m) and no
// two writes collide; a key whose slot is k or more drops out.  The list is
// left as one insert a candidate would leave it: the k smallest of it and
// the candidates.  Returns the candidates offered.
template <int NS>
__device__ __forceinline__ int merge_slots(uint64_t* L, int k,
                                           const uint64_t (&c)[4], int lane) {
  const uint64_t last = L[k - 1];
  int offered = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    offered += __popc(__ballot_sync(0xFFFFFFFFu, c[e] < last));
  if (offered == 0) return 0;
  uint64_t v[NS];
  unsigned above[(NS + 3) / 4] = {};
  int live = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int i = lane + 32 * s;
    live += i < k;
    v[s] = i < k ? L[i] : 0ull;          // no key lies below a dead slot's
  }
  int to[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    unsigned b = __ballot_sync(0xFFFFFFFFu, c[e] < last);
    while (b) {
      const int src = __ffs(b) - 1;
      b &= b - 1;
      const uint64_t x = __shfl_sync(0xFFFFFFFFu, c[e], src);
      int below = live;                  // my list keys, then candidates
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const bool a = x < v[s];
        above[s / 4] += a ? 1u << (8 * (s % 4)) : 0u;
        below -= a;
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) below += c[f] < x;
      below = __reduce_add_sync(0xFFFFFFFFu, below);
      if (lane == src) to[e] = below;
    }
  }
  __syncwarp();                          // every lane has read the list
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int i = lane + 32 * s;
    const int up = (above[s / 4] >> (8 * (s % 4))) & 0xFF;
    if (i < k && up && i + up < k) L[i + up] = v[s];
  }
#pragma unroll
  for (int f = 0; f < 4; ++f)
    if (c[f] < last && to[f] < k) L[to[f]] = c[f];
  __syncwarp();
  return offered;
}

// merge_slots for any k in (32, MAX_K], with as many list slots a lane as k
// needs.
__device__ __forceinline__ int warp_merge(uint64_t* L, int k,
                                          const uint64_t (&c)[4], int lane) {
  static_assert(MAX_K <= 8 * 32, "a lane holds at most 8 list slots");
  if (k <= 64) return merge_slots<2>(L, k, c, lane);
  if (k <= 128) return merge_slots<4>(L, k, c, lane);
  return merge_slots<8>(L, k, c, lane);
}

// Offer the keys of rows r0 .. r0 + 3 (distances d0 .. d3; rows at or past
// r_end are not offered) from every lane to the list at slot `list` of the
// block's dynamic shared memory; returns the keys offered.  Up to k = 32
// one key after another through the register list, above it all at once
// through warp_merge.  Not inlined: the scan calls it for few tiles, and
// one copy keeps the scan's code small.  The list comes as a slot and not
// a pointer so that its loads and stores address shared memory directly.
__device__ __noinline__ int insert_rows(int list, int k, uint32_t d0,
                                        uint32_t d1, uint32_t d2,
                                        uint32_t d3, int r0, int r_end,
                                        int lane) {
  extern __shared__ uint64_t smem[];
  uint64_t* L = smem + list;
  const uint32_t dk[4] = {d0, d1, d2, d3};
  if (k > 32) {
    uint64_t c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)          // ~0: above every list key
      c[e] = r0 + e < r_end
                 ? ((uint64_t)dk[e] << 32) | (uint32_t)(r0 + e)
                 : ~0ull;
    return warp_merge(L, k, c, lane);
  }
  int offered = 0;
#pragma unroll 1
  for (int e = 0; e < 4; ++e) {
    const int r = r0 + e;
    const uint64_t key = ((uint64_t)dk[e] << 32) | (uint32_t)r;
    offered += warp_insert(L, k, key, r < r_end && key < L[k - 1], lane);
  }
  return offered;
}

// The counters a traced partial pass adds to its `stats` buffer, one
// uint64 each (src/repro_torch/obs.py's `cam_topk` group, in this order):
// votes (one a query a tile), votes that called insert_rows, SM clock
// cycles, summed over warps, in tile_counts and in the rest of each tile,
// and the keys those calls offered to the lists.
enum TopkStat { kVotes, kInserts, kCyclesCompare, kCyclesSelect, kOffered };

// Pass 1: block (query tile, split) -> the k smallest keys of its rows for
// each of its queries, in part_keys[q][split][0, k), and its threshold
// count in part_counts[q][split].  Tiles of TR rows: BN, or FEW_BN for a
// table of at most FEW_BN rows (the few-row pass, k <= 32).  TRACED adds
// the block's counters to `stats` (one atomicAdd a counter a warp); the
// outputs are the same.
template <int P, int BQ, int TR, bool MASKED, bool COUNTED, bool TRACED>
__device__ __forceinline__ void topk_partial(
    const uint32_t* __restrict__ qp, const uint32_t* __restrict__ tp,
    const uint32_t* __restrict__ cp, const int32_t* __restrict__ valid_rows,
    const float* __restrict__ count_le, uint64_t* __restrict__ part_keys,
    int32_t* __restrict__ part_counts, int Q, int N, int D, int GP, int k,
    int splits, int rows_per_split, unsigned long long* __restrict__ stats) {
  static_assert(!TRACED || (!MASKED && !COUNTED),
                "the traced pass is unmasked and uncounted");
  constexpr int TQ = BQ / 16, TN = TR / 16;
  constexpr int WARPS = THREADS / 32;
  constexpr int QPW = BQ / WARPS;            // queries per warp
  constexpr int RL = TR / 32;                // rows a lane in the vote
  static_assert(TR == BN || TR == FEW_BN, "a lane votes on 4 rows or 1");
  extern __shared__ uint64_t smem[];
  uint64_t* lists = smem;                                  // [BQ][k]
  uint32_t* dist = reinterpret_cast<uint32_t*>(lists + BQ * k);  // [BQ][TR]
  uint32_t* qs = dist + BQ * TR;             // 16-byte aligned: BQ * TR * 4
  uint32_t* ts = qs + BQ * LDW;
  uint32_t* cs = ts + TR * LDW;

  const int split = blockIdx.y, q0 = blockIdx.x * BQ;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  const int vr = min(*valid_rows, N);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool one_chunk = GP * Layout<P>::W <= CW;

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

  [[maybe_unused]] long long cycles_compare = 0, cycles_select = 0;
  [[maybe_unused]] unsigned votes = 0, inserts = 0, offered = 0;
  for (int n0 = r_begin; n0 < r_end; n0 += TR) {
    [[maybe_unused]] long long t0 = 0, t1 = 0;
    if constexpr (TRACED) t0 = clock64();
    int acc[TQ][TN];
    tile_counts<P, BQ, TR, MASKED>(acc, qp, tp, cp, q0, Q, n0, N, GP,
                                   !one_chunk || n0 == r_begin, qs, ts, cs);
    if constexpr (TRACED) {
      t1 = clock64();
      cycles_compare += t1 - t0;
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        dist[(ty * TQ + i) * TR + tx + 16 * j] =
            MASKED ? acc[i][j] : D - acc[i][j];
    __syncthreads();
    // Each lane takes RL consecutive rows of the tile.  Most tiles hold no
    // row below the list's largest key once the list is full, so a 32-bit
    // filter and one vote skip them.  It is exact: the list's keys come
    // from earlier (lower) rows of this split or are SENTINEL, so a row at
    // the largest key's distance enters only while that key is SENTINEL.
#pragma unroll
    for (int s = 0; s < QPW; ++s) {
      const int ql = warp + WARPS * s;
      if (q0 + ql >= Q) continue;              // warp-uniform
      uint64_t* L = lists + ql * k;
      uint32_t dv[RL];
      if constexpr (RL == 4) {
        const uint4 d4 =
            *reinterpret_cast<const uint4*>(dist + ql * TR + 4 * lane);
        dv[0] = d4.x; dv[1] = d4.y; dv[2] = d4.z; dv[3] = d4.w;
      } else {
        dv[0] = dist[ql * TR + lane];
      }
      const uint64_t last = L[k - 1];
      const uint32_t worst = (uint32_t)(last >> 32);
      const bool open = last == SENTINEL;
      uint32_t dk[RL];
      bool cand = false;
#pragma unroll
      for (int e = 0; e < RL; ++e) {
        const int r = n0 + RL * lane + e;
        const bool real = r < r_end, live = r < vr;
        if (COUNTED && real)
          cnt[s] += (live ? (float)dv[e] : __int_as_float(0x7F800000)) <=
                    thr[s];
        dk[e] = live ? dv[e] : 0xFFFFFFFFu;
        cand |= real && (dk[e] < worst || (open && dk[e] == worst));
      }
      if constexpr (TRACED) ++votes;
      if (__any_sync(0xFFFFFFFFu, cand)) {
        [[maybe_unused]] int o;
        if constexpr (RL == 4) {
          o = insert_rows(ql * k, k, dk[0], dk[1], dk[2], dk[3],
                          n0 + 4 * lane, r_end, lane);
        } else {
          // The few-row pass: the split is this one tile, so the list is
          // open and takes the tile's k smallest keys.  A lane's key goes
          // to its rank among the real rows' keys, which are unique: equal
          // distances rank by row, that is by lane.
          const int rows = r_end - n0;             // warp-uniform
          int rank = 0;
          for (int j = 0; j < rows; ++j) {
            const uint32_t dj =
                n0 + j < vr ? dist[ql * TR + j] : 0xFFFFFFFFu;
            rank += dj < dk[0] || (dj == dk[0] && j < lane);
          }
          if (lane < rows && rank < k)
            L[rank] = ((uint64_t)dk[0] << 32) | (uint32_t)(n0 + lane);
          __syncwarp();
          o = rows;
        }
        if constexpr (TRACED) {
          ++inserts;
          offered += o;
        }
      }
    }
    __syncthreads();
    if constexpr (TRACED) cycles_select += clock64() - t1;
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
  if constexpr (TRACED) {
    if (lane == 0) {
      atomicAdd(stats + kVotes, (unsigned long long)votes);
      atomicAdd(stats + kInserts, (unsigned long long)inserts);
      atomicAdd(stats + kCyclesCompare, (unsigned long long)cycles_compare);
      atomicAdd(stats + kCyclesSelect, (unsigned long long)cycles_select);
      atomicAdd(stats + kOffered, (unsigned long long)offered);
    }
  }
}

template <int P, int BQ, bool MASKED, bool COUNTED>
__global__ void __launch_bounds__(THREADS)
cam_topk_partial_kernel(const uint32_t* __restrict__ qp,
                        const uint32_t* __restrict__ tp,
                        const uint32_t* __restrict__ cp,
                        const int32_t* __restrict__ valid_rows,
                        const float* __restrict__ count_le,
                        uint64_t* __restrict__ part_keys,
                        int32_t* __restrict__ part_counts, int Q, int N,
                        int D, int GP, int k, int splits,
                        int rows_per_split) {
  topk_partial<P, BQ, BN, MASKED, COUNTED, false>(
      qp, tp, cp, valid_rows, count_le, part_keys, part_counts, Q, N, D, GP, k,
      splits, rows_per_split, nullptr);
}

// The partial pass with its counters, for an unmasked, uncounted search.
template <int P, int BQ>
__global__ void __launch_bounds__(THREADS)
cam_topk_partial_traced_kernel(const uint32_t* __restrict__ qp,
                               const uint32_t* __restrict__ tp,
                               const int32_t* __restrict__ valid_rows,
                               uint64_t* __restrict__ part_keys, int Q, int N,
                               int D, int GP, int k, int splits,
                               int rows_per_split,
                               unsigned long long* __restrict__ stats) {
  topk_partial<P, BQ, BN, false, false, true>(
      qp, tp, nullptr, valid_rows, nullptr, part_keys, nullptr, Q, N, D, GP, k,
      splits, rows_per_split, stats);
}

// The few-row pass: pass 1 over a table of at most FEW_BN rows (so k <=
// 32), one FEW_BN-row tile a split, FEW_BQ queries a block.
//
// What bounds it on this card: the popc issue rate.  Each (query, row)
// pair costs one popc a 32-symbol group, and an SM issues 16 popc a
// cycle; at the HDC cell's shape (Q = 4,096, N = 26, D = 4,096 3-bit codes
// at L1, 896 one-bit groups a row) that is 95.4 M popc, 22.8 us on 132 SMs
// at 1.98 GHz, against 29.4 MB of query planes read once (8.8 us at 3.35
// TB/s).  The 128-row pass compared 128 rows to find 26 (102 of them zero
// padding) in 64 blocks of 64 queries, 4.9x the work on half the SMs.
// What the design does: a 32-row tile, so at most 31 padding rows are
// loaded or compared; 16-query blocks, 256 blocks at Q = 4,096, two an SM
// on all 132; the next chunk's words fetched into registers while a chunk
// is compared (tile_counts), since a chunk holds too little work to cover
// its own load; the split is one tile, so the vote takes one row a lane
// and writes each key at its rank among the tile's keys.  tile_counts'
// compare (chunk_counts) and the counters are the 128-row pass's.
template <int P, bool MASKED, bool COUNTED>
__global__ void __launch_bounds__(THREADS)
cam_topk_partial_few_kernel(const uint32_t* __restrict__ qp,
                            const uint32_t* __restrict__ tp,
                            const uint32_t* __restrict__ cp,
                            const int32_t* __restrict__ valid_rows,
                            const float* __restrict__ count_le,
                            uint64_t* __restrict__ part_keys,
                            int32_t* __restrict__ part_counts, int Q, int N,
                            int D, int GP, int k, int splits,
                            int rows_per_split) {
  topk_partial<P, FEW_BQ, FEW_BN, MASKED, COUNTED, false>(
      qp, tp, cp, valid_rows, count_le, part_keys, part_counts, Q, N, D, GP, k,
      splits, rows_per_split, nullptr);
}

// The few-row pass with its counters, for an unmasked, uncounted search.
template <int P>
__global__ void __launch_bounds__(THREADS)
cam_topk_partial_few_traced_kernel(const uint32_t* __restrict__ qp,
                                   const uint32_t* __restrict__ tp,
                                   const int32_t* __restrict__ valid_rows,
                                   uint64_t* __restrict__ part_keys, int Q,
                                   int N, int D, int GP, int k, int splits,
                                   int rows_per_split,
                                   unsigned long long* __restrict__ stats) {
  topk_partial<P, FEW_BQ, FEW_BN, false, false, true>(
      qp, tp, nullptr, valid_rows, nullptr, part_keys, nullptr, Q, N, D, GP, k,
      splits, rows_per_split, stats);
}

// Pass 2: one warp per query merges its splits' lists into the final
// (k,) rows and distances and sums the splits' threshold counts: 32 keys a
// step through the register list up to k = 32, 128 through warp_merge
// above it.
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
  if (k <= 32) {
    for (int base = 0; base < total; base += 32) {
      const int c = base + lane;
      const uint64_t key = c < total ? src[c] : SENTINEL;
      warp_insert(L, k, key, key < L[k - 1], lane);
    }
  } else {
    for (int base = 0; base < total; base += 128) {
      uint64_t key[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = base + 32 * e + lane;
        key[e] = c < total ? src[c] : SENTINEL;
      }
      warp_merge(L, k, key, lane);
    }
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

template <int P>
cudaError_t launch_pack(const int8_t* q, const int8_t* t, const int8_t* care,
                        uint32_t* qp, uint32_t* tp, uint32_t* cp, int Q,
                        int N, int D, int GP, int levels,
                        cudaStream_t stream) {
  const long long items = (long long)(Q + N) * GP;
  const long long blocks = (items + PACK_THREADS - 1) / PACK_THREADS;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  cam_pack_kernel<P><<<(unsigned)blocks, PACK_THREADS, 0, stream>>>(
      q, t, care, qp, tp, cp, Q, N, D, GP, lim_add_of(levels));
  return cudaGetLastError();
}

template <int M1>
cudaError_t launch_pack_l1(const int8_t* q, const int8_t* t,
                           const int8_t* care, uint32_t* qp, uint32_t* tp,
                           uint32_t* cp, int Q, int N, int D, int DP, int GP,
                           cudaStream_t stream) {
  const long long items = (long long)(Q + N) * GP;
  const long long blocks = (items + PACK_THREADS - 1) / PACK_THREADS;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  cam_pack_l1_kernel<M1><<<(unsigned)blocks, PACK_THREADS, 0, stream>>>(
      q, t, care, qp, tp, cp, Q, N, D, DP, GP);
  return cudaGetLastError();
}

template <int P, int BQ, bool MASKED>
cudaError_t launch_dense(const uint32_t* qp, const uint32_t* tp,
                         const uint32_t* cp, int32_t* out, int Q, int N,
                         int D, int GP, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (Q + BQ - 1) / BQ);
  cam_search_kernel<P, BQ, MASKED>
      <<<grid, THREADS, 0, stream>>>(qp, tp, cp, out, Q, N, D, GP);
  return cudaGetLastError();
}

// `kernel` on `grid` with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch_smem(Kernel kernel, dim3 grid, size_t smem,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Pass 1 in tiles of TR rows (BN, or FEW_BN: the few-row kernels, BQ =
// FEW_BQ).
template <int P, int BQ, int TR, bool MASKED, bool COUNTED, bool TRACED>
cudaError_t launch_partial(const uint32_t* qp, const uint32_t* tp,
                           const uint32_t* cp, const int32_t* vr,
                           const float* count_le, uint64_t* part_keys,
                           int32_t* part_counts, int Q, int N, int D, int GP,
                           int k, int splits, int rows_per_split,
                           unsigned long long* stats, cudaStream_t stream) {
  const size_t smem =
      (size_t)BQ * k * sizeof(uint64_t) +
      (size_t)BQ * TR * sizeof(uint32_t) +
      (size_t)(BQ + TR) * LDW * sizeof(uint32_t) +
      (MASKED ? (size_t)TR * Layout<P>::LDC * sizeof(uint32_t) : 0);
  // the query tiles of a split run side by side and share its rows in L2
  const dim3 grid((Q + BQ - 1) / BQ, splits);
  if constexpr (TR == FEW_BN) {
    static_assert(BQ == FEW_BQ, "the few-row pass takes FEW_BQ queries");
    if constexpr (TRACED)
      return launch_smem(cam_topk_partial_few_traced_kernel<P>, grid, smem,
                         stream, qp, tp, vr, part_keys, Q, N, D, GP, k,
                         splits, rows_per_split, stats);
    else
      return launch_smem(cam_topk_partial_few_kernel<P, MASKED, COUNTED>,
                         grid, smem, stream, qp, tp, cp, vr, count_le,
                         part_keys, part_counts, Q, N, D, GP, k, splits,
                         rows_per_split);
  } else if constexpr (TRACED) {
    return launch_smem(cam_topk_partial_traced_kernel<P, BQ>, grid, smem,
                       stream, qp, tp, vr, part_keys, Q, N, D, GP, k, splits,
                       rows_per_split, stats);
  } else {
    return launch_smem(cam_topk_partial_kernel<P, BQ, MASKED, COUNTED>, grid,
                       smem, stream, qp, tp, cp, vr, count_le, part_keys,
                       part_counts, Q, N, D, GP, k, splits, rows_per_split);
  }
}

// The instantiation for (planes, tile_q, masked[, counted]).
#define REPRO_BY_P(CALL)                                                     \
  switch (planes) {                                                          \
    case 1: CALL(1); case 3: CALL(3); case 7: CALL(7);                       \
    default: return cudaErrorInvalidValue;                                   \
  }

cudaError_t dense(int planes, int tile_q, const uint32_t* qp,
                  const uint32_t* tp, const uint32_t* cp, int32_t* out, int Q,
                  int N, int D, int GP, cudaStream_t s) {
#define REPRO_DENSE(P)                                                       \
  if (tile_q == 16)                                                          \
    return cp ? launch_dense<P, 16, true>(qp, tp, cp, out, Q, N, D, GP, s)   \
              : launch_dense<P, 16, false>(qp, tp, cp, out, Q, N, D, GP, s); \
  return cp ? launch_dense<P, 64, true>(qp, tp, cp, out, Q, N, D, GP, s)     \
            : launch_dense<P, 64, false>(qp, tp, cp, out, Q, N, D, GP, s)
  REPRO_BY_P(REPRO_DENSE)
#undef REPRO_DENSE
}

// With `stats` (unmasked and uncounted only) the traced pass runs;
// `tile_n` FEW_BN takes the few-row pass.
cudaError_t partial(int planes, int tile_q, int tile_n, bool counted,
                    const uint32_t* qp, const uint32_t* tp, const uint32_t* cp,
                    const int32_t* vr, const float* thr, uint64_t* pk,
                    int32_t* pc, int Q, int N, int D, int GP, int k,
                    int splits, int rows_per_split, unsigned long long* stats,
                    cudaStream_t s) {
  if (stats && (cp || counted)) return cudaErrorInvalidValue;
#define REPRO_PART_N(P, BQ, TR, M, C, T)                                     \
  return launch_partial<P, BQ, TR, M, C, T>(qp, tp, cp, vr, thr, pk, pc, Q,  \
                                            N, D, GP, k, splits,             \
                                            rows_per_split, stats, s)
#define REPRO_PART_T(P, BQ, M, C, T) REPRO_PART_N(P, BQ, BN, M, C, T)
#define REPRO_PART(P, BQ, M, C) REPRO_PART_T(P, BQ, M, C, false)
#define REPRO_FEW(P, M, C, T) REPRO_PART_N(P, FEW_BQ, FEW_BN, M, C, T)
#define REPRO_PARTIAL(P)                                                     \
  if (tile_n == FEW_BN) {                                                    \
    if (stats) REPRO_FEW(P, false, false, true);                             \
    if (cp) {                                                                \
      if (counted) REPRO_FEW(P, true, true, false);                          \
      REPRO_FEW(P, true, false, false);                                      \
    }                                                                        \
    if (counted) REPRO_FEW(P, false, true, false);                           \
    REPRO_FEW(P, false, false, false);                                       \
  }                                                                          \
  if (stats) {                                                               \
    if (tile_q == 16) REPRO_PART_T(P, 16, false, false, true);               \
    REPRO_PART_T(P, 64, false, false, true);                                 \
  }                                                                          \
  if (tile_q == 16) {                                                        \
    if (cp) {                                                                \
      if (counted) REPRO_PART(P, 16, true, true);                            \
      REPRO_PART(P, 16, true, false);                                        \
    }                                                                        \
    if (counted) REPRO_PART(P, 16, false, true);                             \
    REPRO_PART(P, 16, false, false);                                         \
  }                                                                          \
  if (cp) {                                                                  \
    if (counted) REPRO_PART(P, 64, true, true);                              \
    REPRO_PART(P, 64, true, false);                                          \
  }                                                                          \
  if (counted) REPRO_PART(P, 64, false, true);                               \
  REPRO_PART(P, 64, false, false)
  REPRO_BY_P(REPRO_PARTIAL)
#undef REPRO_PARTIAL
#undef REPRO_FEW
#undef REPRO_PART
#undef REPRO_PART_T
#undef REPRO_PART_N
}

}  // namespace

// The layout arguments every entry point takes: `planes` (1, 3 or 7) value
// planes per 32-symbol group and `gp` groups per packed row, with
// gp * 32 >= D and gp * (planes + 1) a multiple of 4 (the wrapper computes
// both from D and `levels`).  Pointers are device pointers.  Each returns
// the CUDA error code of its launches (0 on success).

// (Q, D) queries and (N, D) table [and (N, D) care] int8 -> packed
// (Q, gp, planes + 1) and (N, gp, planes + 1) words [and (N, gp) care
// words].  `care` and `cp` may be null.  D is a multiple of 16; `levels`
// is the symbol range (clamped to 128).
extern "C" int cam_pack_launch(const void* q, const void* t, const void* care,
                               void* qp, void* tp, void* cp, int Q, int N,
                               int D, int levels, int planes, int gp,
                               void* stream) {
  if (Q < 1 || N < 1 || D < 16 || D % 16 || levels < 1 || gp * 32 < D ||
      gp * (planes + 1) % 4)
    return (int)cudaErrorInvalidValue;
  const auto* qs = static_cast<const int8_t*>(q);
  const auto* ts = static_cast<const int8_t*>(t);
  const auto* cs = static_cast<const int8_t*>(care);
  auto* qo = static_cast<uint32_t*>(qp);
  auto* to = static_cast<uint32_t*>(tp);
  auto* co = care ? static_cast<uint32_t*>(cp) : nullptr;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_PACK(P)                                                        \
  return (int)launch_pack<P>(qs, ts, cs, qo, to, co, Q, N, D, gp, levels, s)
  REPRO_BY_P(REPRO_PACK)
#undef REPRO_PACK
}

// (Q, D) queries and (N, D) table [and (N, D) care] int8 level codes of
// `bits` bits (2 to 7) -> the packed words of their thermometer expansion
// at one bit, (Q, gp, 2) and (N, gp, 2) [and (N, gp) care words], as
// `cam_pack_launch` makes them at levels = 2 of the (rows, dp) expansion
// zero-padded to dp = D (2^bits - 1) rounded up to 16.  `care` and `cp`
// may be null; the codes need no alignment.
extern "C" int cam_pack_l1_launch(const void* q, const void* t,
                                  const void* care, void* qp, void* tp,
                                  void* cp, int Q, int N, int D, int bits,
                                  int gp, void* stream) {
  if (Q < 1 || N < 1 || D < 1 || bits < 2 || bits > 7)
    return (int)cudaErrorInvalidValue;
  const long long dp = ((long long)D * ((1 << bits) - 1) + 15) / 16 * 16;
  if (dp > 0x7FFFFFFFLL - 64 || (long long)gp * 32 < dp || gp % 2)
    return (int)cudaErrorInvalidValue;
  const auto* qs = static_cast<const int8_t*>(q);
  const auto* ts = static_cast<const int8_t*>(t);
  const auto* cs = static_cast<const int8_t*>(care);
  auto* qo = static_cast<uint32_t*>(qp);
  auto* to = static_cast<uint32_t*>(tp);
  auto* co = care ? static_cast<uint32_t*>(cp) : nullptr;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_PACK_L1(B)                                                     \
  case B:                                                                    \
    return (int)launch_pack_l1<(1 << B) - 1>(qs, ts, cs, qo, to, co, Q, N,   \
                                             D, (int)dp, gp, s)
  switch (bits) {
    REPRO_PACK_L1(2); REPRO_PACK_L1(3); REPRO_PACK_L1(4);
    REPRO_PACK_L1(5); REPRO_PACK_L1(6); REPRO_PACK_L1(7);
  }
#undef REPRO_PACK_L1
  return (int)cudaErrorInvalidValue;
}

// Packed queries and table [and care words] -> (Q, N) int32 mismatches.
// `cp` may be null.  `tile_q` (16 or 64) is the queries per block.
extern "C" int cam_search_launch(const void* qp, const void* tp,
                                 const void* cp, void* out, int Q, int N,
                                 int D, int planes, int gp, int tile_q,
                                 void* stream) {
  if (tile_q != 16 && tile_q != 64) return (int)cudaErrorInvalidValue;
  return (int)dense(planes, tile_q, static_cast<const uint32_t*>(qp),
                    static_cast<const uint32_t*>(tp),
                    static_cast<const uint32_t*>(cp),
                    static_cast<int32_t*>(out), Q, N, D, gp,
                    static_cast<cudaStream_t>(stream));
}

// Fused top-k, both passes, on packed inputs.  `cp` and `count_le` may be
// null; with `count_le`, `part_counts` ((Q, splits) int32) and `out_count`
// ((Q,) int32) must be given.  `part_keys` is (Q, splits, k) uint64
// scratch.  `valid_rows` is a device int32 the kernel reads itself.
// `stats`, null or five device uint64 (TopkStat), selects the traced pass 1,
// which adds its counters there; it takes no `cp` and no `count_le`.
// `tile_q` (16 or 64) is the queries per block of pass 1 and `tile_n` (128,
// or 32 with tile_q 16, k <= 32 and one tile a split: the few-row pass)
// its rows per tile; `rows_per_split` is a multiple of `tile_n`.
extern "C" int cam_search_topk_launch(
    const void* qp, const void* tp, const void* cp, const void* valid_rows,
    const void* count_le, void* part_keys, void* part_counts, void* out_idx,
    void* out_dist, void* out_count, void* stats, int Q, int N, int D,
    int planes, int gp, int k, int splits, int rows_per_split, int tile_q,
    int tile_n, void* stream) {
  if (k < 1 || k > MAX_K || (tile_q != 16 && tile_q != 64) ||
      (tile_n != BN && tile_n != FEW_BN) ||
      (tile_n == FEW_BN &&
       (tile_q != FEW_BQ || k > 32 || rows_per_split != FEW_BN)))
    return (int)cudaErrorInvalidValue;
  auto* pk = static_cast<uint64_t*>(part_keys);
  auto* pc = static_cast<int32_t*>(part_counts);
  auto s = static_cast<cudaStream_t>(stream);
  const bool counted = count_le != nullptr;
  cudaError_t err = partial(
      planes, tile_q, tile_n, counted, static_cast<const uint32_t*>(qp),
      static_cast<const uint32_t*>(tp), static_cast<const uint32_t*>(cp),
      static_cast<const int32_t*>(valid_rows),
      static_cast<const float*>(count_le), pk, pc, Q, N, D, gp, k, splits,
      rows_per_split, static_cast<unsigned long long*>(stats), s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Q + MERGE_WARPS - 1) / MERGE_WARPS;
  const size_t smem = (size_t)MERGE_WARPS * k * sizeof(uint64_t);
  cam_topk_merge_kernel<<<blocks, MERGE_WARPS * 32, smem, s>>>(
      pk, pc, static_cast<int32_t*>(out_idx), static_cast<float*>(out_dist),
      counted ? static_cast<int32_t*>(out_count) : nullptr, Q, k, splits);
  return (int)cudaGetLastError();
}
