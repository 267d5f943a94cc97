// The column loops of persistent warps: the category plane of kernel A
// (classify_cat.cu) and of kernel C's catmode (fused.cuh); below it, one
// loop (stream_warp) over two planes of column pairs: the byte plane of
// kernel D and its word entry (classify_bytes.cu) and of kernels F and C
// on byte words, and the nibble plane of kernel E (classify_nibbles.cu)
// and of kernels F and C on nibble words (fused.cuh).  Kernel 8's byte
// words take the byte plane too (fused.cuh), so every kernel's columns
// stream through these loops.
//
// Bound.  128 x 2^20 columns of cat plane is 64 MiB: 20 us at 3.35 TB/s.
// The first port's per-chunk loop (one block per 16K columns of a row,
// since deleted) counted each 8-column word with seven __popc and ~25
// integer ops, so at 2^24 words over 132 SMs (64 integer lanes and 16
// __popc a clock each) it issued about as long as it measured (66 us): it
// was bound by integer issue, not by memory.  This loop spends ~12 integer
// ops and 1.75 __popc per word, under the memory time.
//
// Design.
// - Work: a row is cut into warp segments of CS_SEG words (4096 columns);
//   the B x segments (row, segment) pairs, in row order, are split into
//   contiguous ranges, one per warp of about (SMs x resident blocks)
//   persistent blocks.  CS_MIN_BLOCKS = 3 caps the registers so that
//   three blocks fit an SM; at two, kernel C's B2 op-row scan blocks held
//   half the slots while the columns streamed (C 46 us against 37 us).
// - Loads: each lane loads its segment's CS_VEC uint4 (64 B; 16 KiB a
//   block) and, before it counts them, issues the next segment's loads:
//   one segment in flight behind the one being counted.
// - A warp keeps its counters in registers while its row does not change
//   and adds them, with lane 0's 8 atomics into the zeroed out[row], only
//   when the row changes and at the end of its range.  No __syncthreads
//   and no shared memory: at most (rows a range touches) x 8 atomics per
//   warp: ~26 000 at B=128 x 2^20 on 132 SMs (3168 warps, 128 row ends),
//   against the per-chunk loop's 65 536 from its 8192 block reductions.
// - The category before a word: within a uint4 from the word before it,
//   across lanes by __shfl_up_sync of the lane before's last word, and
//   across a segment's batches from lane 31 of the batch before.  Only
//   lane 0 reads the word before its segment from memory.
// - Counting: run starts of four words are merged into one word, and the
//   four words' category bits are transposed (delta swaps) so that each
//   output word holds one category bit of all four: seven __popc per 16-B
//   load.  The bit meanings and counters are count_word's exactly, for any
//   nibble, so the counters equal count_word's one word at a time.
// - Ragged edges: words before a segment's first 16-B boundary (a row's
//   base need not be aligned: LW % 4 != 0), words after its last uint4,
//   and the row's partial last word (valid_nibbles) go through count_word,
//   one lane each, reading the word before from memory.  Lengths are
//   clamped to [0, 8 LW]; column 0 of a row always starts a run.
// - The zeroing of out stays a separate torch.zeros in the wrappers
//   (timed on its own line by chip_smoke.py: ~2 us of the call).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stats.cuh"

namespace wga {

// The category plane: int32 [B, LW] category words (8 columns each), read
// as they are.
struct CatPlane {
  const uint32_t* cw;
  long long LW;  // words per row
};

constexpr int CS_THREADS = 256;
constexpr int CS_VEC = 4;  // uint4 loads per lane per segment
constexpr int CS_MIN_BLOCKS = 3;  // resident blocks per SM the registers allow
// words per warp segment: 32 lanes x CS_VEC uint4
constexpr int CS_SEG = 4 * 32 * CS_VEC;

__device__ __forceinline__ void delta_swap(uint32_t& a, uint32_t& b, int s,
                                           uint32_t m) {
  const uint32_t t = ((a >> s) ^ b) & m;
  b ^= t;
  a ^= t << s;
}

// Bit 3 of each nibble set where that column's category differs from the
// one before it (pw: the word of the categories before, w << 4 with the
// column before the word in nibble 0); bits 0-2 are unspecified.  Same
// test as run_starts.
template <bool CALLER>
__device__ __forceinline__ uint32_t starts_hi(uint32_t w, uint32_t pw) {
  const uint32_t d = w ^ pw;
  const uint32_t s = (d & M7) + M7;
  return CALLER ? (s | d) : s;
}

// count_word's counters of the four full words of v; prev's top nibble is
// the category of the column before v.
template <bool CALLER>
__device__ __forceinline__ void count_vec(const uint4& v, uint32_t prev,
                                          uint32_t (&c)[7]) {
  uint32_t a0 = v.x, a1 = v.y, a2 = v.z, a3 = v.w;
  const uint32_t r0 = starts_hi<CALLER>(a0, __funnelshift_l(prev, a0, 4));
  const uint32_t r1 = starts_hi<CALLER>(a1, __funnelshift_l(a0, a1, 4));
  const uint32_t r2 = starts_hi<CALLER>(a2, __funnelshift_l(a1, a2, 4));
  const uint32_t r3 = starts_hi<CALLER>(a3, __funnelshift_l(a2, a3, 4));
  // run starts of word i in bit i of each nibble
  const uint32_t rs = ((r0 >> 3) & M1) | ((r1 >> 2) & (M1 << 1)) |
                      ((r2 >> 1) & (M1 << 2)) | (r3 & HI);
  // transpose: afterwards a_k holds category bit k of word i in bit i
  delta_swap(a0, a2, 2, 0x33333333u);
  delta_swap(a1, a3, 2, 0x33333333u);
  delta_swap(a0, a1, 1, 0x55555555u);
  delta_swap(a2, a3, 1, 0x55555555u);
  c[0] += __popc(a0);
  c[1] += __popc(a1);
  c[2] += __popc(a2);
  c[3] += __popc(a3);
  c[4] += __popc(rs);
  c[5] += __popc(rs & a1);
  c[6] += __popc(rs & a2);
}

// One warp segment: words [g0, gend) of a row, uniform over the warp, and
// what its lane loaded.  Words [g0, g0 + h) lie before the first 16-B
// boundary, [g0 + h, tail0) are nv full uint4, [tail0, gend) the words
// after them and the row's partial last word.
struct CatSeg {
  const uint32_t* rp;  // the row
  int row, n, g0, gend, h, nv, tail0;
  uint4 v[CS_VEC];     // the lane's uint4, k-th at 32 k + lane
  uint32_t before;     // lane 0: the word before the first uint4
  uint32_t sw, sp;     // lanes < h + gend - tail0: a scalar word, the one before
};

// Geometry of segment s (of nseg per row) and the lane's loads.  The row's
// length is read when the row differs from *len_row (cached in *n_row).
__device__ __forceinline__ void cat_seg_load(const CatPlane& p,
                                             const int* __restrict__ lengths,
                                             unsigned s, unsigned nseg,
                                             int* len_row, int* n_row,
                                             CatSeg& q) {
  const int lane = threadIdx.x & 31;
  q.row = static_cast<int>(s / nseg);
  if (q.row != *len_row) {
    const long long cols = 8 * p.LW, v = __ldg(lengths + q.row);
    *len_row = q.row;
    *n_row = static_cast<int>(v < 0 ? 0 : (v > cols ? cols : v));
  }
  q.n = *n_row;
  q.rp = p.cw + static_cast<long long>(q.row) * p.LW;
  const int ng = (q.n + 7) >> 3, nfull = q.n >> 3;
  q.g0 = static_cast<int>(s - static_cast<unsigned>(q.row) * nseg) * CS_SEG;
  q.gend = q.g0 + CS_SEG < ng ? q.g0 + CS_SEG : ng;  // <= g0: nothing valid
  int len = (q.gend < nfull ? q.gend : nfull) - q.g0;
  len = len < 0 ? 0 : len;
  const auto addr = reinterpret_cast<uintptr_t>(q.rp + q.g0);
  q.h = static_cast<int>(((16u - (addr & 15u)) & 15u) >> 2);
  q.h = q.h < len ? q.h : len;
  q.nv = (len - q.h) >> 2;
  q.tail0 = q.g0 + q.h + 4 * q.nv;
  const auto* vp = reinterpret_cast<const uint4*>(q.rp + q.g0 + q.h);
#pragma unroll
  for (int k = 0; k < CS_VEC; ++k) {
    const int i = 32 * k + lane;
    q.v[k] = i < q.nv ? __ldg(vp + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  const int gb = q.g0 + q.h;
  q.before = (lane == 0 && q.nv > 0 && gb > 0) ? __ldg(q.rp + gb - 1) : 0u;
  const int scalar = q.h + (q.gend > q.tail0 ? q.gend - q.tail0 : 0);
  q.sw = q.sp = 0;
  if (lane < scalar) {
    const int g = lane < q.h ? q.g0 + lane : q.tail0 + (lane - q.h);
    q.sw = __ldg(q.rp + g);
    if (g) q.sp = __ldg(q.rp + g - 1);
  }
}

// Counters of a loaded segment, added to c.  Every lane of the warp.
template <bool CALLER>
__device__ __forceinline__ void cat_seg_count(const CatSeg& q,
                                              uint32_t (&c)[7]) {
  const int lane = threadIdx.x & 31;
  const int scalar = q.h + (q.gend > q.tail0 ? q.gend - q.tail0 : 0);
  if (lane < scalar) {
    const int g = lane < q.h ? q.g0 + lane : q.tail0 + (lane - q.h);
    count_word<CALLER>(q.sw, q.sp >> 28, g == 0, valid_nibbles(q.n - 8 * g),
                       c);
  }
  if (q.nv == 0) return;  // uniform over the warp
  uint32_t carry = q.before;
#pragma unroll
  for (int k = 0; k < CS_VEC; ++k) {
    uint32_t prev = __shfl_up_sync(0xffffffffu, q.v[k].w, 1);
    if (lane == 0) {
      // column 0 of the row: a category unlike its own forces the start
      prev = (k == 0 && q.g0 + q.h == 0) ? (q.v[0].x ^ 7u) << 28 : carry;
    }
    carry = __shfl_sync(0xffffffffu, q.v[k].w, 31);
    if (32 * k + lane < q.nv) count_vec<CALLER>(q.v[k], prev, c);
  }
}

// Adds the warp's counters c (valid columns `valid`) into o as the eight
// stats, with lane 0's 8 atomics, and clears them.
template <bool CALLER>
__device__ __forceinline__ void warp_flush(uint32_t (&c)[7], uint32_t valid,
                                           int* o) {
  uint32_t s[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    uint32_t v = c[j];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    s[j] = v;
    c[j] = 0;
  }
  if ((threadIdx.x & 31) == 0) atomic_add_stats<CALLER>(s, valid, o);
}

// Segments [s0, s1) of the (row, segment) order, by one warp, added into
// out.  The next segment's loads are issued before the current one is
// counted.
template <bool CALLER>
__device__ __forceinline__ void cat_stream_warp(const CatPlane& p,
                                                const int* __restrict__ lengths,
                                                int* __restrict__ out,
                                                unsigned nseg, unsigned s0,
                                                unsigned s1) {
  if (s0 >= s1) return;  // uniform over the warp
  uint32_t c[7] = {0, 0, 0, 0, 0, 0, 0};
  uint32_t valid = 0;  // uniform over the warp
  int row = -1, len_row = -1, n_row = 0;
  CatSeg cur, nxt;
  cat_seg_load(p, lengths, s0, nseg, &len_row, &n_row, cur);
  for (unsigned s = s0; s < s1; ++s) {
    if (s + 1 < s1) cat_seg_load(p, lengths, s + 1, nseg, &len_row, &n_row, nxt);
    if (cur.row != row) {
      if (valid) warp_flush<CALLER>(c, valid, out + row * N_STATS);
      valid = 0;
      row = cur.row;
    }
    if (cur.gend > cur.g0) {
      const int hi = 8 * cur.gend < cur.n ? 8 * cur.gend : cur.n;
      valid += static_cast<uint32_t>(hi - 8 * cur.g0);
      cat_seg_count<CALLER>(cur, c);
    }
    cur = nxt;
  }
  if (valid) warp_flush<CALLER>(c, valid, out + row * N_STATS);
}

// The range of segments of column warp `w` of `warps`, `segs` in all.
__device__ __forceinline__ void warp_range(unsigned long long w,
                                           unsigned long long warps,
                                           unsigned long long segs,
                                           unsigned* s0, unsigned* s1) {
  *s0 = static_cast<unsigned>(w * segs / warps);
  *s1 = static_cast<unsigned>((w + 1) * segs / warps);
}

inline unsigned cat_segs_per_row(long long LW) {
  return static_cast<unsigned>((LW + CS_SEG - 1) / CS_SEG);
}

// *blocks = resident blocks of `kernel` on the current device (CS_THREADS
// threads, no dynamic shared memory) times its SMs.  Returns the error of
// the first query that fails, else cudaSuccess.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        CS_THREADS, 0);
  }
  *blocks = sms * per_sm;
  if (err == cudaSuccess && *blocks <= 0) err = cudaErrorInvalidConfiguration;
  return err;
}

// ---- the byte plane (kernel D; kernels F and C on byte words) ---------------
//
// Bound.  Two bytes are read per column: [1, 12 500 003] is 25 MB, 7.46 us
// at 3.35 TB/s.  The first port's per-chunk loop, since deleted, spent
// 2-3 aligned 4-byte loads and funnel shifts per plane per 8 columns,
// built the category nibble word (byte_cats), counted it with seven __popc,
// and read the column before from memory: 70-80 integer ops and seven
// quarter-rate __popc per 8 columns, with 8 B in flight per plane per
// thread.  It is what the ragged edges below still do, one lane a word.
//
// Design: cat_stream_warp's loop with two planes.
// - Work: a row is cut into warp segments of BS_SEG (1024) columns whose
//   boundaries fall on 16-byte boundaries of the t row (segment 0 also
//   takes the columns before the first one); contiguous ranges of (row,
//   segment) pairs, one per warp of about (SMs x resident blocks)
//   persistent blocks.
// - Loads: a lane loads BS_VEC uint4 of t and of q (64 B), and the next
//   segment's before it counts the current one.
// - Counting without the nibble word: per 4-byte word, three zero-byte
//   tests give bit 7 of each byte that is equal (t ^ q), a t gap and a q
//   gap.  A run starts where a byte's key differs from the byte before's:
//   (equal, t gap, q gap) in caller mode, where the five categories differ
//   in it; (equal, t gap ^ q gap, q gap & ~t gap) in ext mode, which is
//   the same for '=' and gap/gap, so that gap/gap merges into '=' runs.
//   The byte before comes by a funnel shift within a lane, from the lane
//   before (__shfl_up_sync), from lane 31 of the uint4 batch before, or,
//   for a segment's first uint4, from memory (lane 0).  The bit-7 flags
//   of a lane's eight words are merged into one word each (word j of uint4
//   k shifted right by 7 - 4 k - j), so one __popc counts 32 columns:
//   equal (the LUT's bit 0, gap/gap included), t gap, q gap and run
//   starts; gap/gap is t gap & q gap, I = t gap - gap/gap and D = q gap -
//   gap/gap, so the counters are count_word's and both modes are exact.
// - Counters stay in registers while the row does not change; lane 0 adds
//   them with 8 atomics when the row changes (warp_flush).  At the range's
//   end the warps of a block that end in one row add their sums once
//   (block_flush): with one row, 8 atomics per block and not per warp.
// - Ragged edges: a row's columns before its first 16-B boundary and
//   after its last whole uint4, and every column of a row whose t and q
//   bases differ mod 16, go through load8 and count_word, 8 columns a
//   lane, reading the column before from memory.  Lengths are clamped to
//   [0, L]; column 0 of a row always starts a run.

constexpr int BS_VEC = 2;  // uint4 loads per lane per plane per segment
static_assert(BS_VEC == 2, "seg_count merges 8 byte words a lane");
constexpr int BS_MIN_BLOCKS = 2;  // resident blocks per SM the registers allow
// columns per warp segment: 32 lanes x BS_VEC x 16 bytes
constexpr int BS_SEG = 32 * BS_VEC * 16;

// Bit 7 of each byte of v that is 0.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t v) {
  constexpr uint32_t M = 0x7f7f7f7fu;
  return ~(((v & M) + M) | v) & 0x80808080u;
}

// Three flag words of a group of columns, one bit per column: equal, t
// gap, q gap (bit 7 of a byte column, bit 3 of a nibble column, or the bit
// a merged word gives the column).
struct ColumnFlags {
  uint32_t e, tg, qg;
};

__device__ __forceinline__ ColumnFlags byte_masks(uint32_t t, uint32_t q) {
  constexpr uint32_t GAP4 = 0x2d2d2d2du;  // '-' in every byte
  return {zero_bytes(t ^ q), zero_bytes(t ^ GAP4), zero_bytes(q ^ GAP4)};
}

// The run key of each column (see above), three flag words.
template <bool CALLER>
__device__ __forceinline__ ColumnFlags run_key(const ColumnFlags& m) {
  if (CALLER) return m;
  return {m.e, m.tg ^ m.qg, m.qg & ~m.tg};
}

// Bit 7 of each byte whose key differs from the byte before's; p: the key
// of the word before (its top byte is the column before this word).
__device__ __forceinline__ uint32_t key_starts(const ColumnFlags& k,
                                               const ColumnFlags& p) {
  return (k.e ^ __funnelshift_l(p.e, k.e, 8)) |
         (k.tg ^ __funnelshift_l(p.tg, k.tg, 8)) |
         (k.qg ^ __funnelshift_l(p.qg, k.qg, 8));
}

__device__ __forceinline__ ColumnFlags shfl_up_masks(const ColumnFlags& m) {
  return {__shfl_up_sync(0xffffffffu, m.e, 1),
          __shfl_up_sync(0xffffffffu, m.tg, 1),
          __shfl_up_sync(0xffffffffu, m.qg, 1)};
}

__device__ __forceinline__ ColumnFlags shfl_masks(const ColumnFlags& m,
                                                  int src) {
  return {__shfl_sync(0xffffffffu, m.e, src),
          __shfl_sync(0xffffffffu, m.tg, src),
          __shfl_sync(0xffffffffu, m.qg, src)};
}

// Adds count_word's counters of 32 columns given as merged flag words
// (one bit per column, the same bit in each) to c: m the flags, rs the run
// starts.
__device__ __forceinline__ void count_flags(const ColumnFlags& m, uint32_t rs,
                                            uint32_t (&c)[7]) {
  const uint32_t ng = __popc(m.tg & m.qg);  // gap/gap
  c[0] += __popc(m.e);
  c[1] += __popc(m.tg) - ng;
  c[2] += __popc(m.qg) - ng;
  c[3] += ng;
  c[4] += __popc(rs);
  c[5] += __popc(rs & m.tg & ~m.qg);
  c[6] += __popc(rs & m.qg & ~m.tg);
}

// One warp segment of the byte plane: columns [c0, cend) of a row, uniform
// over the warp, and what its lane loaded.  Columns [c0, c0 + h) lie
// before the row's first 16-B boundary of t (segment 0 only), [c0 + h,
// tail0) are nv uint4 of each plane, [tail0, cend) the rest.  A row whose
// t and q bases differ mod 16 has h = cend - c0 and nv = 0.
struct ByteSeg {
  const uint8_t* tp;  // the row's planes
  const uint8_t* qp;
  int row, h, nv;
  long long c0, cend, tail0;
  uint4 t[BS_VEC], q[BS_VEC];  // the lane's uint4, k-th at 32 k + lane
  uint32_t bt, bq;  // lane 0: the column before the uint4, in the top byte
};

// uint8 t, q [B, L] of any base alignment; an int32 [B, LW] byte-word plane
// is the same buffer with L = 4 LW.
struct ByteStream {
  using Seg = ByteSeg;
  const uint8_t* t;
  const uint8_t* q;
  long long L;  // bytes per row; row b starts at byte b * L
  unsigned long long segs_per_row() const { return (L + BS_SEG - 1) / BS_SEG; }
};

// Geometry of segment k of row `row` and the lane's loads.  The row's
// length is read when the row differs from *len_row (cached in *n_row).
__device__ __forceinline__ void seg_load(const ByteStream& p,
                                         const int* __restrict__ lengths,
                                         int row, long long k, int* len_row,
                                         long long* n_row, ByteSeg& g) {
  const int lane = threadIdx.x & 31;
  const long long L = p.L;
  g.row = row;
  if (g.row != *len_row) {
    const long long v = __ldg(lengths + g.row);
    *len_row = g.row;
    *n_row = v < 0 ? 0 : (v > L ? L : v);
  }
  const long long n = *n_row;
  g.tp = p.t + static_cast<long long>(g.row) * L;
  g.qp = p.q + static_cast<long long>(g.row) * L;
  const auto ta = reinterpret_cast<uintptr_t>(g.tp);
  const bool vec = ((ta ^ reinterpret_cast<uintptr_t>(g.qp)) & 15u) == 0;
  // columns before the row's first 16-B boundary of t
  const long long a = vec ? static_cast<long long>((16u - (ta & 15u)) & 15u)
                          : 0;
  g.c0 = k == 0 ? 0 : a + k * BS_SEG;
  g.cend = a + (k + 1) * BS_SEG < n ? a + (k + 1) * BS_SEG : n;
  const long long len = g.cend > g.c0 ? g.cend - g.c0 : 0;  // 0: nothing
  if (vec) {
    g.h = static_cast<int>(k == 0 ? (a < len ? a : len) : 0);
    g.nv = static_cast<int>((len - g.h) >> 4);
  } else {
    g.h = static_cast<int>(len);
    g.nv = 0;
  }
  g.tail0 = g.c0 + g.h + 16 * g.nv;
  const long long cb = g.c0 + g.h;
  const auto* tv = reinterpret_cast<const uint4*>(g.tp + cb);
  const auto* qv = reinterpret_cast<const uint4*>(g.qp + cb);
#pragma unroll
  for (int j = 0; j < BS_VEC; ++j) {
    const int i = 32 * j + lane;
    g.t[j] = i < g.nv ? __ldg(tv + i) : make_uint4(0u, 0u, 0u, 0u);
    g.q[j] = i < g.nv ? __ldg(qv + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  g.bt = g.bq = 0;
  if (lane == 0 && g.nv > 0 && cb > 0) {
    g.bt = static_cast<uint32_t>(__ldg(g.tp + cb - 1)) << 24;
    g.bq = static_cast<uint32_t>(__ldg(g.qp + cb - 1)) << 24;
  }
}

// Valid columns of a loaded segment (0: none).
__device__ __forceinline__ uint32_t seg_valid(const ByteSeg& g) {
  return g.cend > g.c0 ? static_cast<uint32_t>(g.cend - g.c0) : 0u;
}

// count_word's counters of columns [a, b) of the segment's row, 8 a lane.
template <bool CALLER>
__device__ __forceinline__ void byte_count_scalar(const ByteSeg& g,
                                                  long long a, long long b,
                                                  uint32_t (&c)[7]) {
  for (long long col = a + 8 * (threadIdx.x & 31); col < b; col += 8 * 32) {
    const int nb = b - col >= 8 ? 8 : static_cast<int>(b - col);
    const uint32_t w = byte_cats(g.tp + col, g.qp + col, nb);
    const uint32_t prev = col ? byte_cat(g.tp + col - 1, g.qp + col - 1) : 0u;
    count_word<CALLER>(w, prev, col == 0, valid_nibbles(nb), c);
  }
}

// Counters of a loaded segment, added to c.  Every lane of the warp.
template <bool CALLER>
__device__ __forceinline__ void seg_count(const ByteSeg& g, uint32_t (&c)[7]) {
  const int lane = threadIdx.x & 31;
  if (g.h > 0) byte_count_scalar<CALLER>(g, g.c0, g.c0 + g.h, c);
  if (g.cend > g.tail0) byte_count_scalar<CALLER>(g, g.tail0, g.cend, c);
  if (g.nv == 0) return;  // uniform over the warp
  ColumnFlags me{0, 0, 0};
  uint32_t mr = 0;
  // the key of the column before the lane's uint4 (lane 0 of batch 0)
  ColumnFlags carry = run_key<CALLER>(byte_masks(g.bt, g.bq));
#pragma unroll
  for (int k = 0; k < BS_VEC; ++k) {
    const uint32_t tw[4] = {g.t[k].x, g.t[k].y, g.t[k].z, g.t[k].w};
    const uint32_t qw[4] = {g.q[k].x, g.q[k].y, g.q[k].z, g.q[k].w};
    ColumnFlags m[4], key[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = byte_masks(tw[j], qw[j]);
      key[j] = run_key<CALLER>(m[j]);
    }
    ColumnFlags prev = shfl_up_masks(key[3]);
    if (lane == 0) prev = carry;
    carry = shfl_masks(key[3], 31);
    if (32 * k + lane < g.nv) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t rs = key_starts(key[j], prev);
        // column 0 of the row always starts a run
        if (k == 0 && j == 0 && lane == 0 && g.c0 + g.h == 0) rs |= 0x80u;
        prev = key[j];
        const int sh = 7 - 4 * k - j;
        me.e |= m[j].e >> sh;
        me.tg |= m[j].tg >> sh;
        me.qg |= m[j].qg >> sh;
        mr |= rs >> sh;
      }
    }
  }
  count_flags(me, mr, c);
}

// ---- the nibble plane (kernel E; kernels F and C on nibble words) -----------
//
// Bound.  One byte is read per column (t and q, 4 bits each): 128 x 2^20
// columns are 128 MiB, 40 us at 3.35 TB/s.  The per-chunk loop spent per
// 8 columns a 4-byte load of each plane, two more of the word before,
// cat_nibbles twice, count_word's seven __popc and ~25 integer ops, and a
// block reduction with 8 atomics per 16K columns: ~100 us, bound by
// integer issue as kernel A's and D's were.
//
// Design: the byte plane's loop (stream_warp) with NS_VEC uint4 of each
// plane a lane, 32 x NS_VEC x 32 columns a warp segment, cut at the t
// row's 16-byte boundaries.
// - Counting without the category word: per word pair (t, q), 8 columns,
//   three zero-nibble tests ~(((x & M7) + M7) | x) & HI give bit 3 of each
//   nibble that is equal (t ^ q), a t gap (t) and a q gap (q).  The four
//   word pairs of a uint4 are merged first, word j shifted right by 3 - j,
//   so that bit 4 i + j of a merged word is column 8 j + i of the uint4.
//   The run key is the byte plane's (ext mode: equal, t gap ^ q gap,
//   q gap & ~t gap) on the merged words, and the key of the column before
//   bit 4 i + j is bit 4 i + j - 4 for i > 0 (a shift by 4), bit 27 + j for
//   i = 0 < j, and, for column 0, bit 31 of the uint4 before: from the lane
//   before (__shfl_up_sync), lane 31 of the batch before, or, for a
//   segment's first uint4, the word before in memory (lane 0).  One __popc
//   then counts 32 columns of each counter, as count_flags does for bytes;
//   the counters are count_word's for any nibble, codes 12-15 included.
// - Ragged edges: a row's words before its first 16-B boundary (LW % 4 !=
//   0), after its last whole uint4, its partial last word, and every word
//   of a row whose t and q bases differ mod 16 go through cat_nibbles and
//   count_word, one word a lane, reading the word before from memory.
//   Lengths are clamped to [0, 8 LW]; column 0 of a row always starts a run.

constexpr int NS_VEC = 2;  // uint4 loads per lane per plane per segment
constexpr int NS_MIN_BLOCKS = 2;  // resident blocks per SM the registers allow
// words (8 columns each) per warp segment: 32 lanes x NS_VEC x 4 words
constexpr int NS_SEG = 32 * NS_VEC * 4;

// Bit 3 of each nibble of x that is 0.
__device__ __forceinline__ uint32_t zero_nibbles(uint32_t x) {
  return ~(((x & M7) + M7) | x) & HI;
}

__device__ __forceinline__ ColumnFlags nibble_masks(uint32_t t, uint32_t q) {
  return {zero_nibbles(t ^ q), zero_nibbles(t), zero_nibbles(q)};
}

// The flags of the 32 columns of a uint4 pair, merged: bit 4 i + j is
// column 8 j + i (word j, nibble i).
__device__ __forceinline__ ColumnFlags nibble_merged(const uint4& t,
                                                     const uint4& q) {
  const uint32_t tw[4] = {t.x, t.y, t.z, t.w};
  const uint32_t qw[4] = {q.x, q.y, q.z, q.w};
  ColumnFlags m{0, 0, 0};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const ColumnFlags f = nibble_masks(tw[j], qw[j]);
    m.e |= f.e >> (3 - j);
    m.tg |= f.tg >> (3 - j);
    m.qg |= f.qg >> (3 - j);
  }
  return m;
}

// Bits of a merged key word whose column's key differs from the column
// before's; c: that of the column before column 0, in bit 0.
__device__ __forceinline__ uint32_t merged_starts(uint32_t k, uint32_t c) {
  return k ^ ((k << 4) | ((k >> 27) & 0xeu) | c);
}

// One warp segment of the nibble plane: words [g0, gend) of a row, uniform
// over the warp, and what its lane loaded.  Words [g0, g0 + h) lie before
// the row's first 16-B boundary of t (segment 0 only), [g0 + h, tail0) are
// nv whole uint4 of each plane, [tail0, gend) the rest.  A row whose t and
// q bases differ mod 16 has h = gend - g0 and nv = 0.
struct NibbleSeg {
  const uint32_t* tp;  // the row's planes
  const uint32_t* qp;
  int row, n, h, nv, g0, gend, tail0;  // n: the row's valid columns
  uint4 t[NS_VEC], q[NS_VEC];  // the lane's uint4, k-th at 32 k + lane
  uint32_t bt, bq;  // lane 0: the words before the first uint4
};

// int32 t, q [B, LW] 4-bit dictionary codes (gap = 0, code equality = byte
// equality), 8 columns a word, 8 LW < 2^31.
struct NibbleStream {
  using Seg = NibbleSeg;
  const uint32_t* t;
  const uint32_t* q;
  long long LW;  // words per row
  unsigned long long segs_per_row() const {
    return (LW + NS_SEG - 1) / NS_SEG;
  }
};

// Geometry of segment k of row `row` and the lane's loads.  The row's
// length is read when the row differs from *len_row (cached in *n_row).
__device__ __forceinline__ void seg_load(const NibbleStream& p,
                                         const int* __restrict__ lengths,
                                         int row, long long k, int* len_row,
                                         long long* n_row, NibbleSeg& g) {
  const int lane = threadIdx.x & 31;
  g.row = row;
  if (row != *len_row) {
    const long long cols = 8 * p.LW, v = __ldg(lengths + row);
    *len_row = row;
    *n_row = v < 0 ? 0 : (v > cols ? cols : v);
  }
  g.n = static_cast<int>(*n_row);
  g.tp = p.t + static_cast<long long>(row) * p.LW;
  g.qp = p.q + static_cast<long long>(row) * p.LW;
  const auto ta = reinterpret_cast<uintptr_t>(g.tp);
  const bool vec = ((ta ^ reinterpret_cast<uintptr_t>(g.qp)) & 15u) == 0;
  // words before the row's first 16-B boundary of t
  const int a = vec ? static_cast<int>(((16u - (ta & 15u)) & 15u) >> 2) : 0;
  const int ng = (g.n + 7) >> 3, nfull = g.n >> 3;
  const int s = static_cast<int>(k);
  g.g0 = s == 0 ? 0 : a + s * NS_SEG;
  g.gend = a + (s + 1) * NS_SEG < ng ? a + (s + 1) * NS_SEG : ng;
  const int len = g.gend > g.g0 ? g.gend - g.g0 : 0;  // 0: nothing
  g.h = vec ? (s == 0 ? (a < len ? a : len) : 0) : len;
  // whole uint4 end before the row's partial last word
  const int vl = (g.gend < nfull ? g.gend : nfull) - g.g0 - g.h;
  g.nv = vec && vl > 0 ? vl >> 2 : 0;
  g.tail0 = g.g0 + g.h + 4 * g.nv;
  const int gb = g.g0 + g.h;
  const auto* tv = reinterpret_cast<const uint4*>(g.tp + gb);
  const auto* qv = reinterpret_cast<const uint4*>(g.qp + gb);
#pragma unroll
  for (int j = 0; j < NS_VEC; ++j) {
    const int i = 32 * j + lane;
    g.t[j] = i < g.nv ? __ldg(tv + i) : make_uint4(0u, 0u, 0u, 0u);
    g.q[j] = i < g.nv ? __ldg(qv + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  g.bt = g.bq = 0;
  if (lane == 0 && g.nv > 0 && gb > 0) {
    g.bt = __ldg(g.tp + gb - 1);
    g.bq = __ldg(g.qp + gb - 1);
  }
}

// Valid columns of a loaded segment (0: none).
__device__ __forceinline__ uint32_t seg_valid(const NibbleSeg& g) {
  if (g.gend <= g.g0) return 0u;
  const int hi = 8 * g.gend < g.n ? 8 * g.gend : g.n;
  return static_cast<uint32_t>(hi - 8 * g.g0);
}

// count_word's counters of words [a, b) of the segment's row, one a lane.
template <bool CALLER>
__device__ __forceinline__ void nibble_count_scalar(const NibbleSeg& g, int a,
                                                    int b, uint32_t (&c)[7]) {
  for (int w = a + (threadIdx.x & 31); w < b; w += 32) {
    const uint32_t prev =
        w ? cat_nibbles(__ldg(g.tp + w - 1) >> 28, __ldg(g.qp + w - 1) >> 28) &
                0xfu
          : 0u;
    count_word<CALLER>(cat_nibbles(__ldg(g.tp + w), __ldg(g.qp + w)), prev,
                       w == 0, valid_nibbles(g.n - 8LL * w), c);
  }
}

// Counters of a loaded segment, added to c.  Every lane of the warp.
template <bool CALLER>
__device__ __forceinline__ void seg_count(const NibbleSeg& g,
                                          uint32_t (&c)[7]) {
  const int lane = threadIdx.x & 31;
  if (g.h > 0) nibble_count_scalar<CALLER>(g, g.g0, g.g0 + g.h, c);
  if (g.gend > g.tail0) nibble_count_scalar<CALLER>(g, g.tail0, g.gend, c);
  if (g.nv == 0) return;  // uniform over the warp
  // the key of a group's last column, in bit 0
  const auto last = [](const ColumnFlags& k) {
    return ColumnFlags{k.e >> 31, k.tg >> 31, k.qg >> 31};
  };
  // the key of the column before the lane's uint4 (lane 0 of batch 0)
  ColumnFlags carry = last(run_key<CALLER>(nibble_masks(g.bt, g.bq)));
#pragma unroll
  for (int k = 0; k < NS_VEC; ++k) {
    const ColumnFlags m = nibble_merged(g.t[k], g.q[k]);
    const ColumnFlags key = run_key<CALLER>(m);
    ColumnFlags prev = shfl_up_masks(last(key));
    if (lane == 0) prev = carry;
    carry = shfl_masks(last(key), 31);
    if (32 * k + lane < g.nv) {
      uint32_t rs = merged_starts(key.e, prev.e) |
                    merged_starts(key.tg, prev.tg) |
                    merged_starts(key.qg, prev.qg);
      // column 0 of the row always starts a run
      if (k == 0 && lane == 0 && g.g0 + g.h == 0) rs |= 1u;
      count_flags(m, rs, c);
    }
  }
}

// ---- the loop of both planes -----------------------------------------------

// The counters a warp's range ends with: its last row and the warp's sums
// of count_word's counters over `valid` columns of it (valid 0: none).
struct WarpTail {
  int row;
  uint32_t valid;
  uint32_t s[7];
};

constexpr unsigned NO_SEG = 0xffffffffu;

// The segments of one warp: the contiguous range [s, end) (kernels D and
// E).  first() and next() are uniform over the warp; NO_SEG ends the work.
struct SegRange {
  unsigned s, end;
  __device__ __forceinline__ unsigned first() const {
    return s < end ? s : NO_SEG;
  }
  __device__ __forceinline__ unsigned next(unsigned cur) const {
    return cur + 1 < end ? cur + 1 : NO_SEG;
  }
};

// The segments of one warp of a fused launch: chunks of CHUNK_SEGS taken in
// turn from a zeroed counter in memory, the next chunk taken as one is
// started.  The column blocks that start only when an op-row scan block
// ends take what is left, so no warp's share waits behind the scans.
constexpr unsigned CHUNK_SEGS = 8;

struct SegChunks {
  unsigned* counter;
  unsigned segs;
  unsigned pending;
  __device__ __forceinline__ unsigned take() const {
    unsigned c = 0;
    if ((threadIdx.x & 31) == 0) c = atomicAdd(counter, 1u);
    c = __shfl_sync(0xffffffffu, c, 0);
    const unsigned long long s = static_cast<unsigned long long>(c) * CHUNK_SEGS;
    return s < segs ? static_cast<unsigned>(s) : NO_SEG;
  }
  __device__ __forceinline__ unsigned first() {
    const unsigned s = take();
    pending = s == NO_SEG ? NO_SEG : take();
    return s;
  }
  __device__ __forceinline__ unsigned next(unsigned cur) {
    if ((cur + 1) % CHUNK_SEGS != 0 && cur + 1 < segs) return cur + 1;
    const unsigned s = pending;
    if (s != NO_SEG) pending = take();
    return s;
  }
};

// The segments `work` gives one warp, of the (row, segment) order of plane
// p (ByteStream or NibbleStream): the rows it leaves are added into out,
// the last one is returned.  The next segment's loads are issued before
// the current one is counted.
template <bool CALLER, class Plane, class Work>
__device__ __forceinline__ WarpTail stream_warp(
    const Plane& p, const int* __restrict__ lengths, int* __restrict__ out,
    unsigned nseg, Work work) {
  uint32_t c[7] = {0, 0, 0, 0, 0, 0, 0};
  WarpTail tail{-1, 0, {0, 0, 0, 0, 0, 0, 0}};
  unsigned s = work.first();
  if (s == NO_SEG) return tail;  // uniform over the warp
  uint32_t valid = 0;  // uniform over the warp
  int row = -1, len_row = -1;
  long long n_row = 0;
  // the segment loaded last, as (row, segment of the row)
  int next_row = static_cast<int>(s / nseg);
  long long next_k = s - static_cast<unsigned>(next_row) * nseg;
  typename Plane::Seg cur, nxt;
  seg_load(p, lengths, next_row, next_k, &len_row, &n_row, cur);
  while (true) {
    const unsigned n = work.next(s);
    if (n != NO_SEG) {
      if (n == s + 1) {
        if (++next_k == nseg) {
          next_k = 0;
          ++next_row;
        }
      } else {
        next_row = static_cast<int>(n / nseg);
        next_k = n - static_cast<unsigned>(next_row) * nseg;
      }
      seg_load(p, lengths, next_row, next_k, &len_row, &n_row, nxt);
    }
    if (cur.row != row) {
      if (valid) warp_flush<CALLER>(c, valid, out + row * N_STATS);
      valid = 0;
      row = cur.row;
    }
    const uint32_t v = seg_valid(cur);
    if (v) {
      valid += v;
      seg_count<CALLER>(cur, c);
    }
    if (n == NO_SEG) break;
    cur = nxt;
    s = n;
  }
  tail.row = row;
  tail.valid = valid;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    uint32_t v = c[j];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    tail.s[j] = v;
  }
  return tail;
}

// Adds the warps' tails into out, the tails of one row summed first: when
// rows are few and long, every warp of a block ends in the same row, and
// 8 atomics per warp on the row's counters would queue thousands deep on
// one address.  Every thread of the block.
template <bool CALLER>
__device__ __forceinline__ void block_flush(const WarpTail& w, int* out) {
  constexpr int WARPS = CS_THREADS / 32;
  __shared__ int rows[WARPS];
  __shared__ uint32_t sums[WARPS][8];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    rows[warp] = w.valid ? w.row : -1;
    sums[warp][7] = w.valid;
#pragma unroll
    for (int j = 0; j < 7; ++j) sums[warp][j] = w.s[j];
  }
  __syncthreads();
  if (threadIdx.x < WARPS) {
    const int r = rows[threadIdx.x];
    bool first = r >= 0;
    for (int v = 0; v < static_cast<int>(threadIdx.x); ++v) {
      if (rows[v] == r) first = false;
    }
    if (first) {
      uint32_t s[7] = {0, 0, 0, 0, 0, 0, 0}, valid = 0;
      for (int v = threadIdx.x; v < WARPS; ++v) {
        if (rows[v] != r) continue;
        valid += sums[v][7];
#pragma unroll
        for (int j = 0; j < 7; ++j) s[j] += sums[v][j];
      }
      atomic_add_stats<CALLER>(s, valid,
                               out + static_cast<long long>(r) * N_STATS);
    }
  }
}


// The (row, segment) pairs of B rows of plane p; refuses 2^32 or more.
template <class Plane>
cudaError_t stream_segs(const Plane& p, int B, unsigned long long* segs) {
  *segs = B > 0 ? static_cast<unsigned long long>(B) * p.segs_per_row() : 0;
  return *segs >= (1ull << 32) ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Column blocks for `segs` segments: about (SMs x resident blocks of
// `kernel`), no more than one per 8 segments (a warp's worth each).
template <class Kernel>
cudaError_t stream_grid(Kernel kernel, unsigned long long segs,
                          long long* blocks) {
  *blocks = 0;
  if (segs == 0) return cudaSuccess;
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, &resident);
  const unsigned long long need = (segs + 7) / 8;
  *blocks = static_cast<long long>(
      need < static_cast<unsigned long long>(resident) ? need : resident);
  return err;
}

}  // namespace wga

namespace {

// The stats kernel of a streamed plane (kernels D and E): persistent
// blocks, at least MIN_BLOCKS of them resident per SM.
template <bool CALLER, class Plane, int MIN_BLOCKS>
__global__ void __launch_bounds__(wga::CS_THREADS, MIN_BLOCKS)
    stream_stats_kernel(Plane p, const int* __restrict__ lengths,
                        int* __restrict__ out, unsigned nseg,
                        unsigned long long segs) {
  constexpr int WARPS = wga::CS_THREADS / 32;
  wga::SegRange r;
  wga::warp_range(static_cast<unsigned long long>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5),
                  static_cast<unsigned long long>(gridDim.x) * WARPS, segs,
                  &r.s, &r.end);
  wga::block_flush<CALLER>(
      wga::stream_warp<CALLER>(p, lengths, out, nseg, r), out);
}

// Launches the counters of B rows of plane p into the zeroed int32 [B, 8]
// out.  Returns cudaGetLastError(), or the error of a query that failed.
template <int MIN_BLOCKS, class Plane>
int launch_stream_stats(const Plane& p, int B, const void* lengths, void* out,
                        int caller, void* stream) {
  unsigned long long segs = 0;
  cudaError_t err = wga::stream_segs(p, B, &segs);
  long long blocks = 0;
  if (err == cudaSuccess) {
    err = caller ? wga::stream_grid(
                       stream_stats_kernel<true, Plane, MIN_BLOCKS>, segs,
                       &blocks)
                 : wga::stream_grid(
                       stream_stats_kernel<false, Plane, MIN_BLOCKS>, segs,
                       &blocks);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const auto* n = static_cast<const int*>(lengths);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const auto nseg = static_cast<unsigned>(p.segs_per_row());
  const dim3 grid(static_cast<unsigned>(blocks));
  if (caller) {
    stream_stats_kernel<true, Plane, MIN_BLOCKS>
        <<<grid, wga::CS_THREADS, 0, s>>>(p, n, o, nseg, segs);
  } else {
    stream_stats_kernel<false, Plane, MIN_BLOCKS>
        <<<grid, wga::CS_THREADS, 0, s>>>(p, n, o, nseg, segs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
