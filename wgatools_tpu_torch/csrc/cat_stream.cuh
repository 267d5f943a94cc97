// The column loops of persistent warps: the category plane of kernel A
// (classify_cat.cu) and of kernel C's catmode (fused.cuh), and, below it,
// the byte plane of kernel D and its word entry (classify_bytes.cu).  The
// nibble plane and the byte words of kernels F and 8 keep the per-chunk
// loop of cat_stats.cuh (plane_stats_chunk).
//
// Bound.  128 x 2^20 columns of cat plane is 64 MiB: 20 us at 3.35 TB/s.
// The per-chunk loop counted each 8-column word with seven __popc and ~25
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
//   against the per-chunk loop's 65 536 from 8192 block reductions.
// - The category before a word: within a uint4 from the word before it,
//   across lanes by __shfl_up_sync of the lane before's last word, and
//   across a segment's batches from lane 31 of the batch before.  Only
//   lane 0 reads the word before its segment from memory.
// - Counting: run starts of four words are merged into one word, and the
//   four words' category bits are transposed (delta swaps) so that each
//   output word holds one category bit of all four: seven __popc per 16-B
//   load.  The bit meanings and counters are count_word's exactly, for any
//   nibble, so the counters equal the per-chunk loop's.
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

// ---- the byte plane (kernel D) ---------------------------------------------
//
// Bound.  Two bytes are read per column: [1, 12 500 003] is 25 MB, 7.46 us
// at 3.35 TB/s.  The per-chunk loop (BytePlane) spent 2-3 aligned 4-byte
// loads and funnel shifts per plane per 8 columns, built the category
// nibble word (cat_bytes, bytes_to_nibbles twice), counted it with seven
// __popc, and read the column before from memory: 70-80 integer ops and
// seven quarter-rate __popc per 8 columns, with 8 B in flight per plane
// per thread.
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
static_assert(BS_VEC == 2, "byte_seg_count merges 8 words a lane");
constexpr int BS_MIN_BLOCKS = 2;  // resident blocks per SM the registers allow
// columns per warp segment: 32 lanes x BS_VEC x 16 bytes
constexpr int BS_SEG = 32 * BS_VEC * 16;

// Bit 7 of each byte of v that is 0.
__device__ __forceinline__ uint32_t zero_bytes(uint32_t v) {
  constexpr uint32_t M = 0x7f7f7f7fu;
  return ~(((v & M) + M) | v) & 0x80808080u;
}

// The bit-7 flags of 4 byte columns: equal, t gap, q gap.
struct ByteMasks {
  uint32_t e, tg, qg;
};

__device__ __forceinline__ ByteMasks byte_masks(uint32_t t, uint32_t q) {
  constexpr uint32_t GAP4 = 0x2d2d2d2du;  // '-' in every byte
  return {zero_bytes(t ^ q), zero_bytes(t ^ GAP4), zero_bytes(q ^ GAP4)};
}

// The run key of each byte (see above), three bit-7 words.
template <bool CALLER>
__device__ __forceinline__ ByteMasks run_key(const ByteMasks& m) {
  if (CALLER) return m;
  return {m.e, m.tg ^ m.qg, m.qg & ~m.tg};
}

// Bit 7 of each byte whose key differs from the byte before's; p: the key
// of the word before (its top byte is the column before this word).
__device__ __forceinline__ uint32_t key_starts(const ByteMasks& k,
                                               const ByteMasks& p) {
  return (k.e ^ __funnelshift_l(p.e, k.e, 8)) |
         (k.tg ^ __funnelshift_l(p.tg, k.tg, 8)) |
         (k.qg ^ __funnelshift_l(p.qg, k.qg, 8));
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

// Geometry of segment k of row `row` and the lane's loads.  The row's
// length is read when the row differs from *len_row (cached in *n_row).
__device__ __forceinline__ void byte_seg_load(
    const uint8_t* t, const uint8_t* q, long long L,
    const int* __restrict__ lengths, int row, long long k, int* len_row,
    long long* n_row, ByteSeg& g) {
  const int lane = threadIdx.x & 31;
  g.row = row;
  if (g.row != *len_row) {
    const long long v = __ldg(lengths + g.row);
    *len_row = g.row;
    *n_row = v < 0 ? 0 : (v > L ? L : v);
  }
  const long long n = *n_row;
  g.tp = t + static_cast<long long>(g.row) * L;
  g.qp = q + static_cast<long long>(g.row) * L;
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

__device__ __forceinline__ ByteMasks shfl_up_masks(const ByteMasks& m) {
  return {__shfl_up_sync(0xffffffffu, m.e, 1),
          __shfl_up_sync(0xffffffffu, m.tg, 1),
          __shfl_up_sync(0xffffffffu, m.qg, 1)};
}

__device__ __forceinline__ ByteMasks shfl_masks(const ByteMasks& m, int src) {
  return {__shfl_sync(0xffffffffu, m.e, src),
          __shfl_sync(0xffffffffu, m.tg, src),
          __shfl_sync(0xffffffffu, m.qg, src)};
}

// Counters of a loaded segment, added to c.  Every lane of the warp.
template <bool CALLER>
__device__ __forceinline__ void byte_seg_count(const ByteSeg& g,
                                               uint32_t (&c)[7]) {
  const int lane = threadIdx.x & 31;
  if (g.h > 0) byte_count_scalar<CALLER>(g, g.c0, g.c0 + g.h, c);
  if (g.cend > g.tail0) byte_count_scalar<CALLER>(g, g.tail0, g.cend, c);
  if (g.nv == 0) return;  // uniform over the warp
  uint32_t me = 0, mt = 0, mq = 0, mr = 0;
  // the key of the column before the lane's uint4 (lane 0 of batch 0)
  ByteMasks carry = run_key<CALLER>(byte_masks(g.bt, g.bq));
#pragma unroll
  for (int k = 0; k < BS_VEC; ++k) {
    const uint32_t tw[4] = {g.t[k].x, g.t[k].y, g.t[k].z, g.t[k].w};
    const uint32_t qw[4] = {g.q[k].x, g.q[k].y, g.q[k].z, g.q[k].w};
    ByteMasks m[4], key[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m[j] = byte_masks(tw[j], qw[j]);
      key[j] = run_key<CALLER>(m[j]);
    }
    ByteMasks prev = shfl_up_masks(key[3]);
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
        me |= m[j].e >> sh;
        mt |= m[j].tg >> sh;
        mq |= m[j].qg >> sh;
        mr |= rs >> sh;
      }
    }
  }
  const uint32_t ng = __popc(mt & mq);  // gap/gap
  c[0] += __popc(me);
  c[1] += __popc(mt) - ng;
  c[2] += __popc(mq) - ng;
  c[3] += ng;
  c[4] += __popc(mr);
  c[5] += __popc(mr & mt & ~mq);
  c[6] += __popc(mr & mq & ~mt);
}

// The counters a warp's range ends with: its last row and the warp's sums
// of count_word's counters over `valid` columns of it (valid 0: none).
struct WarpTail {
  int row;
  uint32_t valid;
  uint32_t s[7];
};

// Segments [s0, s1) of the (row, segment) order of a byte plane, by one
// warp: the rows it leaves are added into out, the last one is returned.
// The next segment's loads are issued before the current one is counted.
template <bool CALLER>
__device__ __forceinline__ WarpTail byte_stream_warp(
    const uint8_t* t, const uint8_t* q, long long L,
    const int* __restrict__ lengths, int* __restrict__ out, unsigned nseg,
    unsigned s0, unsigned s1) {
  uint32_t c[7] = {0, 0, 0, 0, 0, 0, 0};
  WarpTail tail{-1, 0, {0, 0, 0, 0, 0, 0, 0}};
  if (s0 >= s1) return tail;  // uniform over the warp
  uint32_t valid = 0;  // uniform over the warp
  int row = -1, len_row = -1;
  long long n_row = 0;
  // the next segment to load, as (row, segment of the row)
  int next_row = static_cast<int>(s0 / nseg);
  long long next_k = s0 - static_cast<unsigned>(next_row) * nseg;
  const auto advance = [&]() {
    if (++next_k == nseg) {
      next_k = 0;
      ++next_row;
    }
  };
  ByteSeg cur, nxt;
  byte_seg_load(t, q, L, lengths, next_row, next_k, &len_row, &n_row, cur);
  advance();
  for (unsigned s = s0; s < s1; ++s) {
    if (s + 1 < s1) {
      byte_seg_load(t, q, L, lengths, next_row, next_k, &len_row, &n_row,
                    nxt);
      advance();
    }
    if (cur.row != row) {
      if (valid) warp_flush<CALLER>(c, valid, out + row * N_STATS);
      valid = 0;
      row = cur.row;
    }
    if (cur.cend > cur.c0) {
      valid += static_cast<uint32_t>(cur.cend - cur.c0);
      byte_seg_count<CALLER>(cur, c);
    }
    cur = nxt;
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

}  // namespace wga
