// Column statistics over a plane of aligned column pairs: the counting
// words shared by the column loops of cat_stream.cuh (kernels A, D and its
// word entry, E, and the fused kernels C, F and 8 of fused.cuh).
//
// Replaces the bodies of wgatools_tpu/ops/classify.py::_kernel_cat,
// _kernel (byte planes), _kernel_words and _kernel_nibbles.  A plane's
// columns, 8 at a time, are the word of one-hot category nibbles the host
// 64K (t, q) LUT gives (X=0 EQ=1 I=2 D=4 GG=9; column j of the group in
// bits [4j, 4j+4)).  Output is int32 [B, 8] per-record counters (matched,
// mismatched, ins_size, del_size, ins_events, del_events, gap/gap, runs).
// The loops count whole 16-byte loads bit-sliced (cat_stream.cuh); the
// ragged words of a row (its head before a 16-byte boundary, its tail, its
// partial last word, rows whose t and q bases differ mod 16) are built
// here (byte_cats, cat_nibbles) and counted one word at a time by
// count_word, reading the column before from memory.  Columns >=
// lengths[b] are masked (valid_nibbles), so none of the TPU kernels'
// gap-padding corrections (_finish_stats, the edge side output, 16-bit
// counter fields, rows rounded up to 8) exist.  Counters are added with
// integer atomics into a zeroed [B, 8] buffer (atomic_add_stats): exact in
// any order, so every counter is linear per range of columns (mismatched =
// valid - (EQ|GG) - I - D, caller-mode matched = bit0 - GG).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace wga {

constexpr int N_STATS = 8;

constexpr uint32_t M1 = 0x11111111u;  // bit 0 of every nibble
constexpr uint32_t M7 = 0x77777777u;  // bits 0-2 of every nibble
constexpr uint32_t HI = 0x88888888u;  // bit 3 of every nibble

// Bit 0 of each nibble set where that column's category differs from the
// column before it.  prev_top is the category of the column before the
// word.  Ext mode masks bit 3 of the diff so that GG (9) merges into EQ (1)
// runs, as cigar_cat_ext does; caller mode diffs full nibbles, so GG is its
// own W run.  Words are uint32_t: a word whose top nibble is GG or D is
// negative as int32, and the shifts must be logical.
template <bool CALLER>
__device__ __forceinline__ uint32_t run_starts(uint32_t w, uint32_t prev_top) {
  const uint32_t diff = w ^ ((w << 4) | prev_top);
  uint32_t nz;
  if (CALLER) {
    nz = (((diff & M7) + M7) | diff) & HI;
  } else {
    nz = ((diff & M7) + M7) & HI;  // 7 + 7 < 16: no carry between nibbles
  }
  return nz >> 3;
}

// Bit 0 of each nibble of a word whose first `rem` columns are valid.
__device__ __forceinline__ uint32_t valid_nibbles(long long rem) {
  return rem >= 8 ? M1 : (M1 & ((1u << (4 * static_cast<int>(rem))) - 1u));
}

// Adds the counters of one word of 8 category nibbles to c (eq|gg, ins,
// del, gg, run starts, ins starts, del starts).  prev_top is the category
// of the column before the word; row_start forces a run start at its first
// column (column 0 of a row); vm = valid_nibbles(columns left in the row).
template <bool CALLER>
__device__ __forceinline__ void count_word(uint32_t w, uint32_t prev_top,
                                           bool row_start, uint32_t vm,
                                           uint32_t (&c)[7]) {
  uint32_t rs = run_starts<CALLER>(w, prev_top);
  if (row_start) rs |= 1u;
  rs &= vm;
  const uint32_t b0 = w & vm;
  const uint32_t b1 = (w >> 1) & vm;
  const uint32_t b2 = (w >> 2) & vm;
  const uint32_t b3 = (w >> 3) & vm;
  c[0] += __popc(b0);
  c[1] += __popc(b1);
  c[2] += __popc(b2);
  c[3] += __popc(b3);
  c[4] += __popc(rs);
  c[5] += __popc(rs & b1);
  c[6] += __popc(rs & b2);
}

// Adds summed count_word counters s of `valid` columns into o = out[row]
// as the eight stats, with one atomic each.
template <bool CALLER>
__device__ __forceinline__ void atomic_add_stats(const uint32_t (&s)[7],
                                                 uint32_t valid, int* o) {
  atomicAdd(o + 0, static_cast<int>(CALLER ? s[0] - s[3] : s[0]));
  atomicAdd(o + 1, static_cast<int>(valid - s[0] - s[1] - s[2]));
  atomicAdd(o + 2, static_cast<int>(s[1]));
  atomicAdd(o + 3, static_cast<int>(s[2]));
  atomicAdd(o + 4, static_cast<int>(s[5]));
  atomicAdd(o + 5, static_cast<int>(s[6]));
  atomicAdd(o + 6, static_cast<int>(s[3]));
  atomicAdd(o + 7, static_cast<int>(s[4]));
}

// ---- the category words of ragged columns --------------------------------

// 0x01 in each byte where the bytes of a and b are equal.
__device__ __forceinline__ uint32_t eq_bytes(uint32_t a, uint32_t b) {
  return __vcmpeq4(a, b) & 0x01010101u;
}

// The host LUT's category code of each of 4 byte columns, one per byte.
__device__ __forceinline__ uint32_t cat_bytes(uint32_t t, uint32_t q) {
  constexpr uint32_t GAP4 = 0x2d2d2d2du;  // '-' in every byte
  const uint32_t e = eq_bytes(t, q);
  const uint32_t tg = eq_bytes(t, GAP4);
  const uint32_t qg = eq_bytes(q, GAP4);
  const uint32_t gg = tg & qg;
  // gap/gap has e set too: 1 | 8 = GG
  return e | ((tg ^ gg) << 1) | ((qg ^ gg) << 2) | (gg << 3);
}

// Four byte codes (each < 16) -> four nibbles in the low 16 bits.
__device__ __forceinline__ uint32_t bytes_to_nibbles(uint32_t c) {
  const uint32_t x = c | (c >> 4);
  return (x & 0xffu) | ((x >> 8) & 0xff00u);
}

// The 8 bytes at p, of any alignment, as two little-endian words.  Reads
// only the aligned words that hold bytes [p, p + n), 1 <= n <= 8; the bytes
// past n are unspecified.
__device__ __forceinline__ void load8(const uint8_t* p, int n, uint32_t& lo,
                                      uint32_t& hi) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const auto* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const int s = static_cast<int>(a & 3);
  const int last = (s + n - 1) >> 2;  // 0, 1 or 2
  const uint32_t w0 = __ldg(w);
  const uint32_t w1 = last >= 1 ? __ldg(w + 1) : 0u;
  const uint32_t w2 = last >= 2 ? __ldg(w + 2) : 0u;
  lo = __funnelshift_r(w0, w1, 8 * s);
  hi = __funnelshift_r(w1, w2, 8 * s);
}

// The LUT's code of each of 8 nibble-coded columns.  Gap is code 0, so a
// gap is a zero nibble, and code equality is byte equality.
__device__ __forceinline__ uint32_t cat_nibbles(uint32_t t, uint32_t q) {
  const auto zero = [](uint32_t x) {  // bit 0 of each nibble that is 0
    return ~((((x & M7) + M7) | x) >> 3) & M1;
  };
  const uint32_t e = zero(t ^ q);
  const uint32_t tg = zero(t);
  const uint32_t qg = zero(q);
  const uint32_t gg = tg & qg;
  return e | ((tg ^ gg) << 1) | ((qg ^ gg) << 2) | (gg << 3);
}

// The category word of the byte columns at t, q (any alignment), whose
// first nb (1..8) are valid; nibbles past nb are unspecified.
__device__ __forceinline__ uint32_t byte_cats(const uint8_t* t,
                                              const uint8_t* q, int nb) {
  uint32_t tlo, thi, qlo, qhi;
  load8(t, nb, tlo, thi);
  load8(q, nb, qlo, qhi);
  return bytes_to_nibbles(cat_bytes(tlo, qlo)) |
         (bytes_to_nibbles(cat_bytes(thi, qhi)) << 16);
}

// The category of the one byte column at t, q.
__device__ __forceinline__ uint32_t byte_cat(const uint8_t* t,
                                             const uint8_t* q) {
  return cat_bytes(__ldg(t), __ldg(q)) & 0xfu;
}

}  // namespace wga
