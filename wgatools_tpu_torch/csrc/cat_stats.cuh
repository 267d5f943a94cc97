// Category-plane column statistics: the device code shared by kernel A
// (classify_cat.cu) and kernel C (fused_adv16.cu); kernel D
// (classify_bytes.cu) builds the same nibble words from byte planes and
// counts them with count_word and add_chunk_counters.
//
// Replaces the body of wgatools_tpu/ops/classify.py::_kernel_cat (the
// Pallas kernel classify_stat_pallas_cat).  Input is ONE int32 [B, LW]
// category plane: column j of a row is the nibble in bits [4(j%8), 4(j%8)+4)
// of word j/8, a one-hot code from the host 64K (t, q) LUT: X=0 EQ=1 I=2
// D=4 GG=9.  Output is int32 [B, 8] per-record counters (matched,
// mismatched, ins_size, del_size, ins_events, del_events, gap/gap, runs).
//
// Bound: memory.  The plane is 0.5 B per column and every word is read once
// (its left neighbour a second time, from L1), against a few integer ops
// and seven __popc per 8 columns: 128 x 2^20 columns is 64 MiB, about 20 us
// at 3.35 TB/s.
//
// Design: a block owns CAT_CHUNK_WORDS words of one row, each thread a
// strided subset of them (neighbouring threads on neighbouring words).
// Columns >= lengths[b] are masked here, so none of the TPU kernel's
// gap-padding corrections (_finish_stats, the edge side output, 16-bit
// counter fields, rows rounded up to 8) exist.  Each block reduces its
// counters and adds them with integer atomics into a zeroed [B, 8] buffer:
// exact in any order, so every counter is linear per chunk (mismatched =
// valid - (EQ|GG) - I - D, caller-mode matched = bit0 - GG).
// Left for later: TMA bulk loads, persistent blocks, wider vector loads.
#pragma once

#include <cstdint>

namespace wga {

constexpr int N_STATS = 8;
constexpr int CAT_THREADS = 256;
constexpr long long CAT_CHUNK_WORDS = 2048;  // 16K columns per block

constexpr uint32_t M1 = 0x11111111u;  // bit 0 of every nibble
constexpr uint32_t M7 = 0x77777777u;  // bits 0-2 of every nibble
constexpr uint32_t HI = 0x88888888u;  // bit 3 of every nibble

// Bit 0 of each nibble set where that column's category differs from the
// column before it.  prev_top is the previous word's top nibble (column
// 8k-1).  Ext mode masks bit 3 of the diff so that GG (9) merges into EQ
// (1) runs, as cigar_cat_ext does; caller mode diffs full nibbles, so GG
// is its own W run.  Words are uint32_t: a word whose top nibble is GG or D
// is negative as int32, and the shifts must be logical.
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

// Reduces the block's count_word counters and adds them into o = out[row]
// as the eight stats; `valid` is the number of valid columns the block
// covered.  Must be called by every thread of the block.
template <bool CALLER>
__device__ __forceinline__ void add_chunk_counters(const uint32_t (&c)[7],
                                                   uint32_t valid, int* o) {
  __shared__ uint32_t part[32][7];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    uint32_t v = c[j];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    if (lane == 0) part[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s[7] = {0, 0, 0, 0, 0, 0, 0};
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int w = 0; w < nwarps; ++w) {
#pragma unroll
      for (int j = 0; j < 7; ++j) s[j] += part[w][j];
    }
    atomicAdd(o + 0, static_cast<int>(CALLER ? s[0] - s[3] : s[0]));
    atomicAdd(o + 1, static_cast<int>(valid - s[0] - s[1] - s[2]));
    atomicAdd(o + 2, static_cast<int>(s[1]));
    atomicAdd(o + 3, static_cast<int>(s[2]));
    atomicAdd(o + 4, static_cast<int>(s[5]));
    atomicAdd(o + 5, static_cast<int>(s[6]));
    atomicAdd(o + 6, static_cast<int>(s[3]));
    atomicAdd(o + 7, static_cast<int>(s[4]));
  }
}

// Counters of words [chunk * CAT_CHUNK_WORDS, ...) of one row, added into
// out[row, :].  Must be called by every thread of the block.
template <bool CALLER>
__device__ __forceinline__ void cat_stats_chunk(
    const uint32_t* __restrict__ cw, const int* __restrict__ lengths,
    int* __restrict__ out, long long LW, long long row, long long chunk) {
  long long n = lengths[row];
  n = n < 0 ? 0 : (n > 8 * LW ? 8 * LW : n);
  const long long nw = (n + 7) >> 3;
  const long long k0 = chunk * CAT_CHUNK_WORDS;
  if (k0 >= nw) return;  // uniform over the block
  const long long k1 = k0 + CAT_CHUNK_WORDS < nw ? k0 + CAT_CHUNK_WORDS : nw;
  const uint32_t* r = cw + row * LW;

  uint32_t c[7] = {0, 0, 0, 0, 0, 0, 0};
  for (long long k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
    const uint32_t w = __ldg(r + k);
    const uint32_t prev = k ? __ldg(r + k - 1) : 0u;
    // n - 8k >= 1 because k < nw
    count_word<CALLER>(w, prev >> 28, k == 0, valid_nibbles(n - 8 * k), c);
  }
  const long long hi = 8 * k1 < n ? 8 * k1 : n;
  add_chunk_counters<CALLER>(c, static_cast<uint32_t>(hi - 8 * k0),
                             out + row * N_STATS);
}

}  // namespace wga
