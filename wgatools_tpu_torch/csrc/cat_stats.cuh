// Column statistics over a plane of aligned column pairs: the device code
// shared by kernels A (classify_cat.cu), D and its word entry
// (classify_bytes.cu), E (classify_nibbles.cu) and the fused kernels C and
// F (fused.cuh).
//
// Replaces the bodies of wgatools_tpu/ops/classify.py::_kernel_cat,
// _kernel (byte planes), _kernel_words and _kernel_nibbles.  Every plane is
// turned, 8 columns at a time, into the word of one-hot category nibbles the
// host 64K (t, q) LUT gives (X=0 EQ=1 I=2 D=4 GG=9; column j of the group in
// bits [4j, 4j+4)), and counted by count_word.  Output is int32 [B, 8]
// per-record counters (matched, mismatched, ins_size, del_size, ins_events,
// del_events, gap/gap, runs).  The planes:
//   CatPlane     int32 [B, LW] category words, read as they are (kernel A);
//   BytePlane    uint8 t, q [B, L] of any width and base alignment (kernel
//                D); an int32 [B, LW] byte-word plane is the same buffer
//                with L = 4 LW;
//   NibblePlane  int32 t, q [B, LW] 4-bit dictionary codes, gap = 0, code
//                equality = byte equality (kernel E).
//
// Bound: memory.  0.5 B per column (cat), 1 B (nibbles) or 2 B (bytes)
// against a few integer ops and seven __popc per 8 columns: 128 x 2^20
// columns of cat plane is 64 MiB, about 20 us at 3.35 TB/s.
//
// Design: a block owns CAT_CHUNK_GROUPS groups of 8 columns of one row,
// each thread a strided subset of them (neighbouring threads on neighbouring
// groups).  Columns >= lengths[b] are masked here, so none of the TPU
// kernels' gap-padding corrections (_finish_stats, the edge side output,
// 16-bit counter fields, rows rounded up to 8) exist.  A group's run
// boundary reads the column before it from memory (L1), never a value
// carried between threads or blocks.  Each block reduces its counters and
// adds them with integer atomics into a zeroed [B, 8] buffer: exact in any
// order, so every counter is linear per chunk (mismatched = valid - (EQ|GG)
// - I - D, caller-mode matched = bit0 - GG).
// Left for later: TMA bulk loads, persistent blocks, wider vector loads.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace wga {

constexpr int N_STATS = 8;
constexpr int CAT_THREADS = 256;
constexpr long long CAT_CHUNK_GROUPS = 2048;  // 16K columns per block

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

// ---- planes ---------------------------------------------------------------
// cats(row, g, n): the category word of columns [8g, 8g + 8) of the row,
// whose first n columns are valid (8g < n); nibbles past n are unspecified.
// prev(row, g): the category of column 8g - 1 (g >= 1).  cols: columns per
// row.

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

struct CatPlane {
  const uint32_t* cw;
  long long LW;  // words per row
  __device__ __forceinline__ long long cols() const { return 8 * LW; }
  __device__ __forceinline__ uint32_t cats(long long row, long long g,
                                           long long) const {
    return __ldg(cw + row * LW + g);
  }
  __device__ __forceinline__ uint32_t prev(long long row, long long g) const {
    return __ldg(cw + row * LW + g - 1) >> 28;
  }
};

struct BytePlane {
  const uint8_t* t;
  const uint8_t* q;
  long long L;  // bytes per row; row b starts at byte b * L
  __device__ __forceinline__ long long cols() const { return L; }
  __device__ __forceinline__ uint32_t cats(long long row, long long g,
                                           long long n) const {
    const long long col = 8 * g;
    const int nb = n - col >= 8 ? 8 : static_cast<int>(n - col);
    uint32_t tlo, thi, qlo, qhi;
    load8(t + row * L + col, nb, tlo, thi);
    load8(q + row * L + col, nb, qlo, qhi);
    return bytes_to_nibbles(cat_bytes(tlo, qlo)) |
           (bytes_to_nibbles(cat_bytes(thi, qhi)) << 16);
  }
  __device__ __forceinline__ uint32_t prev(long long row, long long g) const {
    const long long i = row * L + 8 * g - 1;
    return cat_bytes(__ldg(t + i), __ldg(q + i)) & 0xfu;
  }
};

struct NibblePlane {
  const uint32_t* t;
  const uint32_t* q;
  long long LW;  // words per row
  __device__ __forceinline__ long long cols() const { return 8 * LW; }
  __device__ __forceinline__ uint32_t cats(long long row, long long g,
                                           long long) const {
    const long long i = row * LW + g;
    return cat_nibbles(__ldg(t + i), __ldg(q + i));
  }
  __device__ __forceinline__ uint32_t prev(long long row, long long g) const {
    const long long i = row * LW + g - 1;
    return cat_nibbles(__ldg(t + i) >> 28, __ldg(q + i) >> 28) & 0xfu;
  }
};

// Blocks per row for a plane of `cols` columns.
inline long long stat_chunks(long long cols) {
  const long long groups = (cols + 7) / 8;
  return (groups + CAT_CHUNK_GROUPS - 1) / CAT_CHUNK_GROUPS;
}

// Counters of groups [chunk * CAT_CHUNK_GROUPS, ...) of one row, added into
// out[row, :].  Must be called by every thread of the block.
template <bool CALLER, class Plane>
__device__ __forceinline__ void plane_stats_chunk(
    const Plane& p, const int* __restrict__ lengths, int* __restrict__ out,
    long long row, long long chunk) {
  long long n = lengths[row];
  const long long cols = p.cols();
  n = n < 0 ? 0 : (n > cols ? cols : n);
  const long long ng = (n + 7) >> 3;
  const long long g0 = chunk * CAT_CHUNK_GROUPS;
  if (g0 >= ng) return;  // uniform over the block
  const long long g1 = g0 + CAT_CHUNK_GROUPS < ng ? g0 + CAT_CHUNK_GROUPS : ng;

  uint32_t c[7] = {0, 0, 0, 0, 0, 0, 0};
  for (long long g = g0 + threadIdx.x; g < g1; g += blockDim.x) {
    // n - 8g >= 1 because g < ng
    const uint32_t w = p.cats(row, g, n);
    const uint32_t prev = g ? p.prev(row, g) : 0u;
    count_word<CALLER>(w, prev, g == 0, valid_nibbles(n - 8 * g), c);
  }
  const long long hi = 8 * g1 < n ? 8 * g1 : n;
  add_chunk_counters<CALLER>(c, static_cast<uint32_t>(hi - 8 * g0),
                             out + row * N_STATS);
}

}  // namespace wga

namespace {

// One block per (row, chunk), flattened into x, so that a batch of many
// short records is not held to gridDim.y's 65535.
template <bool CALLER, class Plane>
__global__ void __launch_bounds__(wga::CAT_THREADS)
    plane_stats_kernel(Plane p, const int* __restrict__ lengths,
                       int* __restrict__ out, long long nchunks) {
  const long long b = blockIdx.x;
  wga::plane_stats_chunk<CALLER>(p, lengths, out, b / nchunks, b % nchunks);
}

// Launches the counters of B rows of plane p into the zeroed int32 [B, 8]
// out.  Returns cudaGetLastError().
template <class Plane>
int launch_plane_stats(const Plane& p, long long cols, const void* lengths,
                       void* out, int B, int caller, void* stream) {
  if (B <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  const long long nchunks = wga::stat_chunks(cols);
  const long long blocks = static_cast<long long>(B) * nchunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* n = static_cast<const int*>(lengths);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (caller) {
    plane_stats_kernel<true, Plane>
        <<<grid, wga::CAT_THREADS, 0, s>>>(p, n, o, nchunks);
  } else {
    plane_stats_kernel<false, Plane>
        <<<grid, wga::CAT_THREADS, 0, s>>>(p, n, o, nchunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
