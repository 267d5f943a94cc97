// Kernel D: byte-plane classify statistics.
//
// Replaces wgatools_tpu/ops/classify.py::classify_stat_pallas (Pallas body
// _kernel).  uint8 t, q [B, L] + int32 [B] lengths in columns -> int32
// [B, 8] counters (matched, mismatched, ins_size, del_size, ins_events,
// del_events, gap/gap, runs), in ext mode (gap/gap is '=' and merges into
// '=' runs) or caller mode (gap/gap is its own W run).  Columns >=
// min(lengths[b], L) are masked here, so the result equals
// classify_stat_jnp whatever the padding bytes hold; the TPU kernel's
// '-'/'-' padding contract, its _finish_stats corrections and its edge side
// output do not exist.
//
// Bound: memory.  Two bytes are read per column (t and q) against about 40
// integer ops per 8 columns: a [1, 12.5M] row is 25 MB, ~7.5 us at
// 3.35 TB/s.
//
// Design: kernel A's 1-D grid over (row, chunk of BYTE_CHUNK_GROUPS groups
// of 8 columns), since a batch of short records can exceed gridDim.y.  Each
// thread turns 8 columns at a time into the word of category nibbles the
// host LUT would give (X=0 EQ=1 I=2 D=4 GG=9, from SWAR byte compares) and
// counts it with kernel A's count_word; blocks add per-chunk counters with
// integer atomics (cat_stats.cuh).  Row b starts at byte b * L (64-bit),
// which for L % 4 != 0 is not word-aligned, nor is the tensor's base
// pointer in general: a thread reads the two or three aligned words that
// cover its 8 bytes, never a word without one of its valid columns, and
// funnel-shifts them into place.  The column before a thread's first column
// is read as one byte pair for its run boundary, never carried between
// threads or blocks.  Left for later: 16-byte loads, TMA, persistent blocks.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stats.cuh"

namespace {

constexpr int BYTE_THREADS = 256;
constexpr long long BYTE_CHUNK_GROUPS = 2048;  // 16K columns per block

// 0x01 in each byte where the bytes of a and b are equal.
__device__ __forceinline__ uint32_t eq_bytes(uint32_t a, uint32_t b) {
  return __vcmpeq4(a, b) & 0x01010101u;
}

// The host LUT's category code of each of 4 columns, one per byte.
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

template <bool CALLER>
__global__ void __launch_bounds__(BYTE_THREADS) classify_bytes_kernel(
    const uint8_t* __restrict__ t, const uint8_t* __restrict__ q,
    const int* __restrict__ lengths, int* __restrict__ out, long long L,
    long long nchunks) {
  const long long row = static_cast<long long>(blockIdx.x) / nchunks;
  const long long chunk = static_cast<long long>(blockIdx.x) % nchunks;
  long long n = lengths[row];
  n = n < 0 ? 0 : (n > L ? L : n);
  const long long ng = (n + 7) >> 3;
  const long long g0 = chunk * BYTE_CHUNK_GROUPS;
  if (g0 >= ng) return;  // uniform over the block
  const long long g1 = g0 + BYTE_CHUNK_GROUPS < ng ? g0 + BYTE_CHUNK_GROUPS : ng;
  const uint8_t* tr = t + row * L;
  const uint8_t* qr = q + row * L;

  uint32_t c[7] = {0, 0, 0, 0, 0, 0, 0};
  for (long long g = g0 + threadIdx.x; g < g1; g += blockDim.x) {
    const long long col = 8 * g;
    const long long rem = n - col;  // >= 1 because g < ng
    const int nb = rem >= 8 ? 8 : static_cast<int>(rem);
    uint32_t tlo, thi, qlo, qhi;
    load8(tr + col, nb, tlo, thi);
    load8(qr + col, nb, qlo, qhi);
    const uint32_t w = bytes_to_nibbles(cat_bytes(tlo, qlo)) |
                       (bytes_to_nibbles(cat_bytes(thi, qhi)) << 16);
    const uint32_t prev =
        col ? cat_bytes(__ldg(tr + col - 1), __ldg(qr + col - 1)) & 0xfu : 0u;
    wga::count_word<CALLER>(w, prev, col == 0, wga::valid_nibbles(rem), c);
  }
  const long long hi = 8 * g1 < n ? 8 * g1 : n;
  wga::add_chunk_counters<CALLER>(c, static_cast<uint32_t>(hi - 8 * g0),
                                  out + row * wga::N_STATS);
}

}  // namespace

// out must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_classify_bytes(const void* t, const void* q,
                                  const void* lengths, void* out, int B,
                                  long long L, int caller, void* stream) {
  if (B <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  const long long nchunks =
      (L + 8 * BYTE_CHUNK_GROUPS - 1) / (8 * BYTE_CHUNK_GROUPS);
  const long long blocks = static_cast<long long>(B) * nchunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* tp = static_cast<const uint8_t*>(t);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* n = static_cast<const int*>(lengths);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (caller) {
    classify_bytes_kernel<true>
        <<<grid, BYTE_THREADS, 0, s>>>(tp, qp, n, o, L, nchunks);
  } else {
    classify_bytes_kernel<false>
        <<<grid, BYTE_THREADS, 0, s>>>(tp, qp, n, o, L, nchunks);
  }
  return static_cast<int>(cudaGetLastError());
}
