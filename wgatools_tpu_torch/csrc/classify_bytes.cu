// Kernel D: byte-plane classify statistics, and its word-plane entry.
//
// Replaces wgatools_tpu/ops/classify.py::classify_stat_pallas (Pallas body
// _kernel) through wga_classify_bytes, and classify_stat_pallas_words
// (Pallas body _kernel_words) through wga_classify_words.  uint8 t, q
// [B, L] + int32 [B] lengths in columns -> int32 [B, 8] counters
// (matched, mismatched, ins_size, del_size, ins_events, del_events,
// gap/gap, runs), in ext mode (gap/gap is '=' and merges into '=' runs) or
// caller mode (gap/gap is its own W run).  Columns >= min(lengths[b], L)
// are masked here, so the result equals classify_stat_jnp whatever the
// padding bytes hold; the TPU kernels' '-'/'-' padding contract, their
// _finish_stats corrections and their edge side output do not exist.
//
// The word plane: int32 [B, LW] little-endian words of the byte planes
// (4 columns per word).  On the card that is the same buffer as the uint8
// [B, 4 LW] byte plane; the TPU kernel existed only because an on-device
// bitcast lowered badly there (classify.py:398-402).  So the word entry
// runs this same device code with L = 4 LW.
//
// Bound: memory.  Two bytes are read per column (t and q): a [1, 12.5M]
// row is 25 MB, 7.46 us at 3.35 TB/s.
//
// Design: cat_stream.cuh's byte-plane loop.  About (SMs x resident
// blocks) persistent blocks whose warps stream contiguous ranges of (row,
// 1024-column segment) pairs with 16-byte loads of both planes, one
// segment in flight behind the one being counted, and count 32 columns
// per __popc from per-byte flags (__vcmpeq4); row heads before a 16-byte
// boundary, tails, and rows whose t and q bases differ mod 16 go through
// load8 and count_word.  Row b starts at byte b * L (64-bit), so for
// L % 16 != 0 every row has its own head.

#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stream.cuh"

namespace {

template <bool CALLER>
__global__ void __launch_bounds__(wga::CS_THREADS, wga::BS_MIN_BLOCKS)
    byte_stats_kernel(const uint8_t* __restrict__ t,
                      const uint8_t* __restrict__ q, long long L,
                      const int* __restrict__ lengths, int* __restrict__ out,
                      unsigned nseg, unsigned long long segs) {
  constexpr int WARPS = wga::CS_THREADS / 32;
  unsigned s0, s1;
  wga::warp_range(static_cast<unsigned long long>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5),
                  static_cast<unsigned long long>(gridDim.x) * WARPS, segs,
                  &s0, &s1);
  wga::block_flush<CALLER>(
      wga::byte_stream_warp<CALLER>(t, q, L, lengths, out, nseg, s0, s1), out);
}

}  // namespace

// out must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_classify_bytes(const void* t, const void* q,
                                  const void* lengths, void* out, int B,
                                  long long L, int caller, void* stream) {
  if (B <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned long long nseg = (L + wga::BS_SEG - 1) / wga::BS_SEG;
  const unsigned long long segs = static_cast<unsigned long long>(B) * nseg;
  if (segs >= (1ull << 32)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  int resident = 0;
  const cudaError_t err =
      caller ? wga::resident_blocks(byte_stats_kernel<true>, &resident)
             : wga::resident_blocks(byte_stats_kernel<false>, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long need = (segs + 7) / 8;
  const dim3 grid(static_cast<unsigned>(
      need < static_cast<unsigned long long>(resident) ? need : resident));
  const auto* tp = static_cast<const uint8_t*>(t);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* n = static_cast<const int*>(lengths);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const auto ns = static_cast<unsigned>(nseg);
  if (caller) {
    byte_stats_kernel<true><<<grid, wga::CS_THREADS, 0, s>>>(tp, qp, L, n, o,
                                                             ns, segs);
  } else {
    byte_stats_kernel<false><<<grid, wga::CS_THREADS, 0, s>>>(tp, qp, L, n,
                                                              o, ns, segs);
  }
  return static_cast<int>(cudaGetLastError());
}

// tw, qw: int32 [B, LW] byte words.  out must be zeroed by the caller.
extern "C" int wga_classify_words(const void* tw, const void* qw,
                                  const void* lengths, void* out, int B,
                                  long long LW, int caller, void* stream) {
  return wga_classify_bytes(tw, qw, lengths, out, B, 4 * LW, caller, stream);
}
