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
// Design: cat_stream.cuh's loop on the byte plane.  About (SMs x resident
// blocks) persistent blocks whose warps stream contiguous ranges of (row,
// 1024-column segment) pairs with 16-byte loads of both planes, one
// segment in flight behind the one being counted, and count 32 columns
// per __popc from zero-byte tests of each word; row heads before a 16-byte
// boundary, tails, and rows whose t and q bases differ mod 16 go through
// load8 and count_word.  Row b starts at byte b * L (64-bit), so for
// L % 16 != 0 every row has its own head.

#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stream.cuh"

// out must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_classify_bytes(const void* t, const void* q,
                                  const void* lengths, void* out, int B,
                                  long long L, int caller, void* stream) {
  const wga::ByteStream p{static_cast<const uint8_t*>(t),
                          static_cast<const uint8_t*>(q), L};
  return launch_stream_stats<wga::BS_MIN_BLOCKS>(p, B, lengths, out, caller,
                                                 stream);
}

// tw, qw: int32 [B, LW] byte words.  out must be zeroed by the caller.
extern "C" int wga_classify_words(const void* tw, const void* qw,
                                  const void* lengths, void* out, int B,
                                  long long LW, int caller, void* stream) {
  return wga_classify_bytes(tw, qw, lengths, out, B, 4 * LW, caller, stream);
}
