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
// runs this same device code with L = 4 LW: word-aligned rows take load8's
// aligned case, and no special case is needed.
//
// Bound: memory.  Two bytes are read per column (t and q) against about 40
// integer ops per 8 columns: a [1, 12.5M] row is 25 MB, ~7.5 us at
// 3.35 TB/s.
//
// Design: cat_stats.cuh's BytePlane.  Each thread turns 8 columns at a time
// into the word of category nibbles the host LUT would give (SWAR byte
// compares) and counts it with kernel A's count_word; blocks add per-chunk
// counters with integer atomics.  Row b starts at byte b * L (64-bit),
// which for L % 4 != 0 is not word-aligned, nor is the tensor's base
// pointer in general: a thread reads the two or three aligned words that
// cover its 8 bytes, never a word without one of its valid columns, and
// funnel-shifts them into place.  Left for later: 16-byte loads, TMA,
// persistent blocks.

#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stats.cuh"

// out must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_classify_bytes(const void* t, const void* q,
                                  const void* lengths, void* out, int B,
                                  long long L, int caller, void* stream) {
  const wga::BytePlane p{static_cast<const uint8_t*>(t),
                         static_cast<const uint8_t*>(q), L};
  return launch_plane_stats(p, L, lengths, out, B, caller, stream);
}

// tw, qw: int32 [B, LW] byte words.  out must be zeroed by the caller.
extern "C" int wga_classify_words(const void* tw, const void* qw,
                                  const void* lengths, void* out, int B,
                                  long long LW, int caller, void* stream) {
  return wga_classify_bytes(tw, qw, lengths, out, B, 4 * LW, caller, stream);
}
