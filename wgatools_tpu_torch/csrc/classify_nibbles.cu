// Kernel E: nibble-plane classify statistics.
//
// Replaces wgatools_tpu/ops/classify.py::classify_stat_pallas_nibbles
// (Pallas body _kernel_nibbles).  int32 t, q [B, LW] 4-bit dictionary
// planes (ops.classify.pack_nibble_words: '-' = 0, ACGTNacgtn. = 1..11, 8
// columns per word, column j in bits [4(j%8), 4(j%8)+4) of word j/8) +
// int32 [B] lengths in columns -> int32 [B, 8] counters, ext or caller
// mode.  The dictionary is a bijection, so code equality is byte equality
// and a gap is a zero nibble.
//
// Memory-bound: 1 B read per column (half the byte planes) against
// 3.35 TB/s.  Design: cat_stats.cuh's NibblePlane; each thread turns a word
// pair into kernel A's one-hot category word with SWAR (nibble equality,
// zero tests) and counts it with count_word.  Columns >= lengths[b] are
// masked here, so the TPU kernel's 0/0 padding contract and its
// corrections do not exist.

#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stats.cuh"

// out must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_classify_nibbles(const void* tw, const void* qw,
                                    const void* lengths, void* out, int B,
                                    long long LW, int caller, void* stream) {
  const wga::NibblePlane p{static_cast<const uint32_t*>(tw),
                           static_cast<const uint32_t*>(qw), LW};
  return launch_plane_stats(p, 8 * LW, lengths, out, B, caller, stream);
}
