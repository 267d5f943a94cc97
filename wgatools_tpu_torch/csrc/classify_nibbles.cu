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
// 3.35 TB/s.  Design: cat_stream.cuh's loop on the nibble plane.  About
// (SMs x resident blocks) persistent blocks whose warps stream contiguous
// ranges of (row, 2048-column segment) pairs with 16-byte loads of both
// planes, one segment in flight behind the one being counted; per uint4
// pair three zero-nibble tests per word, merged so that one __popc counts
// 32 columns.  Row heads before a 16-byte boundary, tails, partial last
// words and rows whose t and q bases differ mod 16 go through cat_nibbles
// and count_word.  Columns >= lengths[b] are masked here, so the TPU
// kernel's 0/0 padding contract and its corrections do not exist.

#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stream.cuh"

// out must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_classify_nibbles(const void* tw, const void* qw,
                                    const void* lengths, void* out, int B,
                                    long long LW, int caller, void* stream) {
  const wga::NibbleStream p{static_cast<const uint32_t*>(tw),
                            static_cast<const uint32_t*>(qw), LW};
  return launch_stream_stats<wga::NS_MIN_BLOCKS>(p, B, lengths, out, caller,
                                                 stream);
}
