// Kernel F: fused column statistics + 16-bit packed op scan.
//
// Replaces wgatools_tpu/ops/fused.py::classify_liftover_fused16 (Pallas
// body _fused_kernel_packed16).  Planes: byte words or nibble words.  Op
// words: int32 [B2, NOH], two ops per word (liftover.pack_ops_words16:
// 13-bit length + 3-bit advance class per half), decoded here.  Outputs:
// the int32 [B, 8] counters and int32 [B2, NOH] even and odd offsets of
// both directions (op 2k at *_even[:, k], op 2k+1 at *_odd[:, k]).
//
// Memory-bound: 1-2 B per column of plane plus 4 B in and 16 B out per op
// pair against 3.35 TB/s.  The same launch as kernel C's byte-word and
// nibble modes (fused.cuh: launch_fused_stream): B2 op-row scan blocks,
// then persistent column blocks on cat_stream.cuh's loop of the plane (the
// loop of kernel D's word entry, or of kernel E); only the op-word decode
// differs.

#include <cstdint>

#include <cuda_runtime.h>

#include "fused.cuh"

// plane: 0 byte words, 1 nibble words.  stats: int32 [B, 8] zeroed by the
// caller; scratch: one int32 word, any contents.  Returns
// cudaGetLastError().
extern "C" int wga_fused16(int plane, const void* tw, const void* qw,
                           const void* lengths, const void* opw, void* stats,
                           void* scratch, void* te, void* to, void* qe,
                           void* qo, int B, long long LW, int B2,
                           long long NOH, int caller, void* stream) {
  if (plane == PLANE_CAT) return static_cast<int>(cudaErrorInvalidValue);
  const wga::OpTable a{static_cast<const int*>(opw), nullptr,
                       static_cast<int*>(te),       static_cast<int*>(to),
                       static_cast<int*>(qe),       static_cast<int*>(qo),
                       NOH};
  return launch_fused_plane(plane, tw, qw, LW, lengths, stats, scratch, B,
                            wga::Packed16{a}, B2, caller, stream);
}
