// Kernel C: fused column statistics + advance-packed op scan, every mode.
//
// Replaces wgatools_tpu/ops/fused.py::classify_liftover_fused_adv16
// (Pallas body _fused_kernel_adv16).  Planes: byte words, nibble words or
// one category plane (catmode).  Op words per direction, int32 [B2, NOH]:
//   raw_sums       group advance sums (liftover.pack_ops_sums) -> anchors;
//   adv16 pairs    (adv_even << 14) | pair_sum (liftover.pack_ops_adv16) ->
//                  even offsets, and odd ones too with emit_odd.
// Outputs: the int32 [B, 8] counters of kernels A/D/E and int32 [B2, NOH]
// per output stream.  Per-op offsets from anchors are expanded on the host
// (liftover.expand_group_prefix), as behind the TPU kernel.
//
// Memory-bound: 0.5-2 B per column of plane plus 8-16 B per op word pair
// against 3.35 TB/s.  ONE launch (fused.cuh): B2 op-row scan blocks, then
// the column chunks.  Left for later: TMA loads, persistent blocks, a
// decoupled look-back scan.

#include <cstdint>

#include <cuda_runtime.h>

#include "fused.cuh"

// plane: 0 byte words (tw, qw), 1 nibble words (tw, qw), 2 one category
// plane (tw; qw unused).  raw_sums: wt, wq are group sums and te, qe
// receive the anchors; otherwise they are adv16 pair words, te, qe receive
// the even offsets and, with emit_odd, to, qo the odd ones.  Unused output
// pointers may be null.  stats must be zeroed by the caller.  Returns
// cudaGetLastError().
extern "C" int wga_fused_adv16(int plane, const void* tw, const void* qw,
                               const void* lengths, const void* wt,
                               const void* wq, void* stats, void* te,
                               void* to, void* qe, void* qo, int B,
                               long long LW, int B2, long long NOH,
                               int caller, int raw_sums, int emit_odd,
                               void* stream) {
  const wga::OpTable a{static_cast<const int*>(wt),
                       static_cast<const int*>(wq),
                       static_cast<int*>(te),
                       static_cast<int*>(to),
                       static_cast<int*>(qe),
                       static_cast<int*>(qo),
                       NOH};
  if (raw_sums) {
    return launch_fused_plane(plane, tw, qw, LW, lengths, stats, B,
                              wga::GroupSums{a}, B2, caller, stream);
  }
  if (emit_odd) {
    return launch_fused_plane(plane, tw, qw, LW, lengths, stats, B,
                              wga::PairWords<true>{a}, B2, caller, stream);
  }
  return launch_fused_plane(plane, tw, qw, LW, lengths, stats, B,
                            wga::PairWords<false>{a}, B2, caller, stream);
}
