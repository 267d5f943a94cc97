// Kernel 8: fused column statistics + full per-op offset scan.
//
// Replaces wgatools_tpu/ops/fused.py::classify_liftover_fused (Pallas
// bodies _fused_kernel and _fused_kernel_packed).  Plane: byte words,
// int32 [B, LW], 4 columns per word (the TPU kernel read only those,
// _kernel_words).  Op table, either form, [B2, NO] (B2 may differ from B):
//   uint8 ops + int32 lens;
//   int32 packed words (op byte << 24) | len (liftover.pack_ops_words):
//     op = w >> 24 (logical), len = w & 0xFFFF, bits 16-23 ignored.
// Outputs: the int32 [B, 8] counters of kernel D's word entry and the
// exclusive int32 [B2, NO] target and query offsets in liftover mode (the
// advance rules of kernel B, op_advance.cuh).  The sums are uint32_t adds,
// exact as int32 for any length: the TPU's len < 2^16 bound (its bf16-limb
// "mm" scan) is gone, as in kernel B.
//
// Memory-bound: 2 B per column of plane plus 4-5 B in and 8 B out per op
// against 3.35 TB/s.  The same launch as kernels C and F (fused.cuh): B2
// op-row scan blocks, then the column chunks; only the op-row decode
// differs.

#include <cstdint>

#include <cuda_runtime.h>

#include "fused.cuh"

// lens null: ops are packed int32 words; otherwise ops are uint8 and lens
// int32.  stats must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_fused_ops(const void* tw, const void* qw,
                             const void* lengths, const void* ops,
                             const void* lens, void* stats, void* t_off,
                             void* q_off, int B, long long LW, int B2,
                             long long NO, int caller, void* stream) {
  const wga::BytePlane p{static_cast<const uint8_t*>(tw),
                         static_cast<const uint8_t*>(qw), 4 * LW};
  const wga::OpTable a{static_cast<const int*>(ops),
                       static_cast<const int*>(lens),
                       static_cast<int*>(t_off),
                       nullptr,
                       static_cast<int*>(q_off),
                       nullptr,
                       NO};
  if (lens == nullptr) {
    return launch_fused(p, 4 * LW, lengths, stats, B, wga::PackedOps{a}, B2,
                        caller, stream);
  }
  return launch_fused(p, 4 * LW, lengths, stats, B,
                      wga::OpsLens{a, static_cast<const uint8_t*>(ops)}, B2,
                      caller, stream);
}
