// The per-op advances of the op-table scans and the (uint8 ops, int32
// lens) op row: the one decoder of kernel B (liftover_scan.cu) and of
// kernel 8's op rows (fused.cuh, fused_ops.cu).
//
//   liftover mode: the target advances by the op's length on every op
//     byte but 0 (padding), I and S, bytes that are not CIGAR ops
//     included; the query on every op byte but 0 and D;
//   chain mode: the cumulative I sizes and D sizes (cigar_unit_chain,
//     reference cigar.rs:460-490).
// Lengths are taken as uint32_t, so sums wrap exactly as int32 adds do.
#pragma once

#include <cstdint>

#include "row_scan.cuh"

namespace wga {

template <bool CHAIN>
__device__ __forceinline__ Adv2 op_advance(uint32_t op, uint32_t len) {
  Adv2 e;
  if (CHAIN) {
    e.t = op == 'I' ? len : 0u;
    e.q = op == 'D' ? len : 0u;
  } else {
    e.t = (op == 0u || op == 'I' || op == 'S') ? 0u : len;
    e.q = (op == 0u || op == 'D') ? 0u : len;
  }
  return e;
}

// One row of uint8 ops + int32 lens, scanned into exclusive int32 t_off,
// q_off (block_exclusive_scan2's load/store).
template <bool CHAIN>
struct OpsLensRow {
  using Elem = Adv2;
  const uint8_t* ops;
  const int* lens;
  int* t_off;
  int* q_off;
  __device__ __forceinline__ Elem load(long long i) const {
    return op_advance<CHAIN>(ops[i], static_cast<uint32_t>(lens[i]));
  }
  __device__ __forceinline__ void store(long long i, const Elem&,
                                        uint32_t ex_t, uint32_t ex_q) const {
    t_off[i] = static_cast<int>(ex_t);
    q_off[i] = static_cast<int>(ex_q);
  }
};

}  // namespace wga
