// Kernel B: per-op exclusive offset scan.
//
// Replaces wgatools_tpu/ops/liftover.py::liftover_scan_pallas (Pallas body
// _liftover_kernel).  uint8 ops [B, N] (0 = padding) + int32 lens [B, N]
// -> int32 [B, N] x 2:
//   mode 0 (liftover): exclusive target / query offsets; the target
//     advances on every op but I, S and padding, the query on every op but
//     D and padding;
//   mode 1 (chain): exclusive cumulative I sizes and D sizes
//     (cigar_unit_chain, reference cigar.rs:460-490).
// The advance is decoded here from the op byte, as the TPU kernel did
// (op_advance.cuh, shared with kernel 8).
//
// Memory-bound: 5 B read and 8 B written per op (about 13 B/op) against
// 3.35 TB/s.  One block per row, a loop over tiles with a running carry
// (row_scan.cuh).  The TPU kernel needed every length below 2^16 for its
// bf16 limbs; this scan adds in uint32_t, identical to int32 sums for any
// length, so the bound is gone.  Left for later: several rows per block
// for short rows, a decoupled look-back for few long rows.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "op_advance.cuh"

namespace {

constexpr int SCAN_THREADS = 128;

template <bool CHAIN>
__global__ void __launch_bounds__(SCAN_THREADS) liftover_scan_kernel(
    const uint8_t* __restrict__ ops, const int* __restrict__ lens,
    int* __restrict__ t_off, int* __restrict__ q_off, long long N) {
  const long long row = blockIdx.x;
  const wga::OpsLensRow<CHAIN> adv{ops + row * N, lens + row * N,
                                   t_off + row * N, q_off + row * N};
  wga::block_exclusive_scan2(adv, N);
}

}  // namespace

// mode: 0 liftover, 1 chain.  Returns cudaGetLastError().
extern "C" int wga_liftover_scan(const void* ops, const void* lens,
                                 void* t_off, void* q_off, int B, long long N,
                                 int mode, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const auto* o = static_cast<const uint8_t*>(ops);
  const auto* l = static_cast<const int*>(lens);
  auto* t = static_cast<int*>(t_off);
  auto* q = static_cast<int*>(q_off);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B));
  if (mode == 1) {
    liftover_scan_kernel<true><<<grid, SCAN_THREADS, 0, s>>>(o, l, t, q, N);
  } else {
    liftover_scan_kernel<false><<<grid, SCAN_THREADS, 0, s>>>(o, l, t, q, N);
  }
  return static_cast<int>(cudaGetLastError());
}
