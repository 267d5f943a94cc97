// Kernel C: fused category-plane statistics + group-sum anchor scan.
//
// Replaces wgatools_tpu/ops/fused.py::classify_liftover_fused_adv16
// (Pallas body _fused_kernel_adv16) in the configuration bench.py times:
// catmode=True, scan_mode="once", raw_sums=True.  Inputs: the int32
// [B, LW] category plane with int32 [B] lengths, and int32 [B2, NG] raw
// group sums per direction (liftover.pack_ops_sums, group 8).  Outputs: the
// int32 [B, 8] counters of kernel A and int32 [B2, NG] exclusive
// group-prefix anchors per direction.  B2 may differ from B.  Per-op
// offsets are not expanded here: the host does that
// (liftover.expand_group_prefix), as it did behind the TPU kernel.
//
// Memory-bound: about 0.5 B per column for the plane plus 16 B per group
// of 8 ops (0.5 B/column at a mean run of 32) against 3.35 TB/s.  ONE
// launch: the first B2 blocks each scan one op row (row_scan.cuh); the
// rest run kernel A's column chunks (cat_stats.cuh).  The scan blocks come
// first so that they start while the column chunks stream.  Left for
// later: TMA loads, persistent blocks, a decoupled look-back scan.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stats.cuh"
#include "row_scan.cuh"

namespace {

struct GroupSums {
  const int* st;
  const int* sq;
  __device__ __forceinline__ void operator()(long long i, uint32_t& at,
                                             uint32_t& aq) const {
    at = static_cast<uint32_t>(st[i]);
    aq = static_cast<uint32_t>(sq[i]);
  }
};

template <bool CALLER>
__global__ void __launch_bounds__(wga::CAT_THREADS) fused_adv16_kernel(
    const uint32_t* __restrict__ cw, const int* __restrict__ lengths,
    const int* __restrict__ st, const int* __restrict__ sq,
    int* __restrict__ stats, int* __restrict__ t_anchor,
    int* __restrict__ q_anchor, long long LW, long long nchunks, long long B2,
    long long NG) {
  const long long b = blockIdx.x;
  if (b < B2) {
    const GroupSums sums{st + b * NG, sq + b * NG};
    wga::block_exclusive_scan2(sums, NG, t_anchor + b * NG, q_anchor + b * NG);
    return;
  }
  const long long c = b - B2;
  wga::cat_stats_chunk<CALLER>(cw, lengths, stats, LW, c / nchunks,
                               c % nchunks);
}

}  // namespace

// stats must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_fused_adv16(const void* cw, const void* lengths,
                               const void* st, const void* sq, void* stats,
                               void* t_anchor, void* q_anchor, int B,
                               long long LW, int B2, long long NG, int caller,
                               void* stream) {
  const long long nchunks =
      (B > 0 && LW > 0)
          ? (LW + wga::CAT_CHUNK_WORDS - 1) / wga::CAT_CHUNK_WORDS
          : 0;
  const long long scan_rows = (B2 > 0 && NG > 0) ? B2 : 0;
  const long long blocks = scan_rows + static_cast<long long>(B) * nchunks;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* w = static_cast<const uint32_t*>(cw);
  const auto* n = static_cast<const int*>(lengths);
  const auto* gt = static_cast<const int*>(st);
  const auto* gq = static_cast<const int*>(sq);
  auto* o = static_cast<int*>(stats);
  auto* ta = static_cast<int*>(t_anchor);
  auto* qa = static_cast<int*>(q_anchor);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (caller) {
    fused_adv16_kernel<true><<<grid, wga::CAT_THREADS, 0, s>>>(
        w, n, gt, gq, o, ta, qa, LW, nchunks, scan_rows, NG);
  } else {
    fused_adv16_kernel<false><<<grid, wga::CAT_THREADS, 0, s>>>(
        w, n, gt, gq, o, ta, qa, LW, nchunks, scan_rows, NG);
  }
  return static_cast<int>(cudaGetLastError());
}
