// Kernel A: category-plane classify statistics.
//
// Replaces wgatools_tpu/ops/classify.py::classify_stat_pallas_cat (Pallas
// body _kernel_cat).  int32 [B, LW] category plane + int32 [B] lengths in
// columns -> int32 [B, 8] counters, in ext mode (gap/gap merges into '='
// runs) or caller mode (gap/gap is its own W run).
//
// Memory-bound: about 0.5 B read per column against 3.35 TB/s of HBM.  The
// grid is (column chunks x rows) flattened into x, so that a batch of many
// short records is not held to gridDim.y's 65535; a block handles one
// CAT_CHUNK_WORDS chunk of one row (cat_stats.cuh).  Left for later: TMA
// loads and persistent blocks.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stats.cuh"

template <bool CALLER>
__global__ void __launch_bounds__(wga::CAT_THREADS) classify_cat_kernel(
    const uint32_t* __restrict__ cw, const int* __restrict__ lengths,
    int* __restrict__ out, long long LW, long long nchunks) {
  const long long b = blockIdx.x;
  wga::cat_stats_chunk<CALLER>(cw, lengths, out, LW, b / nchunks,
                               b % nchunks);
}

// out must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_classify_cat(const void* cw, const void* lengths,
                                void* out, int B, long long LW, int caller,
                                void* stream) {
  if (B <= 0 || LW <= 0) return static_cast<int>(cudaGetLastError());
  const long long nchunks =
      (LW + wga::CAT_CHUNK_WORDS - 1) / wga::CAT_CHUNK_WORDS;
  const long long blocks = static_cast<long long>(B) * nchunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* w = static_cast<const uint32_t*>(cw);
  const auto* n = static_cast<const int*>(lengths);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (caller) {
    classify_cat_kernel<true><<<grid, wga::CAT_THREADS, 0, s>>>(w, n, o, LW,
                                                                 nchunks);
  } else {
    classify_cat_kernel<false><<<grid, wga::CAT_THREADS, 0, s>>>(w, n, o, LW,
                                                                  nchunks);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wga_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
