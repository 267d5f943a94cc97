// Kernel A: category-plane classify statistics.
//
// Replaces wgatools_tpu/ops/classify.py::classify_stat_pallas_cat (Pallas
// body _kernel_cat).  int32 [B, LW] category plane + int32 [B] lengths in
// columns -> int32 [B, 8] counters, in ext mode (gap/gap merges into '='
// runs) or caller mode (gap/gap is its own W run).
//
// Memory-bound: about 0.5 B read per column against 3.35 TB/s of HBM.  A
// block handles one CAT_CHUNK_GROUPS chunk of one row (cat_stats.cuh,
// CatPlane).  Left for later: TMA loads and persistent blocks.

#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stats.cuh"

// out must be zeroed by the caller.  Returns cudaGetLastError().
extern "C" int wga_classify_cat(const void* cw, const void* lengths,
                                void* out, int B, long long LW, int caller,
                                void* stream) {
  const wga::CatPlane p{static_cast<const uint32_t*>(cw), LW};
  return launch_plane_stats(p, 8 * LW, lengths, out, B, caller, stream);
}

extern "C" const char* wga_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
