// Exclusive int32 scan of two streams along one row, by one thread block:
// the op-row blocks of the fused kernels C, F and 8 (fused.cuh).  Kernel B
// (liftover_scan.cu) builds its warp-per-row and tiled scans on the warp
// scan below.
//
// The block walks the row in passes of V x blockDim.x elements and carries
// the running totals in registers (the TPU kernels carried them in a
// scratch across the sequential column grid).  Sums are uint32_t, so they
// wrap modulo 2^32 exactly like the int32 adds of
// torch.cumsum(..., dtype=torch.int32).
#pragma once

#include <cstdint>

namespace wga {

// The two advances of one element, and whatever else its store needs.
struct Adv2 {
  uint32_t t = 0, q = 0;
};

// Inclusive scan of (t, q) over the lanes of a warp.  Every lane.
__device__ __forceinline__ void warp_inclusive_scan2(uint32_t& t,
                                                     uint32_t& q) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t yt = __shfl_up_sync(0xffffffffu, t, d);
    const uint32_t yq = __shfl_up_sync(0xffffffffu, q, d);
    if (lane >= d) {
      t += yt;
      q += yq;
    }
  }
}

// ops.load(i) gives element i's advances as an Elem (Adv2 or a struct
// with the same t and q members); ops.store(i, elem, ex_t, ex_q) receives
// the sums of the advances before it.  Each thread owns V consecutive
// elements of a pass of V x THREADS (blockDim.x == THREADS): loaded
// coalesced, turned through shared memory into runs, summed along each run,
// and one warp scan of the runs' totals a pass, so that a long row is not
// bound by a chain of shuffles and barriers per element.  Shared indices
// are padded by one word per 32 so that neither the coalesced nor the run
// order has bank conflicts.  Every thread of the block must call this.
template <int V, int THREADS, class Ops>
__device__ __forceinline__ void block_exclusive_scan2_runs(const Ops& ops,
                                                           long long n) {
  constexpr int TILE = V * THREADS;
  constexpr int WARPS = THREADS / 32;
  __shared__ uint32_t sh_t[TILE + TILE / 32], sh_q[TILE + TILE / 32];
  __shared__ uint32_t warp_t[WARPS], warp_q[WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const auto pad = [](int x) { return x + (x >> 5); };
  uint32_t carry_t = 0, carry_q = 0;
  for (long long base = 0; base < n; base += TILE) {
    typename Ops::Elem e[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + j * THREADS + tid;
      e[j] = i < n ? ops.load(i) : typename Ops::Elem{};
      sh_t[pad(j * THREADS + tid)] = e[j].t;
      sh_q[pad(j * THREADS + tid)] = e[j].q;
    }
    __syncthreads();
    // the thread's run, elements [V tid, V tid + V) of the pass
    uint32_t run_t[V], run_q[V], tot_t = 0, tot_q = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      run_t[j] = tot_t;
      run_q[j] = tot_q;
      tot_t += sh_t[pad(V * tid + j)];
      tot_q += sh_q[pad(V * tid + j)];
    }
    uint32_t inc_t = tot_t, inc_q = tot_q;
    warp_inclusive_scan2(inc_t, inc_q);
    if (lane == 31) {
      warp_t[warp] = inc_t;
      warp_q[warp] = inc_q;
    }
    __syncthreads();
    uint32_t pre_t = carry_t + inc_t - tot_t, pre_q = carry_q + inc_q - tot_q;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t a = warp_t[w], b = warp_q[w];
      if (w < warp) {
        pre_t += a;
        pre_q += b;
      }
      carry_t += a;
      carry_q += b;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sh_t[pad(V * tid + j)] = pre_t + run_t[j];
      sh_q[pad(V * tid + j)] = pre_q + run_q[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + j * THREADS + tid;
      if (i < n) {
        ops.store(i, e[j], sh_t[pad(j * THREADS + tid)],
                  sh_q[pad(j * THREADS + tid)]);
      }
    }
    __syncthreads();  // shared memory is rewritten by the next pass
  }
}

}  // namespace wga
