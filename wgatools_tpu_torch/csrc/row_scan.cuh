// Exclusive int32 scan of two streams along one row, by one thread block:
// the op-row blocks of the fused kernels C, F and 8 (fused.cuh).  Kernel B
// (liftover_scan.cu) builds its warp-per-row and tiled scans on the warp
// scan below.
//
// The block walks the row in passes of E x blockDim.x elements and carries
// the running totals in registers (the TPU kernels carried them in a
// scratch across the sequential column grid).  Within a pass: an inclusive
// warp-shuffle scan per warp and element, then the warp totals through
// shared memory.  Sums are uint32_t, so they wrap modulo 2^32 exactly like
// the int32 adds of torch.cumsum(..., dtype=torch.int32).
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
// the sums of the advances before it.  E elements a thread per pass, all
// loaded before any is scanned, so that a pass waits for memory once and
// passes two barriers.  Element base + k blockDim.x + threadIdx.x is the
// thread's k-th of the pass.  blockDim.x must be a multiple of 32 and every
// thread of the block must call this.
template <int E, class Ops>
__device__ __forceinline__ void block_exclusive_scan2_batched(const Ops& ops,
                                                              long long n) {
  __shared__ uint32_t tile_t[E][32], tile_q[E][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t carry_t = 0, carry_q = 0;
  for (long long base = 0; base < n; base += E * static_cast<long long>(blockDim.x)) {
    typename Ops::Elem e[E];
    uint32_t st[E], sq[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const long long i = base + k * static_cast<long long>(blockDim.x) + threadIdx.x;
      e[k] = i < n ? ops.load(i) : typename Ops::Elem{};
    }
#pragma unroll
    for (int k = 0; k < E; ++k) {
      st[k] = e[k].t;
      sq[k] = e[k].q;
      warp_inclusive_scan2(st[k], sq[k]);
      if (lane == 31) {
        tile_t[k][warp] = st[k];
        tile_q[k][warp] = sq[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k) {
      uint32_t pre_t = 0, pre_q = 0, tot_t = 0, tot_q = 0;
      for (int w = 0; w < nwarps; ++w) {
        const uint32_t a = tile_t[k][w], b = tile_q[k][w];
        if (w < warp) {
          pre_t += a;
          pre_q += b;
        }
        tot_t += a;
        tot_q += b;
      }
      const long long i = base + k * static_cast<long long>(blockDim.x) + threadIdx.x;
      if (i < n) {
        ops.store(i, e[k], carry_t + pre_t + st[k] - e[k].t,
                  carry_q + pre_q + sq[k] - e[k].q);
      }
      carry_t += tot_t;
      carry_q += tot_q;
    }
    __syncthreads();  // the tile totals are rewritten by the next pass
  }
}

}  // namespace wga
