// Exclusive int32 scan of two streams along one row, by one thread block:
// the device code shared by kernel B (liftover_scan.cu) and the op-row
// blocks of the fused kernels C and F (fused.cuh).
//
// The block walks the row in tiles of blockDim.x elements and carries the
// running totals in registers (the TPU kernels carried them in a scratch
// across the sequential column grid).  Within a tile: an inclusive
// warp-shuffle scan per warp, then the warp totals through shared memory.
// Sums are uint32_t, so they wrap modulo 2^32 exactly like the int32 adds
// of torch.cumsum(..., dtype=torch.int32); callers keep row totals below
// 2^31.  Left for later: several elements per thread, a decoupled
// look-back across blocks for rows that are long and few.
#pragma once

#include <cstdint>

namespace wga {

// The two advances of one element, and whatever else its store needs.
struct Adv2 {
  uint32_t t = 0, q = 0;
};

// ops.load(i) gives element i's advances as an Elem (Adv2 or a struct
// with the same t and q members); ops.store(i, elem, ex_t, ex_q) receives
// the sums of the advances before it.  blockDim.x must be a multiple of 32
// and every thread of the block must call this.
template <class Ops>
__device__ __forceinline__ void block_exclusive_scan2(const Ops& ops,
                                                      long long n) {
  __shared__ uint32_t warp_t[32], warp_q[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t carry_t = 0, carry_q = 0;
  for (long long base = 0; base < n; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    typename Ops::Elem e{};
    if (i < n) e = ops.load(i);
    uint32_t st = e.t, sq = e.q;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t yt = __shfl_up_sync(0xffffffffu, st, d);
      const uint32_t yq = __shfl_up_sync(0xffffffffu, sq, d);
      if (lane >= d) {
        st += yt;
        sq += yq;
      }
    }
    if (lane == 31) {
      warp_t[warp] = st;
      warp_q[warp] = sq;
    }
    __syncthreads();
    uint32_t pre_t = 0, pre_q = 0, tot_t = 0, tot_q = 0;
    for (int w = 0; w < nwarps; ++w) {
      const uint32_t a = warp_t[w], b = warp_q[w];
      if (w < warp) {
        pre_t += a;
        pre_q += b;
      }
      tot_t += a;
      tot_q += b;
    }
    if (i < n) {
      ops.store(i, e, carry_t + pre_t + st - e.t, carry_q + pre_q + sq - e.q);
    }
    carry_t += tot_t;
    carry_q += tot_q;
    __syncthreads();  // warp totals are rewritten by the next tile
  }
}

}  // namespace wga
