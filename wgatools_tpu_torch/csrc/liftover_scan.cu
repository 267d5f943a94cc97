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
// (op_advance.cuh, shared with kernel 8).  Sums are uint32_t, so every row
// wraps exactly as torch.cumsum(..., dtype=torch.int32) does, for any
// length (the TPU kernel's len < 2^16 limit of its bf16 limbs is gone).
//
// Bound: memory.  5 B read and 8 B written per op (13 B/op) against
// 3.35 TB/s: 8192 x 128 ops, or 4 x 2^18, is 13.6 MB, 4.07 us.
//
// Design.  The unit of work is a warp step: 32 lanes x SCAN_U groups of 4
// consecutive ops (256 ops); lane l's k-th group starts at op
// 4 (32 k + l) of the step, so the warp's loads are contiguous.  A lane
// loads a group's 4 op bytes as one 32-bit word and its 4 lengths as one
// int4, sums the group serially, and a warp shuffle scan adds the lanes;
// the offsets leave as two int4 stores.  No shared memory on the short
// path and no __syncthreads.
// - Short rows (N < LONG_N): one warp per row, SCAN_THREADS / 32 rows a
//   block; the warp walks its row in steps with a running carry, and
//   loads the next step before it scans the current one.
// - Long rows (N >= LONG_N = 4096): each row is cut into tiles of TILE
//   (2048) ops, one block (8 warps, one step each) a tile, in two launches:
//   the first writes each tile's two advance totals, the second sums the
//   totals of the tiles before its own (all threads of the block, strided,
//   then a block reduction) and scans its tile.  The second launch reads
//   the ops again; at the tools' batches (2^20 op slots, 5 MiB of input)
//   that read comes from the 50 MB L2.  A single-pass chained scan
//   (decoupled look-back) would need its tile flags zeroed before every
//   call, which is a launch too, and a spin-wait on other blocks.
//   At 4096 ops a row, one warp a row walks 16 serial steps; a few such
//   rows leave the card idle, while two tiles a row give twice as many
//   blocks as rows.
// - Alignment: ops [h, N) of a row are loaded as vectors when the row's
//   lens + h, t_off + h and q_off + h are 16-byte aligned and ops + h
//   4-byte aligned, where h < 4 ops take the lens to a 16-byte boundary
//   (the head, scanned with one op a lane); a partial last group, and
//   every group of a row whose pointers cannot all be aligned, load and
//   store op by op in the same layout.  In the tools N is a multiple of
//   128 and every row is aligned.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "op_advance.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_U = 2;                     // groups of 4 ops per lane a step
constexpr int STEP = 32 * 4 * SCAN_U;         // ops per warp step
constexpr int TILE = SCAN_WARPS * STEP;       // ops per block tile (long rows)
constexpr long long LONG_N = 4096;            // rows this long take the tiles

// One row from its head on: ops [h, h + n) at these pointers.
struct RowView {
  const uint8_t* ops;
  const int* lens;
  int* t;
  int* q;
  long long n;
  bool vec;
};

// The advances of one group of 4 ops.
struct Group {
  uint32_t t[4], q[4];
};

__device__ __forceinline__ bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// Row `row` of the [B, N] tables: its head length *h (< 4) and the view of
// ops [h, N).
__device__ __forceinline__ RowView row_view(const uint8_t* ops,
                                            const int* lens, int* t, int* q,
                                            long long N, long long row,
                                            int* h) {
  const long long o = row * N;
  const uintptr_t la = reinterpret_cast<uintptr_t>(lens + o);
  long long hh = static_cast<long long>(((16u - (la & 15u)) & 15u) >> 2);
  hh = hh < N ? hh : N;
  RowView r{ops + o + hh, lens + o + hh, t + o + hh, q + o + hh, N - hh,
            false};
  r.vec = aligned(r.ops, 4) && aligned(r.lens, 16) && aligned(r.t, 16) &&
          aligned(r.q, 16);
  if (!r.vec) {  // op by op from op 0: no head
    hh = 0;
    r = RowView{ops + o, lens + o, t + o, q + o, N, false};
  }
  *h = static_cast<int>(hh);
  return r;
}

template <bool CHAIN>
__device__ __forceinline__ void load_group(const RowView& r, long long i,
                                           Group& g) {
  if (r.vec && i + 4 <= r.n) {
    const uint32_t o = __ldg(reinterpret_cast<const unsigned int*>(r.ops + i));
    const int4 l = __ldg(reinterpret_cast<const int4*>(r.lens + i));
    const uint32_t len[4] = {static_cast<uint32_t>(l.x),
                             static_cast<uint32_t>(l.y),
                             static_cast<uint32_t>(l.z),
                             static_cast<uint32_t>(l.w)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const wga::Adv2 a = wga::op_advance<CHAIN>((o >> (8 * k)) & 0xffu, len[k]);
      g.t[k] = a.t;
      g.q[k] = a.q;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wga::Adv2 a;
      if (i + k < r.n) {
        a = wga::op_advance<CHAIN>(__ldg(r.ops + i + k),
                                   static_cast<uint32_t>(__ldg(r.lens + i + k)));
      }
      g.t[k] = a.t;
      g.q[k] = a.q;
    }
  }
}

// Writes the group's exclusive offsets, starting from et, eq.
__device__ __forceinline__ void store_group(const RowView& r, long long i,
                                            const Group& g, uint32_t et,
                                            uint32_t eq) {
  int ot[4], oq[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ot[k] = static_cast<int>(et);
    oq[k] = static_cast<int>(eq);
    et += g.t[k];
    eq += g.q[k];
  }
  if (r.vec && i + 4 <= r.n) {
    *reinterpret_cast<int4*>(r.t + i) = make_int4(ot[0], ot[1], ot[2], ot[3]);
    *reinterpret_cast<int4*>(r.q + i) = make_int4(oq[0], oq[1], oq[2], oq[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < r.n) {
        r.t[i + k] = ot[k];
        r.q[i + k] = oq[k];
      }
    }
  }
}

__device__ __forceinline__ void warp_sum2(uint32_t& t, uint32_t& q) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    t += __shfl_xor_sync(0xffffffffu, t, d);
    q += __shfl_xor_sync(0xffffffffu, q, d);
  }
}

// The lane's groups of the warp step at op `base` of the view.
template <bool CHAIN>
__device__ __forceinline__ void step_load(const RowView& r, long long base,
                                          Group (&g)[SCAN_U]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < SCAN_U; ++k) {
    load_group<CHAIN>(r, base + 4 * (32 * k + lane), g[k]);
  }
}

__device__ __forceinline__ void group_sum(const Group& g, uint32_t& t,
                                          uint32_t& q) {
  t = g.t[0] + g.t[1] + g.t[2] + g.t[3];
  q = g.q[0] + g.q[1] + g.q[2] + g.q[3];
}

// Scans and stores a loaded warp step; (ct, cq): the sums of the ops before
// it, advanced past it.  Every lane of the warp.
__device__ __forceinline__ void step_store(const RowView& r, long long base,
                                           const Group (&g)[SCAN_U],
                                           uint32_t& ct, uint32_t& cq) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < SCAN_U; ++k) {
    const long long i = base + 4 * (32 * k + lane);
    if (base + 4 * 32 * k >= r.n) break;  // uniform over the warp
    uint32_t st, sq;
    group_sum(g[k], st, sq);
    uint32_t it = st, iq = sq;
    wga::warp_inclusive_scan2(it, iq);
    store_group(r, i, g[k], ct + it - st, cq + iq - sq);
    ct += __shfl_sync(0xffffffffu, it, 31);
    cq += __shfl_sync(0xffffffffu, iq, 31);
  }
}

// The row's head, ops [0, h) with h < 4, one a lane: writes their offsets
// and returns their sums in (ct, cq).  Every lane of the warp.
template <bool CHAIN>
__device__ __forceinline__ void head_scan(const uint8_t* ops, const int* lens,
                                          int* t, int* q, int h,
                                          uint32_t& ct, uint32_t& cq) {
  const int lane = threadIdx.x & 31;
  wga::Adv2 a;
  if (lane < h) {
    a = wga::op_advance<CHAIN>(__ldg(ops + lane),
                               static_cast<uint32_t>(__ldg(lens + lane)));
  }
  uint32_t it = a.t, iq = a.q;
  wga::warp_inclusive_scan2(it, iq);
  if (lane < h) {
    t[lane] = static_cast<int>(it - a.t);
    q[lane] = static_cast<int>(iq - a.q);
  }
  ct = __shfl_sync(0xffffffffu, it, 31);
  cq = __shfl_sync(0xffffffffu, iq, 31);
}

// Short rows: warp w of the grid scans row w.
template <bool CHAIN>
__global__ void __launch_bounds__(SCAN_THREADS) scan_rows_kernel(
    const uint8_t* __restrict__ ops, const int* __restrict__ lens,
    int* __restrict__ t_off, int* __restrict__ q_off, int B, long long N) {
  const long long row =
      static_cast<long long>(blockIdx.x) * SCAN_WARPS + (threadIdx.x >> 5);
  if (row >= B) return;  // uniform over the warp
  int h;
  const RowView r = row_view(ops, lens, t_off, q_off, N, row, &h);
  uint32_t ct = 0, cq = 0;
  if (h > 0) {
    const long long o = row * N;
    head_scan<CHAIN>(ops + o, lens + o, t_off + o, q_off + o, h, ct, cq);
  }
  Group cur[SCAN_U], nxt[SCAN_U];
  step_load<CHAIN>(r, 0, cur);
  for (long long base = 0; base < r.n; base += STEP) {
    if (base + STEP < r.n) step_load<CHAIN>(r, base + STEP, nxt);
    step_store(r, base, cur, ct, cq);
#pragma unroll
    for (int k = 0; k < SCAN_U; ++k) cur[k] = nxt[k];
  }
}

// Long rows, launch 1: the advance totals of tile blockIdx.x % tiles of row
// blockIdx.x / tiles (tile 0 with the head) into agg_t, agg_q [B, tiles].
// t_off and q_off are not written: the row's view (its head) depends on
// their alignment as in the second launch.
template <bool CHAIN>
__global__ void __launch_bounds__(SCAN_THREADS) tile_totals_kernel(
    const uint8_t* __restrict__ ops, const int* __restrict__ lens,
    int* t_off, int* q_off, uint32_t* __restrict__ agg_t,
    uint32_t* __restrict__ agg_q, long long N, long long tiles) {
  __shared__ uint32_t part_t[SCAN_WARPS], part_q[SCAN_WARPS];
  const long long row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int h;
  const RowView r = row_view(ops, lens, t_off, q_off, N, row, &h);
  uint32_t st = 0, sq = 0;
  const long long base = tile * TILE + static_cast<long long>(warp) * STEP;
  if (base < r.n) {
    Group g[SCAN_U];
    step_load<CHAIN>(r, base, g);
#pragma unroll
    for (int k = 0; k < SCAN_U; ++k) {
      uint32_t a, b;
      group_sum(g[k], a, b);
      st += a;
      sq += b;
    }
  }
  if (tile == 0 && warp == 0 && lane < h) {
    const wga::Adv2 a = wga::op_advance<CHAIN>(
        __ldg(ops + row * N + lane),
        static_cast<uint32_t>(__ldg(lens + row * N + lane)));
    st += a.t;
    sq += a.q;
  }
  warp_sum2(st, sq);
  if (lane == 0) {
    part_t[warp] = st;
    part_q[warp] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t tt = 0, tq = 0;
#pragma unroll
    for (int w = 0; w < SCAN_WARPS; ++w) {
      tt += part_t[w];
      tq += part_q[w];
    }
    agg_t[blockIdx.x] = tt;
    agg_q[blockIdx.x] = tq;
  }
}

// Long rows, launch 2: the offsets of one tile, from the totals of the
// tiles before it in its row.
template <bool CHAIN>
__global__ void __launch_bounds__(SCAN_THREADS) tile_scan_kernel(
    const uint8_t* __restrict__ ops, const int* __restrict__ lens,
    int* __restrict__ t_off, int* __restrict__ q_off,
    const uint32_t* __restrict__ agg_t, const uint32_t* __restrict__ agg_q,
    long long N, long long tiles) {
  __shared__ uint32_t part_t[SCAN_WARPS], part_q[SCAN_WARPS];
  const long long row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int h;
  const RowView r = row_view(ops, lens, t_off, q_off, N, row, &h);
  const long long base = tile * TILE + static_cast<long long>(warp) * STEP;
  Group g[SCAN_U];
  step_load<CHAIN>(r, base, g);

  // the totals of tiles [0, tile) of the row, strided over the block
  uint32_t pt = 0, pq = 0;
  for (long long j = threadIdx.x; j < tile; j += SCAN_THREADS) {
    pt += __ldg(agg_t + row * tiles + j);
    pq += __ldg(agg_q + row * tiles + j);
  }
  // plus this tile's warps before this one
  uint32_t st = 0, sq = 0;
#pragma unroll
  for (int k = 0; k < SCAN_U; ++k) {
    uint32_t a, b;
    group_sum(g[k], a, b);
    st += a;
    sq += b;
  }
  warp_sum2(pt, pq);
  warp_sum2(st, sq);
  __shared__ uint32_t pre_t[SCAN_WARPS], pre_q[SCAN_WARPS];
  if (lane == 0) {
    pre_t[warp] = pt;
    pre_q[warp] = pq;
    part_t[warp] = st;
    part_q[warp] = sq;
  }
  __syncthreads();
  uint32_t ct = 0, cq = 0;
#pragma unroll
  for (int w = 0; w < SCAN_WARPS; ++w) {
    ct += pre_t[w];
    cq += pre_q[w];
    if (w < warp) {
      ct += part_t[w];
      cq += part_q[w];
    }
  }
  if (tile == 0 && warp == 0 && h > 0) {  // the head comes first
    uint32_t ht, hq;
    const long long o = row * N;
    head_scan<CHAIN>(ops + o, lens + o, t_off + o, q_off + o, h, ht, hq);
    ct += ht;
    cq += hq;
  } else if (tile == 0 && h > 0) {
    const long long o = row * N;
    for (int k = 0; k < h; ++k) {
      const wga::Adv2 a = wga::op_advance<CHAIN>(
          __ldg(ops + o + k), static_cast<uint32_t>(__ldg(lens + o + k)));
      ct += a.t;
      cq += a.q;
    }
  }
  if (base < r.n) step_store(r, base, g, ct, cq);
}

template <bool CHAIN>
int launch_scan(const uint8_t* o, const int* l, int* t, int* q, int B,
                long long N, void* scratch, cudaStream_t s) {
  if (N < LONG_N) {
    const long long blocks = (B + SCAN_WARPS - 1) / SCAN_WARPS;
    scan_rows_kernel<CHAIN><<<static_cast<unsigned>(blocks), SCAN_THREADS, 0,
                              s>>>(o, l, t, q, B, N);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = (N + TILE - 1) / TILE;
  const long long blocks = B * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto* agg_t = static_cast<uint32_t*>(scratch);
  uint32_t* agg_q = agg_t + blocks;
  tile_totals_kernel<CHAIN><<<static_cast<unsigned>(blocks), SCAN_THREADS, 0,
                              s>>>(o, l, t, q, agg_t, agg_q, N, tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_scan_kernel<CHAIN><<<static_cast<unsigned>(blocks), SCAN_THREADS, 0,
                            s>>>(o, l, t, q, agg_t, agg_q, N, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// uint32 words of scratch wga_liftover_scan needs for a [B, N] table.
extern "C" long long wga_liftover_scan_scratch(int B, long long N) {
  if (B <= 0 || N < LONG_N) return 0;
  return 2 * static_cast<long long>(B) * ((N + TILE - 1) / TILE);
}

// mode: 0 liftover, 1 chain.  scratch: wga_liftover_scan_scratch(B, N)
// uint32 words, any contents.  Returns cudaGetLastError().
extern "C" int wga_liftover_scan(const void* ops, const void* lens,
                                 void* t_off, void* q_off, void* scratch,
                                 int B, long long N, int mode, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  const auto* o = static_cast<const uint8_t*>(ops);
  const auto* l = static_cast<const int*>(lens);
  auto* t = static_cast<int*>(t_off);
  auto* q = static_cast<int*>(q_off);
  auto s = static_cast<cudaStream_t>(stream);
  return mode == 1 ? launch_scan<true>(o, l, t, q, B, N, scratch, s)
                   : launch_scan<false>(o, l, t, q, B, N, scratch, s);
}
