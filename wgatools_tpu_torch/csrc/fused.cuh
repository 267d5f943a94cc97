// The fused classify + op-scan body shared by kernel C (fused_adv16.cu),
// kernel F (fused16.cu) and kernel 8 (fused_ops.cu).
//
// One launch reads a column plane (cat_stats.cuh: CatPlane, NibblePlane or
// BytePlane over byte words) and the op words of a matching table, and
// writes the [B, 8] counters of the plane and the exclusive per-row scans
// of the op words.  The first B2 blocks each scan one op row
// (row_scan.cuh); the rest count the plane's column chunks.  The scan
// blocks come first so that they start while the column chunks stream.  B2
// may differ from B; the two parts never mix rows.  The TPU kernels carried
// each row's scan across a sequential column grid in scratch, in three
// formulations (scan_mode vpu / mm / once, chunk, tiles); a block walking
// its whole row gives the same sums, so those choices have no counterpart.
//
// The op words (int32 [B2, NOH] per direction, or one packed plane, or
// kernel 8's op table):
//   GroupSums        raw group advance sums (liftover.pack_ops_sums) ->
//                    exclusive group-prefix anchors;
//   PairWords<ODD>   adv16 pair words (adv_even << 14) | pair_sum
//                    (liftover.pack_ops_adv16) -> even offsets = the scan
//                    of the pair sums, and with ODD odd = even + (w >> 14);
//   Packed16         two ops per word, [0:13) len0 [13:16) cls0 [16:29)
//                    len1 [29:32) cls1 (liftover.pack_ops_words16), classes
//                    ADV_BOTH=1 (t and q), I=2 and S=3 (q), D=4 (t) ->
//                    even and odd offsets of both directions;
//   OpsLens          uint8 ops + int32 lens [B2, NO] -> the full exclusive
//                    t/q offsets, liftover mode (op_advance.cuh);
//   PackedOps        (op byte << 24) | len words [B2, NO]
//                    (liftover.pack_ops_words; bits 16-23 ignored) -> the
//                    same offsets.
// Words are decoded as uint32_t with logical shifts: cls1 = 4 and op bytes
// >= 0x80 set bit 31.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "cat_stats.cuh"
#include "op_advance.cuh"
#include "row_scan.cuh"

namespace wga {

// One op row of a fused launch: load/store as block_exclusive_scan2 wants.
struct GroupSumsRow {
  using Elem = Adv2;
  const int* st;
  const int* sq;
  int* ta;
  int* qa;
  __device__ __forceinline__ Elem load(long long i) const {
    Elem e;
    e.t = static_cast<uint32_t>(__ldg(st + i));
    e.q = static_cast<uint32_t>(__ldg(sq + i));
    return e;
  }
  __device__ __forceinline__ void store(long long i, const Elem&,
                                        uint32_t ex_t, uint32_t ex_q) const {
    ta[i] = static_cast<int>(ex_t);
    qa[i] = static_cast<int>(ex_q);
  }
};

// A pair's scanned sums and the even op's advances, for the odd offsets.
struct PairElem {
  uint32_t t = 0, q = 0, even_t = 0, even_q = 0;
};

// even/odd offsets of one row; odd outputs are written only with ODD.
template <bool ODD>
struct EvenOddOut {
  int* te;
  int* to;
  int* qe;
  int* qo;
  __device__ __forceinline__ void operator()(long long i, const PairElem& e,
                                             uint32_t ex_t,
                                             uint32_t ex_q) const {
    te[i] = static_cast<int>(ex_t);
    qe[i] = static_cast<int>(ex_q);
    if (ODD) {
      to[i] = static_cast<int>(ex_t + e.even_t);
      qo[i] = static_cast<int>(ex_q + e.even_q);
    }
  }
};

template <bool ODD>
struct PairWordsRow {
  using Elem = PairElem;
  const int* wt;
  const int* wq;
  EvenOddOut<ODD> out;
  __device__ __forceinline__ Elem load(long long i) const {
    const auto a = static_cast<uint32_t>(__ldg(wt + i));
    const auto b = static_cast<uint32_t>(__ldg(wq + i));
    Elem e;
    e.t = a & 0x3fffu;
    e.q = b & 0x3fffu;
    e.even_t = a >> 14;
    e.even_q = b >> 14;
    return e;
  }
  __device__ __forceinline__ void store(long long i, const Elem& e,
                                        uint32_t ex_t, uint32_t ex_q) const {
    out(i, e, ex_t, ex_q);
  }
};

struct Packed16Row {
  using Elem = PairElem;
  const int* opw;
  EvenOddOut<true> out;
  __device__ __forceinline__ Elem load(long long i) const {
    const auto w = static_cast<uint32_t>(__ldg(opw + i));
    const uint32_t len0 = w & 0x1fffu, cls0 = (w >> 13) & 7u;
    const uint32_t len1 = (w >> 16) & 0x1fffu, cls1 = w >> 29;
    const auto adv_t = [](uint32_t cls, uint32_t len) {
      return (cls == 1u || cls == 4u) ? len : 0u;
    };
    const auto adv_q = [](uint32_t cls, uint32_t len) {
      return (cls == 1u || cls == 2u || cls == 3u) ? len : 0u;
    };
    Elem e;
    e.even_t = adv_t(cls0, len0);
    e.even_q = adv_q(cls0, len0);
    e.t = e.even_t + adv_t(cls1, len1);
    e.q = e.even_q + adv_q(cls1, len1);
    return e;
  }
  __device__ __forceinline__ void store(long long i, const Elem& e,
                                        uint32_t ex_t, uint32_t ex_q) const {
    out(i, e, ex_t, ex_q);
  }
};

// One row of packed op words (op << 24) | len, decoded as OpsLensRow's.
struct PackedOpsRow {
  using Elem = Adv2;
  const int* opw;
  int* t_off;
  int* q_off;
  __device__ __forceinline__ Elem load(long long i) const {
    const auto w = static_cast<uint32_t>(__ldg(opw + i));
    return op_advance<false>(w >> 24, w & 0xffffu);
  }
  __device__ __forceinline__ void store(long long i, const Elem&,
                                        uint32_t ex_t, uint32_t ex_q) const {
    t_off[i] = static_cast<int>(ex_t);
    q_off[i] = static_cast<int>(ex_q);
  }
};

// Base pointers of the op words and outputs of a launch; row(b) gives the
// op row b view of a table of NOH words per row.
struct OpTable {
  const int* wt;  // GroupSums / PairWords: t words; Packed16: the words
  const int* wq;
  int* te;
  int* to;
  int* qe;
  int* qo;
  long long NOH;
};

struct GroupSums {
  OpTable a;
  __device__ GroupSumsRow row(long long b) const {
    const long long o = b * a.NOH;
    return {a.wt + o, a.wq + o, a.te + o, a.qe + o};
  }
};

template <bool ODD>
struct PairWords {
  OpTable a;
  __device__ PairWordsRow<ODD> row(long long b) const {
    const long long o = b * a.NOH;
    return {a.wt + o, a.wq + o,
            {a.te + o, ODD ? a.to + o : nullptr, a.qe + o,
             ODD ? a.qo + o : nullptr}};
  }
};

struct Packed16 {
  OpTable a;
  __device__ Packed16Row row(long long b) const {
    const long long o = b * a.NOH;
    return {a.wt + o, {a.te + o, a.to + o, a.qe + o, a.qo + o}};
  }
};

// Kernel 8's op tables (NOH = NO ops per row): te and qe receive t_off and
// q_off.  OpsLens reads the uint8 ops and, in wq, the int32 lens;
// PackedOps reads the packed words in wt.
struct OpsLens {
  OpTable a;
  const uint8_t* ops;
  __device__ OpsLensRow<false> row(long long b) const {
    const long long o = b * a.NOH;
    return {ops + o, a.wq + o, a.te + o, a.qe + o};
  }
};

struct PackedOps {
  OpTable a;
  __device__ PackedOpsRow row(long long b) const {
    const long long o = b * a.NOH;
    return {a.wt + o, a.te + o, a.qe + o};
  }
};

}  // namespace wga

namespace {

template <bool CALLER, class Plane, class Ops>
__global__ void __launch_bounds__(wga::CAT_THREADS)
    fused_kernel(Plane p, const int* __restrict__ lengths,
                 int* __restrict__ stats, Ops ops, long long nchunks,
                 long long B2) {
  const long long b = blockIdx.x;
  if (b < B2) {
    wga::block_exclusive_scan2(ops.row(b), ops.a.NOH);
    return;
  }
  const long long c = b - B2;
  wga::plane_stats_chunk<CALLER>(p, lengths, stats, c / nchunks, c % nchunks);
}

// Launches plane p's counters over B rows of `cols` columns into the
// zeroed int32 [B, 8] stats, and the scans of B2 op rows.  Returns
// cudaGetLastError().
template <class Plane, class Ops>
int launch_fused(const Plane& p, long long cols, const void* lengths,
                 void* stats, int B, const Ops& ops, int B2, int caller,
                 void* stream) {
  const long long nchunks = (B > 0 && cols > 0) ? wga::stat_chunks(cols) : 0;
  const long long scan_rows = (B2 > 0 && ops.a.NOH > 0) ? B2 : 0;
  const long long blocks = scan_rows + static_cast<long long>(B) * nchunks;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto* n = static_cast<const int*>(lengths);
  auto* o = static_cast<int*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (caller) {
    fused_kernel<true, Plane, Ops>
        <<<grid, wga::CAT_THREADS, 0, s>>>(p, n, o, ops, nchunks, scan_rows);
  } else {
    fused_kernel<false, Plane, Ops>
        <<<grid, wga::CAT_THREADS, 0, s>>>(p, n, o, ops, nchunks, scan_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// Plane kinds of the fused entry points.
constexpr int PLANE_WORDS = 0;   // int32 byte words, 4 columns per word
constexpr int PLANE_NIBBLE = 1;  // int32 nibble words, 8 columns per word
constexpr int PLANE_CAT = 2;     // one int32 category plane, 8 per word

// Runs launch_fused on the plane kind `plane` built from tw, qw, LW.
template <class Ops>
int launch_fused_plane(int plane, const void* tw, const void* qw,
                       long long LW, const void* lengths, void* stats, int B,
                       const Ops& ops, int B2, int caller, void* stream) {
  const auto* t = static_cast<const uint32_t*>(tw);
  const auto* q = static_cast<const uint32_t*>(qw);
  switch (plane) {
    case PLANE_WORDS:
      return launch_fused(
          wga::BytePlane{reinterpret_cast<const uint8_t*>(t),
                         reinterpret_cast<const uint8_t*>(q), 4 * LW},
          4 * LW, lengths, stats, B, ops, B2, caller, stream);
    case PLANE_NIBBLE:
      return launch_fused(wga::NibblePlane{t, q, LW}, 8 * LW, lengths, stats,
                          B, ops, B2, caller, stream);
    case PLANE_CAT:
      return launch_fused(wga::CatPlane{t, LW}, 8 * LW, lengths, stats, B,
                          ops, B2, caller, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
