// v14 dense-list walk for Hopper: literal runs, then the matches resolved
// by the grid-wide group chase, over one body.
//
// Replaces the TPU kernel _walk_kernel_v14 (debigulator_tpu/ops/archive/
// lz77_generations.py:1015).  Inputs are compact_v14's dense lists: runs
// (position; lit_flat << 7 | run_len, the run's bytes being
// lit[lit_flat ...]) and matches (position; clean bit 31 | len << 16 |
// dist) in stream order.  A record at position p lands at p + base_adj;
// stores are clipped to the body [kBodyStart, body_end) and a match that
// begins before it is head-clipped.  The TPU kernel walks one 512 KiB
// segment per call, staging the lists through SMEM: the matches in groups
// of 8 aligned to the dense list's index, a group whose first slot has
// bit 31 set (the compaction's "clean" hint) by its fast path, all 8 loads
// before the 8 stores with no wrap, every other group one match at a time
// with RLE doubling.  Here the buffer holds the whole body, memory is byte
// addressable, and the work is two entries with nothing read back between
// them:
//  (a) runs_kernel (dbg_walk_v14_runs), a thread per run: runs read no
//      output, so any order;
//  (b) group_chase::launch (dbg_walk_v14_chase, group_chase.cuh) over the
//      dense matches [m_lo, m_hi): `V14Rec` reads record q's position and
//      meta (len = meta >> 16 & 0x1FF, dist = meta & 0xFFFF), clips it
//      with lz77::clip_match and keeps the TPU kernel's groups on any
//      list.  A clean group is one group of the chase, from its aligned
//      first slot (or its segment's first record, where a segment of lims
//      starts inside it, as the TPU kernel's call a segment does), each
//      member's byte d + i taking what byte d - dist + i held before the
//      group (a member of distance 0 included); every other match is a
//      group of its own under the overlap rule (d - dist + i % dist;
//      distance 0 does nothing).  A head-clipped match keeps its distance;
//      a source below the body (the window prologue) is read as the
//      buffer holds it, one outside the buffer as 0.  A match is cut at
//      512 - (dst & 127) bytes, where the TPU kernel's 4-row span ends
//      (only lengths past 258, which DEFLATE never makes, reach it).
//
// What bounds it on the H100: (a) bytes; (b) bytes and latency
// (group_chase.cuh), two words a match read twice, two words set per
// buffer byte and a 64-bit state per written byte.

#include <cstdint>
#include <cuda_runtime.h>

#include "chase.cuh"
#include "group_chase.cuh"
#include "lz77_copy.cuh"

namespace {

constexpr int kBodyStart = 128 + 32768;

__global__ void runs_kernel(int* out, int body_end, int base_adj,
                            const int* __restrict__ rdst,
                            const int* __restrict__ rmeta, int r_lo, int r_hi,
                            const int* __restrict__ lit, int64_t n_lit) {
  const int i = r_lo + blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r_hi) return;
  const int meta = rmeta[i];
  const int len = meta & 0x7F;
  const int64_t lf = static_cast<int64_t>(static_cast<unsigned>(meta) >> 7);
  const int dst = rdst[i] + base_adj;
  for (int j = 0; j < len; ++j) {
    const int p = dst + j;
    if (p >= kBodyStart && p < body_end && lf + j < n_lit) out[p] = lit[lf + j];
  }
}

}  // namespace

// The record source of the group chase, outside the unnamed namespace: it
// is a template argument of a kernel.
namespace walk_v14 {

// Dense match m_lo + t for the group chase (see the header).
struct V14Rec {
  static constexpr int kPiece = 512;
  const int* __restrict__ lims;
  int n_seg;
  const int* __restrict__ mdst;
  const int* __restrict__ mmeta;
  int m_lo, base_adj, body_end;
  __device__ __forceinline__ void operator()(int64_t t, int& dst, int& len,
                                             int& src, int& period) const {
    len = 0;
    const int64_t q = m_lo + t;
    const int meta = mmeta[q];
    int d = mdst[q] + base_adj;
    int eff = lz77::clip_match(&d, (meta >> 16) & 0x1FF, kBodyStart,
                               body_end);
    eff = min(eff, kPiece - (d & 127));
    const int dist = meta & 0xFFFF;
    const bool clean = mmeta[q & ~int64_t{7}] < 0;
    if (eff <= 0 || (dist == 0 && !clean)) return;
    dst = d;
    len = eff;
    src = d - dist;
    period = clean ? eff : dist;
  }
  // A clean group's first slot, not below its segment's first record nor
  // below m_lo; else the slot itself.
  __device__ __forceinline__ int64_t lo(int64_t t) const {
    const int64_t q = m_lo + t;
    const int64_t q0 = q & ~int64_t{7};
    if (mmeta[q0] >= 0) return t;
    const int k = lz77::segment_of(lims, n_seg, 0, 1, q);
    int64_t first = q0;
    if (k >= 0 && lims[k * 8] > first) first = lims[k * 8];
    return first > m_lo ? first - m_lo : 0;
  }
};

}  // namespace walk_v14

extern "C" int dbg_walk_v14_runs(int* out, int body_end, int base_adj,
                                 const int* rdst, const int* rmeta, int r_lo,
                                 int r_hi, const int* lit, int64_t n_lit,
                                 cudaStream_t stream) {
  if (r_hi > r_lo) {
    const int threads = 256;
    const int blocks = (r_hi - r_lo + threads - 1) / threads;
    runs_kernel<<<blocks, threads, 0, stream>>>(out, body_end, base_adj, rdst,
                                                rmeta, r_lo, r_hi, lit, n_lit);
  }
  return static_cast<int>(cudaGetLastError());
}

// lims: n_seg rows of 8 ints (column 0 each segment's first record);
// last, first: n_out ints; state: n_out 64-bit words; heads: (n_out + 511)
// / 512 + 2 ints; next: m_hi - m_lo ints; all scratch.
extern "C" int dbg_walk_v14_chase(int* out, int64_t n_out, int body_end,
                                  int base_adj, const int* lims, int n_seg,
                                  const int* mdst, const int* mmeta, int m_lo,
                                  int m_hi, int* last, int* first,
                                  unsigned long long* state, int* heads,
                                  int* next, cudaStream_t stream) {
  const walk_v14::V14Rec rec{lims, n_seg, mdst, mmeta, m_lo, base_adj,
                             body_end};
  return group_chase::launch(out, n_out, rec,
                             static_cast<int64_t>(m_hi) - m_lo,
                             {last, first, state, heads, next}, stream);
}
