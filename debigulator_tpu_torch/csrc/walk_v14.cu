// v14 dense-list walk for Hopper: literal runs, then the matches resolved
// by the grid-wide source chase, over one body.
//
// Replaces the TPU kernel _walk_kernel_v14 (debigulator_tpu/ops/archive/
// lz77_generations.py:1015).  Inputs are compact_v14's dense lists: runs
// (position; lit_flat << 7 | run_len, the run's bytes being
// lit[lit_flat ...]) and matches (position; clean bit 31 | len << 16 |
// dist) in stream order.  A record at position p lands at p + base_adj;
// stores are clipped to the body [kBodyStart, body_end) and a match that
// begins before it is head-clipped.  The TPU kernel walks one 512 KiB
// segment per call, staging the lists through SMEM, with a fast path for
// groups of 8 marked clean and RLE doubling for the rest.  Here the
// buffer holds the whole body, memory is byte addressable, and the work is
// two entries with nothing read back between them:
//  (a) runs_kernel (dbg_walk_v14_runs), a thread per run: runs read no
//      output, so any order;
//  (b) chase::launch_list (dbg_walk_v14_chase, chase.cuh) over the dense
//      matches [m_lo, m_hi): `DenseRec` reads record q's position and meta
//      (len = meta >> 16 & 0x1FF, dist = meta & 0xFFFF; the clean bit 31
//      is not read, so a record with it set is a match like any other)
//      and clips it with lz77::clip_match; the pointer pass spreads the
//      bytes, then the grid-wide chase resolves every body byte to the
//      root of its chain of sources.  No stream order: the compaction's
//      matches never overlap (DEFLATE output is written once) and every
//      source lies below the byte it feeds, which is when the chase equals
//      the in-order walk.  A head-clipped match keeps its distance, so it
//      resolves as the in-order walk of the clipped match does; a source
//      below the body (the window prologue) has no flag and is final, and
//      one below 0 is skipped.  The overlapping (dist < len) case needs no
//      doubling: each byte points at d - dist + i % dist.
//
// What bounds it on the H100: (a) bytes; (b) bytes and latency
// (chase.cuh), two words a match read once and a 64-bit state and a bit
// per body byte.

#include <cstdint>
#include <cuda_runtime.h>

#include "chase.cuh"
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

// The record source of the chase's pointer pass, outside the unnamed
// namespace: it is a template argument of a kernel.
namespace walk_v14 {

// Dense match m_lo + q for chase::list_pointer_kernel.
struct DenseRec {
  const int* __restrict__ mdst;
  const int* __restrict__ mmeta;
  int m_lo, base_adj, body_end;
  __device__ __forceinline__ void operator()(int64_t q, int& dst, int& len,
                                             int& dist) const {
    const int meta = mmeta[m_lo + q];
    int d = mdst[m_lo + q] + base_adj;
    const int eff = lz77::clip_match(&d, (meta >> 16) & 0x1FF, kBodyStart,
                                     body_end);
    if (eff > 0 && (meta & 0xFFFF) != 0) {
      dst = d;
      len = eff;
      dist = meta & 0xFFFF;
    }
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

// state: a 64-bit word per body byte (body_end - PAD - WINDOW), bits: a
// bit per body byte, rounded up to whole 32-bit words; both scratch.
extern "C" int dbg_walk_v14_chase(int* out, int body_end, int base_adj,
                                  const int* mdst, const int* mmeta, int m_lo,
                                  int m_hi, unsigned long long* state,
                                  unsigned* bits, cudaStream_t stream) {
  const walk_v14::DenseRec rec{mdst, mmeta, m_lo, base_adj, body_end};
  return chase::launch_list(out, kBodyStart, body_end, rec,
                            static_cast<int64_t>(m_hi) - m_lo, state, bits,
                            stream);
}
