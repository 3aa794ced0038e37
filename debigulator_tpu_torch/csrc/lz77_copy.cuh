// In-order LZ77 match application for Hopper.  Its users: the match-list
// resolver of ops/lz77.py (lz77_match.cu: copy_match, leading_ok),
// clip_match for the resolvers whose matches the grid-wide chase of
// chase.cuh resolves (lz77_tape.cu, lz77_ops.cu, walk_v14.cu; that chase
// keeps copy_match's overlap rule) and segment_of for the group resolvers
// on group_chase.cuh (groups_v9.cu, groups_v11.cu).
//
// A DEFLATE match copies `len` bytes from `dist` bytes back; matches must
// take effect in stream order because a source may be bytes an earlier
// match wrote.  The TPU kernels (debigulator_tpu/ops/lz77_pallas.py) load
// aligned 4-row spans, rotate lanes, test groups of 8 matches pairwise for
// hazards and double the pattern nine times for the overlapping case; all
// of that answers Mosaic's 128-lane alignment.  Here memory is byte
// addressable (one int32 per byte), so:
//
//  * one warp copies one match, lane i taking bytes i, i + 32, ...:
//    out[dst + i] = out[dst - dist + i % dist].  Every source index lies
//    below dst, so the bytes read were final before the match began and
//    the overlapping (dist < len) case needs no doubling;
//  * one CTA of 32 warps walks a list in order.  A batch is the longest
//    run of matches whose sources do not reach into what the batch itself
//    writes; the batch copies in parallel, then one __syncthreads() makes
//    its bytes visible to the next.
//
// What bounds it on the H100: latency.  A list's batches are serialised,
// each costs about two L2 round trips, and a list uses one of 132 SMs.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace lz77 {

constexpr int kWalkThreads = 1024;
constexpr int kWalkWarps = kWalkThreads / 32;

// One warp copies one match.  `dist` 0 (a corrupt record) copies nothing;
// stores are clipped to [0, limit) and sources below 0 are skipped.
__device__ __forceinline__ void copy_match(int* out, int64_t limit, int dst,
                                           int len, int dist, int lane) {
  if (dist <= 0) return;
  const int64_t src = static_cast<int64_t>(dst) - dist;
  for (int i = lane; i < len; i += 32) {
    const int64_t s = src + (i % dist);
    const int64_t d = static_cast<int64_t>(dst) + i;
    if (s >= 0 && d < limit) out[d] = out[s];
  }
}

// Number of leading set flags among the CTA's per-warp flags.
__device__ __forceinline__ int leading_ok(const int* s_ok) {
  int n = 0;
  while (n < kWalkWarps && s_ok[n]) ++n;
  return n;
}

// Head and tail clip of a match at buffer position dst to the body
// [body_start, body_end): the destination moves up, the length shrinks,
// the distance stays.  Returns the clipped length (0: nothing to copy).
__device__ __forceinline__ int clip_match(int* dst, int len, int body_start,
                                          int body_end) {
  const int delta = max(body_start - *dst, 0);
  int eff = max(len - delta, 0);
  *dst += delta;
  eff = min(eff, max(body_end - *dst, 0));
  return eff;
}

// The segment whose slot range [lims[k][lo], lims[k][hi]) holds slot t, or
// -1.  lims rows are 8 ints; the ranges rise with k, and the last k with
// lims[k][lo] <= t is tried.
__device__ __forceinline__ int segment_of(const int* __restrict__ lims,
                                          int n_seg, int lo, int hi,
                                          int64_t t) {
  int a = 0, b = n_seg;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (lims[m * 8 + lo] <= t) a = m + 1;
    else b = m;
  }
  const int k = a - 1;
  return (k >= 0 && t < lims[k * 8 + hi]) ? k : -1;
}

}  // namespace lz77
