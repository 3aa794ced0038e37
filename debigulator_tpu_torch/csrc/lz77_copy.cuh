// Match helpers for Hopper shared by the LZ77 resolvers: clip_match for
// the resolvers that clip their matches to a body (lz77_tape.cu and
// lz77_ops.cu over chase.cuh's source chase, walk_v14.cu over
// group_chase.cuh) and segment_of for the resolvers whose records carry a
// segment's limits (groups_v9.cu, groups_v11.cu, walk_v14.cu).
//
// No resolver walks a list in order any more: every match list goes
// through a grid-wide chase (chase.cuh for DEFLATE tapes, whose bytes are
// written once; group_chase.cuh for lists, with their kernels' group
// semantics on any list).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lz77 {

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
