// v4 match resolver for Hopper: a front-compacted match list applied in
// order to a buffer whose literals and stored bytes are already placed.
//
// Replaces the TPU kernel _match_kernel_v4 (debigulator_tpu/ops/
// lz77_pallas.py:145).  pos[i] is the match's destination in the buffer,
// meta[i] = len << 16 | dist; entries from n_matches on and entries of
// length 0 do nothing.
//
// The archived match-list kernels _match_kernel (v1) and _match_kernel_v2
// (v2) (debigulator_tpu/ops/archive/lz77_generations.py:171 and :231) are
// this walk over their whole list (n_matches = every entry, padding of
// length 0 included); their layouts differ only in where the buffer
// starts, which their wrappers in ops/archive/lz77_generations.py check.
//
// One CTA, 32 matches a batch, a warp per match (lz77_copy.cuh).  Warp w
// holds match s + w and its lanes test it against the earlier members
// s + 0 .. s + w - 1 exactly: it may not read what one of them writes,
// nor write what one of them reads or writes.  The batch is the longest
// clean prefix, so the result is the sequential one for any list.
//
// What bounds it on the H100: latency (see lz77_copy.cuh), not the
// 12 bytes per match and 8 bytes per copied byte it moves.

#include "lz77_copy.cuh"

namespace {

__device__ __forceinline__ bool overlap(int64_t a, int64_t an, int64_t b,
                                        int64_t bn) {
  return an > 0 && bn > 0 && a < b + bn && b < a + an;
}

__global__ void __launch_bounds__(lz77::kWalkThreads)
match_list_kernel(int* out, int64_t limit, const int* __restrict__ pos,
                  const int* __restrict__ meta, int n_matches) {
  __shared__ int s_ok[lz77::kWalkWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int s = 0;
  while (s < n_matches) {
    const int i = s + warp;
    const bool live = i < n_matches;
    const int dst = live ? pos[i] : 0;
    const int m = live ? meta[i] : 0;
    const int len = m >> 16;
    const int dist = m & 0xFFFF;
    const int rd = min(len, dist);  // source bytes actually read
    bool hit = false;
    if (lane < warp && s + lane < n_matches && len > 0) {
      const int pj = pos[s + lane];
      const int mj = meta[s + lane];
      const int lj = mj >> 16;
      const int dj = mj & 0xFFFF;
      const int rj = min(lj, dj);
      hit = overlap(dst - dist, rd, pj, lj) ||        // reads its output
            overlap(dst, len, pj - dj, rj) ||         // overwrites its source
            overlap(dst, len, pj, lj);                // overwrites its output
    }
    const bool ok = live && !__any_sync(0xFFFFFFFFu, hit);
    if (lane == 0) s_ok[warp] = ok;
    __syncthreads();
    const int n = lz77::leading_ok(s_ok);
    if (warp < n && len > 0) lz77::copy_match(out, limit, dst, len, dist, lane);
    __syncthreads();
    s += n;
  }
}

}  // namespace

extern "C" int dbg_lz77_match(int* out, int64_t out_len, const int* pos,
                              const int* meta, int n_matches,
                              cudaStream_t stream) {
  if (n_matches > 0) {
    match_list_kernel<<<1, lz77::kWalkThreads, 0, stream>>>(
        out, out_len, pos, meta, n_matches);
  }
  return static_cast<int>(cudaGetLastError());
}
