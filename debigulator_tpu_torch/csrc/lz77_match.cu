// Match-list resolver for Hopper: a match list applied in order to a
// buffer whose literals and stored bytes are already placed.
//
// Replaces the TPU kernel _match_kernel_v4 (debigulator_tpu/ops/
// lz77_pallas.py:145).  pos[t] is match t's destination in the buffer,
// meta[t] = len << 16 | dist; the wrapper passes n = n_matches, and entries
// of length 0 or distance 0 do nothing.  The archived match-list kernels
// _match_kernel (v1) and _match_kernel_v2 (v2) (debigulator_tpu/ops/
// archive/lz77_generations.py:171 and :231) are the same walk over their
// whole list (n = every entry, padding of length 0 included); their
// layouts differ only in where the buffer starts, which their wrappers in
// ops/archive/lz77_generations.py check.
//
// The TPU kernels walk the list in slot order: v4 stages it through SMEM
// and loads a group of 8 before it stores it only where no member reads
// what an earlier one writes (its fast path), the rest one match at a
// time with the pattern doubled for dist < len.  So match t takes effect
// after every earlier slot: byte d + i gets what byte d - dist + i % dist
// holds then, and a later slot's store wins.  That is group_chase.cuh's
// chase with groups of one (`MatchRec`: lo(t) = t, src = d - dist, period =
// dist), since such a source lies below the match's own bytes: no slot
// order, a pass per step over the whole grid, nothing read back, so a
// call replays from a CUDA graph.  A source outside the buffer reads 0;
// stores outside it are dropped.  Lengths past 258 are not DEFLATE: a
// match is cut at 512 - (dst & 127) bytes, where the TPU kernels' 4-row
// span ends.
//
// What bounds it on the H100: bytes and latency (group_chase.cuh), across
// all 132 SMs: two words a match read twice, two words set per buffer
// byte and a 64-bit state per written byte.

#include <cstdint>
#include <cuda_runtime.h>

#include "chase.cuh"
#include "group_chase.cuh"

// The record source of the group chase, outside an unnamed namespace: it
// is a template argument of a kernel.
namespace lz77_match {

// Match t: position pos[t], len = meta >> 16 (at most kPiece - (dst &
// 127)), source dst - dist under the overlap rule; length 0 for len <= 0
// or dist 0.  Every match is its own group.
struct MatchRec {
  static constexpr int kPiece = 512;
  const int* __restrict__ pos;
  const int* __restrict__ meta;
  __device__ __forceinline__ void operator()(int64_t t, int& dst, int& len,
                                             int& src, int& period) const {
    len = 0;
    const int m = meta[t];
    const int dist = m & 0xFFFF;
    if ((m >> 16) <= 0 || dist == 0) return;
    dst = pos[t];
    len = min(m >> 16, kPiece - (dst & 127));
    src = dst - dist;
    period = dist;
  }
  __device__ __forceinline__ int64_t lo(int64_t t) const { return t; }
};

}  // namespace lz77_match

// last, first: n_out ints; state: n_out 64-bit words; heads: (n_out + 511)
// / 512 + 2 ints; next: n ints; all scratch.
extern "C" int dbg_lz77_match(int* out, int64_t n_out, const int* pos,
                              const int* meta, int64_t n, int* last,
                              int* first, unsigned long long* state,
                              int* heads, int* next, cudaStream_t stream) {
  const lz77_match::MatchRec rec{pos, meta};
  return group_chase::launch(out, n_out, rec, n,
                             {last, first, state, heads, next}, stream);
}
