// Host-fed group resolvers v9 and v10 for Hopper: the native packer's
// match groups of 8 (and, for v10, literal pieces over the scanner's dense
// literal bytes) applied to a buffer: pad row, 32 KiB window, the
// segments' bodies one after another, slack.
//
// Replaces the TPU kernels _group_kernel_v9 and _group_kernel_v10
// (debigulator_tpu/ops/archive/lz77_generations.py:345 and :431).  A
// group's 8 pieces copy len <= 128 bytes each from dst - dist to dst; the
// TPU kernels stage the piece lists through SMEM and, per group, issue all
// 8 loads (3-row windows rolled into place) before the 8 masked 2-row
// stores, one segment per call.  Those semantics are kept: within a group
// every load sees the buffer as the groups before it left it, and the
// stores follow in slot order (a later store wins); groups run in slot
// order.  For the packer's groups, whose pieces never read what the group
// writes, that is the in-order LZ77 result.
//
// Here memory is byte addressable (one int32 per byte) and the buffer
// holds every segment, so:
//  (a) lits_kernel (v10), a thread per literal slot: literal pieces read
//      no output, so any order (their destinations are disjoint);
//  (b) group_walk_kernel: the live match pieces, which the wrapper has
//      split into ranges that share no byte (a range keeps slot order; the
//      part of a group that falls in one range is a sub-group), one CTA
//      per range.  A warp takes a sub-group: its lanes load all of its
//      pieces' bytes into registers, __syncwarp(), then store them piece
//      by piece.  Up to 32 consecutive sub-groups run side by side, a
//      batch ending before the first one whose read or write span meets
//      an earlier member's write span, or whose write span meets an
//      earlier member's read span, so the result is the group walk's for
//      any input.
//
// What bounds it on the H100: (a) bytes, the words and literals read once;
// (b) latency: a range's batches are serialised, each about two L2 round
// trips, and a range uses one of 132 SMs.

#include "lz77_copy.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kMaxLen = 128;  // bytes of one piece a warp holds (4 a lane)
constexpr int kBodyStart = 128 + 32768;

using lz77::kWalkThreads;
using lz77::kWalkWarps;

// Literal slot t of segment k (the segment whose literal slot range holds
// the first slot of t's group): lpos = stream-global destination, lmeta =
// len << 20 | rel, its bytes lit[lims[k][5] * 128 + rel - 128 ...].
__global__ void lits_kernel(int* out, int64_t n_out,
                            const int* __restrict__ lims, int n_seg,
                            const int* __restrict__ lpos,
                            const int* __restrict__ lmeta, int64_t n_slots,
                            const int* __restrict__ lit, int64_t n_lit) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_slots) return;
  const int k = lz77::segment_of(lims, n_seg, 3, 4, t - t % kGroup);
  if (k < 0) return;
  const int m = lmeta[t];
  const int len = m >> 20;
  const int64_t dst = static_cast<int64_t>(lpos[t]) - lims[2] + kBodyStart;
  const int64_t src = static_cast<int64_t>(lims[k * 8 + 5]) * 128
                      + (m & 0xFFFFF) - 128;
  for (int i = 0; i < len; ++i) {
    if (dst + i >= 0 && dst + i < n_out && src + i >= 0 && src + i < n_lit)
      out[dst + i] = lit[src + i];
  }
}

__device__ __forceinline__ bool meets(int a0, int a1, int b0, int b1) {
  return a0 < a1 && b0 < b1 && a0 < b1 && b0 < a1;
}

// CTA r walks sub-groups [bounds[r], bounds[r + 1]); sub-group c holds the
// pieces [sg_first[c], sg_first[c + 1]) (at most 8) of pdst (buffer
// position) and pmeta (len << 16 | dist, len <= 128).  A source byte
// outside the buffer reads as 0; stores outside it are dropped.
__global__ void __launch_bounds__(kWalkThreads)
group_walk_kernel(int* out, int64_t n_out, const int* __restrict__ pdst,
                  const int* __restrict__ pmeta,
                  const int* __restrict__ sg_first,
                  const int64_t* __restrict__ bounds) {
  __shared__ int s_span[4][kWalkWarps];  // read lo, hi, write lo, hi
  __shared__ int s_ok[kWalkWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int b = static_cast<int>(bounds[blockIdx.x]);
  const int end = static_cast<int>(bounds[blockIdx.x + 1]);
  while (b < end) {
    const int c = b + warp;
    const bool live = c < end;
    int first = 0, n = 0;
    if (live) {
      first = sg_first[c];
      n = min(sg_first[c + 1] - first, kGroup);
    }
    // Lane p < n holds piece p; its spans join the sub-group's.
    int dst = 0, len = 0, src = 0;
    if (lane < n) {
      const int m = pmeta[first + lane];
      dst = pdst[first + lane];
      len = min(max(m >> 16, 0), kMaxLen);
      src = dst - (m & 0xFFFF);
    }
    int rlo = len > 0 ? src : INT_MAX, rhi = len > 0 ? src + len : INT_MIN;
    int wlo = len > 0 ? dst : INT_MAX, whi = len > 0 ? dst + len : INT_MIN;
    for (int o = 16; o > 0; o >>= 1) {
      rlo = min(rlo, __shfl_xor_sync(0xFFFFFFFFu, rlo, o));
      rhi = max(rhi, __shfl_xor_sync(0xFFFFFFFFu, rhi, o));
      wlo = min(wlo, __shfl_xor_sync(0xFFFFFFFFu, wlo, o));
      whi = max(whi, __shfl_xor_sync(0xFFFFFFFFu, whi, o));
    }
    if (lane == 0) {
      s_span[0][warp] = rlo;
      s_span[1][warp] = rhi;
      s_span[2][warp] = wlo;
      s_span[3][warp] = whi;
    }
    __syncthreads();
    bool hit = false;
    if (live && lane < warp) {
      const int jr0 = s_span[0][lane], jr1 = s_span[1][lane];
      const int jw0 = s_span[2][lane], jw1 = s_span[3][lane];
      hit = meets(rlo, rhi, jw0, jw1) ||   // reads what j writes
            meets(wlo, whi, jr0, jr1) ||   // writes what j reads
            meets(wlo, whi, jw0, jw1);     // writes what j writes
    }
    const bool ok = live && !__any_sync(0xFFFFFFFFu, hit);
    if (lane == 0) s_ok[warp] = ok;
    __syncthreads();
    const int nb = lz77::leading_ok(s_ok);
    if (warp < nb) {
      int v[kGroup][kMaxLen / 32];
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const int ps = __shfl_sync(0xFFFFFFFFu, src, p);
        const int pl = __shfl_sync(0xFFFFFFFFu, len, p);
#pragma unroll
        for (int k = 0; k < kMaxLen / 32; ++k) {
          const int i = lane + 32 * k;
          const int64_t s = static_cast<int64_t>(ps) + i;
          v[p][k] = (p < n && i < pl && s >= 0 && s < n_out) ? out[s] : 0;
        }
      }
      __syncwarp();
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const int pd = __shfl_sync(0xFFFFFFFFu, dst, p);
        const int pl = __shfl_sync(0xFFFFFFFFu, len, p);
#pragma unroll
        for (int k = 0; k < kMaxLen / 32; ++k) {
          const int i = lane + 32 * k;
          const int64_t d = static_cast<int64_t>(pd) + i;
          if (p < n && i < pl && d >= 0 && d < n_out) out[d] = v[p][k];
        }
        __syncwarp();  // a later piece's store to the same byte wins
      }
    }
    __syncthreads();
    b += nb;
  }
}

}  // namespace

extern "C" int dbg_groups_v10_lits(int* out, int64_t n_out, const int* lims,
                                   int n_seg, const int* lpos,
                                   const int* lmeta, int64_t n_slots,
                                   const int* lit, int64_t n_lit,
                                   cudaStream_t stream) {
  if (n_slots > 0) {
    const int threads = 256;
    const int64_t blocks = (n_slots + threads - 1) / threads;
    lits_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        out, n_out, lims, n_seg, lpos, lmeta, n_slots, lit, n_lit);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dbg_groups_v9_walk(int* out, int64_t n_out, const int* pdst,
                                  const int* pmeta, const int* sg_first,
                                  const int64_t* bounds, int n_ranges,
                                  cudaStream_t stream) {
  if (n_ranges > 0) {
    group_walk_kernel<<<n_ranges, kWalkThreads, 0, stream>>>(
        out, n_out, pdst, pmeta, sg_first, bounds);
  }
  return static_cast<int>(cudaGetLastError());
}
