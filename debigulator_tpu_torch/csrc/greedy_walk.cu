// Greedy LZ77 selection for Hopper: one walker over staged windows.
//
// Replaces the TPU kernel _greedy_walk_kernel (debigulator_tpu/ops/
// deflate_encode_jnp.py:44).  That kernel is a scalar-core loop over SMEM
// stages filled and flushed with hand-rolled DMAs, over (rows, 128) padded
// arrays; none of that staging is kept.  What it computes is kept exactly:
// the orbit of 0 under next(i) = i + (len[i] >= 3 ? len[i] : 1) below n,
// one record (i, len[i] << 16 | dist[i]) per visited i with len[i] >= 3,
// in order, and the record count.
//
// What bounds it on the H100: latency.  The walk is one dependent chain;
// a thread chasing it through device memory would pay several hundred
// nanoseconds per visit, and a 4 MB filtered image has of the order of a
// million visits.  So the CTA stages the next window of best_len and
// best_dist in shared memory with coalesced loads by all threads, the
// first warp walks the window out of shared memory and appends records to
// shared buffers, and all threads flush the records to device memory.
// The warp looks at 32 positions per step: one shared load and a ballot of
// len >= 3, then the walk over those 32 positions stays in registers (find
// the first match at or after the walk's offset, shuffle its length in,
// jump), so a run of literals costs nothing and a match one shuffle; the
// lanes whose matches were taken then write their records together.  A
// match that jumps past the window's end simply starts the next window
// further on.  One CTA, one SM: the chain does not parallelize in this
// form (pointer doubling over `next` does, at log2 n passes over device
// memory; that is what the plain version uses).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 4096;
constexpr int kMinMatch = 3;
// Taken matches in one window start at least kMinMatch apart.
constexpr int kRecords = kWindow / kMinMatch + 2;

__global__ void __launch_bounds__(kThreads)
greedy_walk_kernel(const int* __restrict__ best_len,
                   const int* __restrict__ best_dist, int64_t n,
                   int* __restrict__ pos_out, int* __restrict__ meta_out,
                   int* __restrict__ count_out) {
  __shared__ int s_len[kWindow];
  __shared__ int s_dist[kWindow];
  __shared__ int s_pos[kRecords];
  __shared__ int s_meta[kRecords];
  __shared__ int64_t s_next;  // where the walk stands
  __shared__ int s_nrec;      // records of this window
  const int tid = threadIdx.x;

  int64_t i = 0;  // uniform across the CTA
  int64_t k = 0;  // records flushed so far
  while (i < n) {
    const int64_t base = i;
    const int64_t end = base + kWindow < n ? base + kWindow : n;
    const int span = static_cast<int>(end - base);
    for (int j = tid; j < span; j += kThreads) {
      s_len[j] = best_len[base + j];
      s_dist[j] = best_dist[base + j];
    }
    __syncthreads();
    if (tid < 32) {
      int64_t at = base;  // uniform across the warp
      int nrec = 0;
      while (at < end) {
        const int64_t mine = at + tid;
        const int j = static_cast<int>(mine - base);
        const int len = mine < end ? s_len[j] : 0;
        const unsigned mask = __ballot_sync(0xFFFFFFFFu, len >= kMinMatch);
        // Walk the 32 positions in registers: p is the walk's offset and
        // `took` marks the lanes whose match the walk takes.
        unsigned took = 0;
        int p = 0;
        while (p < 32) {
          const unsigned ahead = mask >> p;
          if (ahead == 0) break;  // literals as far as the warp sees
          const int first = p + __ffs(ahead) - 1;
          took |= 1u << first;
          p = first + __shfl_sync(0xFFFFFFFFu, len, first);
        }
        // The taken lanes append their records together, in lane order.
        if ((took >> tid) & 1u) {
          const int slot = nrec + __popc(took & ((1u << tid) - 1u));
          s_pos[slot] = static_cast<int>(mine);
          s_meta[slot] = (len << 16) | s_dist[j];
        }
        nrec += __popc(took);
        // Trailing literals end at the view's or the window's end; the
        // last match may carry the walk past either.
        const int64_t seen = at + 32 < end ? at + 32 : end;
        at = at + p > seen ? at + p : seen;
      }
      if (tid == 0) {
        s_next = at;
        s_nrec = nrec;
      }
    }
    __syncthreads();
    const int nrec = s_nrec;
    for (int j = tid; j < nrec; j += kThreads) {
      pos_out[k + j] = s_pos[j];
      meta_out[k + j] = s_meta[j];
    }
    k += nrec;
    i = s_next;
    __syncthreads();  // the next window overwrites the staged arrays
  }
  if (tid == 0) count_out[0] = static_cast<int>(k);
}

}  // namespace

extern "C" int dbg_greedy_walk(const int* best_len, const int* best_dist,
                               int64_t n, int* pos_out, int* meta_out,
                               int* count_out, cudaStream_t stream) {
  greedy_walk_kernel<<<1, kThreads, 0, stream>>>(best_len, best_dist, n,
                                                 pos_out, meta_out, count_out);
  return static_cast<int>(cudaGetLastError());
}
