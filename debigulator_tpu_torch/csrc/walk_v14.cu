// v14 dense-list walk for Hopper: literal runs, then matches in stream
// order, over one body.
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
// buffer holds the whole body and memory is byte addressable:
//  (a) runs_kernel, a thread per run: runs read no output, so any order;
//  (b) the matches, which the wrapper splits into ranges that share no
//      byte (the streams of a batch at least), clipped and walked in
//      stream order, a warp per 8, one CTA per range (lz77_chunks.cu).
//      A warp copies a match byte by byte from below its destination, so
//      the overlapping (dist < len) case needs no doubling and the clean
//      bit is not read.
//
// What bounds it on the H100: (a) bytes; (b) latency (lz77_copy.cuh).

#include <cstdint>
#include <cuda_runtime.h>

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
