// LZ77 walk for Hopper: literal runs and matches into the flat output.
//
// Replaces the TPU kernel _walk_kernel_v16 (debigulator_tpu/ops/
// phase_b_v15.py:308).  The TPU kernel keeps one 512 KiB segment at a time
// in VMEM, carries the 32 KiB window between segments, and addresses
// matches with segment-relative exec words; all of that is residency.
// Here the whole output lives in device memory as one flat int32 buffer
// (one byte per element), with the window prologue (`window` elements,
// the caller's tail0) placed just before the body.  Two launches:
//
// (a) run_kernel: every literal run at once, one thread per run record.
//     The run meta is litrow << 14 | lane0 << 7 | len and uses the sign
//     bit, so litrow is read with a logical shift.  Padding records
//     (meta 0) are skipped.
//
// (b) match_kernel: one CTA per independent stream of a merged batch walks
//     that stream's slice [bounds[b], bounds[b+1]) of the dense dst-sorted
//     match list in frontier batches (a DEFLATE match only reads its own
//     stream's output, so the slices do not interact).  Once every literal and stored byte is in place
//     and every match before record s has run, all output below dst[s] is
//     final, so the size8[s] records from s (each with src + len <= dst[s],
//     precomputed in the glue) read only final bytes and write disjoint
//     ranges: one warp per record, then __syncthreads().  size8 == 0 marks
//     an overlapping (dist < len) or wide record, which the whole CTA copies
//     alone with the overlap-exact rule out[d+i] = out[d-dist + i % dist]
//     (every source byte lies below d).  Records are staged in shared
//     memory a tile at a time so the batch hop reads no device memory.
//     Padding records (meta 0) are len-0 no-ops; the list ends at the
//     first dst >= 2^30.
//
// What bounds it on the H100: (a) bytes -- each literal is read once from
// the literal tape and written once.  (b) latency: within a stream the
// batches are serialized by __syncthreads(), so a CTA runs at roughly one
// L2 round trip per batch, and a batch of N streams uses N of 132 SMs.
// A single large stream stays on one SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kRunThreads = 256;
constexpr int kWalkThreads = 256;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kTile = 2048;
constexpr int kGroup = 8;  // the largest size8

__global__ void run_kernel(int* out, int64_t out_len, int64_t window,
                           const int* __restrict__ rdst,
                           const int* __restrict__ rmeta, int64_t n_r,
                           const int* __restrict__ lit, int64_t n_lit) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n_r) return;
  const int meta = rmeta[k];
  if (meta == 0) return;
  const int64_t d = window + rdst[k];
  const int len = meta & 0x7F;
  const int64_t src = static_cast<int64_t>(static_cast<uint32_t>(meta) >> 14) * 128 +
                      ((meta >> 7) & 0x7F);
  for (int i = 0; i < len; ++i) {
    if (d + i < out_len && src + i < n_lit) out[d + i] = lit[src + i];
  }
}

__global__ void __launch_bounds__(kWalkThreads)
match_kernel(int* out, int64_t out_len, int64_t window,
             const int* __restrict__ mdst, const int* __restrict__ mmeta,
             const int* __restrict__ size8,
             const int64_t* __restrict__ bounds) {
  __shared__ int s_dst[kTile + kGroup];
  __shared__ int s_meta[kTile + kGroup];
  __shared__ int s_size[kTile + kGroup];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int64_t s = bounds[blockIdx.x];
  const int64_t n_m = bounds[blockIdx.x + 1];
  while (s < n_m) {
    // Stage records [s, s + kTile + kGroup): a batch starting below
    // s + kTile reads at most kGroup - 1 records past it.
    const int64_t t0 = s;
    for (int i = tid; i < kTile + kGroup; i += kWalkThreads) {
      const int64_t k = t0 + i;
      const bool in = k < n_m;
      s_dst[i] = in ? mdst[k] : kBig;
      s_meta[i] = in ? mmeta[k] : 0;
      s_size[i] = in ? size8[k] : 1;
    }
    __syncthreads();
    bool done = false;
    while (s < t0 + kTile) {
      const int j = static_cast<int>(s - t0);
      const int d0 = s_dst[j];
      if (d0 >= kBig) {
        done = true;
        break;
      }
      const int sz = s_size[j];
      if (sz > 0) {
        if (warp < sz) {
          const int meta = s_meta[j + warp];
          const int len = meta >> 16;
          const int64_t d = window + s_dst[j + warp];
          const int64_t src = d - (meta & 0xFFFF);
          for (int i = lane; i < len; i += 32) {
            if (d + i < out_len && src + i >= 0) out[d + i] = out[src + i];
          }
        }
        s += sz;
      } else {
        const int meta = s_meta[j];
        const int len = meta >> 16;
        const int dist = meta & 0xFFFF;
        const int64_t d = window + d0;
        if (dist > 0) {
          for (int i = tid; i < len; i += kWalkThreads) {
            const int64_t src = d - dist + (i % dist);
            if (d + i < out_len && src >= 0) out[d + i] = out[src];
          }
        }
        s += 1;
      }
      __syncthreads();
    }
    if (done) break;
    __syncthreads();  // the next tile overwrites the staged records
  }
}

}  // namespace

extern "C" int dbg_walk(int* out, int64_t out_len, int64_t window,
                        const int* mdst, const int* mmeta, const int* size8,
                        const int64_t* bounds, int n_streams, const int* rdst,
                        const int* rmeta, int64_t n_r, const int* lit,
                        int64_t n_lit, cudaStream_t stream) {
  if (n_r > 0) {
    const int64_t blocks = (n_r + kRunThreads - 1) / kRunThreads;
    run_kernel<<<static_cast<unsigned>(blocks), kRunThreads, 0, stream>>>(
        out, out_len, window, rdst, rmeta, n_r, lit, n_lit);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_streams > 0) {
    match_kernel<<<n_streams, kWalkThreads, 0, stream>>>(
        out, out_len, window, mdst, mmeta, size8, bounds);
  }
  return static_cast<int>(cudaGetLastError());
}
