// LZ77 walk for Hopper: literal runs and matches into the flat output, as a
// grid-wide source chase.
//
// Replaces the TPU kernel _walk_kernel_v16 (debigulator_tpu/ops/
// phase_b_v15.py:308).  The TPU kernel keeps one 512 KiB segment at a time
// in VMEM, carries the 32 KiB window between segments, and walks the
// dst-sorted match list in frontier batches; all of that is residency and
// order.  Here the whole output lives in device memory as one flat int32
// buffer (one byte per element, every value 0..255), with the window
// prologue (`window` elements, the caller's tail0) placed just before the
// body.  Three launches, none of which depends on the order in which
// blocks run:
//
// (a) run_kernel: every literal run at once, one thread per run record.
//     The run meta is litrow << 14 | lane0 << 7 | len and uses the sign
//     bit, so litrow is read with a logical shift.  Padding records
//     (meta 0) are skipped.
//
// (b) pointer_kernel: every byte of every match record (dst, len << 16 |
//     dist) gets -(s + 1), where s = d - dist + i % dist is the byte it
//     copies, in place (chase.cuh's `InPlaceStore`).  So after (a) and (b)
//     a value >= 0 is final (window, stored, literal or untouched byte)
//     and a value < 0 names the byte to copy.  A persistent grid of warps
//     takes 32 records at a time and spreads their bytes over the lanes
//     (chase.cuh's `spread_bytes`).  Padding records (len 0) and dist 0
//     are no-ops; the list ends at the first dst >= 2^30 (compact's tail,
//     most of the dense list, is never read past its first group); a byte
//     at or past out_len, or whose source would lie below 0, is left as it
//     was.
//
// (c) chase_kernel: a thread per kChase output elements, chasing each
//     pointer to its root's byte with owner-only stores and the owner's
//     shorter pointer published between hops (chase.cuh's
//     `chase_elements` over `InPlaceChain`).  Every hop moves strictly
//     downwards, so each chase ends whatever the order of blocks.
//
// What bounds it on the H100: bytes and latency, across all 132 SMs.  (a)
// reads each literal once and writes it once; (b) reads each record once
// and writes each match byte once; (c) reads each element once and, per
// match byte, its source (within 32 KiB below it, mostly L2 hits) and
// writes the result.  The dependent part is the chase itself: a byte's
// chain of copies is usually 1-3 hops deep (text, images), at most a few
// rounds of L2 latency.  The deep chains (a zero run coded as dist-1
// matches: one hop per 258 bytes) shrink by the publication above.  Nothing
// here knows where a stream starts: a DEFLATE match reads only its own
// stream, so a merged batch resolves as one and a single large stream
// spreads over the whole card instead of one SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "chase.cuh"

namespace {

using chase::kChase;
using chase::kFull;
using chase::kPointerBlocks;
using chase::kThreads;
using chase::kWarps;

constexpr int kBig = 1 << 30;

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

__global__ void __launch_bounds__(kThreads)
pointer_kernel(int* __restrict__ out, int64_t out_len, int64_t window,
               const int* __restrict__ mdst, const int* __restrict__ mmeta,
               int64_t n_m) {
  const int lane = threadIdx.x & 31;
  const chase::InPlaceStore store{out};
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       g * 32 < n_m; g += warps) {
    const int64_t k = g * 32 + lane;
    const int dst = k < n_m ? mdst[k] : kBig;
    const int meta = k < n_m ? mmeta[k] : 0;
    if (__all_sync(kFull, dst >= kBig)) break;  // the list has ended
    const int dist = meta & 0xFFFF;
    const int len = dst < kBig && dist != 0 && meta > 0 ? meta >> 16 : 0;
    chase::spread_bytes(lane, window, dst, len, dist, out_len, store);
  }
}

__global__ void __launch_bounds__(kThreads)
chase_kernel(int* out, int64_t out_len, int64_t window) {
  const int64_t j0 = window + static_cast<int64_t>(blockIdx.x) * kThreads * kChase +
                     threadIdx.x;
  chase::chase_elements(chase::InPlaceChain{out}, j0, out_len);
}

}  // namespace

// out: out_len int32 values >= 0 (window prologue, then the body with the
// stored bytes placed).  mdst/mmeta: n_m match records; rdst/rmeta: n_r
// literal-run records over the n_lit-value literal tape.
extern "C" int dbg_walk(int* out, int64_t out_len, int64_t window,
                        const int* mdst, const int* mmeta, int64_t n_m,
                        const int* rdst, const int* rmeta, int64_t n_r,
                        const int* lit, int64_t n_lit, cudaStream_t stream) {
  if (n_r > 0) {
    const int64_t blocks = (n_r + kThreads - 1) / kThreads;
    run_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        out, out_len, window, rdst, rmeta, n_r, lit, n_lit);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_m > 0) {
    int64_t blocks = (n_m + 32 * kWarps - 1) / (32 * kWarps);
    if (blocks > kPointerBlocks) blocks = kPointerBlocks;
    pointer_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        out, out_len, window, mdst, mmeta, n_m);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_m > 0 && out_len > window) {
    const int64_t per = static_cast<int64_t>(kThreads) * kChase;
    const int64_t blocks = (out_len - window + per - 1) / per;
    chase_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        out, out_len, window);
  }
  return static_cast<int>(cudaGetLastError());
}
