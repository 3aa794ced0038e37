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
//     copies (the overlap rule out[d+i] = out[d-dist + i % dist]; s < d + i
//     always).  So after (a) and (b) a value >= 0 is final (window,
//     stored, literal or untouched byte) and a value < 0 names the byte to
//     copy.  A persistent grid of warps takes 32 records at a time, one a
//     lane, and spreads their bytes over the lanes (a prefix sum of the
//     lengths, and a binary search by shuffles for each byte's record), so
//     every lane stores and neighbouring lanes store neighbouring bytes.
//     Padding records (len 0) and dist 0 are no-ops; the list ends at the
//     first dst >= 2^30 (compact's tail, most of the dense list, is never
//     read past its first group); a byte at or past out_len, or whose
//     source would lie below 0, is left as it was.
//
// (c) chase_kernel: a thread per kChase output elements, their chases
//     interleaved so that each round's loads are in flight together.
//     While an element's value is a pointer the thread follows it; the
//     first value >= 0 is the root's byte, which it stores into the
//     element.  Only an element's owner ever stores into it, so there is
//     no race to lose: between hops the owner also publishes how far it
//     got (the pointer it holds now, still on the same chain), so a chase
//     that reads that element jumps as far.
//     Chasers that run together thus do pointer jumping among themselves
//     (a chain of depth D shrinks in about log2 D rounds), and a byte whose
//     source was already resolved, by an earlier block or by its owner,
//     stops after one hop.  Every hop moves strictly downwards, so each
//     chase ends whatever the order of blocks; nothing waits on another
//     block.
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

namespace {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChase = 8;  // elements a chase thread
constexpr int kPointerBlocks = 132 * 8;  // a persistent grid
constexpr unsigned kFull = 0xFFFFFFFFu;

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
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       g * 32 < n_m; g += warps) {
    // 32 records a lane each, then their bytes flattened over the lanes.
    const int64_t k = g * 32 + lane;
    const int dst = k < n_m ? mdst[k] : kBig;
    const int meta = k < n_m ? mmeta[k] : 0;
    if (__all_sync(kFull, dst >= kBig)) break;  // the list has ended
    const int dist = meta & 0xFFFF;
    const int len = dst < kBig && dist != 0 && meta > 0 ? meta >> 16 : 0;
    int incl = len;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    const int excl = incl - len;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int b = 0; b < total; b += 32) {
      const int q = b + lane;
      int r = 0;  // the last record whose bytes start at or before q
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFull, excl, r + step) <= q) r += step;
      }
      const int i = q - __shfl_sync(kFull, excl, r);
      const int64_t d = window + __shfl_sync(kFull, dst, r);
      const int rd = __shfl_sync(kFull, dist, r);
      if (q < total) {
        const int64_t s = d - rd + i % rd;
        if (d + i < out_len && s >= 0) out[d + i] = static_cast<int>(-(s + 1));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
chase_kernel(int* out, int64_t out_len, int64_t window) {
  // kChase elements a thread, kThreads apart: their chases advance in
  // rounds, each round's loads issued together.
  const int64_t j0 = window + static_cast<int64_t>(blockIdx.x) * kThreads * kChase +
                     threadIdx.x;
  int v[kChase];
  bool pending = false;
#pragma unroll
  for (int c = 0; c < kChase; ++c) {
    const int64_t j = j0 + c * kThreads;
    v[c] = j < out_len ? out[j] : 0;
    pending |= v[c] < 0;
  }
  while (pending) {
    int w[kChase];
#pragma unroll
    for (int c = 0; c < kChase; ++c) {
      w[c] = v[c] < 0 ? __ldcg(out + (-static_cast<int64_t>(v[c]) - 1)) : v[c];
    }
    pending = false;
#pragma unroll
    for (int c = 0; c < kChase; ++c) {
      if (v[c] < 0) {
        // The root's byte, or a shorter pointer on the same chain.
        __stcg(out + j0 + c * kThreads, w[c]);
        pending |= w[c] < 0;
      }
      v[c] = w[c];
    }
  }
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
