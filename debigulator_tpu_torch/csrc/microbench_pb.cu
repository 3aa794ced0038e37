// The piece-loop microbenchmark for Hopper: the v12 narrow-piece group
// loop under variants that drop parts of its work, to see what a piece
// costs.
//
// Replaces the TPU kernel _kernel of tools/microbench_pb.py (:31).  Piece
// t is two words: w0 = dst_row << 16 | rp << 8 | (rp + len) and w1 =
// q_row << 16 | r << 8 | (128 - r), q = q_row * 128 + r the first byte of
// a 128-byte source window whose byte L goes to dst_row * 128 + L for L in
// [rp, rp + len).  The TPU kernel DMAs stage_rows rows of both word arrays
// into SMEM per stage, then walks the stage's groups of 8 in order, each
// group issuing its 8 loads (2 rows, a lane roll and a row select) before
// its 8 masked one-row stores.
//
// Here one CTA runs the pieces in stages: its threads stage stage_rows *
// 128 pieces into shared memory, then one warp walks the stage's groups
// in order with the same semantics (all loads of a group, __syncwarp(),
// then the stores in slot order).  A staged piece is w0 and the 16-bit
// distance dst_row * 128 - q (6 bytes; the packing makes w1 a function of
// the two), so 256 staged rows fit the 227 KB a block may hold (8 bytes a
// piece would need 256 KB).  A source byte outside the buffer reads as 0.
// Variants:
//   full        loads, then masked stores (the group loop itself);
//   load_only   the 8 windows summed lane by lane into row 8;
//   store_only  zeros stored under each piece's mask;
//   scalar_only the words unpacked and summed, the sum stored across row 8;
//   scalar_smem the same sum kept in shared memory, nothing stored;
//   noop        the loop with an empty body;
//   nodma       full, but the stage is never filled (undefined output).
// An unroll factor (unrollN, noop8) walks that many groups per iteration.
//
// What bounds it on the H100: latency.  One warp walks every group, and a
// group's loads wait for the stores before them (about one L2 round trip
// per group).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;
constexpr int kThreads = 256;
constexpr int kAccRow = 8;

enum Variant {
  kFull = 0,
  kLoadOnly = 1,
  kStoreOnly = 2,
  kScalarOnly = 3,
  kScalarSmem = 4,
  kNoop = 5,
  kNodma = 6,
};

__device__ __forceinline__ unsigned w1_of(int w0, int dist) {
  const int q = (w0 >> 16) * 128 - dist;
  const int r = q & 127;
  return (static_cast<unsigned>(q >> 7) << 16) | (r << 8) | (128 - r);
}

template <int V>
__device__ __forceinline__ void group(int* out, int64_t n_out,
                                      const int* s_w0,
                                      const unsigned short* s_dist, int i0,
                                      int lane, volatile int* acc_s) {
  if (V == kNoop) return;
  if (V == kScalarSmem || V == kScalarOnly) {
    unsigned t = 0;
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      t += static_cast<unsigned>(s_w0[i0 + g]) + w1_of(s_w0[i0 + g],
                                                       s_dist[i0 + g]);
    if (V == kScalarSmem) {
      if (lane == 0) *acc_s = static_cast<int>(t);
    } else {
      for (int L = lane; L < 128; L += 32)
        out[kAccRow * 128 + L] = static_cast<int>(t);
      __syncwarp();
    }
    return;
  }
  int v[kGroup][4];
  if (V != kStoreOnly) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int w0 = s_w0[i0 + g];
      const int64_t q = static_cast<int64_t>(w0 >> 16) * 128 - s_dist[i0 + g];
      const int rp = (w0 >> 8) & 127, hi = w0 & 255;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int L = lane + 32 * k;
        const int64_t s = q + L;
        const bool need = V == kLoadOnly || (L >= rp && L < hi);
        v[g][k] = (need && s >= 0 && s < n_out) ? out[s] : 0;
      }
    }
    __syncwarp();
  }
  if (V == kLoadOnly) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned a = 0;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) a += static_cast<unsigned>(v[g][k]);
      out[kAccRow * 128 + lane + 32 * k] = static_cast<int>(a);
    }
    __syncwarp();
    return;
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int w0 = s_w0[i0 + g];
    const int64_t base = static_cast<int64_t>(w0 >> 16) * 128;
    const int rp = (w0 >> 8) & 127, hi = w0 & 255;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int L = lane + 32 * k;
      if (L >= rp && L < hi && base + L >= 0 && base + L < n_out)
        out[base + L] = V == kStoreOnly ? 0 : v[g][k];
    }
    __syncwarp();  // a later piece's store to the same byte wins
  }
}

template <int V, int U>
__global__ void __launch_bounds__(kThreads)
microbench_kernel(int* out, int64_t n_out, const int* __restrict__ w0,
                  const int* __restrict__ w1, int n_stages, int stage_rows) {
  extern __shared__ int s_w0[];
  __shared__ int acc_s;
  const int per_stage = stage_rows * 128;
  unsigned short* s_dist = reinterpret_cast<unsigned short*>(s_w0 + per_stage);
  const int lane = threadIdx.x & 31;
  for (int st = 0; st < n_stages; ++st) {
    if (V != kNodma) {
      for (int j = threadIdx.x; j < per_stage; j += kThreads) {
        const int64_t t = static_cast<int64_t>(st) * per_stage + j;
        const int a = w0[t], b = w1[t];
        s_w0[j] = a;
        s_dist[j] = static_cast<unsigned short>(
            (a >> 16) * 128 - ((b >> 16) * 128 + ((b >> 8) & 127)));
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      constexpr int W = V == kNodma ? kFull : V;
      for (int gi = 0; gi < per_stage / kGroup; gi += U) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          group<W>(out, n_out, s_w0, s_dist, (gi + u) * kGroup, lane, &acc_s);
      }
    }
    __syncthreads();
  }
}

template <int V, int U>
int launch(int* out, int64_t n_out, const int* w0, const int* w1,
           int n_stages, int stage_rows, cudaStream_t stream) {
  const int smem = stage_rows * 128 * (4 + 2);
  cudaError_t err = cudaFuncSetAttribute(
      microbench_kernel<V, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  microbench_kernel<V, U><<<1, kThreads, smem, stream>>>(
      out, n_out, w0, w1, n_stages, stage_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: the Variant codes above; unroll: 1, 2, 4 or 8 (full and noop),
// 1 otherwise.  Returns cudaErrorInvalidValue for any other pair.
extern "C" int dbg_microbench_pb(int* out, int64_t n_out, const int* w0,
                                 const int* w1, int n_stages, int stage_rows,
                                 int variant, int unroll,
                                 cudaStream_t stream) {
  if (n_stages <= 0) return static_cast<int>(cudaGetLastError());
#define MB_CASE(v, u)                                                     \
  if (variant == v && unroll == u)                                        \
    return launch<v, u>(out, n_out, w0, w1, n_stages, stage_rows, stream);
  MB_CASE(kFull, 1)
  MB_CASE(kFull, 2)
  MB_CASE(kFull, 4)
  MB_CASE(kFull, 8)
  MB_CASE(kLoadOnly, 1)
  MB_CASE(kStoreOnly, 1)
  MB_CASE(kScalarOnly, 1)
  MB_CASE(kScalarSmem, 1)
  MB_CASE(kNoop, 1)
  MB_CASE(kNoop, 8)
  MB_CASE(kNodma, 1)
#undef MB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
