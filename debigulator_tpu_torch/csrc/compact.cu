// Compact for Hopper: per-cell padded match / run tapes -> dense,
// dst-sorted record lists in 128-record-aligned chunk regions.
//
// Replaces the TPU kernel _compact_kernel (debigulator_tpu/ops/
// phase_b_v15.py:126).  The TPU grid walks the chunks in order, carries
// the running max of valid dst in SMEM (lastd_ref) and lets each chunk's
// fixed-size flush overrun into the next chunk's region, relying on the
// serialized DMAs to overwrite it.  Blocks on the H100 run in parallel and
// in no order, so the carry is a prefix max computed before the launch
// (`fill`, one value per chunk) and every chunk writes exactly its own
// region [base, end) (the last chunk's end includes the reference's
// cap_rows tail fill).
//
// Layout: one CTA per (chunk, list): blockIdx.x = chunk, blockIdx.y = 0 for
// matches and 1 for runs.  The CTA streams its chunk's records in
// 1024-record tiles; a record is valid when its meta != 0; a warp ballot
// plus a scan of the 32 warp counts in shared memory gives each valid
// record its rank, and it is stored at base*128 + running + rank.  After
// the last tile the CTA fills [base*128 + n_valid, end*128) with
// (fill[chunk], meta 0).
//
// What bounds it on the H100: bytes -- every tape record is read once and
// every dense record of the regions written once; the scan costs a few
// shared-memory round trips per 1024 records.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void compact_kernel(const int* __restrict__ dm,
                               const int* __restrict__ mm,
                               const int* __restrict__ dr,
                               const int* __restrict__ mr,
                               const int* __restrict__ mbase,
                               const int* __restrict__ rbase,
                               const int* __restrict__ mend,
                               const int* __restrict__ rend,
                               const int* __restrict__ mfill,
                               const int* __restrict__ rfill, int per_chunk,
                               int* __restrict__ odm, int* __restrict__ omm,
                               int* __restrict__ odr, int* __restrict__ omr) {
  __shared__ int warp_tot[kWarps];
  __shared__ int warp_off[kWarps + 1];
  const int chunk = blockIdx.x;
  const bool runs = blockIdx.y == 1;
  const int* __restrict__ dst = runs ? dr : dm;
  const int* __restrict__ meta = runs ? mr : mm;
  int* __restrict__ odst = runs ? odr : odm;
  int* __restrict__ ometa = runs ? omr : omm;
  const int64_t base = static_cast<int64_t>(runs ? rbase[chunk] : mbase[chunk]) * 128;
  const int64_t end = static_cast<int64_t>(runs ? rend[chunk] : mend[chunk]) * 128;
  const int fill = runs ? rfill[chunk] : mfill[chunk];
  const int64_t in0 = static_cast<int64_t>(chunk) * per_chunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int64_t running = 0;
  for (int t0 = 0; t0 < per_chunk; t0 += kThreads) {
    const int k = t0 + threadIdx.x;
    int d = 0, m = 0;
    if (k < per_chunk) {
      d = dst[in0 + k];
      m = meta[in0 + k];
    }
    const bool valid = k < per_chunk && m != 0;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, valid);
    const int in_warp = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int v = warp_tot[lane];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += u;
      }
      warp_off[lane] = incl - v;
      if (lane == 31) warp_off[kWarps] = incl;
    }
    __syncthreads();
    if (valid) {
      const int64_t at = base + running + warp_off[warp] + in_warp;
      odst[at] = d;
      ometa[at] = m;
    }
    running += warp_off[kWarps];
    __syncthreads();  // warp_tot / warp_off are rewritten by the next tile
  }
  for (int64_t at = base + running + threadIdx.x; at < end; at += kThreads) {
    odst[at] = fill;
    ometa[at] = 0;
  }
}

}  // namespace

extern "C" int dbg_compact(const int* dm, const int* mm, const int* dr,
                           const int* mr, const int* mbase, const int* rbase,
                           const int* mend, const int* rend, const int* mfill,
                           const int* rfill, int n_chunks, int per_chunk,
                           int* odm, int* omm, int* odr, int* omr,
                           cudaStream_t stream) {
  if (n_chunks > 0) {
    compact_kernel<<<dim3(n_chunks, 2), kThreads, 0, stream>>>(
        dm, mm, dr, mr, mbase, rbase, mend, rend, mfill, rfill, per_chunk,
        odm, omm, odr, omr);
  }
  return static_cast<int>(cudaGetLastError());
}
