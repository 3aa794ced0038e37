// v14 compaction for Hopper: every cell's match, run and literal records
// to precomputed dense offsets, in one pass.
//
// Replaces the TPU kernel _compact_kernel_v14 (debigulator_tpu/ops/
// archive/lz77_generations.py:893).  The TPU kernel DMAs 512-cell chunks
// into VMEM and, cell after cell, rolls the cell's records to its dense
// offset and stores two masked rows.  The offsets are exclusive prefix
// sums computed before the launch, so no cell depends on another: here a
// thread per (cell, slot) copies its record, if the slot is below the
// cell's count, to the cell's offset plus the slot.  Records are
// cell-major (record j of cell c at c * slots + j), so a warp reads 128
// contiguous bytes of each list.  The outputs are zeroed by the wrapper;
// writes past an output's end are dropped.
//
// What bounds it on the H100: bytes, the records and counts read once and
// every valid record written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void compact_kernel(const int* __restrict__ ma,
                               const int* __restrict__ mb,
                               const int* __restrict__ ra,
                               const int* __restrict__ rb,
                               const int* __restrict__ lit,
                               const int* __restrict__ cnt,
                               const int* __restrict__ moff,
                               const int* __restrict__ roff,
                               const int* __restrict__ loff, int n_cells,
                               int slots, int* __restrict__ mdst,
                               int* __restrict__ mmeta, int* __restrict__ rdst,
                               int* __restrict__ rmeta, int64_t n_out,
                               int* __restrict__ lit_out, int64_t n_lit_out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(n_cells) * slots) return;
  const int cell = static_cast<int>(t / slots);
  const int j = static_cast<int>(t % slots);
  const int packed = cnt[cell];
  // A count past `slots` (an overflowed tape) is read as `slots`.
  if (j < min(packed >> 16, slots)) {
    const int64_t at = static_cast<int64_t>(moff[cell]) + j;
    if (at >= 0 && at < n_out) {
      mdst[at] = ma[t];
      mmeta[at] = mb[t];
    }
  }
  if (j < min((packed >> 8) & 0xFF, slots)) {
    const int64_t at = static_cast<int64_t>(roff[cell]) + j;
    if (at >= 0 && at < n_out) {
      rdst[at] = ra[t];
      rmeta[at] = rb[t];
    }
  }
  if (j < min(packed & 0xFF, slots)) {
    const int64_t at = static_cast<int64_t>(loff[cell]) + j;
    if (at >= 0 && at < n_lit_out) lit_out[at] = lit[t];
  }
}

}  // namespace

extern "C" int dbg_compact_v14(const int* ma, const int* mb, const int* ra,
                               const int* rb, const int* lit, const int* cnt,
                               const int* moff, const int* roff,
                               const int* loff, int n_cells, int slots,
                               int* mdst, int* mmeta, int* rdst, int* rmeta,
                               int64_t n_out, int* lit_out, int64_t n_lit_out,
                               cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(n_cells) * slots;
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    compact_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        ma, mb, ra, rb, lit, cnt, moff, roff, loff, n_cells, slots, mdst,
        mmeta, rdst, rmeta, n_out, lit_out, n_lit_out);
  }
  return static_cast<int>(cudaGetLastError());
}
