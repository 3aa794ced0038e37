// v13 op resolver for Hopper: one segment of Phase B from Phase A's match,
// run and literal tapes.
//
// Replaces the TPU kernel _op_kernel_v13 (debigulator_tpu/ops/
// lz77_pallas.py:581).  All tapes are cell-major, `slots` records a cell:
// ma = within-cell output offset of a match, mb = len << 16 | dist; ra =
// offset of a literal run, rb = lit0 << 16 | run_len, the run's bytes
// being lit[cell * slots + lit0 ...]; cnt = match_count << 16 | run_count
// << 8 | lit_count.  Cell c's first byte lands at cbase[c] + base_adj, and
// stores are clipped to the body [body_start, body_end).
//
// Two launches:
//  (a) place_kernel, a thread per cell: copies the cell's runs from its
//      lit row (values as they are, no mask) and lists its matches, head-
//      and tail-clipped, with their count, the highest and lowest source
//      bytes they read and the cell's first position.  Runs read no output, so the
//      cells run in any order.
//  (b) lz77::walk_cells_kernel: the matches in stream order, one CTA per
//      independent range of cells (the wrapper finds the ranges between
//      the launches).
//
// What bounds it on the H100: (a) bytes, the records and literals read
// once and one int32 written per literal; (b) latency (lz77_copy.cuh).

#include "lz77_copy.cuh"

namespace {

constexpr int kBodyStart = 128 + 32768;

__global__ void place_kernel(int* out, int body_end,
                             const int* __restrict__ ma,
                             const int* __restrict__ mb,
                             const int* __restrict__ ra,
                             const int* __restrict__ rb,
                             const int* __restrict__ lit, int64_t n_lit,
                             const int* __restrict__ cnt,
                             const int* __restrict__ cbase, int cell_lo,
                             int n_cells, int base_adj, int slots,
                             int* __restrict__ mpos, int* __restrict__ mmeta,
                             int* __restrict__ kc, int* __restrict__ rmax,
                             int* __restrict__ rmin, int* __restrict__ thr) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int cell = cell_lo + c;
  const int packed = cnt[cell];
  const int n_match = min(packed >> 16, slots);
  const int n_run = min((packed >> 8) & 0xFF, slots);
  const int64_t rec = static_cast<int64_t>(cell) * slots;
  const int64_t at = static_cast<int64_t>(c) * slots;
  const int cb = cbase[cell] + base_adj;
  thr[c] = cb;

  for (int j = 0; j < n_run; ++j) {
    const int dst = cb + ra[rec + j];
    const int b = rb[rec + j];
    const int64_t src = rec + (b >> 16);
    const int len = b & 0xFFFF;
    for (int i = 0; i < len; ++i) {
      const int p = dst + i;
      if (p >= kBodyStart && p < body_end && src + i < n_lit)
        out[p] = lit[src + i];
    }
  }

  int k = 0;
  int hi = INT_MIN;
  int lo = INT_MAX;
  for (int j = 0; j < n_match; ++j) {
    int dst = cb + ma[rec + j];
    const int b = mb[rec + j];
    const int dist = b & 0xFFFF;
    const int eff = lz77::clip_match(&dst, b >> 16, kBodyStart, body_end);
    if (eff > 0) {
      mpos[at + k] = dst;
      mmeta[at + k] = (eff << 16) | dist;
      hi = max(hi, dst - dist + min(eff, dist));
      lo = min(lo, dst - dist);
      ++k;
    }
  }
  kc[c] = k;
  rmax[c] = hi;
  rmin[c] = lo;
}

}  // namespace

extern "C" int dbg_lz77_ops_place(int* out, int body_end, const int* ma,
                                  const int* mb, const int* ra, const int* rb,
                                  const int* lit, int64_t n_lit, const int* cnt,
                                  const int* cbase, int cell_lo, int n_cells,
                                  int base_adj, int slots, int* mpos,
                                  int* mmeta, int* kc, int* rmax, int* rmin,
                                  int* thr, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n_cells + threads - 1) / threads;
  place_kernel<<<blocks, threads, 0, stream>>>(
      out, body_end, ma, mb, ra, rb, lit, n_lit, cnt, cbase, cell_lo, n_cells,
      base_adj, slots, mpos, mmeta, kc, rmax, rmin, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dbg_lz77_ops_walk(int* out, int body_end, const int* mpos,
                                 const int* mmeta, const int* kc,
                                 const int* rmax, const int* thr,
                                 const int64_t* bounds, int n_ranges,
                                 int slots, cudaStream_t stream) {
  return lz77::launch_walk_cells(out, body_end, mpos, mmeta, kc, rmax, thr,
                                 bounds, n_ranges, slots, stream);
}
