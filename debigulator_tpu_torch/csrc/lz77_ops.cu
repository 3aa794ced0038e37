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
// Two entries, no read-back between them:
//  (a) place_kernel (dbg_lz77_ops_place), a thread per cell: copies the
//      cell's runs from its lit row (values as they are, no mask) and
//      lists its matches, head- and tail-clipped (lz77::clip_match), with
//      their count.  Runs read no output, so the cells run in any order.
//  (b) chase::launch_cells (dbg_lz77_ops_chase, chase.cuh), as in
//      lz77_tape.cu: after the prefix sum of the counts, the bitmap
//      zeroed, a pointer for every match byte, the grid-wide chase over
//      the body.
//
// Where it could go wrong, and what the design does (as lz77_tape.cu):
// the per-cell lists' padding is never read and their records spread
// evenly over the warps; literal values are stored unmasked and the
// caller's buffer may hold any int32, so pointers live in a side array of
// states flagged by a bitmap, never in the buffer, and a chase
// follows a pointer only while it moves down; a segment's window prologue
// lies outside the bitmap and is final, and the pad and slack rows are
// never stored.
//
// What bounds it on the H100: (a) bytes, the records and literals read
// once and one int32 written per literal; (b) bytes and latency
// (chase.cuh).

#include "chase.cuh"
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
                             int* __restrict__ kc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int cell = cell_lo + c;
  const int packed = cnt[cell];
  const int n_match = min(packed >> 16, slots);
  const int n_run = min((packed >> 8) & 0xFF, slots);
  const int64_t rec = static_cast<int64_t>(cell) * slots;
  const int64_t at = static_cast<int64_t>(c) * slots;
  const int cb = cbase[cell] + base_adj;

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
  for (int j = 0; j < n_match; ++j) {
    int dst = cb + ma[rec + j];
    const int b = mb[rec + j];
    const int dist = b & 0xFFFF;
    const int eff = lz77::clip_match(&dst, b >> 16, kBodyStart, body_end);
    if (eff > 0) {
      mpos[at + k] = dst;
      mmeta[at + k] = (eff << 16) | dist;
      ++k;
    }
  }
  kc[c] = k;
}

}  // namespace

extern "C" int dbg_lz77_ops_place(int* out, int body_end, const int* ma,
                                  const int* mb, const int* ra, const int* rb,
                                  const int* lit, int64_t n_lit, const int* cnt,
                                  const int* cbase, int cell_lo, int n_cells,
                                  int base_adj, int slots, int* mpos,
                                  int* mmeta, int* kc, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n_cells + threads - 1) / threads;
  place_kernel<<<blocks, threads, 0, stream>>>(
      out, body_end, ma, mb, ra, rb, lit, n_lit, cnt, cbase, cell_lo, n_cells,
      base_adj, slots, mpos, mmeta, kc);
  return static_cast<int>(cudaGetLastError());
}

// kinc: inclusive prefix sums of kc.  state: a 64-bit word per body byte
// (body_end - PAD - WINDOW), bits: a bit per body byte, rounded up to whole
// 32-bit words; both scratch.
extern "C" int dbg_lz77_ops_chase(int* out, int body_end, const int* mpos,
                                  const int* mmeta, const int* kinc,
                                  int n_cells, int slots,
                                  unsigned long long* state, unsigned* bits,
                                  cudaStream_t stream) {
  return chase::launch_cells(out, kBodyStart, body_end, mpos, mmeta, kinc,
                             n_cells, slots, state, bits, stream);
}
