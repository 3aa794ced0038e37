// v6 tape resolver for Hopper: one segment of Phase B from the token tape.
//
// Replaces the TPU kernel _tape_kernel_v6 (debigulator_tpu/ops/
// lz77_pallas.py:317).  The tape is cell-major, `slots` tokens a cell: a
// literal byte, or 1 << 30 | len << 16 | dist.  Cell c's first byte lands
// at buffer position cbase[c] + base_adj (base_adj = PAD + WINDOW -
// seg_off), and stores are clipped to the body [body_start, body_end).
//
// Two launches:
//  (a) place_kernel, a thread per cell of [cell_lo, cell_lo + n_cells):
//      walks the cell's tokens, stores its literals (masked with 0x1FF as
//      the reference does), and writes the cell's matches, head- and
//      tail-clipped, to a per-cell list with their count, the highest
//      source byte they read and the cell's first position.  Literals read
//      no output, so the cells run in any order.
//  (b) lz77::walk_cells_kernel: the matches in stream order, one CTA per
//      independent range of cells (the wrapper finds the ranges between
//      the launches).
//
// What bounds it on the H100: (a) bytes, 4 * slots + 8 read per cell and
// one int32 written per literal; (b) latency (lz77_copy.cuh).
//
// The same file holds the first tape resolver (v1), replacing the TPU
// kernel _lz77_kernel (debigulator_tpu/ops/archive/lz77_generations.py:49)
// as the reference's resolve_tape_pallas drives it: a per-token walk of
// the tape, chained launches of at most 8192 cells with a 32 KiB window
// carried between them.  Here one pass covers the whole tape: (v1a)
// tape_v1_len_kernel, a thread per cell, sums the cell's token lengths;
// the wrapper's exclusive prefix sum gives each cell's first byte; then
// (a) and (b) above run over the whole tape with a zero window before it.
// (v1a) is bound by bytes, the tape read once.

#include "lz77_copy.cuh"

namespace {

constexpr int kBodyStart = 128 + 32768;
constexpr int kMatchBit = 1 << 30;

__global__ void place_kernel(int* out, int body_end,
                             const int* __restrict__ tape,
                             const int* __restrict__ counts,
                             const int* __restrict__ cbase, int cell_lo,
                             int n_cells, int base_adj, int slots,
                             int* __restrict__ mpos, int* __restrict__ mmeta,
                             int* __restrict__ kc, int* __restrict__ rmax,
                             int* __restrict__ rmin, int* __restrict__ thr) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int cell = cell_lo + c;
  const int cnt = min(counts[cell], slots);
  const int* __restrict__ row = tape + static_cast<int64_t>(cell) * slots;
  const int64_t at = static_cast<int64_t>(c) * slots;
  int cur = cbase[cell] + base_adj;
  thr[c] = cur;
  int k = 0;
  int hi = INT_MIN;
  int lo = INT_MAX;
  for (int j = 0; j < cnt; ++j) {
    const int tok = row[j];
    if (tok >= kMatchBit) {
      const int len = (tok >> 16) & 0x3FFF;
      const int dist = tok & 0xFFFF;
      int dst = cur;
      const int eff = lz77::clip_match(&dst, len, kBodyStart, body_end);
      if (eff > 0) {
        mpos[at + k] = dst;
        mmeta[at + k] = (eff << 16) | dist;
        hi = max(hi, dst - dist + min(eff, dist));
        lo = min(lo, dst - dist);
        ++k;
      }
      cur += len;
    } else {
      if (cur >= kBodyStart && cur < body_end) out[cur] = tok & 0x1FF;
      ++cur;
    }
  }
  kc[c] = k;
  rmax[c] = hi;
  rmin[c] = lo;
}

// Output bytes of each cell's first min(count, slots) tokens.
__global__ void tape_v1_len_kernel(const int* __restrict__ tape,
                                   const int* __restrict__ counts,
                                   int n_cells, int slots,
                                   int* __restrict__ cell_len) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int cnt = min(counts[c], slots);
  const int* __restrict__ row = tape + static_cast<int64_t>(c) * slots;
  int n = 0;
  for (int j = 0; j < cnt; ++j) {
    const int tok = row[j];
    n += tok >= kMatchBit ? (tok >> 16) & 0x3FFF : 1;
  }
  cell_len[c] = n;
}

}  // namespace

extern "C" int dbg_lz77_tape_v1_len(const int* tape, const int* counts,
                                    int n_cells, int slots, int* cell_len,
                                    cudaStream_t stream) {
  if (n_cells > 0) {
    const int threads = 128;
    const int blocks = (n_cells + threads - 1) / threads;
    tape_v1_len_kernel<<<blocks, threads, 0, stream>>>(tape, counts, n_cells,
                                                       slots, cell_len);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dbg_lz77_tape_place(int* out, int body_end, const int* tape,
                                   const int* counts, const int* cbase,
                                   int cell_lo, int n_cells, int base_adj,
                                   int slots, int* mpos, int* mmeta, int* kc,
                                   int* rmax, int* rmin, int* thr,
                                   cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n_cells + threads - 1) / threads;
  place_kernel<<<blocks, threads, 0, stream>>>(
      out, body_end, tape, counts, cbase, cell_lo, n_cells, base_adj, slots,
      mpos, mmeta, kc, rmax, rmin, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dbg_lz77_tape_walk(int* out, int body_end, const int* mpos,
                                  const int* mmeta, const int* kc,
                                  const int* rmax, const int* thr,
                                  const int64_t* bounds, int n_ranges,
                                  int slots, cudaStream_t stream) {
  return lz77::launch_walk_cells(out, body_end, mpos, mmeta, kc, rmax, thr,
                                 bounds, n_ranges, slots, stream);
}
