// v6 tape resolver for Hopper: one segment of Phase B from the token tape.
//
// Replaces the TPU kernel _tape_kernel_v6 (debigulator_tpu/ops/
// lz77_pallas.py:317).  The tape is cell-major, `slots` tokens a cell: a
// literal byte, or 1 << 30 | len << 16 | dist.  Cell c's first byte lands
// at buffer position cbase[c] + base_adj (base_adj = PAD + WINDOW -
// seg_off), and stores are clipped to the body [body_start, body_end).
//
// Two entries, no read-back between them:
//  (a) place_kernel (dbg_lz77_tape_place), a thread per cell of
//      [cell_lo, cell_lo + n_cells): walks the cell's tokens, stores its
//      literals (masked with 0x1FF as the reference does), and writes the
//      cell's matches, head- and tail-clipped (lz77::clip_match), to a
//      per-cell list with their count.  Literals read no output, so the
//      cells run in any order.
//  (b) chase::launch_cells (dbg_lz77_tape_chase, chase.cuh), after the
//      wrapper's prefix sum of the counts on the card: the bitmap zeroed,
//      a pointer for every match byte, then the grid-wide chase over the
//      body.  No stream order: every match byte's chain of sources runs
//      strictly down to a literal, a stored byte or a window byte.
//
// Where it could go wrong, and what the design does:
//  * the per-cell lists are mostly padding (slots entries a cell, kc[c]
//    valid) and a few cells may hold most bytes (a zero run): the pointer
//    pass numbers the valid records across all cells, takes them 32 a
//    warp and never reads the rest;
//  * the caller's buffer may hold any int32 (tests pad it and the tape
//    with -1): pointers live in a side array of states flagged by a
//    bitmap, never in the buffer, and a chase follows a pointer only while
//    it moves down,
//    so an overflowed tape (a count past `slots`, read as `slots`; every
//    caller discards its result) ends too;
//  * a segment (seg_off > 0, cell_lo > 0) reads sources in the window
//    prologue [PAD, PAD + WINDOW): the bitmap covers the body only, so the
//    prologue is final, and the pad and slack rows are never stored.
//
// What bounds it on the H100: (a) bytes, 4 * slots + 8 read per cell and
// one int32 written per literal; (b) bytes and latency (chase.cuh).
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

#include "chase.cuh"
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
                             int* __restrict__ kc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int cell = cell_lo + c;
  const int cnt = min(counts[cell], slots);
  const int* __restrict__ row = tape + static_cast<int64_t>(cell) * slots;
  const int64_t at = static_cast<int64_t>(c) * slots;
  int cur = cbase[cell] + base_adj;
  int k = 0;
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
        ++k;
      }
      cur += len;
    } else {
      if (cur >= kBodyStart && cur < body_end) out[cur] = tok & 0x1FF;
      ++cur;
    }
  }
  kc[c] = k;
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
                                   cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (n_cells + threads - 1) / threads;
  place_kernel<<<blocks, threads, 0, stream>>>(
      out, body_end, tape, counts, cbase, cell_lo, n_cells, base_adj, slots,
      mpos, mmeta, kc);
  return static_cast<int>(cudaGetLastError());
}

// kinc: inclusive prefix sums of kc.  state: a 64-bit word per body byte
// (body_end - PAD - WINDOW), bits: a bit per body byte, rounded up to whole
// 32-bit words; both scratch.
extern "C" int dbg_lz77_tape_chase(int* out, int body_end, const int* mpos,
                                   const int* mmeta, const int* kinc,
                                   int n_cells, int slots,
                                   unsigned long long* state, unsigned* bits,
                                   cudaStream_t stream) {
  return chase::launch_cells(out, kBodyStart, body_end, mpos, mmeta, kinc,
                             n_cells, slots, state, bits, stream);
}
