// v14 compaction for Hopper: every cell's match, run and literal records
// to precomputed dense offsets, in one pass that writes every output slot
// once (no zero pre-fill).
//
// Replaces the TPU kernel _compact_kernel_v14 (debigulator_tpu/ops/
// archive/lz77_generations.py:893).  The TPU kernel DMAs 512-cell chunks
// into VMEM and, cell after cell, rolls the cell's records to its dense
// offset and stores two masked rows into outputs aliased to zeros.
//
// The offsets.  The one caller, inflate_generations.resolve_segmented_v14
// (as the reference's), passes each list's offsets as exclusive prefix
// sums of the cells' 8-bit counts, so they start at 0, never decrease, and
// leave no gap between one cell's records and the next cell's unless a
// count is past `slots` (an overflowed tape whose result every caller
// discards; its records are read as `slots` and the rest of its span is
// a gap of zeros).  So the outputs are a dense prefix of records followed
// by zeros, and the kernel is the scatter plus zeros where no record
// lands:
//  * record blocks: a thread per cell.  It reads the cell's packed counts
//    and its three offsets (a warp reads them as 128 contiguous bytes),
//    then for each list copies records j < count (read as at most `slots`;
//    record j of cell c is at c * slots + j, so a cell's valid records are
//    one run of at most slots * 4 bytes) to offset + j, and zeroes the
//    rest of its span up to the next cell's offset (a gap, only after an
//    overflow).  (A thread per (cell, slot) would leave most threads
//    with nothing to copy, each after dependent loads of the count and
//    offsets;)
//  * tail blocks, a thread per four slots of the longest output: it
//    zeroes those of its slots in each list that lie before the first
//    cell's offset or from the last cell's last record on, with one
//    16-byte store where all four do.  (A loop of such stores per thread
//    over a strided range is much slower than a memset on the H100.)
// Writes past an output's end are dropped.  The precondition (offsets
// non-decreasing, each cell's records ending at or before the next
// cell's offset) is what exclusive prefix sums of the counts give; the
// wrapper states it.
//
// What bounds it on the H100: bytes, the valid records and each cell's
// count and offsets read once and every output slot written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct List {
  const int* a;    // first record field (dst, or the literal)
  const int* b;    // second field (meta), or nullptr
  const int* off;  // per-cell offsets
  int* oa;
  int* ob;
  int64_t n_out;
  int shift;       // count = cnt >> 16, (cnt >> 8) & 0xFF or cnt & 0xFF
};

__device__ __forceinline__ int count_of(int packed, int shift, int slots) {
  return min(shift == 16 ? packed >> 16 : (packed >> shift) & 0xFF, slots);
}

// One cell's records of one list to off[cell] + j, j < its count (read as
// at most `slots`), then zeros up to the next cell's offset (a gap, only
// after an overflow).
__device__ __forceinline__ void scatter(const List& L, int cell, int n_cells,
                                       int slots, int packed) {
  const int* __restrict__ a = L.a;
  const int* __restrict__ b = L.b;
  int* __restrict__ oa = L.oa;
  int* __restrict__ ob = L.ob;
  const int k = count_of(packed, L.shift, slots);
  const int64_t off = L.off[cell];
  const int64_t span =
      cell + 1 < n_cells ? max(static_cast<int64_t>(k), L.off[cell + 1] - off)
                         : k;
  const int64_t src = static_cast<int64_t>(cell) * slots;
#pragma unroll 4
  for (int64_t q = 0; q < span; ++q) {
    const int64_t at = off + q;
    if (at < 0 || at >= L.n_out) continue;
    const bool rec = q < k;
    oa[at] = rec ? a[src + q] : 0;
    if (ob) ob[at] = rec ? b[src + q] : 0;
  }
}

// Zero the slots [4v, 4v + 4) of a list that lie outside its records
// [first, end): one 16-byte store where all four do.
__device__ __forceinline__ void zero_outside(const List& L, const int* cnt,
                                             int n_cells, int slots,
                                             int64_t v) {
  const int64_t s0 = 4 * v;
  if (s0 >= L.n_out) return;
  const int64_t first = L.off[0];
  const int64_t end = static_cast<int64_t>(L.off[n_cells - 1]) +
                      count_of(cnt[n_cells - 1], L.shift, slots);
  if ((s0 >= end || s0 + 4 <= first) && s0 + 4 <= L.n_out) {
    const int4 z = make_int4(0, 0, 0, 0);
    reinterpret_cast<int4*>(L.oa)[v] = z;
    if (L.ob) reinterpret_cast<int4*>(L.ob)[v] = z;
    return;
  }
  for (int64_t at = s0; at < s0 + 4 && at < L.n_out; ++at) {
    if (at < first || at >= end) {
      L.oa[at] = 0;
      if (L.ob) L.ob[at] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(List m, List r, List l, const int* __restrict__ cnt,
               int n_cells, int slots, int record_blocks) {
  if (static_cast<int>(blockIdx.x) < record_blocks) {
    const int cell = blockIdx.x * kThreads + threadIdx.x;
    if (cell >= n_cells) return;
    const int packed = cnt[cell];
    scatter(m, cell, n_cells, slots, packed);
    scatter(r, cell, n_cells, slots, packed);
    scatter(l, cell, n_cells, slots, packed);
    return;
  }
  const int64_t v =
      static_cast<int64_t>(blockIdx.x - record_blocks) * kThreads + threadIdx.x;
  zero_outside(m, cnt, n_cells, slots, v);
  zero_outside(r, cnt, n_cells, slots, v);
  zero_outside(l, cnt, n_cells, slots, v);
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
    const int64_t record_blocks = (n_cells + kThreads - 1) / kThreads;
    // A tail thread per four slots of the longest output.
    const int64_t longest = n_out > n_lit_out ? n_out : n_lit_out;
    const int64_t tail_blocks = (longest / 4 + kThreads) / kThreads;
    if (record_blocks + tail_blocks > 0x7FFFFFFF) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const List m{ma, mb, moff, mdst, mmeta, n_out, 16};
    const List r{ra, rb, roff, rdst, rmeta, n_out, 8};
    const List l{lit, nullptr, loff, lit_out, nullptr, n_lit_out, 0};
    compact_kernel<<<static_cast<unsigned>(record_blocks + tail_blocks),
                     kThreads, 0, stream>>>(m, r, l, cnt, n_cells, slots,
                                            static_cast<int>(record_blocks));
  }
  return static_cast<int>(cudaGetLastError());
}
