// Host-fed group resolvers v9 and v10 for Hopper: the native packer's
// match groups of 8 (and, for v10, literal pieces over the scanner's dense
// literal bytes) applied to a buffer: pad row, 32 KiB window, the
// segments' bodies one after another, slack.
//
// Replaces the TPU kernels _group_kernel_v9 and _group_kernel_v10
// (debigulator_tpu/ops/archive/lz77_generations.py:345 and :431).  A
// group's 8 pieces copy len <= 128 bytes each from dst - dist to dst; the
// TPU kernels stage the piece lists through SMEM and, per group, issue all
// 8 loads (3-row windows rolled into place) before the 8 masked 2-row
// stores, one segment per call.  Those semantics are kept: within a group
// every load sees the buffer as the groups before it left it, and the
// stores follow in slot order (a later store wins); groups run in slot
// order.  For the packer's groups, whose pieces never read what the group
// writes, that is the in-order LZ77 result.
//
// Here memory is byte addressable (one int32 per byte), the buffer holds
// every segment, and the work is two entries with nothing read back
// between them:
//  (a) lits_kernel (dbg_groups_v10_lits, v10), a thread per literal slot:
//      literal pieces read no output, so any order (their destinations are
//      disjoint);
//  (b) group_chase::launch (dbg_groups_v9_chase, group_chase.cuh) over the
//      match slots: `V9Rec` reads slot t's position and meta (its segment
//      from the group's first slot, a group never spanning segments), and
//      the chase gives every written byte the value of its source before
//      the piece's group, whatever the list.  A source outside the buffer
//      reads 0; stores outside it are dropped.
//
// What bounds it on the H100: (a) bytes, the words and literals read once;
// (b) bytes and latency (group_chase.cuh), the piece words read twice,
// two words set per buffer byte and a 64-bit state per written byte.

#include "chase.cuh"
#include "group_chase.cuh"
#include "lz77_copy.cuh"

namespace {

constexpr int kGroup = 8;  // pieces per group
constexpr int kBodyStart = 128 + 32768;

// Literal slot t of segment k (the segment whose literal slot range holds
// the first slot of t's group): lpos = stream-global destination, lmeta =
// len << 20 | rel, its bytes lit[lims[k][5] * 128 + rel - 128 ...].
__global__ void lits_kernel(int* out, int64_t n_out,
                            const int* __restrict__ lims, int n_seg,
                            const int* __restrict__ lpos,
                            const int* __restrict__ lmeta, int64_t n_slots,
                            const int* __restrict__ lit, int64_t n_lit) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_slots) return;
  const int k = lz77::segment_of(lims, n_seg, 3, 4, t - t % kGroup);
  if (k < 0) return;
  const int m = lmeta[t];
  const int len = m >> 20;
  const int64_t dst = static_cast<int64_t>(lpos[t]) - lims[2] + kBodyStart;
  const int64_t src = static_cast<int64_t>(lims[k * 8 + 5]) * 128
                      + (m & 0xFFFFF) - 128;
  for (int i = 0; i < len; ++i) {
    if (dst + i >= 0 && dst + i < n_out && src + i >= 0 && src + i < n_lit)
      out[dst + i] = lit[src + i];
  }
}

}  // namespace

// The record source of the group chase, outside the unnamed namespace: it
// is a template argument of a kernel.
namespace groups_v9 {

// Slot t's piece: buffer position (stream-global position less lims[0][2],
// plus the body start), length (meta >> 16, at most 128; 0 for padding and
// for a slot whose group's first slot lies outside every segment's range)
// and source (position less the 16-bit distance), with no wrap (period =
// len); groups of 8.
struct V9Rec {
  static constexpr int kPiece = 128;
  const int* __restrict__ lims;
  int n_seg;
  const int* __restrict__ gpos;
  const int* __restrict__ gmeta;
  __device__ __forceinline__ void operator()(int64_t t, int& dst, int& len,
                                             int& src, int& period) const {
    len = 0;
    if (lz77::segment_of(lims, n_seg, 0, 1, lo(t)) < 0) return;
    const int m = gmeta[t];
    const int n = min(m >> 16, kPiece);
    if (n <= 0) return;
    dst = gpos[t] - lims[2] + kBodyStart;
    src = dst - (m & 0xFFFF);
    len = n;
    period = n;
  }
  __device__ __forceinline__ int64_t lo(int64_t t) const {
    return t - t % kGroup;
  }
};

}  // namespace groups_v9

extern "C" int dbg_groups_v10_lits(int* out, int64_t n_out, const int* lims,
                                   int n_seg, const int* lpos,
                                   const int* lmeta, int64_t n_slots,
                                   const int* lit, int64_t n_lit,
                                   cudaStream_t stream) {
  if (n_slots > 0) {
    const int threads = 256;
    const int64_t blocks = (n_slots + threads - 1) / threads;
    lits_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        out, n_out, lims, n_seg, lpos, lmeta, n_slots, lit, n_lit);
  }
  return static_cast<int>(cudaGetLastError());
}

// last, first: n_out ints; state: n_out 64-bit words; heads: (n_out +
// 127) / 128 + 2 ints; next: n_slots ints; all scratch.
extern "C" int dbg_groups_v9_chase(int* out, int64_t n_out, const int* lims,
                                   int n_seg, const int* gpos,
                                   const int* gmeta, int64_t n_slots,
                                   int* last, int* first,
                                   unsigned long long* state, int* heads,
                                   int* next, cudaStream_t stream) {
  const groups_v9::V9Rec rec{lims, n_seg, gpos, gmeta};
  return group_chase::launch(out, n_out, rec, n_slots,
                             {last, first, state, heads, next}, stream);
}
