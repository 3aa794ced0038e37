// Host-fed group resolver (v11) for Hopper: Phase B of the host-fed
// decode from packed piece words.
//
// Replaces the TPU kernel _group_kernel_v11 (debigulator_tpu/ops/archive/
// lz77_generations.py:609).  The native packer cuts every match into
// pieces of at most 128 bytes that never cross a 128-byte output row and
// places them in groups of 8 that do not read what the group writes; the
// scanner's literal runs become pieces over the dense literal array.  Each
// piece is two words, segment-local (a segment's body starts at PAD +
// WINDOW): w0 = dst_row << 16 | rp << 8 | (rp + len), w1 = q_row << 16 |
// r << 8 | (128 - r), with rp = dst & 127 and q = src - rp.  Segment k
// (lims row k) lands lims[k][2] - lims[0][2] bytes after the first.
//
// The TPU kernel stages the words through SMEM, rolls 2-row windows into
// place and stores masked rows, one segment per call with the window
// carried; per group of 8 it issues all 8 loads before the 8 stores.
// Here the buffer holds every segment, memory is byte addressable (one
// int32 per byte), and the work is two entries with nothing read back
// between them:
//  (a) lit_kernel (dbg_groups_v11_lits), a thread per literal piece:
//      literals read no output, so any order;
//  (b) group_chase::launch (dbg_groups_v11_chase, group_chase.cuh) over
//      the match slots: `PieceRec` unpacks slot t's words itself (its
//      segment from the group's first slot, a group never spanning
//      segments) into a buffer position, length and source, length 0 for
//      padding and for a slot outside every segment; the chase keeps the
//      TPU kernel's group semantics on any list: every written byte takes
//      the value its source held before the piece's group (the literal
//      pieces' bytes, the window, or an earlier group's write), a later
//      slot's store wins.  A source outside the buffer reads 0, a store
//      outside it is dropped, and the buffer may hold any int32.
//
// What bounds it on the H100: (a) bytes, the literal words and bytes read
// once; (b) bytes and latency (group_chase.cuh), the piece words read
// twice, two words set per buffer byte and a 64-bit state per written
// byte.

#include "chase.cuh"
#include "group_chase.cuh"
#include "lz77_copy.cuh"

namespace {

constexpr int kGroup = 8;  // pieces per group

struct Piece {
  int dst, len, src;
};

// A piece's bytes end at its row's end: lanes rp .. min(w0 & 255, 128).
__device__ __forceinline__ Piece unpack(int w0, int w1) {
  const int rp = (w0 >> 8) & 127;
  Piece p;
  p.dst = (w0 >> 16) * 128 + rp;
  p.len = min(w0 & 255, 128) - rp;
  p.src = (w1 >> 16) * 128 + ((w1 >> 8) & 127) + rp;
  return p;
}

using lz77::segment_of;

__global__ void lit_kernel(int* out, int64_t n_out,
                           const int* __restrict__ lims, int n_seg,
                           const int* __restrict__ lpos,
                           const int* __restrict__ lmeta, int64_t n_slots,
                           const int* __restrict__ lit, int64_t n_lit) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_slots) return;
  const int k = segment_of(lims, n_seg, 3, 4, t);
  if (k < 0) return;
  const Piece p = unpack(lpos[t], lmeta[t]);
  const int64_t dst = static_cast<int64_t>(p.dst) + lims[k * 8 + 2] - lims[2];
  // Literal sources are relative to the segment's literal row base, plus
  // the TPU kernel's one pad row.
  const int64_t src = static_cast<int64_t>(p.src) - 128
                      + static_cast<int64_t>(lims[k * 8 + 5]) * 128;
  for (int i = 0; i < p.len; ++i) {
    if (dst + i >= 0 && dst + i < n_out && src + i >= 0 && src + i < n_lit)
      out[dst + i] = lit[src + i];
  }
}

}  // namespace

// The record source of the group chase, outside the unnamed namespace: it
// is a template argument of a kernel.
namespace groups_v11 {

// Slot t's piece for the group chase: its buffer position and source
// (segment-local positions plus the segment's offset) and its length; 0
// for a slot outside every segment's range (its group's first slot
// decides) and for a padding piece.  No wrap (period = len); groups of 8.
struct PieceRec {
  static constexpr int kPiece = 128;  // a row's bytes
  const int* __restrict__ lims;
  int n_seg;
  const int* __restrict__ gpos;
  const int* __restrict__ gmeta;
  __device__ __forceinline__ void operator()(int64_t t, int& dst, int& len,
                                             int& src, int& period) const {
    len = 0;
    const int seg = segment_of(lims, n_seg, 0, 1, lo(t));
    if (seg < 0) return;
    const Piece p = unpack(gpos[t], gmeta[t]);
    if (p.len <= 0) return;
    const int off = lims[seg * 8 + 2] - lims[2];
    dst = p.dst + off;
    src = p.src + off;
    len = p.len;
    period = p.len;
  }
  __device__ __forceinline__ int64_t lo(int64_t t) const {
    return t - t % kGroup;
  }
};

}  // namespace groups_v11

extern "C" int dbg_groups_v11_lits(int* out, int64_t n_out, const int* lims,
                                   int n_seg, const int* lpos,
                                   const int* lmeta, int64_t n_slots,
                                   const int* lit, int64_t n_lit,
                                   cudaStream_t stream) {
  if (n_slots > 0) {
    const int threads = 256;
    const int64_t blocks = (n_slots + threads - 1) / threads;
    lit_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        out, n_out, lims, n_seg, lpos, lmeta, n_slots, lit, n_lit);
  }
  return static_cast<int>(cudaGetLastError());
}

// last, first: n_out ints; state: n_out 64-bit words; heads: (n_out +
// 127) / 128 + 2 ints; next: n_slots ints; all scratch.
extern "C" int dbg_groups_v11_chase(int* out, int64_t n_out, const int* lims,
                                    int n_seg, const int* gpos,
                                    const int* gmeta, int64_t n_slots,
                                    int* last, int* first,
                                    unsigned long long* state, int* heads,
                                    int* next, cudaStream_t stream) {
  const groups_v11::PieceRec rec{lims, n_seg, gpos, gmeta};
  return group_chase::launch(out, n_out, rec, n_slots,
                             {last, first, state, heads, next}, stream);
}
