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
// carried.  Here the buffer holds every segment, memory is byte
// addressable (one int32 per byte), and the work is two entries with
// nothing read back between them:
//  (a) lit_kernel (dbg_groups_v11_lits), a thread per literal piece:
//      literals read no output, so any order;
//  (b) chase::launch_list (dbg_groups_v11_chase, chase.cuh) over the match
//      slots: `PieceRec` unpacks slot t's words itself (its segment from
//      the group's first slot, a group never spanning segments) into a
//      buffer position, length and distance, length 0 for padding and for
//      a slot outside every segment; the pointer pass spreads the pieces'
//      bytes, then the grid-wide chase resolves every body byte to the
//      root of its chain of sources.  No slot order and no group order:
//      the packer's pieces never overlap (DEFLATE output is written once)
//      and every source lies below the byte it feeds, which is when the
//      chase equals the in-order walk.  A source below the body (the
//      window prologue, or with a one-row `lims` the previous segment's
//      tail) has no flag and is final; one below 0 is skipped.  The
//      buffer may hold any int32: pointers live in chase.cuh's side array.
//
// What bounds it on the H100: (a) bytes, the literal words and bytes read
// once; (b) bytes and latency (chase.cuh), the piece words read once and
// a 64-bit state and a bit per body byte.

#include "chase.cuh"
#include "lz77_copy.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kBodyStart = 128 + 32768;

struct Piece {
  int dst, len, src;
};

__device__ __forceinline__ Piece unpack(int w0, int w1) {
  const int rp = (w0 >> 8) & 127;
  Piece p;
  p.dst = (w0 >> 16) * 128 + rp;
  p.len = (w0 & 255) - rp;
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

// The record source of the chase's pointer pass, outside the unnamed
// namespace: it is a template argument of a kernel.
namespace groups_v11 {

// Slot t's piece for chase::list_pointer_kernel: its buffer position
// (segment-local position plus the segment's offset), clipped to the body
// [kBodyStart, body_end) as lz77::clip_match clips; length 0 for a slot
// outside every segment's range (its group's first slot decides) and for
// a padding piece.
struct PieceRec {
  const int* __restrict__ lims;
  int n_seg;
  const int* __restrict__ gpos;
  const int* __restrict__ gmeta;
  int body_end;
  __device__ __forceinline__ void operator()(int64_t t, int& dst, int& len,
                                             int& dist) const {
    const int seg = segment_of(lims, n_seg, 0, 1, t - t % kGroup);
    if (seg < 0) return;
    const Piece p = unpack(gpos[t], gmeta[t]);
    int d = p.dst + lims[seg * 8 + 2] - lims[2];
    const int eff = lz77::clip_match(&d, p.len, kBodyStart, body_end);
    if (eff > 0 && p.dst > p.src) {
      dst = d;
      len = eff;
      dist = p.dst - p.src;
    }
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

// state: a 64-bit word per body byte (body_end - PAD - WINDOW), bits: a
// bit per body byte, rounded up to whole 32-bit words; both scratch.
extern "C" int dbg_groups_v11_chase(int* out, int body_end, const int* lims,
                                    int n_seg, const int* gpos,
                                    const int* gmeta, int64_t n_slots,
                                    unsigned long long* state, unsigned* bits,
                                    cudaStream_t stream) {
  const groups_v11::PieceRec rec{lims, n_seg, gpos, gmeta, body_end};
  return chase::launch_list(out, kBodyStart, body_end, rec, n_slots, state,
                            bits, stream);
}
