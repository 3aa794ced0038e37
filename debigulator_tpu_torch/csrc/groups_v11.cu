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
// addressable (one int32 per byte), and the work is:
//  (a) lit_kernel, a thread per literal piece: literals read no output,
//      so any order;
//  (b) unpack_kernel, a thread per match slot: the piece as buffer
//      position and len << 16 | dist;
//  (c) the live pieces, which the wrapper has split into ranges that
//      share no byte, each in slot order (the streams of a merged batch
//      never meet, though a packed group may hold pieces of two), walked
//      in chunks of 8, one CTA per range (lz77_chunks.cu).
//
// What bounds it on the H100: (a) and (b) bytes, the words and literals
// read once; (c) latency (lz77_copy.cuh).

#include "lz77_copy.cuh"

namespace {

constexpr int kGroup = 8;

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

// Slot t's piece as buffer position and len << 16 | dist; meta 0 for a
// slot outside every segment's range (its group's first slot decides: a
// group never spans segments) and for a length-0 padding piece.
__global__ void unpack_kernel(const int* __restrict__ lims, int n_seg,
                              const int* __restrict__ gpos,
                              const int* __restrict__ gmeta, int64_t n_slots,
                              int* __restrict__ pdst, int* __restrict__ pmeta) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_slots) return;
  const int seg = segment_of(lims, n_seg, 0, 1, t - t % kGroup);
  int dst = 0, meta = 0;
  if (seg >= 0) {
    const Piece p = unpack(gpos[t], gmeta[t]);
    if (p.len > 0) {
      dst = p.dst + lims[seg * 8 + 2] - lims[2];
      meta = (p.len << 16) | (p.dst - p.src);
    }
  }
  pdst[t] = dst;
  pmeta[t] = meta;
}

}  // namespace

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

extern "C" int dbg_groups_v11_unpack(const int* lims, int n_seg,
                                     const int* gpos, const int* gmeta,
                                     int64_t n_slots, int* pdst, int* pmeta,
                                     cudaStream_t stream) {
  if (n_slots > 0) {
    const int threads = 256;
    const int64_t blocks = (n_slots + threads - 1) / threads;
    unpack_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        lims, n_seg, gpos, gmeta, n_slots, pdst, pmeta);
  }
  return static_cast<int>(cudaGetLastError());
}
