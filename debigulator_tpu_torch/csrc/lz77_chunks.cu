// In-order walk of a flat LZ77 match list for Hopper, shared by the
// archive resolvers of ops/archive/lz77_generations.py: the match pieces
// of the host-fed group resolver (groups_v11.cu) and the dense match list
// of the v14 walk (walk_v14.cu).
//
// The list is in a valid order (a match may read what an earlier one
// wrote).  The wrapper splits it into ranges whose matches share no byte
// with another range's (the streams of a merged batch at least), and each
// range into chunks of at most 8 consecutive matches that play the part
// of lz77_copy.cuh's cells:
//  (a) place_chunks_kernel, a thread per chunk: the chunk's matches
//      clipped to the body, listed with the bytes they read and the
//      lowest position they write;
//  (b) lz77::walk_cells_kernel: the chunks in order, a warp per chunk
//      copying its matches one after another, one CTA per range.
//
// What bounds it on the H100: (a) bytes, the list read once; (b) latency
// (lz77_copy.cuh).

#include "lz77_copy.cuh"

namespace {

// Chunk c holds entries [first[c], end[c]) (at most `slots`) of dst/meta
// (position dst + base_adj; len in bits 16-24, dist in bits 0-15, bit 31
// ignored), head- and tail-clipped to [body_start, body_end).  Writes the
// clipped matches to mpos/mmeta at c * slots with their count, one past
// the highest source byte they read (rmax), and the lowest position of the
// chunk's entries before clipping (dmin; the wrapper's suffix minimum of
// it is walk_cells_kernel's thr).
__global__ void place_chunks_kernel(const int* __restrict__ dst,
                                    const int* __restrict__ meta,
                                    const int* __restrict__ first,
                                    const int* __restrict__ end, int n_chunks,
                                    int slots, int base_adj, int body_start,
                                    int body_end, int* __restrict__ mpos,
                                    int* __restrict__ mmeta,
                                    int* __restrict__ kc,
                                    int* __restrict__ rmax,
                                    int* __restrict__ dmin) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const int64_t at = static_cast<int64_t>(c) * slots;
  int k = 0, hi = INT_MIN, dl = INT_MAX;
  for (int i = first[c]; i < end[c]; ++i) {
    const int m = meta[i];
    const int dist = m & 0xFFFF;
    int d = dst[i] + base_adj;
    dl = min(dl, d);
    const int eff = lz77::clip_match(&d, (m >> 16) & 0x1FF, body_start,
                                     body_end);
    if (eff > 0) {
      mpos[at + k] = d;
      mmeta[at + k] = (eff << 16) | dist;
      hi = max(hi, d - dist + min(eff, dist));
      ++k;
    }
  }
  kc[c] = k;
  rmax[c] = hi;
  dmin[c] = dl;
}

}  // namespace

extern "C" int dbg_lz77_chunks_place(const int* dst, const int* meta,
                                     const int* first, const int* end,
                                     int n_chunks, int slots, int base_adj,
                                     int body_start, int body_end, int* mpos,
                                     int* mmeta, int* kc, int* rmax, int* dmin,
                                     cudaStream_t stream) {
  if (n_chunks > 0) {
    const int threads = 256;
    place_chunks_kernel<<<(n_chunks + threads - 1) / threads, threads, 0,
                          stream>>>(dst, meta, first, end, n_chunks, slots,
                                    base_adj, body_start, body_end, mpos,
                                    mmeta, kc, rmax, dmin);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dbg_lz77_chunks_walk(int* out, int64_t limit, const int* mpos,
                                    const int* mmeta, const int* kc,
                                    const int* rmax, const int* thr,
                                    const int64_t* bounds, int n_ranges,
                                    int slots, cudaStream_t stream) {
  return lz77::launch_walk_cells(out, limit, mpos, mmeta, kc, rmax, thr,
                                 bounds, n_ranges, slots, stream);
}
