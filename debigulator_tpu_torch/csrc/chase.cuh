// Grid-wide LZ77 source chase for Hopper, shared by the flat walk
// (walk.cu, row 3 of PERF.md's kernel table) and the two segment resolvers
// (lz77_tape.cu and lz77_ops.cu, rows 7 and 9, and row 10d through
// lz77_tape.cu); the chase of every match or piece list (group_chase.cuh,
// rows 8, 10a, 10c and 10e-10h) runs chase_elements with group semantics
// instead of the overlap rule alone.
//
// A DEFLATE match copies `len` bytes from `dist` bytes back: byte d + i of
// a match at d takes the value of byte s = d - dist + i % dist (the
// overlap rule; s < d + i always, and a head-clipped match, its
// destination moved up and its distance kept, resolves as the in-order
// walk does).  A DEFLATE tape writes each byte once, so the bytes of all
// matches form chains of pointers that run strictly downwards and end at a
// byte that no match writes: a literal, a stored byte, the window
// prologue or a byte of the caller's buffer.  Resolving them needs no
// stream order, only the chains' roots:
//
//  * a pointer pass stores a pointer for every match byte.  A persistent
//    grid of warps takes 32 records at a time, one a lane, and spreads
//    their bytes over the lanes (a prefix sum of the lengths and a binary
//    search by shuffles for each byte's record, `spread_bytes`), so every
//    lane stores and neighbouring lanes store neighbouring bytes;
//  * a chase gives each thread kChase elements, kThreads apart, their
//    chases interleaved so that each round's loads are in flight
//    together (`chase_elements`).  While an element holds a pointer its
//    owner follows it; between hops the owner publishes how far it got
//    (its current pointer, still on the same chain), so chasers that run
//    together do pointer jumping among themselves (a chain of depth D in
//    about log2 D rounds) and a byte whose source was resolved already
//    stops after one hop.  Only an element's owner ever stores into it,
//    and every hop moves strictly downwards, so each chase ends whatever
//    the order of blocks; nothing waits on another block.
//
// Two encodings of "this byte still holds a pointer":
//
//  * in place (row 3, `InPlaceStore` / `InPlaceChain`): out[d] = -(s + 1).
//    The walk's buffer holds byte values 0..255 (the caller's window,
//    stored bytes, literals), so a negative value is a pointer.
//  * flagged (rows 7 and 9, `FlagStore` / `FlagChain`, launched by
//    `launch_cells`): these resolvers get their buffer from the caller and
//    row 9 stores its literals unmasked, so any int32 may be a final value
//    (a tape or buffer padded with -1, for one).  A bitmap over the body
//    marks the match bytes (zeroed first: body / 8 bytes, not a pass over
//    the buffer) and a side array holds each match byte's state in one
//    64-bit word: its pointer while it is chased, its value once resolved,
//    so a chase that reaches a resolved byte stops there as the in-place
//    chase does.  The buffer itself only ever holds values.  A hop loads
//    the source's bit, its state and its value together; a source outside
//    the body (the window prologue of a segment, the pad row) has no bit
//    and is final.  The chase follows a pointer only while it moves
//    strictly down, so it ends on any input, an overflowed tape included.
//
// The segment resolvers' matches come as per-cell lists, `slots` entries a
// cell with kc[c] of them valid (87% of the 8.4 M slots are padding at the
// 29-stream shape), and a few cells may hold most of the bytes (a zero run
// is 512 cells of 32 matches of 258 bytes).  `cells_pointer_kernel` takes
// the records 32 at a time in one numbering across all cells (the
// inclusive prefix sums of kc, made on the card between the launches) and
// finds each record's cell by a binary search, so the padding is never
// read and the bytes spread evenly over the warps.

// What bounds it on the H100: bytes and latency, across all 132 SMs.  The
// pointer pass reads each valid record once and writes a pointer per match
// byte (plus, flagged, one bitmap word per 32 bytes through a warp-wide
// OR); the chase reads each element's bit (flagged) or value (in place)
// and, per match byte, its chain's sources (mostly L2 hits, within 32 KiB
// below), and writes the result.  A byte's chain is usually 1-3 hops deep
// (text); a zero run coded as dist-1 matches (one hop per 258 bytes) is
// shortened by the publication above.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace chase {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChase = 8;                // elements a chase thread
constexpr int kPointerBlocks = 132 * 8;  // a persistent grid

// Spread the bytes of 32 match records, one a lane (buffer position
// base + dst, length len, distance dist; len 0 for none, and dist > 0
// wherever len > 0), over the lanes: store(ok, d, s) for every byte d and
// its source s, in rounds of 32 bytes, every lane calling in every round.
// ok is false for a lane with no byte this round, for d >= limit and for
// s < 0 (such a byte is left as it was).
template <class Store>
__device__ __forceinline__ void spread_bytes(int lane, int64_t base, int dst,
                                             int len, int dist, int64_t limit,
                                             const Store& store) {
  int incl = len;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const int excl = incl - len;
  const int total = __shfl_sync(kFull, incl, 31);
  for (int b = 0; b < total; b += 32) {
    const int q = b + lane;
    int r = 0;  // the last record whose bytes start at or before q
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFull, excl, r + step) <= q) r += step;
    }
    const int i = q - __shfl_sync(kFull, excl, r);
    const int64_t d = base + __shfl_sync(kFull, dst, r) + i;
    const int rd = __shfl_sync(kFull, dist, r);
    const bool live = q < total;
    const int64_t s = live ? d - i - rd + i % rd : -1;
    store(live && d < limit && s >= 0, d, s);
  }
}

// Grid-wide chase over elements [j0 + c * kThreads] for c < kChase, each
// below `end`.  Chain supplies start(j, v) (false: element j is final;
// else v is its first pointer), load(v) (one hop's loads, issued for all
// live elements of the thread before any is used) and step(j, v, hop)
// (store or publish; false once element j holds its value).
template <class Chain>
__device__ __forceinline__ void chase_elements(const Chain& ch, int64_t j0,
                                               int64_t end) {
  int v[kChase];
  bool live[kChase];
  bool pending = false;
#pragma unroll
  for (int c = 0; c < kChase; ++c) {
    const int64_t j = j0 + c * kThreads;
    live[c] = j < end && ch.start(j, v[c]);
    pending |= live[c];
  }
  while (pending) {
    typename Chain::Hop h[kChase];
#pragma unroll
    for (int c = 0; c < kChase; ++c) {
      if (live[c]) h[c] = ch.load(v[c]);
    }
    pending = false;
#pragma unroll
    for (int c = 0; c < kChase; ++c) {
      if (live[c]) {
        live[c] = ch.step(j0 + c * kThreads, v[c], h[c]);
        pending |= live[c];
      }
    }
  }
}

// In place: a match byte holds -(s + 1); every final value is >= 0.
struct InPlaceStore {
  int* out;
  __device__ __forceinline__ void operator()(bool ok, int64_t d,
                                             int64_t s) const {
    if (ok) out[d] = static_cast<int>(-(s + 1));
  }
};

struct InPlaceChain {
  int* out;
  using Hop = int;
  __device__ __forceinline__ bool start(int64_t j, int& v) const {
    v = out[j];
    return v < 0;
  }
  __device__ __forceinline__ int load(int v) const {
    return __ldcg(out + (-static_cast<int64_t>(v) - 1));
  }
  // The root's byte, or a shorter pointer on the same chain.
  __device__ __forceinline__ bool step(int64_t j, int& v, int w) const {
    __stcg(out + j, w);
    v = w;
    return w < 0;
  }
};

// Flagged: bit e of `bits` marks body element body_start + e as a match
// byte, and ptr[e] holds its state in one 64-bit word, read and written
// whole: a pointer (a buffer position, in the low word) while it is being
// chased, then its value (in the high word, the low word kDone).  `out`
// holds values only.
constexpr unsigned kDone = 0xFFFFFFFFu;

__device__ __forceinline__ bool flag_of(const unsigned* bits, int64_t e) {
  return (__ldg(bits + (e >> 5)) >> (e & 31)) & 1u;
}

__device__ __forceinline__ unsigned long long pointer_entry(int64_t s) {
  return static_cast<unsigned>(s);
}

__device__ __forceinline__ unsigned long long value_entry(int val) {
  return static_cast<unsigned long long>(static_cast<unsigned>(val)) << 32 |
         kDone;
}

struct FlagStore {
  unsigned long long* ptr;
  unsigned* bits;
  int64_t body_start;
  int lane;
  // All 32 lanes call this together: the lanes that hit one bitmap word
  // OR their bits, and the lowest of them stores the word.
  __device__ __forceinline__ void operator()(bool ok, int64_t d,
                                             int64_t s) const {
    const int64_t e = d - body_start;
    ok = ok && e >= 0;
    if (ok) ptr[e] = pointer_entry(s);
    const int word = ok ? static_cast<int>(e >> 5) : -1;
    const unsigned peers = __match_any_sync(kFull, word);
    const unsigned m = __reduce_or_sync(peers, ok ? 1u << (e & 31) : 0u);
    if (ok && lane == __ffs(peers) - 1) atomicOr(bits + (e >> 5), m);
  }
};

struct FlagChain {
  int* out;
  unsigned long long* ptr;
  const unsigned* bits;
  int64_t body_start;
  struct Hop {
    unsigned long long entry;  // the source's state, where it has its bit
    int val;                   // the source's value, where it has none
    bool flag;
  };
  __device__ __forceinline__ bool start(int64_t j, int& v) const {
    const int64_t e = j - body_start;
    if (!flag_of(bits, e)) return false;
    v = static_cast<int>(static_cast<unsigned>(ptr[e]));
    return true;
  }
  __device__ __forceinline__ Hop load(int p) const {
    const int64_t e = p - body_start;
    Hop h;
    h.val = __ldcg(out + p);
    h.flag = e >= 0 && flag_of(bits, e);
    h.entry = e >= 0 ? __ldcg(ptr + e) : 0;
    return h;
  }
  __device__ __forceinline__ bool step(int64_t j, int& v, const Hop& h) const {
    int val = h.val;
    if (h.flag) {
      const unsigned low = static_cast<unsigned>(h.entry);
      if (low == kDone) {
        val = static_cast<int>(h.entry >> 32);  // resolved already
      } else if (static_cast<int>(low) < v) {
        v = static_cast<int>(low);  // a shorter pointer: publish it
        __stcg(ptr + (j - body_start), pointer_entry(v));
        return true;
      }
    }
    // v is a root (or, never on the lists the placement writes, a
    // pointer that does not move down: the chase stops all the same).
    __stcg(out + j, val);
    __stcg(ptr + (j - body_start), value_entry(val));
    return false;
  }
};

// The match bytes of per-cell lists: cell c of n_cells holds its records
// at mpos/mmeta[c * slots ...] (buffer position, len << 16 | dist), already
// clipped to the body [body_start, body_end); kinc holds the inclusive
// prefix sums of the cells' record counts (kinc[n_cells - 1] records in
// all, read here).  A warp takes 32 records at a time, numbered across all
// cells, and each lane finds its record's cell by a binary search of
// kinc: the work is spread evenly however the records fall on the cells,
// and padding is never read.
__global__ void __launch_bounds__(kThreads)
cells_pointer_kernel(const int* __restrict__ mpos,
                     const int* __restrict__ mmeta,
                     const int* __restrict__ kinc, int n_cells, int slots,
                     int body_start, int body_end,
                     unsigned long long* __restrict__ ptr,
                     unsigned* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const FlagStore store{ptr, bits, body_start, lane};
  const int64_t total = kinc[n_cells - 1];
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       g * 32 < total; g += warps) {
    const int64_t q = g * 32 + lane;
    int dst = 0, meta = 0;
    if (q < total) {
      int lo = 0, hi = n_cells;  // the first cell whose prefix passes q
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(kinc + mid) <= q) lo = mid + 1;
        else hi = mid;
      }
      const int64_t at = static_cast<int64_t>(lo) * slots + q -
                         (lo > 0 ? __ldg(kinc + lo - 1) : 0);
      dst = mpos[at];
      meta = mmeta[at];
    }
    const int dist = meta & 0xFFFF;
    const int len = dist != 0 && meta > 0 ? meta >> 16 : 0;
    spread_bytes(lane, 0, dst, len, dist, body_end, store);
  }
}

__global__ void __launch_bounds__(kThreads)
flag_chase_kernel(int* out, unsigned long long* ptr,
                  const unsigned* __restrict__ bits, int body_start,
                  int body_end) {
  const int64_t j0 = body_start +
                     static_cast<int64_t>(blockIdx.x) * kThreads * kChase +
                     threadIdx.x;
  chase_elements(FlagChain{out, ptr, bits, body_start}, j0, body_end);
}

// Resolve the listed matches of n_cells cells into `out` over the body
// [body_start, body_end): zero the bitmap, run the pointer pass, then the
// chase.  ptr: body_end - body_start 64-bit words, bits: (that + 31) / 32
// words, both scratch.
inline int launch_cells(int* out, int body_start, int body_end,
                        const int* mpos, const int* mmeta, const int* kinc,
                        int n_cells, int slots, unsigned long long* ptr,
                        unsigned* bits, cudaStream_t stream) {
  const int64_t n_body = static_cast<int64_t>(body_end) - body_start;
  if (n_cells <= 0 || n_body <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(bits, 0, (n_body + 31) / 32 * 4, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t most = static_cast<int64_t>(n_cells) * slots;  // records
  int64_t blocks = (most + 32 * kWarps - 1) / (32 * kWarps);
  if (blocks > kPointerBlocks) blocks = kPointerBlocks;
  cells_pointer_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      mpos, mmeta, kinc, n_cells, slots, body_start, body_end, ptr, bits);
  const int64_t per = static_cast<int64_t>(kThreads) * kChase;
  flag_chase_kernel<<<static_cast<unsigned>((n_body + per - 1) / per),
                      kThreads, 0, stream>>>(out, ptr, bits, body_start,
                                             body_end);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chase
