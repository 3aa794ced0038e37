// Grid-wide chase with group semantics for Hopper, shared by every
// resolver of a match or piece list: the group resolvers v9 / v10
// (groups_v9.cu, rows 10g and 10h of PERF.md's kernel table) and v11
// (groups_v11.cu, row 10a), the match lists v4, v1 and v2 (lz77_match.cu,
// rows 8, 10e and 10f) and the v14 dense-list walk (walk_v14.cu, row 10c).
//
// Its slots are grouped: a group is a run of consecutive slots, and its
// loads all come before its stores.  So every written byte is an event:
// piece t writes byte p = dst + i with the value that byte
// s = src + i % period held before t's group.  That value is the last
// event on s from an earlier group, else the buffer's own byte at s as the
// call's earlier passes left it (literal pieces and runs included); a
// source outside the buffer reads 0.  A byte's final value is its last
// event's by slot; stores outside the buffer are dropped.  The rows take
// their groups and periods from their TPU kernels:
//
//  * the group kernels load a group of 8 pieces before they store it, and
//    a piece reads its source as it was (period = len: no wrap, and a
//    piece with dist < len reads the bytes before its group, not its own
//    output);
//  * the match walks (v4, v1, v2) apply their matches one at a time:
//    groups of one, and the DEFLATE overlap rule, byte d + i of a match at
//    d taking byte d - dist + i % dist (src = d - dist, period = dist).
//    Such a source lies below the match's own bytes, so a group of one is
//    the in-order walk on any list;
//  * the v14 walk loads a group of 8 marked clean (bit 31 on its first
//    slot) before it stores it, with no wrap, and walks every other match
//    in order under the overlap rule.
//
// A record source `Rec` says so: rec(t, dst, len, src, period) decodes
// slot t (len 0 for a slot that writes nothing; dst, src and period are
// then left as they were), rec.lo(t) is the lowest slot of t's group (it
// rises with t, and every slot from lo(t) to t is in t's group), and
// Rec::kPiece bounds a piece's length (a power of two; the record source
// cuts longer ones).
//
// The chase needs no slot order, only two words per buffer byte:
//
//  * mark (`mark_kernel`): each event does atomicMax(last[p], t); an event
//    that finds another writer there also does atomicMin(first[p], the
//    smaller of the two), so `first` holds the first writer of every byte
//    with two or more and stays kOneWriter elsewhere.  Each live piece
//    also joins the list of the kPiece-byte row its destination starts in
//    (heads[row], next[t]), since a writer of byte s starts in s's row or
//    the one before;
//  * pointers (`pointer_kernel`): each byte's last writer stores its
//    event's state in state[p].  With lo the first slot of its group: a
//    source outside the buffer or with no writer is a value (0, or out[s],
//    read here before any store); a source whose last writer lies below
//    lo is a pointer to that byte's state.  Otherwise an earlier writer of
//    s exists only if first[s] lies below lo, and it is the largest
//    covering slot below lo: the kNear slots below lo are tried first
//    (dense rewrites of one row), then the two rows' lists (never on the
//    packer's lists or DEFLATE's, where every byte has one writer).  That
//    event has no state of its own: the pointer names it as (slot,
//    offset), and a chase that reaches it derives its source again
//    (`entry_of`);
//  * chase (`chase_kernel`, chase::chase_elements over the buffer bytes):
//    each last writer follows its pointers, publishing every pointer it
//    reaches, until it holds a value.  Every pointer names an event of an
//    earlier group than the event that holds it, so chains run strictly
//    down in group order and end whatever the order of blocks; only a
//    byte's owner stores into its state;
//  * store (`store_kernel`): out[p] = the value of p's last writer.
//
// States are 64-bit: a value in the high word with kDone in the low word;
// else the low word is a pointer, a byte s >= 0 or, for a writer that is
// not its byte's last, -(t * kPiece + i) - 2 (the wrappers keep t * kPiece
// below 2^31).
//
// What bounds it on the H100: bytes and latency, across all 132 SMs.  Per
// event the records are read twice (mark, pointers) and one atomic is
// made; per buffer byte two words are set, and per written byte a 64-bit
// state is written, chased (a hop is one L2 load: the publication above
// cuts a chain of depth D to about log2 D rounds) and stored.  A reader
// that falls between two writers of its source searches two rows' lists
// of pieces, and a writer that is not its byte's last is derived again at
// each visit: the cost of hand-made lists only.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "chase.cuh"

namespace group_chase {

constexpr int kOneWriter = 0x7F7F7F7F;  // first[] after a 0x7F memset
constexpr int kNear = 32;  // slots tried below a group before the row lists

__host__ __device__ constexpr int log2_of(int v) {
  return v > 1 ? 1 + log2_of(v >> 1) : 0;
}

template <int kPiece>
__device__ __forceinline__ unsigned long long virtual_entry(int64_t t, int i) {
  return static_cast<unsigned>(static_cast<int>(-(t * kPiece + i) - 2));
}

// Spread the events of 32 pieces, one a lane (slot t, buffer position dst,
// length len (0 for none), source src, period, and a key passed on), over
// the lanes: ev(live, t, key, p, s) for every event, in rounds of 32, every
// lane calling in every round.
template <class Ev>
__device__ __forceinline__ void spread_events(int lane, int t, int dst,
                                              int len, int src, int period,
                                              int key, const Ev& ev) {
  int incl = len;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(chase::kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const int excl = incl - len;
  const int total = __shfl_sync(chase::kFull, incl, 31);
  for (int b = 0; b < total; b += 32) {
    const int q = b + lane;
    int r = 0;  // the last piece whose events start at or before q
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(chase::kFull, excl, r + step) <= q) r += step;
    }
    const int i = q - __shfl_sync(chase::kFull, excl, r);
    const int per = __shfl_sync(chase::kFull, period, r);
    const int off = (per > 0 && i >= per) ? i % per : i;
    ev(q < total, __shfl_sync(chase::kFull, t, r),
       __shfl_sync(chase::kFull, key, r),
       static_cast<int64_t>(__shfl_sync(chase::kFull, dst, r)) + i,
       static_cast<int64_t>(__shfl_sync(chase::kFull, src, r)) + off);
  }
}

// The list of the row that a piece at dst starts in: rows of kPiece bytes
// shifted by one, so that a piece starting in the row before the buffer
// has one.
template <int kPiece>
__device__ __forceinline__ int64_t row_of(int64_t dst) {
  return (dst >> log2_of(kPiece)) + 1;
}

// The scratch of one launch: last, first and state per buffer byte,
// heads per row (row_of), next per slot.
struct Scratch {
  int* last;
  int* first;
  unsigned long long* state;
  int* heads;
  int* next;
};

// Where the last event on s before slot `below` (the first slot of the
// reader's group) gets its value: see the header.
template <class Rec>
__device__ __forceinline__ unsigned long long entry_of(
    const Rec& rec, int64_t n_out, const int* out, const Scratch& w,
    int64_t below, int64_t s) {
  constexpr int kPiece = Rec::kPiece;
  if (s < 0 || s >= n_out) return chase::value_entry(0);
  const int l = __ldg(w.last + s);
  if (l < 0) return chase::value_entry(__ldg(out + s));
  if (l < below) return static_cast<unsigned>(static_cast<int>(s));
  const int f = __ldg(w.first + s);
  if (f == kOneWriter || f >= below) return chase::value_entry(__ldg(out + s));
  int dst = 0, len = 0, src = 0, per = 0;
  for (int64_t u = below - 1; u >= f && u >= below - kNear; --u) {
    rec(u, dst, len, src, per);
    if (len > 0 && dst <= s && s < static_cast<int64_t>(dst) + len)
      return virtual_entry<kPiece>(u, static_cast<int>(s - dst));
  }
  int best = f;
  for (int64_t r = row_of<kPiece>(s) - 1; r <= row_of<kPiece>(s); ++r) {
    for (int u = __ldg(w.heads + r); u >= 0; u = __ldg(w.next + u)) {
      if (u <= best || u >= below) continue;
      rec(u, dst, len, src, per);
      if (dst <= s && s < static_cast<int64_t>(dst) + len) best = u;
    }
  }
  rec(best, dst, len, src, per);
  return virtual_entry<kPiece>(best, static_cast<int>(s - dst));
}

template <class Rec>
__global__ void __launch_bounds__(chase::kThreads)
mark_kernel(const Rec rec, int64_t n, int64_t n_out, Scratch w) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * chase::kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * chase::kWarps +
                   (threadIdx.x >> 5);
       g * 32 < n; g += warps) {
    const int64_t t = g * 32 + lane;
    int dst = 0, len = 0, src = 0, per = 0;
    if (t < n) rec(t, dst, len, src, per);
    if (len > 0 && dst >= -Rec::kPiece && dst < n_out)
      w.next[t] = atomicExch(w.heads + row_of<Rec::kPiece>(dst),
                             static_cast<int>(t));
    spread_events(lane, static_cast<int>(t), dst, len, src, len, 0,
                  [&](bool live, int tr, int, int64_t p, int64_t) {
                    if (!live || p < 0 || p >= n_out) return;
                    const int old = atomicMax(w.last + p, tr);
                    if (old >= 0) atomicMin(w.first + p, min(old, tr));
                  });
  }
}

template <class Rec>
__global__ void __launch_bounds__(chase::kThreads)
pointer_kernel(const Rec rec, int64_t n, int64_t n_out,
               const int* __restrict__ out, Scratch w) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * chase::kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * chase::kWarps +
                   (threadIdx.x >> 5);
       g * 32 < n; g += warps) {
    const int64_t t = g * 32 + lane;
    int dst = 0, len = 0, src = 0, per = 0;
    if (t < n) rec(t, dst, len, src, per);
    const int lo = len > 0 ? static_cast<int>(rec.lo(t)) : 0;
    spread_events(lane, static_cast<int>(t), dst, len, src, per, lo,
                  [&](bool live, int tr, int below, int64_t p, int64_t s) {
                    if (!live || p < 0 || p >= n_out) return;
                    if (__ldg(w.last + p) != tr) return;
                    w.state[p] = entry_of(rec, n_out, out, w, below, s);
                  });
  }
}

// chase::chase_elements' policy over the buffer bytes: a byte with a last
// writer is chased while its state holds a pointer.
template <class Rec>
struct Chain {
  Rec rec;
  int64_t n_out;
  const int* out;
  Scratch w;
  using Hop = unsigned long long;
  __device__ __forceinline__ bool start(int64_t j, int& v) const {
    if (__ldg(w.last + j) < 0) return false;
    const unsigned long long e = w.state[j];
    v = static_cast<int>(static_cast<unsigned>(e));
    return static_cast<unsigned>(e) != chase::kDone;
  }
  // A byte's state, or a writer's that has none, derived again.
  __device__ __forceinline__ Hop load(int v) const {
    if (v >= 0) return __ldcg(w.state + v);
    const int64_t id = -static_cast<int64_t>(v) - 2;
    const int64_t u = id >> log2_of(Rec::kPiece);
    const int i = static_cast<int>(id & (Rec::kPiece - 1));
    int dst = 0, len = 0, src = 0, per = 1;
    rec(u, dst, len, src, per);
    return entry_of(rec, n_out, out, w, rec.lo(u),
                    static_cast<int64_t>(src) + (i >= per ? i % per : i));
  }
  // Publish what the hop reached: a value, or a pointer further down.
  __device__ __forceinline__ bool step(int64_t j, int& v, Hop h) const {
    __stcg(w.state + j, h);
    v = static_cast<int>(static_cast<unsigned>(h));
    return static_cast<unsigned>(h) != chase::kDone;
  }
};

template <class Rec>
__global__ void __launch_bounds__(chase::kThreads)
chase_kernel(const Chain<Rec> ch) {
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * chase::kThreads *
                         chase::kChase + threadIdx.x;
  chase::chase_elements(ch, j0, ch.n_out);
}

__global__ void __launch_bounds__(chase::kThreads)
store_kernel(int* out, int64_t n_out, const int* __restrict__ last,
             const unsigned long long* __restrict__ state) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p < n_out && last[p] >= 0) out[p] = static_cast<int>(state[p] >> 32);
}

// Rows of a buffer of n_out bytes in heads[] (row_of, one row more).
template <int kPiece>
inline int64_t n_rows(int64_t n_out) {
  return (n_out + kPiece - 1) / kPiece + 2;
}

// Resolve the n slots of `rec` into out[0, n_out), with the scratch w:
// last, first (n_out ints), state (n_out 64-bit words), heads
// (n_rows<Rec::kPiece>(n_out) ints), next (n ints).  Eight steps on the
// stream, nothing read back.
template <class Rec>
inline int launch(int* out, int64_t n_out, const Rec& rec, int64_t n,
                  const Scratch& w, cudaStream_t stream) {
  if (n <= 0 || n_out <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(w.last, 0xFF, n_out * 4, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(w.first, 0x7F, n_out * 4, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(w.heads, 0xFF, n_rows<Rec::kPiece>(n_out) * 4,
                          stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (n + 32 * chase::kWarps - 1) / (32 * chase::kWarps);
  if (blocks > chase::kPointerBlocks) blocks = chase::kPointerBlocks;
  const unsigned pb = static_cast<unsigned>(blocks);
  mark_kernel<<<pb, chase::kThreads, 0, stream>>>(rec, n, n_out, w);
  pointer_kernel<<<pb, chase::kThreads, 0, stream>>>(rec, n, n_out, out, w);
  const int64_t per = static_cast<int64_t>(chase::kThreads) * chase::kChase;
  chase_kernel<<<static_cast<unsigned>((n_out + per - 1) / per),
                 chase::kThreads, 0, stream>>>(Chain<Rec>{rec, n_out, out, w});
  store_kernel<<<static_cast<unsigned>((n_out + chase::kThreads - 1) /
                                       chase::kThreads),
                 chase::kThreads, 0, stream>>>(out, n_out, w.last, w.state);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace group_chase
