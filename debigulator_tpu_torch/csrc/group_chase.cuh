// Grid-wide chase with group semantics for Hopper, shared by the group
// resolvers v9 / v10 (groups_v9.cu, rows 10g and 10h of PERF.md's kernel
// table) and v11 (groups_v11.cu, row 10a).
//
// The TPU kernels walk their piece lists in slot order, one group of 8
// pieces at a time, and issue a group's 8 loads before its 8 stores.  So
// every written byte is an event: piece t writes byte p = dst + i with the
// value that byte s = src + i held before t's group (there is no overlap
// rule: a piece with dist < len reads the bytes before its group, not its
// own output).  That value is the last event on s from an earlier group,
// else the buffer's own byte at s as the call's earlier passes left it
// (literal pieces included); a source outside the buffer reads 0.  A
// byte's final value is its last event's by slot; stores outside the
// buffer are dropped.  The packer's groups (no piece reading what its
// group writes, every byte written once, sources below) make that the
// in-order LZ77 result, but the contract holds on any list.
//
// The chase needs no slot order, only two words per buffer byte:
//
//  * mark (`mark_kernel`): each event does atomicMax(last[p], t); an event
//    that finds another writer there also does atomicMin(first[p], the
//    smaller of the two), so `first` holds the first writer of every byte
//    with two or more and stays kOneWriter elsewhere.  Each live piece
//    also joins the list of the 128-byte row its destination starts in
//    (heads[row], next[t]), since a writer of byte s starts in s's row or
//    the one before;
//  * pointers (`pointer_kernel`): each byte's last writer stores its
//    event's state in state[p].  With g its group: a source outside the
//    buffer or with no writer is a value (0, or out[s], read here before
//    any store); a source whose last writer lies in an earlier group is a
//    pointer to that byte's state.  Otherwise an earlier writer of s
//    exists only if first[s] lies in a group before g, and it is the
//    largest covering slot below 8g: the kNear slots below 8g are tried
//    first (dense rewrites of one row), then the two rows' lists (never on
//    the packer's lists, where every byte has one writer).  That event
//    has no state of its own: the pointer names it as (slot, offset), and
//    a chase that reaches it derives its source again (`entry_of`);
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
// not its byte's last, -(t * 128 + i) - 2 (the wrapper keeps t * 128
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

constexpr int kGroup = 8;
constexpr int kMaxPiece = 128;
constexpr int kOneWriter = 0x7F7F7F7F;  // first[] after a 0x7F memset
constexpr int kNear = 32;  // slots tried below a group before the row lists

__device__ __forceinline__ unsigned long long virtual_entry(int64_t t, int i) {
  return static_cast<unsigned>(static_cast<int>(-(t * kMaxPiece + i) - 2));
}

// Spread the events of 32 pieces, one a lane (slot t, buffer position dst,
// length len (0 for none), source src), over the lanes: ev(live, t, p, s)
// for every event, in rounds of 32, every lane calling in every round.
template <class Ev>
__device__ __forceinline__ void spread_events(int lane, int t, int dst,
                                              int len, int src, const Ev& ev) {
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
    ev(q < total, __shfl_sync(chase::kFull, t, r),
       static_cast<int64_t>(__shfl_sync(chase::kFull, dst, r)) + i,
       static_cast<int64_t>(__shfl_sync(chase::kFull, src, r)) + i);
  }
}

// The list of the row that a piece at dst starts in: rows shifted by one,
// so that a piece starting in the 128 bytes before the buffer has one.
__device__ __forceinline__ int64_t row_of(int64_t dst) {
  return (dst >> 7) + 1;
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

// Where the last event on s before group g gets its value: see the header.
// rec(u, dst, len, src) decodes slot u (it sets len 0 for a slot that
// writes nothing, and then leaves dst and src as they were).
template <class Rec>
__device__ __forceinline__ unsigned long long entry_of(
    const Rec& rec, int64_t n_out, const int* out, const Scratch& w,
    int64_t g, int64_t s) {
  if (s < 0 || s >= n_out) return chase::value_entry(0);
  const int l = __ldg(w.last + s);
  if (l < 0) return chase::value_entry(__ldg(out + s));
  if (l / kGroup < g) return static_cast<unsigned>(static_cast<int>(s));
  const int f = __ldg(w.first + s);
  if (f == kOneWriter || f / kGroup >= g)
    return chase::value_entry(__ldg(out + s));
  int dst = 0, len = 0, src = 0;
  const int64_t below = g * kGroup;  // slot f < below covers s
  for (int64_t u = below - 1; u >= f && u >= below - kNear; --u) {
    rec(u, dst, len, src);
    if (len > 0 && dst <= s && s < static_cast<int64_t>(dst) + len)
      return virtual_entry(u, static_cast<int>(s - dst));
  }
  int best = f;
  for (int64_t r = row_of(s) - 1; r <= row_of(s); ++r) {
    for (int u = __ldg(w.heads + r); u >= 0; u = __ldg(w.next + u)) {
      if (u <= best || u >= below) continue;
      rec(u, dst, len, src);
      if (dst <= s && s < static_cast<int64_t>(dst) + len) best = u;
    }
  }
  rec(best, dst, len, src);
  return virtual_entry(best, static_cast<int>(s - dst));
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
    int dst = 0, len = 0, src = 0;
    if (t < n) rec(t, dst, len, src);
    if (len > 0 && dst >= -kMaxPiece && dst < n_out)
      w.next[t] = atomicExch(w.heads + row_of(dst), static_cast<int>(t));
    spread_events(lane, static_cast<int>(t), dst, len, src,
                  [&](bool live, int tr, int64_t p, int64_t) {
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
    int dst = 0, len = 0, src = 0;
    if (t < n) rec(t, dst, len, src);
    spread_events(lane, static_cast<int>(t), dst, len, src,
                  [&](bool live, int tr, int64_t p, int64_t s) {
                    if (!live || p < 0 || p >= n_out) return;
                    if (__ldg(w.last + p) != tr) return;
                    w.state[p] = entry_of(rec, n_out, out, w, tr / kGroup, s);
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
    const int64_t u = id / kMaxPiece;
    int dst = 0, len = 0, src = 0;
    rec(u, dst, len, src);
    return entry_of(rec, n_out, out, w, u / kGroup,
                    static_cast<int64_t>(src) + id % kMaxPiece);
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
inline int64_t n_rows(int64_t n_out) { return (n_out + 127) / 128 + 2; }

// Resolve the n slots of `rec` into out[0, n_out), with the scratch w:
// last, first (n_out ints), state (n_out 64-bit words), heads
// (n_rows(n_out) ints), next (n ints).  Eight steps on the stream, nothing
// read back.
template <class Rec>
inline int launch(int* out, int64_t n_out, const Rec& rec, int64_t n,
                  const Scratch& w, cudaStream_t stream) {
  if (n <= 0 || n_out <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(w.last, 0xFF, n_out * 4, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(w.first, 0x7F, n_out * 4, stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(w.heads, 0xFF, n_rows(n_out) * 4, stream);
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
