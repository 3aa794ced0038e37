// The piece-loop microbenchmark for Hopper: the v12 narrow-piece group
// walk, and the group loop under variants that drop parts of its work, to
// see what a piece costs.
//
// Replaces the TPU kernel _kernel of tools/microbench_pb.py (:31).  Piece
// t is two words: w0 = dst_row << 16 | rp << 8 | (rp + len) and w1 =
// q_row << 16 | r << 8 | (128 - r), q = q_row * 128 + r the first word of
// a 128-word source window whose word L goes to dst_row * 128 + L for L in
// [rp, rp + len).  The TPU kernel DMAs stage_rows rows of both word arrays
// into SMEM per stage, then walks the stage's groups of 8 in order, each
// group issuing its 8 loads (2 rows, a lane roll and a row select) before
// its 8 masked one-row stores.  A source word outside the buffer reads as
// 0; a store outside it is dropped.
//
// Two designs:
//
//  * the event chase (`dbg_microbench_chase`; full and unroll2/4/8, which
//    compute one function).  Every written word is an event: piece t
//    writes p = dst_row * 128 + L with the value its source word s = q + L
//    held before t's group, which is the last event on s from an earlier
//    group, else the buffer's word.  The tool's list rewrites each word
//    about 54 times, and nearly every event reads a word an earlier group
//    wrote, so every event gets a 64-bit state of its own:
//      - the wrapper scans the pieces' event counts (a tensor op), reads
//        the total back once and sizes the scratch from it; events are
//        numbered in slot order, so an event's number orders it as its
//        slot does (a piece writes a word once);
//      - `piece_rows_kernel` counts the pieces and their events by the
//        row of their first word, then places each piece in its row's
//        bucket (a counting sort; `scan_kernel` scans the counts), and
//        `sort_kernel` sorts each bucket by slot (a warp a bucket: a
//        bitonic network in shared memory up to kSegSmem entries, in
//        device memory beyond);
//      - `row_kernel`: a piece writes within one 128-word row, so a row's
//        bucket holds every writer of its words.  A thread a word walks
//        the bucket in slot order twice, to count its writers and then to
//        list them in `seg`: each word's writers as a segment, in slot
//        order, with no atomics;
//      - `pointer_kernel`: each event binary-searches its source's segment
//        for the last writer below its group's first event: a pointer to
//        that event's state, else a value (out[s], read before any store,
//        or 0 outside the buffer);
//      - `event_chase_kernel`: chase::chase_elements over the events, the
//        owner alone storing an event's state (a shorter pointer between
//        hops, then its value).  Every pointer names an event of an
//        earlier group, so every chain ends whatever the order of blocks;
//      - `store_kernel`: each word takes its last writer's value.
//
//  * the staged loop (`dbg_microbench_pb`; the probes).  One CTA runs the
//    pieces in stages: its threads stage stage_rows * 128 pieces into
//    shared memory, then one warp walks the stage's groups in order (all
//    loads of a group, __syncwarp(), then the stores in slot order).  A
//    staged piece is w0 and the 16-bit distance dst_row * 128 - q (6
//    bytes; the packing makes w1 a function of the two), so 256 staged
//    rows fit the 227 KB a block may hold.  Variants:
//      load_only   the 8 windows summed lane by lane into row 8;
//      store_only  zeros stored under each piece's mask;
//      scalar_only the words unpacked and summed, the sum stored across
//                  row 8;
//      scalar_smem the same sum kept in shared memory, nothing stored;
//      noop        the loop with an empty body (noop8: 8 groups an
//                  iteration);
//      nodma       the group walk, but the stage is never filled
//                  (undefined output).
//
// What bounds it on the H100.  The chase: L2 traffic across all 132 SMs;
// per event a search of about log2(writers) loads of a sector each (the
// largest pass), a segment entry written, a 64-bit state written and
// chased (a hop is one L2 load; publication cuts a chain of depth D to
// about log2 D rounds): 12 bytes of scratch an event.  Taken in slot
// order, the warps running together covered the whole buffer and the
// searches missed the L2.  The loop: latency; one warp walks every group,
// and a group's loads wait for the stores before them.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "chase.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kThreads = 256;
constexpr int kAccRow = 8;

enum Variant {
  kFull = 0,
  kLoadOnly = 1,
  kStoreOnly = 2,
  kScalarOnly = 3,
  kScalarSmem = 4,
  kNoop = 5,
  kNodma = 6,
};

// ---------------------------------------------------------------------------
// The event chase
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = chase::kFull;
constexpr int kWarps = kThreads / 32;
constexpr int kSegSmem = 1024;  // a segment a warp sorts in shared memory
constexpr int kScanThreads = 1024;
constexpr int kScanBlocks = 32;
constexpr int kRow = 128;  // words a row; a piece writes within one row

// The pieces: packed words, the inclusive prefix sums of their event
// counts (their words inside the buffer, from max(dst, 0)), and `order`,
// the pieces by the row of their first word and by slot within a row.
struct Pieces {
  const int* __restrict__ w0;
  const int* __restrict__ w1;
  const int* __restrict__ ends;
  int* __restrict__ order;
  int n;
};

__device__ __forceinline__ int first_word(int a) {
  const int d0 = (a >> 16) * kRow + ((a >> 8) & 127);
  return d0 > 0 ? d0 : 0;
}

__device__ __forceinline__ int first_event(const Pieces& pc, int t) {
  return t > 0 ? __ldg(pc.ends + t - 1) : 0;
}

// Per row (the row of each piece's first word, the last row for a piece
// past the buffer): kCount counts its pieces into rows[0, n_rows) and
// their events into rows[n_rows + 1, ...), the lanes of a warp on one row
// with one atomic each; !kCount places each piece in its row's bucket of
// `order` (starts in bucket, counted again in rows[0, n_rows)).
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
piece_rows_kernel(Pieces pc, int n_rows, int* rows, const int* bucket) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * kThreads;
       t0 < pc.n; t0 += stride) {
    const int t = static_cast<int>(t0 + threadIdx.x);
    int row = -1, len = 0;
    if (t < pc.n) {
      row = first_word(__ldg(pc.w0 + t)) / kRow;
      row = row < n_rows ? row : n_rows - 1;
      len = __ldg(pc.ends + t) - first_event(pc, t);
    }
    const unsigned peers = __match_any_sync(kFullMask, row);
    const int leader = __ffs(peers) - 1;
    if (kCount) {
      const int events = __reduce_add_sync(peers, len);
      if (row >= 0 && lane == leader) {
        atomicAdd(rows + row, __popc(peers));
        atomicAdd(rows + n_rows + 1 + row, events);
      }
    } else {
      int at = 0;
      if (row >= 0 && lane == leader) at = atomicAdd(rows + row, __popc(peers));
      at = __shfl_sync(kFullMask, at, leader) +
           __popc(peers & ((1u << lane) - 1));
      if (row >= 0) pc.order[__ldg(bucket + row) + at] = t;
    }
  }
}

// Each word's writers in slot order, a block of kRow threads a row, a
// thread a word: the row's pieces (its bucket, sorted by slot) pass
// through shared memory kRow at a time, twice: to count each word's
// writers, whose scan over the row (from the row's first event, base)
// gives start, then to write them into seg.
__global__ void __launch_bounds__(kRow)
row_kernel(Pieces pc, int64_t n_out, int n_rows, const int* __restrict__ bucket,
           const int* __restrict__ base, int* __restrict__ start,
           int* __restrict__ seg) {
  __shared__ int s_lo[kRow], s_hi[kRow], s_ev[kRow];
  __shared__ int red[kRow / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const int b0 = __ldg(bucket + r), b1 = __ldg(bucket + r + 1);
    const int w = threadIdx.x;  // the thread's word in the row
    int k = 0, at = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int c = b0; c < b1; c += kRow) {
        __syncthreads();
        if (c + w < b1) {
          const int t = __ldg(pc.order + c + w);
          const int e0 = first_event(pc, t);
          const int lo = first_word(__ldg(pc.w0 + t)) - r * kRow;
          s_lo[w] = lo;
          s_hi[w] = lo + __ldg(pc.ends + t) - e0;
          s_ev[w] = e0 - lo;  // + word: the piece's event on that word
        }
        __syncthreads();
        const int n = b1 - c < kRow ? b1 - c : kRow;
        for (int j = 0; j < n; ++j) {
          if (s_lo[j] <= w && w < s_hi[j]) {
            if (pass == 1) seg[at + k] = s_ev[j] + w;
            ++k;
          }
        }
      }
      if (pass == 0) {  // at = base + the writers of the words before w
        int incl = k;
        for (int off = 1; off < 32; off <<= 1) {
          const int x = __shfl_up_sync(kFullMask, incl, off);
          if (lane >= off) incl += x;
        }
        __syncthreads();
        if (lane == 31) red[wid] = incl;
        __syncthreads();
        at = __ldg(base + r) + incl - k;
        for (int i = 0; i < wid; ++i) at += red[i];
        const int64_t word = static_cast<int64_t>(r) * kRow + w;
        if (word < n_out) start[word] = at;
        if (r == n_rows - 1 && w == 0) start[n_out] = __ldg(base + n_rows);
        k = 0;
      }
    }
  }
}

// The sum of `v` over the block, to every thread; `red` holds a word a
// warp.
__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[threadIdx.x & 31];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// start[i] = the sum of cnt[0, i), for i <= n.  Block b takes a run of
// the n counts: it sums the counts before its run (every block reads them
// again, in the L2), then scans its run 4 counts a thread at a time,
// threads on neighbouring counts.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ cnt, int64_t n, int* __restrict__ start) {
  __shared__ int red[kScanThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t chunk = ((n + gridDim.x - 1) / gridDim.x + 3) & ~int64_t{3};
  const int64_t lo = blockIdx.x * chunk < n ? blockIdx.x * chunk : n;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  int pre = 0;
#pragma unroll 8
  for (int64_t i = threadIdx.x; i < lo; i += kScanThreads) pre += __ldg(cnt + i);
  int carry = block_sum(pre, red);
  for (int64_t t0 = lo; t0 < hi; t0 += 4 * kScanThreads) {
    const int64_t i = t0 + 4 * threadIdx.x;
    int v[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = i + k < hi ? __ldg(cnt + i + k) : 0;
      sum += v[k];
    }
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += x;
    }
    __syncthreads();
    if (lane == 31) red[wid] = incl;
    __syncthreads();
    const int w = red[lane];
    int wincl = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(kFullMask, wincl, off);
      if (lane >= off) wincl += x;
    }
    int run = carry + __shfl_sync(kFullMask, wincl - w, wid) + incl - sum;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < hi) start[i + k] = run;
      run += v[k];
    }
    carry += __shfl_sync(kFullMask, wincl, 31);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) start[n] = carry;
}

// Sort v[0, n) ascending by one warp: a bitonic network in the form
// whose every comparator puts the smaller value at the lower index (each
// merge starts by comparing i with its mirror in the block), over n
// padded to a power of two.  The padding is +infinity, never moved, so a
// comparator that reaches past n is skipped.
template <class P>
__device__ __forceinline__ void sort_warp(P v, int n, int lane) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int m = lane; m < n2 / 2; m += 32) {
        const int a = ((m & ~(j - 1)) << 1) | (m & (j - 1));
        const int b = j == k >> 1 ? a ^ (k - 1) : a | j;
        if (b < n) {
          const int x = v[a], y = v[b];
          if (x > y) {
            v[a] = y;
            v[b] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Sort each segment v[start[i], start[i + 1]) of v, i < n: a warp a
// segment (the rows' buckets of pieces).
__global__ void __launch_bounds__(kThreads)
sort_kernel(const int* __restrict__ start, int64_t n_seg, int* v) {
  __shared__ int buf[kWarps][kSegSmem];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + wid;
       i < n_seg; i += warps) {
    const int lo = __ldg(start + i), n = __ldg(start + i + 1) - lo;
    int* x = v + lo;
    if (n < 2) continue;
    if (n <= kSegSmem) {
      for (int j = lane; j < n; j += 32) buf[wid][j] = x[j];
      __syncwarp();
      sort_warp(buf[wid], n, lane);
      for (int j = lane; j < n; j += 32) x[j] = buf[wid][j];
    } else {
      sort_warp(x, n, lane);
    }
    __syncwarp();
  }
}

// Each event's state: a binary search of its source's segment for the
// first writer at or past glo, the first event of the event's group; the
// writer before it, if any, is the last one below the group.  The pieces
// come in bucket order, 32 a warp, their events spread 32 at a time over
// the lanes, neighbouring lanes on neighbouring words: the warps that run
// together read neighbouring segments, which stay in the L2.
__global__ void __launch_bounds__(kThreads)
pointer_kernel(const int* __restrict__ out, int64_t n_out, Pieces pc,
               const int* __restrict__ start, const int* __restrict__ seg,
               unsigned long long* __restrict__ state) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       g * 32 < pc.n; g += warps) {
    const int64_t k = g * 32 + lane;
    int len = 0, first = 0, glo = 0, s0 = 0;  // s0: the first word's source
    if (k < pc.n) {
      const int t = __ldg(pc.order + k), lo = t & ~(kGroup - 1);
      const int a = __ldg(pc.w0 + t), b = __ldg(pc.w1 + t);
      first = first_event(pc, t);
      len = __ldg(pc.ends + t) - first;
      glo = first_event(pc, lo);
      s0 = first_word(a) + (b >> 16) * kRow + ((b >> 8) & 127) -
           (a >> 16) * kRow;
    }
    int incl = len;  // the warp's events, numbered locally
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += v;
    }
    const int loc = incl - len;
    const int total = __shfl_sync(kFullMask, incl, 31);
    for (int q = lane; q - lane < total; q += 32) {
      int r = 0;  // the last piece whose events start at or before q
      for (int step = 16; step > 0; step >>= 1) {
        if (__shfl_sync(kFullMask, loc, r + step) <= q) r += step;
      }
      const int i = q - __shfl_sync(kFullMask, loc, r);
      const int e = __shfl_sync(kFullMask, first, r) + i;
      const int ge = __shfl_sync(kFullMask, glo, r);
      const int64_t s = static_cast<int64_t>(__shfl_sync(kFullMask, s0, r)) + i;
      if (q >= total) continue;
      if (s < 0 || s >= n_out) {
        state[e] = chase::value_entry(0);
        continue;
      }
      const int lo = __ldg(start + s);
      int x = lo, y = __ldg(start + s + 1);
      while (x < y) {
        const int mid = (x + y) >> 1;
        if (__ldg(seg + mid) < ge) x = mid + 1;
        else y = mid;
      }
      state[e] = x > lo ? chase::pointer_entry(__ldg(seg + x - 1))
                        : chase::value_entry(__ldg(out + s));
    }
  }
}

// An event's state: chase's 64-bit entry, a pointer (another event's
// number) while it is chased, then its value behind kDone.
struct EventChain {
  unsigned long long* state;
  using Hop = unsigned long long;
  __device__ __forceinline__ bool start(int64_t j, int& v) const {
    const unsigned long long h = state[j];
    v = static_cast<int>(static_cast<unsigned>(h));
    return static_cast<unsigned>(h) != chase::kDone;
  }
  __device__ __forceinline__ Hop load(int v) const {
    return __ldcg(state + v);
  }
  // The value, or a shorter pointer on the same chain: publish it.
  __device__ __forceinline__ bool step(int64_t j, int& v, Hop h) const {
    __stcg(state + j, h);
    v = static_cast<int>(static_cast<unsigned>(h));
    return static_cast<unsigned>(h) != chase::kDone;
  }
};

__global__ void __launch_bounds__(kThreads)
event_chase_kernel(unsigned long long* state, int n_events) {
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kThreads *
                         chase::kChase + threadIdx.x;
  chase::chase_elements(EventChain{state}, j0, n_events);
}

__global__ void __launch_bounds__(kThreads)
store_kernel(int* __restrict__ out, int64_t n_out,
             const int* __restrict__ start, const int* __restrict__ seg,
             const unsigned long long* __restrict__ state) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       w < n_out; w += stride) {
    const int hi = __ldg(start + w + 1);
    if (hi > __ldg(start + w)) {
      out[w] = static_cast<int>(__ldg(state + __ldg(seg + hi - 1)) >> 32);
    }
  }
}

unsigned grid_of(int64_t items, int64_t per_block) {
  const int64_t blocks = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks < chase::kPointerBlocks
                                   ? blocks
                                   : chase::kPointerBlocks);
}

// ---------------------------------------------------------------------------
// The staged loop
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned w1_of(int w0, int dist) {
  const int q = (w0 >> 16) * 128 - dist;
  const int r = q & 127;
  return (static_cast<unsigned>(q >> 7) << 16) | (r << 8) | (128 - r);
}

template <int V>
__device__ __forceinline__ void group(int* out, int64_t n_out,
                                      const int* s_w0,
                                      const unsigned short* s_dist, int i0,
                                      int lane, volatile int* acc_s) {
  if (V == kNoop) return;
  if (V == kScalarSmem || V == kScalarOnly) {
    unsigned t = 0;
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      t += static_cast<unsigned>(s_w0[i0 + g]) + w1_of(s_w0[i0 + g],
                                                       s_dist[i0 + g]);
    if (V == kScalarSmem) {
      if (lane == 0) *acc_s = static_cast<int>(t);
    } else {
      for (int L = lane; L < 128; L += 32)
        out[kAccRow * 128 + L] = static_cast<int>(t);
      __syncwarp();
    }
    return;
  }
  int v[kGroup][4];
  if (V != kStoreOnly) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int w0 = s_w0[i0 + g];
      const int64_t q = static_cast<int64_t>(w0 >> 16) * 128 - s_dist[i0 + g];
      const int rp = (w0 >> 8) & 127, hi = w0 & 255;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int L = lane + 32 * k;
        const int64_t s = q + L;
        const bool need = V == kLoadOnly || (L >= rp && L < hi);
        v[g][k] = (need && s >= 0 && s < n_out) ? out[s] : 0;
      }
    }
    __syncwarp();
  }
  if (V == kLoadOnly) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned a = 0;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) a += static_cast<unsigned>(v[g][k]);
      out[kAccRow * 128 + lane + 32 * k] = static_cast<int>(a);
    }
    __syncwarp();
    return;
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int w0 = s_w0[i0 + g];
    const int64_t base = static_cast<int64_t>(w0 >> 16) * 128;
    const int rp = (w0 >> 8) & 127, hi = w0 & 255;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int L = lane + 32 * k;
      if (L >= rp && L < hi && base + L >= 0 && base + L < n_out)
        out[base + L] = V == kStoreOnly ? 0 : v[g][k];
    }
    __syncwarp();  // a later piece's store to the same word wins
  }
}

template <int V, int U>
__global__ void __launch_bounds__(kThreads)
microbench_kernel(int* out, int64_t n_out, const int* __restrict__ w0,
                  const int* __restrict__ w1, int n_stages, int stage_rows) {
  extern __shared__ int s_w0[];
  __shared__ int acc_s;
  const int per_stage = stage_rows * 128;
  unsigned short* s_dist = reinterpret_cast<unsigned short*>(s_w0 + per_stage);
  const int lane = threadIdx.x & 31;
  for (int st = 0; st < n_stages; ++st) {
    if (V != kNodma) {
      for (int j = threadIdx.x; j < per_stage; j += kThreads) {
        const int64_t t = static_cast<int64_t>(st) * per_stage + j;
        const int a = w0[t], b = w1[t];
        s_w0[j] = a;
        s_dist[j] = static_cast<unsigned short>(
            (a >> 16) * 128 - ((b >> 16) * 128 + ((b >> 8) & 127)));
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      constexpr int W = V == kNodma ? kFull : V;
      for (int gi = 0; gi < per_stage / kGroup; gi += U) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          group<W>(out, n_out, s_w0, s_dist, (gi + u) * kGroup, lane, &acc_s);
      }
    }
    __syncthreads();
  }
}

template <int V, int U>
int launch(int* out, int64_t n_out, const int* w0, const int* w1,
           int n_stages, int stage_rows, cudaStream_t stream) {
  const int smem = stage_rows * 128 * (4 + 2);
  cudaError_t err = cudaFuncSetAttribute(
      microbench_kernel<V, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  microbench_kernel<V, U><<<1, kThreads, smem, stream>>>(
      out, n_out, w0, w1, n_stages, stage_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The group walk of n_pieces pieces into out (n_out words, below 2^31) by
// the event chase.  ends: the inclusive prefix sums of the pieces' event
// counts (n_events in all, below 2^30).  Scratch: order n_pieces words,
// rows 4 (n_rows + 1) words (n_rows = ceil(n_out / 128)), start
// n_out + 1 words, seg n_events words, state n_events 64-bit words.
extern "C" int dbg_microbench_chase(int* out, int64_t n_out, const int* w0,
                                    const int* w1, const int* ends,
                                    int n_pieces, int n_events, int* order,
                                    int* rows, int* start, int* seg,
                                    unsigned long long* state,
                                    cudaStream_t stream) {
  if (n_pieces <= 0 || n_events <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (n_out >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Pieces pc{w0, w1, ends, order, n_pieces};
  const int n_rows = static_cast<int>((n_out + kRow - 1) / kRow);
  int* bucket = rows + 2 * (n_rows + 1);  // a row's first piece in order
  int* base = rows + 3 * (n_rows + 1);    // a row's first writer in seg
  cudaError_t err = cudaMemsetAsync(rows, 0, 2 * (n_rows + 1) * sizeof(int),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned by_piece = grid_of(n_pieces, kThreads);
  piece_rows_kernel<true><<<by_piece, kThreads, 0, stream>>>(pc, n_rows, rows,
                                                             bucket);
  scan_kernel<<<kScanBlocks, kScanThreads, 0, stream>>>(rows, n_rows, bucket);
  scan_kernel<<<kScanBlocks, kScanThreads, 0, stream>>>(rows + n_rows + 1,
                                                        n_rows, base);
  err = cudaMemsetAsync(rows, 0, n_rows * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  piece_rows_kernel<false><<<by_piece, kThreads, 0, stream>>>(pc, n_rows,
                                                              rows, bucket);
  sort_kernel<<<grid_of(n_rows, kWarps), kThreads, 0, stream>>>(bucket, n_rows,
                                                               order);
  row_kernel<<<grid_of(n_rows, 1), kRow, 0, stream>>>(pc, n_out, n_rows, bucket,
                                                      base, start, seg);
  pointer_kernel<<<grid_of(n_pieces, 32 * kWarps), kThreads, 0, stream>>>(
      out, n_out, pc, start, seg, state);
  const int64_t per = static_cast<int64_t>(kThreads) * chase::kChase;
  event_chase_kernel<<<static_cast<unsigned>((n_events + per - 1) / per),
                       kThreads, 0, stream>>>(state, n_events);
  store_kernel<<<grid_of(n_out, kThreads), kThreads, 0, stream>>>(
      out, n_out, start, seg, state);
  return static_cast<int>(cudaGetLastError());
}

// The staged loop.  variant: the Variant codes above but kFull (the
// chase's); unroll: 1, or 8 for noop.  Returns cudaErrorInvalidValue for
// any other pair.
extern "C" int dbg_microbench_pb(int* out, int64_t n_out, const int* w0,
                                 const int* w1, int n_stages, int stage_rows,
                                 int variant, int unroll,
                                 cudaStream_t stream) {
  if (n_stages <= 0) return static_cast<int>(cudaGetLastError());
#define MB_CASE(v, u)                                                     \
  if (variant == v && unroll == u)                                        \
    return launch<v, u>(out, n_out, w0, w1, n_stages, stage_rows, stream);
  MB_CASE(kLoadOnly, 1)
  MB_CASE(kStoreOnly, 1)
  MB_CASE(kScalarOnly, 1)
  MB_CASE(kScalarSmem, 1)
  MB_CASE(kNoop, 1)
  MB_CASE(kNoop, 8)
  MB_CASE(kNodma, 1)
#undef MB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
