// Greedy LZ77 selection for Hopper: chunks walk speculatively across the
// whole grid, then a ticketed hand-off fixes each chunk's entry.
//
// Replaces the TPU kernel _greedy_walk_kernel (debigulator_tpu/ops/
// deflate_encode_jnp.py:44).  That kernel is a scalar-core loop over SMEM
// stages filled and flushed with hand-rolled DMAs, over (rows, 128) padded
// arrays; none of that staging is kept.  What it computes is kept exactly:
// the orbit of 0 under next(i) = i + (len[i] >= 3 ? len[i] : 1) below n,
// one record (i, len[i] << 16 | dist[i]) per visited i with len[i] >= 3,
// in order, and the record count.
//
// What bounds it on the H100: latency.  The walk is one dependent chain,
// and one warp stepping through shared memory covers a few ns a position,
// so one warp walking a 4 MB input takes ~18 ms (NVIDIA H100 80GB HBM3,
// 700 W).  But greedy parses started at nearby positions merge after a
// few tokens, and once merged they agree.  So, one CTA per chunk of
// kChunk positions, in ticket order (atomicAdd at start, so a CTA only
// ever waits on one that is already running):
//
// 1. Speculate.  The CTA stages its chunk's lengths in shared memory (and
//    per 32 positions the ballot of len >= 3).  Each of its kStarts warps
//    walks from one of the chunk's first kStarts positions (32 positions a
//    step: the ballot, then the walk over those 32 in registers, a shuffle
//    per match) and marks its orbit in a bitmap; it records its exit (the
//    first orbit position past the chunk) and, per bitmap word, how many
//    orbit matches lie at or after it.  All chunks do this at once, across
//    the grid.  Several starts cover parses that never merge within a
//    chunk, such as every len = 3, whose orbits are the residues mod 3.
// 2. Hand off.  The true entry of chunk k is chunk k-1's true exit; chunk
//    k-1 publishes it, with the records before chunk k, in one status word.
//    If the entry lies on a speculative orbit, the two parses agree from
//    there: the exit is that orbit's and the count is read off its per-word
//    counts, a few shared loads.  Otherwise warp 0 re-walks from the entry
//    until it meets a position on any orbit (merge) or leaves the chunk.
//    Only this step is serial, and on real data it is a status load, a bit
//    test and a status store per chunk, plus a short re-walk.
// 3. Emit.  The chunk's true orbit is the re-walked prefix plus the merged
//    orbit from the merge point; each thread takes one bitmap word, a block
//    scan ranks the records, and they are written at the chunk's offset.
//    The last chunk writes the count.
//
// What is left serial is the chain of hand-offs, each a few L2 round
// trips, and the re-walks.  Both are paid once a chunk, so chunks are
// large: kChunk = 16384 positions keeps ~103 KB of shared state (dynamic
// shared memory), two CTAs an SM, and a 4 MB input is 257 chunks, all
// resident at once.  An input whose parses never merge with any of the
// kStarts orbits (a period of short matches longer than kStarts)
// re-walks most chunks in the hand-off: one warp's serial walk again, out
// of shared memory that was staged in parallel.  Lengths are
// used as given (a match may jump past any number of chunks; a chunk whose
// entry lies past its end has no records and passes the entry on).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStarts = kThreads / 32;  // a speculative orbit per warp
constexpr int kChunk = 16384;
constexpr int kWords = kChunk / 32;
constexpr int kWordsPerThread = (kWords + kThreads - 1) / kThreads;
constexpr int kMinMatch = 3;
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kWords % 32 == 0, "whole bitmap words a lane");

// The chunk's shared memory (dynamic: above 48 KB for large chunks).
struct Smem {
  int len[kChunk];
  unsigned match[kWords];           // len >= 3
  unsigned spec[kStarts][kWords];   // orbit from offset j
  int after[kStarts][kWords + 1];   // its matches in words >= w
  unsigned any[kWords];             // on some orbit
  unsigned truth[kWords];           // re-walked prefix of the true orbit
  int64_t exit[kStarts];
  int warp_sum[kThreads / 32];
  int ticket, merge, orbit, prefix;
};

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

struct Walk {
  int64_t at;  // chunk offset where the walk stopped (>= span, or the merge)
  int taken;   // matches taken before it stopped
  bool merged;
};

// One warp walks the chunk from offset `start` (< span), writing the
// visited positions of each word it passes into vis[] (lane 0).  With
// `stop`, it ends at the first visited position marked there (not marked
// in vis[], not counted).  s_len holds lengths clamped so that no offset
// overflows 31 bits; s_match[w] is the ballot of len >= 3 over word w (0
// past span).
__device__ Walk walk_chunk(const int* s_len, const unsigned* s_match, int span,
                           int start, unsigned* vis, const unsigned* stop,
                           int lane) {
  int64_t at = start;
  int taken = 0;
  while (at < span) {
    const int w = static_cast<int>(at >> 5);
    const int len = s_len[(w << 5) + lane];
    const unsigned mask = s_match[w];
    unsigned took = 0, seen = 0;
    int p = static_cast<int>(at & 31);
    while (p < 32) {
      const unsigned ahead = mask >> p;
      if (ahead == 0) {  // literals to the end of the word
        seen |= kFull << p;
        p = 32;
        break;
      }
      const int first = p + __ffs(ahead) - 1;
      seen |= (kFull << p) & (kFull >> (31 - first));
      took |= 1u << first;
      p = first + __shfl_sync(kFull, len, first);
    }
    const int left = span - (w << 5);
    if (left < 32) seen &= (1u << left) - 1u;
    if (stop != nullptr) {
      const unsigned hit = seen & stop[w];
      if (hit != 0) {
        const int b = __ffs(hit) - 1;
        const unsigned below = (1u << b) - 1u;
        if (lane == 0) vis[w] = seen & below;
        return {(w << 5) + b, taken + __popc(took & below), true};
      }
    }
    if (lane == 0) vis[w] = seen;
    taken += __popc(took);
    at = (static_cast<int64_t>(w) << 5) + p;
  }
  return {at, taken, false};
}

__global__ void __launch_bounds__(kThreads)
greedy_walk_kernel(const int* __restrict__ best_len,
                   const int* __restrict__ best_dist, int64_t n, int n_chunks,
                   int* __restrict__ pos_out, int* __restrict__ meta_out,
                   int* __restrict__ count_out,
                   unsigned long long* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) sm.ticket = atomicAdd(reinterpret_cast<int*>(status + n_chunks), 1);
  __syncthreads();
  const int k = sm.ticket;
  const int64_t base = static_cast<int64_t>(k) * kChunk;
  const int span = static_cast<int>(n - base < kChunk ? n - base : kChunk);
  // A clamped length jumps past n exactly when the true one does, and
  // keeps every offset below 2^31.
  const int64_t clamp = n > kMinMatch ? n : kMinMatch;
  for (int j = tid; j < kChunk; j += kThreads) {
    int len = j < span ? best_len[base + j] : 0;
    if (len > clamp) len = static_cast<int>(clamp);
    sm.len[j] = len;
    const unsigned bits = __ballot_sync(kFull, len >= kMinMatch);
    if (lane == 0) {
      sm.match[j >> 5] = bits;
      sm.truth[j >> 5] = 0;
      for (int o = 0; o < kStarts; ++o) sm.spec[o][j >> 5] = 0;
    }
  }
  __syncthreads();

  // 1. Speculate: warp j from the chunk's offset j.
  if (warp < span) {
    sm.exit[warp] = walk_chunk(sm.len, sm.match, span, warp, sm.spec[warp],
                               nullptr, lane).at;
    __syncwarp();
  }
  {
    constexpr int kPer = kWords / 32;
    int c[kPer];
    int mine = 0;
    for (int i = 0; i < kPer; ++i) {
      const int w = lane * kPer + i;
      c[i] = __popc(sm.spec[warp][w] & sm.match[w]);
      mine += c[i];
    }
    int after = mine;  // sum over lanes >= lane
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_down_sync(kFull, after, off);
      if (lane + off < 32) after += v;
    }
    int run = after - mine;
    for (int i = kPer - 1; i >= 0; --i) {
      run += c[i];
      sm.after[warp][lane * kPer + i] = run;
    }
    if (lane == 0) sm.after[warp][kWords] = 0;
  }
  __syncthreads();
  for (int w = tid; w < kWords; w += kThreads) {
    unsigned any = 0;
    for (int o = 0; o < kStarts; ++o) any |= sm.spec[o][w];
    sm.any[w] = any;
  }
  __syncthreads();

  if (warp == 0) {
    // 2. Hand-off: the true entry and the records before this chunk.
    unsigned long long prev = 0;
    if (k > 0) {
      if (lane == 0) {
        while ((prev = ld_status(status + k - 1)) == 0) {
        }
      }
      prev = __shfl_sync(kFull, prev, 0);
    }
    const int64_t entry = k > 0 ? static_cast<int64_t>(prev & kFull) - 1 : 0;
    const int prefix = static_cast<int>(prev >> 32);
    const int64_t t = entry - base;
    int64_t exit_at = entry;
    int merge = span, orbit = 0, count = 0;
    if (t < span) {  // else a match carried the walk past this chunk
      Walk fix{t, 0, ((sm.any[t >> 5] >> (t & 31)) & 1u) != 0};
      if (!fix.merged) {
        fix = walk_chunk(sm.len, sm.match, span, static_cast<int>(t),
                         sm.truth, sm.any, lane);
      }
      count = fix.taken;
      exit_at = base + fix.at;
      if (fix.merged) {
        merge = static_cast<int>(fix.at);
        const int w = merge >> 5;
        const unsigned on = lane < kStarts ? sm.spec[lane][w] >> (merge & 31) : 0u;
        orbit = __ffs(__ballot_sync(kFull, on & 1u)) - 1;
        exit_at = base + sm.exit[orbit];
        count += __popc(sm.spec[orbit][w] & sm.match[w] & (kFull << (merge & 31))) +
                 sm.after[orbit][w + 1];
      }
    }
    if (lane == 0) {
      const int64_t ex = exit_at < n ? exit_at : n;
      st_status(status + k,
                (static_cast<unsigned long long>(prefix + count) << 32) |
                    static_cast<unsigned long long>(ex + 1));
      if (k == n_chunks - 1) count_out[0] = prefix + count;
      sm.merge = merge;
      sm.orbit = orbit;
      sm.prefix = prefix;
    }
  }
  __syncthreads();

  // 3. Emit: the re-walked prefix, then the merged orbit from the merge;
  // kWordsPerThread consecutive bitmap words a thread.
  const int merge = sm.merge;
  const int wm = merge >> 5;
  const unsigned* spec = sm.spec[sm.orbit];
  unsigned bits[kWordsPerThread];
  int cnt = 0;
  for (int u = 0; u < kWordsPerThread; ++u) {
    const int w = tid * kWordsPerThread + u;
    bits[u] = 0;
    if (w < kWords) {
      const unsigned from = w > wm ? kFull : w == wm ? kFull << (merge & 31) : 0u;
      bits[u] = (sm.truth[w] | (spec[w] & from)) & sm.match[w];
    }
    cnt += __popc(bits[u]);
  }
  int incl = cnt;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) sm.warp_sum[warp] = incl;
  __syncthreads();
  int at = sm.prefix + incl - cnt;
  for (int i = 0; i < warp; ++i) at += sm.warp_sum[i];
  for (int u = 0; u < kWordsPerThread; ++u) {
    unsigned b32 = bits[u];
    while (b32 != 0) {
      const int b = __ffs(b32) - 1;
      b32 &= b32 - 1u;
      const int64_t p = base + ((tid * kWordsPerThread + u) << 5) + b;
      pos_out[at] = static_cast<int>(p);
      meta_out[at] = static_cast<int>((static_cast<unsigned>(best_len[p]) << 16) |
                                      static_cast<unsigned>(best_dist[p]));
      ++at;
    }
  }
}

}  // namespace

// The chunk size and the speculative starts a chunk, for the caller.
extern "C" int dbg_greedy_chunk() { return kChunk; }
extern "C" int dbg_greedy_starts() { return kStarts; }

// status: ceil(n / dbg_greedy_chunk()) + 1 int64 words zeroed by the
// caller (each chunk's hand-off word, then the ticket counter).
extern "C" int dbg_greedy_walk(const int* best_len, const int* best_dist,
                               int64_t n, int* pos_out, int* meta_out,
                               int* count_out, unsigned long long* status,
                               cudaStream_t stream) {
  if (n >= (int64_t{1} << 31) - 2 * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    // A function attribute belongs to the current card: set it on each
    // call, so a launch on any card of the process gets it.
    const cudaError_t set = cudaFuncSetAttribute(
        greedy_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (set != cudaSuccess) return static_cast<int>(set);
    greedy_walk_kernel<<<static_cast<unsigned>(n_chunks), kThreads,
                         sizeof(Smem), stream>>>(
        best_len, best_dist, n, static_cast<int>(n_chunks), pos_out, meta_out,
        count_out, status);
  }
  return static_cast<int>(cudaGetLastError());
}
