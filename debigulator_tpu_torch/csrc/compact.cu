// Compact for Hopper: per-cell padded match / run tapes -> dense,
// dst-sorted record lists in 128-record-aligned chunk regions, in one
// pass with a decoupled look-back for the running max.
//
// Replaces the TPU kernel _compact_kernel (debigulator_tpu/ops/
// phase_b_v15.py:126).  The TPU grid walks the chunks in order, carries
// the running max of valid dst in SMEM (lastd_ref) and lets each chunk's
// fixed-size flush overrun into the next chunk's region, relying on the
// serialized DMAs to overwrite it.  Blocks on the H100 run in parallel and
// in no order, so here every chunk writes exactly its own region and the
// carry is a decoupled look-back across the CTAs.
//
// Outputs (the reference's compact_v15 contract): chunk c's valid records
// (meta != 0) in order at base[c]*128 + rank; the rest of its region
// [base[c], end[c]) rows as (fill[c], 0), where end[c] = base[c+1] and the
// last chunk's end is base[-1] + cap_rows (the reference's tail fill) and
// fill[c] = max(0, max valid dst of chunks 0..c); (BIG, 0) from
// end[-1]*128 to dense_rows*128.  Every output slot is written once.
//
// Layout.  One CTA of 512 threads per (chunk, list), the pair taken from a
// ticket (atomicAdd) in the order CTAs start, ticket = 2*chunk + list, so
// a CTA only ever waits on CTAs that already run.  The CTA reads its chunk
// in tiles of 4096 records, 8 a thread held in registers, thread t taking
// records t, t+512, ... (each load instruction of a warp reads 128
// contiguous bytes).  A warp ballot per row of 512 gives each record its
// rank in its warp; the 8 x 16 warp counts go to shared memory (double
// buffered by tile parity, so one barrier a tile), and every warp scans
// all 128 of them itself with shuffles, so a valid record's slot is
// known without a second barrier.  Stores of a row are contiguous too.
// The thread's max of valid dst rides along.  After the last tile the CTA
// reduces its max (the chunk's aggregate) and publishes it as a 64-bit
// status word (flag << 32 | value; flag 1 = the chunk alone, 2 = inclusive
// through the chunk; chunk 0 publishes 2 at once).  While predecessors
// finish, the CTA writes its share of the (BIG, 0) region, which depends
// on no carry: that region is cut into equal row ranges, one per chunk.
// Then warp 0 looks back 32 predecessors at a time until it meets an
// inclusive status, publishes its own inclusive max, and the CTA fills
// the tail of its region.  One launch; the wrapper zeroes the status
// words and the ticket (one memset of 16 KB at the gzip shapes).
//
// What bounds it on the H100: bytes -- every tape record read once, every
// dense slot written once, 4 * (4 * n_rec + 4 * dense) bytes (0.0803 ms at
// the gzip shapes).  A chunk of 8192 records costs three block barriers
// (ticket, two tiles) plus one for the max and one for the fill.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // records a thread holds per tile
constexpr int kTile = kThreads * kRows;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kBig = 1 << 30;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
static_assert(kRows * kWarps == 4 * 32, "one warp scans the counts, 4 a lane");

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

__global__ void __launch_bounds__(kThreads)
compact_kernel(const int* __restrict__ dm, const int* __restrict__ mm,
               const int* __restrict__ dr, const int* __restrict__ mr,
               const int* __restrict__ mbase, const int* __restrict__ rbase,
               int n_chunks, int per_chunk, int cap_rows, int dense_rows,
               int* __restrict__ odm, int* __restrict__ omm,
               int* __restrict__ odr, int* __restrict__ omr,
               unsigned long long* __restrict__ status) {
  __shared__ int s_cnt[2][kRows * kWarps];
  __shared__ int s_max[kWarps];
  __shared__ int s_ticket;
  __shared__ int s_fill;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_ticket = atomicAdd(reinterpret_cast<int*>(status + 2 * n_chunks), 1);
  }
  __syncthreads();
  const int ticket = s_ticket;
  const int chunk = ticket >> 1;
  const bool runs = ticket & 1;
  const int* __restrict__ dst = runs ? dr : dm;
  const int* __restrict__ meta = runs ? mr : mm;
  const int* __restrict__ lbase = runs ? rbase : mbase;
  int* __restrict__ odst = runs ? odr : odm;
  int* __restrict__ ometa = runs ? omr : omm;
  const int64_t dense_n = static_cast<int64_t>(dense_rows) * 128;
  const int64_t base = static_cast<int64_t>(lbase[chunk]) * 128;
  const int last_end_rows = lbase[n_chunks - 1] + cap_rows;
  const int64_t end =
      static_cast<int64_t>(chunk + 1 < n_chunks ? lbase[chunk + 1]
                                                : last_end_rows) * 128;
  const int64_t in0 = static_cast<int64_t>(chunk) * per_chunk;
  const unsigned lt_mask = (1u << lane) - 1u;

  int64_t running = 0;
  int tmax = 0;  // max valid dst this thread saw, at least 0
  for (int t0 = 0, it = 0; t0 < per_chunk; t0 += kTile, ++it) {
    int d[kRows], m[kRows];
    unsigned bal[kRows];
    int* cnt = s_cnt[it & 1];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int k = t0 + j * kThreads + threadIdx.x;
      d[j] = 0;
      m[j] = 0;
      if (k < per_chunk) {
        d[j] = dst[in0 + k];
        m[j] = meta[in0 + k];
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const bool v = m[j] != 0;
      bal[j] = __ballot_sync(kFull, v);
      if (v) tmax = max(tmax, d[j]);
      if (lane == 0) cnt[j * kWarps + warp] = __popc(bal[j]);
    }
    __syncthreads();
    // Exclusive scan of the 128 counts (index row * 16 + warp), 4 a lane.
    const int4 c4 = reinterpret_cast<const int4*>(cnt)[lane];
    const int s1 = c4.x, s2 = s1 + c4.y, s3 = s2 + c4.z, s4 = s3 + c4.w;
    int incl = s4;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    const int comp = warp & 3;  // this warp's place in a lane's four
    const int mine = incl - s4 + (comp == 0 ? 0 : comp == 1 ? s1
                                  : comp == 2 ? s2 : s3);
    const int total = __shfl_sync(kFull, incl, 31);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int off = __shfl_sync(kFull, mine, 4 * j + (warp >> 2));
      if (m[j] != 0) {
        const int64_t at = base + running + off + __popc(bal[j] & lt_mask);
        if (at < dense_n) {
          odst[at] = d[j];
          ometa[at] = m[j];
        }
      }
    }
    running += total;
  }

  // The chunk's aggregate, published before anything waits.
  tmax = __reduce_max_sync(kFull, tmax);
  if (lane == 0) s_max[warp] = tmax;
  __syncthreads();
  int agg = 0;  // the chunk's max; set in warp 0, which alone reads it
  if (warp == 0) {
    agg = __reduce_max_sync(kFull, lane < kWarps ? s_max[lane] : 0);
    if (lane == 0) {
      st_status(status + ticket,
                (chunk == 0 ? kInclusive : kAggregate) |
                    static_cast<unsigned>(agg));
    }
  }

  // This chunk's share of the (BIG, 0) region: rows [r0, r1) of it.
  {
    const int64_t big_rows = dense_rows - last_end_rows;
    const int64_t r0 = big_rows * chunk / n_chunks;
    const int64_t r1 = big_rows * (chunk + 1) / n_chunks;
    int4* bd = reinterpret_cast<int4*>(odst + static_cast<int64_t>(last_end_rows) * 128);
    int4* bm = reinterpret_cast<int4*>(ometa + static_cast<int64_t>(last_end_rows) * 128);
    const int4 big4 = make_int4(kBig, kBig, kBig, kBig);
    const int4 zero4 = make_int4(0, 0, 0, 0);
    for (int64_t q = r0 * 32 + threadIdx.x; q < r1 * 32; q += kThreads) {
      bd[q] = big4;
      bm[q] = zero4;
    }
  }

  // Look-back: the max over chunks 0..chunk-1 of this list.
  if (warp == 0) {
    int fill = 0;
    if (chunk > 0) {
      int excl = 0;
      int hi = chunk - 1;  // predecessor that lane 0 reads
      while (true) {
        const int c = hi - lane;
        unsigned long long st = c >= 0 ? ld_status(status + 2 * c + runs)
                                       : kInclusive;
        while (__any_sync(kFull, (st >> 32) == 0)) {
          if ((st >> 32) == 0) st = ld_status(status + 2 * c + runs);
        }
        const unsigned inc = __ballot_sync(kFull, (st >> 32) == 2);
        // Lanes up to the first inclusive one (the nearest predecessor
        // that carries everything before it) contribute.
        const int stop = inc ? __ffs(inc) - 1 : 31;
        const int v = lane <= stop ? static_cast<int>(st & 0xFFFFFFFFu) : 0;
        excl = max(excl, __reduce_max_sync(kFull, v));
        if (inc) break;
        hi -= 32;
      }
      fill = max(excl, agg);
      if (lane == 0) {
        st_status(status + ticket, kInclusive | static_cast<unsigned>(fill));
      }
    } else {
      fill = agg;
    }
    if (lane == 0) s_fill = fill;
  }
  __syncthreads();
  const int fill = s_fill;
  const int64_t stop = end < dense_n ? end : dense_n;
  for (int64_t at = base + running + threadIdx.x; at < stop; at += kThreads) {
    odst[at] = fill;
    ometa[at] = 0;
  }
}

}  // namespace

// status: 2 * n_chunks + 1 int64 words zeroed by the caller (the look-back
// status of each (chunk, list), then the ticket counter).
extern "C" int dbg_compact(const int* dm, const int* mm, const int* dr,
                           const int* mr, const int* mbase, const int* rbase,
                           int n_chunks, int per_chunk, int cap_rows,
                           int dense_rows, int* odm, int* omm, int* odr,
                           int* omr, unsigned long long* status,
                           cudaStream_t stream) {
  if (n_chunks > 0) {
    compact_kernel<<<2 * n_chunks, kThreads, 0, stream>>>(
        dm, mm, dr, mr, mbase, rbase, n_chunks, per_chunk, cap_rows,
        dense_rows, odm, omm, odr, omr, status);
  }
  return static_cast<int>(cudaGetLastError());
}
