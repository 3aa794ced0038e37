// PNG unfilter for Hopper: row bands of 32 rows, one warp a band, bands
// handed off through flags in device memory.
//
// Replaces the TPU kernel _wavefront_kernel (debigulator_tpu/ops/
// unfilter_pallas.py:49).  That kernel shears the image in device memory so
// that diagonals become contiguous rows, widens every byte to int32 on an
// 8-sublane layout, sweeps diagonal tiles over a sequential grid and
// carries the last diagonal between grid steps in VMEM scratch.  None of
// that layout is kept.  What it computes is kept exactly:
//   recon = (filt + pred(left, up, upleft)) & 0xFF
// with left = the byte bpp back in the row, zeros entering at x = 0 and at
// y = 0, Average = (left + up) >> 1 on unreduced values, Paeth ties going
// left, then up, then upleft, and a filter byte above 4 predicting 0.
//
// Layout.  A band is 32 rows of one image and runs on one warp, lane l on
// row band*32 + l.  On step s lane l reconstructs pixel x = s - l of its
// row, so the warp is a wavefront 32 rows deep.  A lane keeps its last
// pixel (`left`) and the `up` it used on the step before (this step's
// `upleft`) in registers, bpp <= 8 bytes in two 32-bit words; `up` is the
// pixel lane l-1 made on the step before, taken with __shfl_up_sync.  No
// step needs a block barrier, and nothing is sized by the image height.
// The predictor runs on four bytes at once in a 32-bit word (SIMD within a
// register: __vabsdiffu4, byte compares, masks of the row's filter type),
// without a branch on the filter type.
//
// Steps go in blocks of 32.  At the start of block k a lane waits for its
// cp.async copies of block k (issued one block earlier) and issues those of
// block k+1: the aligned 32-bit words that hold its next 32 pixels'
// filtered bytes, into a ring of two blocks in shared memory (2 x 32 rows
// x (8*bpp + 3) words, at most 17 KB), so each row is read once from HBM
// and no step waits on device memory.  A step takes its bpp bytes from the
// ring with funnel shifts and stores its pixel (one 4- or 8-byte store
// where the address allows).
//
// Hand-off.  Lane 0 takes `up` from the bottom row of the band above, in
// `out` in device memory: at each block start the warp waits until the
// band above has published at least the block's 32 pixels of that row,
// loads them (one pixel a lane, through L2) and hands them to lane 0 by
// shuffle, one a step.  The band above publishes after every 32 pixels of
// its bottom row (and at the row's end): the bytes, then __threadfence(),
// then a release store of the count.  The waiting warp spins on a relaxed
// load (an acquire load invalidates L1) and reads the published bytes
// through L2 only after it has seen the count.  A band waits only on the
// band above it, and band indices come from a ticket (atomicAdd on a
// counter the wrapper zeroes) in the order the warps start, so a band
// never waits on one that has not been scheduled.  A batch of same-shape
// images shares the grid; each image's first band reads zeros as `up`.
//
// What bounds it on the H100: latency.  The bytes (filtered in, pixels
// out, each once) are microseconds at 3.35 TB/s.  A band is w + 31
// dependent steps (a shuffle and the predictor), and band b+1 starts its
// block of 32 pixels only when band b has finished it, 62 steps after band
// b started it, so an image of h rows takes about (h/32 - 1) * (62 steps +
// hand-off) + (w + 31) steps; only about h/32 warps run at once.
// Predicted before the first chip run (NVIDIA H100 80GB HBM3, 700 W),
// with 50-80 ns a step: 4096x4096 RGBA ~0.95 ms (range 0.6-1.5; 128
// bands), six 1024x1024 RGBA images ~0.24 ms (range 0.15-0.4; 32 bands
// each, all six in parallel), against 41.75 and 3.145 ms for one CTA per
// image.  Measured on that card: 183-267 ns a step at bpp 1-8 (one
// 32 x 4096 band at bpp 4: 0.7952 ms for 4127 steps; about 100
// instructions a step from one warp), so 4096x4096 RGBA ~2.5 ms and six
// 1024x1024 ~0.64 ms (tools/unfilter_bands.py, chip_smoke.py).  Loading the
// words from global memory inside the step (some lane reaches a new cache
// line almost every step, and the warp waits for it) or branching on the
// filter type makes a step several times slower.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 32;  // rows per band = lanes per warp
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}


__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Per-lane masks of the row's filter type: all ones where it is Sub, Up,
// Average or Paeth; a filter byte above 4 leaves all four zero (predict 0).
struct FilterSel {
  uint32_t sub, up, avg, paeth;
};

// Four bytes of one pixel at once (SIMD within a register, no carries
// between bytes): recon = f + pred(a = left, b = up, c = upleft) mod 256.
// Paeth: pa = |b - c|, pb = |a - c|, pc = |(a - c) + (b - c)|.  When the
// two differences have the same sign pc = pa + pb >= pa, pb, so only the
// order matters and pc is taken as 0xFF; otherwise pc = |pa - pb|.
__device__ __forceinline__ uint32_t recon4(uint32_t f, uint32_t a, uint32_t b,
                                           uint32_t c, const FilterSel& m) {
  const uint32_t avg = (a & b) + (((a ^ b) >> 1) & 0x7F7F7F7Fu);
  const uint32_t pa = __vabsdiffu4(b, c);
  const uint32_t pb = __vabsdiffu4(a, c);
  const uint32_t same = ~(__vcmpgeu4(b, c) ^ __vcmpgeu4(a, c));
  const uint32_t pc = __vabsdiffu4(pa, pb) | same;
  const uint32_t ta = __vcmpleu4(pa, pb) & __vcmpleu4(pa, pc);
  const uint32_t tb = __vcmpleu4(pb, pc);
  const uint32_t paeth = (a & ta) | (~ta & ((b & tb) | (c & ~tb)));
  const uint32_t pred =
      (a & m.sub) | (b & m.up) | (avg & m.avg) | (paeth & m.paeth);
  return __vadd4(f, pred);
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, int64_t gaddr) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(sa), "l"(gaddr) : "memory");
}

// Stage pixels [x0, x0 + 32) of a row's filtered data (starting at byte
// address `data`, `stride` bytes): the aligned words that hold them, from
// the word of pixel x0's first byte on, into ring[0, 8*BPP + 2).  Words
// outside the row's data are skipped (no pixel of the row reads them).
template <int BPP>
__device__ __forceinline__ void stage(uint32_t* ring, int64_t data,
                                      int64_t stride, int x0) {
  const int64_t lo = data >> 2;
  const int64_t hi = (data + stride - 1) >> 2;
  const int64_t q0 = (data + static_cast<int64_t>(x0) * BPP) >> 2;
#pragma unroll 4
  for (int i = 0; i < 8 * BPP + 2; ++i) {
    const int64_t q = q0 + i;
    if (q >= lo && q <= hi) cp_async4(ring + i, q << 2);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// sync[0] is the ticket counter; sync[1 + t] the pixels of band t's bottom
// row that are final.
template <int BPP>
__global__ void __launch_bounds__(kBand)
unfilter_band_kernel(const uint8_t* __restrict__ filtered,
                     uint8_t* __restrict__ out, int h, int w, int bands,
                     int* __restrict__ sync) {
  constexpr int kRing = 8 * BPP + 3;  // words a lane stages, odd: no bank conflicts
  __shared__ uint32_t ring_all[2][kBand][kRing];
  const int lane = threadIdx.x;
  int t = 0;
  if (lane == 0) t = atomicAdd(sync, 1);
  t = __shfl_sync(kFull, t, 0);
  const int img = t / bands;
  const int band = t - img * bands;
  const int y = band * kBand + lane;
  const bool row_ok = y < h;
  const int64_t stride = static_cast<int64_t>(w) * BPP;
  const int64_t row = 1 + stride;
  const uint8_t* fil_img = filtered + static_cast<int64_t>(img) * h * row;
  uint8_t* out_img = out + static_cast<int64_t>(img) * h * stride;
  const uint8_t* above =
      band > 0 ? out_img + (static_cast<int64_t>(band) * kBand - 1) * stride
               : out_img;
  const int* above_done = sync + t;  // sync[1 + (t - 1)]
  int* my_done = sync + 1 + t;
  uint8_t* dst = out_img + static_cast<int64_t>(row_ok ? y : 0) * stride;
  const uint8_t* rp = fil_img + static_cast<int64_t>(row_ok ? y : 0) * row;
  const int ftype = row_ok ? rp[0] : 0;
  const FilterSel sel{ftype == 1 ? ~0u : 0u, ftype == 2 ? ~0u : 0u,
                      ftype == 3 ? ~0u : 0u, ftype == 4 ? ~0u : 0u};
  const int64_t data = static_cast<int64_t>(reinterpret_cast<uintptr_t>(rp + 1));
  if (row_ok) stage<BPP>(ring_all[0][lane], data, stride, -lane);

  uint32_t cur_lo = 0, cur_hi = 0;        // this lane's last pixel
  uint32_t upprev_lo = 0, upprev_hi = 0;  // the `up` of the step before
  uint32_t ab_lo = 0, ab_hi = 0;          // above-row pixel (block + lane)
  int mis = 0;                            // block's first byte within its word
  const uint32_t* ring = ring_all[0][lane];
  const int steps = w + kBand - 1;
  for (int s0 = 0; s0 < steps; s0 += 32) {
    {  // block k: steps s0 .. s0 + 31
      const int s = s0;
      const int k = s >> 5;
      asm volatile("cp.async.wait_all;" ::: "memory");  // block k is staged
      ring = ring_all[k & 1][lane];
      mis = static_cast<int>((data + static_cast<int64_t>(32 * k - lane) * BPP) & 3);
      if (row_ok && 32 * (k + 1) - lane < w) {
        stage<BPP>(ring_all[(k + 1) & 1][lane], data, stride, 32 * (k + 1) - lane);
      }
      ab_lo = ab_hi = 0;
      if (band > 0) {
        const int need = min(w, s + 32);
        while (ld_relaxed(above_done) < need) {
        }
        const int xa = s + lane;
        if (xa < w) {
          const uint8_t* ap = above + static_cast<int64_t>(xa) * BPP;
#pragma unroll
          for (int p = 0; p < BPP; ++p) {
            const uint32_t b = __ldcg(ap + p);
            if (p < 4) ab_lo |= b << (8 * p);
            else ab_hi |= b << (8 * (p - 4));
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int s = s0 + j;
      if (s >= steps) break;
      const uint32_t nb_lo = __shfl_up_sync(kFull, cur_lo, 1);
      const uint32_t a_lo = __shfl_sync(kFull, ab_lo, j);
      uint32_t nb_hi = 0, a_hi = 0;
      if (BPP > 4) {
        nb_hi = __shfl_up_sync(kFull, cur_hi, 1);
        a_hi = __shfl_sync(kFull, ab_hi, j);
      }
      const uint32_t up_lo = lane == 0 ? a_lo : nb_lo;
      const uint32_t up_hi = lane == 0 ? a_hi : nb_hi;
      const int x = s - lane;
      if (row_ok && x >= 0 && x < w) {
        const int off = mis + j * BPP;
        const int q = off >> 2;
        const int sh = 8 * (off & 3);
        const uint32_t f_lo = __funnelshift_r(ring[q], ring[q + 1], sh);
        const uint32_t f_hi = BPP > 4 ? __funnelshift_r(ring[q + 1], ring[q + 2], sh) : 0u;
        const uint32_t l_lo = x > 0 ? cur_lo : 0u, l_hi = x > 0 ? cur_hi : 0u;
        const uint32_t c_lo = x > 0 ? upprev_lo : 0u;
        const uint32_t c_hi = x > 0 ? upprev_hi : 0u;
        const uint32_t v_lo = recon4(f_lo, l_lo, up_lo, c_lo, sel);
        const uint32_t v_hi = BPP > 4 ? recon4(f_hi, l_hi, up_hi, c_hi, sel) : 0u;
        uint8_t* px = dst + static_cast<int64_t>(x) * BPP;
        const uintptr_t pa = reinterpret_cast<uintptr_t>(px);
        if (BPP == 4 && (pa & 3) == 0) {
          *reinterpret_cast<uint32_t*>(px) = v_lo;
        } else if (BPP == 8 && (pa & 7) == 0) {
          *reinterpret_cast<uint2*>(px) = make_uint2(v_lo, v_hi);
        } else if (BPP == 2 && (pa & 1) == 0) {
          *reinterpret_cast<uint16_t*>(px) = static_cast<uint16_t>(v_lo);
        } else {
#pragma unroll
          for (int p = 0; p < BPP; ++p) {
            px[p] = static_cast<uint8_t>((p < 4 ? v_lo : v_hi) >> (8 * (p & 3)));
          }
        }
        cur_lo = v_lo;
        cur_hi = v_hi;
        if (lane == kBand - 1 && (((x + 1) & 31) == 0 || x == w - 1)) {
          __threadfence();
          st_release(my_done, x + 1);
        }
      }
      upprev_lo = up_lo;
      upprev_hi = up_hi;
    }
  }
}

template <int BPP>
int launch_bpp(const uint8_t* filtered, uint8_t* out, int batch, int h, int w,
               int* sync, cudaStream_t stream) {
  const int bands = (h + kBand - 1) / kBand;
  const int64_t grid = static_cast<int64_t>(batch) * bands;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  unfilter_band_kernel<BPP><<<static_cast<unsigned>(grid), kBand, 0, stream>>>(
      filtered, out, h, w, bands, sync);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sync: 1 + batch * ceil(h / 32) int32, zeroed by the caller.
extern "C" int dbg_unfilter(const uint8_t* filtered, uint8_t* out, int batch,
                            int h, int w, int bpp, int* sync,
                            cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || w <= 0) return 0;
  switch (bpp) {
    case 1: return launch_bpp<1>(filtered, out, batch, h, w, sync, stream);
    case 2: return launch_bpp<2>(filtered, out, batch, h, w, sync, stream);
    case 3: return launch_bpp<3>(filtered, out, batch, h, w, sync, stream);
    case 4: return launch_bpp<4>(filtered, out, batch, h, w, sync, stream);
    case 5: return launch_bpp<5>(filtered, out, batch, h, w, sync, stream);
    case 6: return launch_bpp<6>(filtered, out, batch, h, w, sync, stream);
    case 7: return launch_bpp<7>(filtered, out, batch, h, w, sync, stream);
    case 8: return launch_bpp<8>(filtered, out, batch, h, w, sync, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
