// PNG unfilter for Hopper: an anti-diagonal wavefront, one CTA per image.
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
// Layout here: a lane is a pair (row y, byte-of-pixel p), lane = y*bpp + p,
// h*bpp lanes spread over the CTA's threads with stride blockDim.x.  On
// diagonal d lane (y, p) handles pixel x = d - y.  Its left neighbour is
// its own value on diagonal d-1; `up` is lane (y-1, p) on diagonal d-1 and
// `upleft` is lane (y-1, p) on diagonal d-2.  A ring of three diagonals in
// shared memory (ring[d % 3] is written, the other two are read) lets one
// __syncthreads() per diagonal suffice: the buffer written on diagonal d+1
// is the one last read on diagonal d, before the barrier.  A single buffer
// would race (a lane could overwrite the value its lower neighbour still
// needs as `up`).  Cells with x = 0 or y = 0 take zeros explicitly, so
// lanes outside the image on a diagonal write nothing.  The filtered bytes
// are read and the pixels written in their natural row-major layout: no
// skewed copy in device memory.
//
// What bounds it on the H100: latency, not bytes.  The bytes (filtered in,
// pixels out, each once) are a few microseconds at 3.35 TB/s; the sweep is
// w+h-1 dependent steps of one barrier and one round of strided byte loads
// (a lane's loads walk along its row, so a 32-byte sector serves the next
// 32/bpp diagonals out of L1/L2), and one image uses one SM.  A batch uses
// one SM per image.  Row bands pipelined over several CTAs are the faster
// form and are left for later.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void unfilter_kernel(const uint8_t* __restrict__ filtered,
                                uint8_t* __restrict__ out, int h, int w,
                                int bpp) {
  extern __shared__ uint8_t smem[];
  const int lanes = h * bpp;
  uint8_t* ring = smem;               // 3 * lanes
  uint8_t* ftype = smem + 3 * lanes;  // h
  const int stride = w * bpp;
  const int64_t row = 1 + stride;
  const uint8_t* fil = filtered + static_cast<int64_t>(blockIdx.x) * h * row;
  uint8_t* dst = out + static_cast<int64_t>(blockIdx.x) * h * stride;

  for (int y = threadIdx.x; y < h; y += blockDim.x) ftype[y] = fil[y * row];
  __syncthreads();

  const int ndiag = w + h - 1;
  for (int d = 0; d < ndiag; ++d) {
    uint8_t* cur = ring + (d % 3) * lanes;
    const uint8_t* p1 = ring + ((d + 2) % 3) * lanes;  // diagonal d-1
    const uint8_t* p2 = ring + ((d + 1) % 3) * lanes;  // diagonal d-2
    // Rows the diagonal crosses: y in [y0, y1].
    const int y0 = d - w + 1 > 0 ? d - w + 1 : 0;
    const int y1 = d < h - 1 ? d : h - 1;
    const int l0 = y0 * bpp;
    const int l1 = (y1 + 1) * bpp;
    for (int l = l0 + threadIdx.x; l < l1; l += blockDim.x) {
      const int y = l / bpp;
      const int p = l - y * bpp;
      const int x = d - y;
      const int f = fil[y * row + 1 + x * bpp + p];
      const int left = x > 0 ? p1[l] : 0;
      const int up = y > 0 ? p1[l - bpp] : 0;
      const int upleft = (x > 0 && y > 0) ? p2[l - bpp] : 0;
      int pred = 0;
      switch (ftype[y]) {
        case 1: pred = left; break;
        case 2: pred = up; break;
        case 3: pred = (left + up) >> 1; break;
        case 4: {
          const int pp = left + up - upleft;
          const int pa = abs(pp - left);
          const int pb = abs(pp - up);
          const int pc = abs(pp - upleft);
          pred = (pa <= pb && pa <= pc) ? left : (pb <= pc ? up : upleft);
          break;
        }
        default: break;
      }
      const uint8_t v = static_cast<uint8_t>((f + pred) & 0xFF);
      cur[l] = v;
      dst[static_cast<int64_t>(y) * stride + x * bpp + p] = v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dbg_unfilter(const uint8_t* filtered, uint8_t* out, int batch,
                            int h, int w, int bpp, cudaStream_t stream) {
  if (batch <= 0) return 0;
  const int lanes = h * bpp;
  const size_t smem = 3 * static_cast<size_t>(lanes) + h;
  int threads = (lanes + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  // Above 48 KB shared memory is dynamic and needs the opt-in; a launch
  // that asks for more than the card has is refused and shows here.
  cudaError_t err = cudaFuncSetAttribute(
      unfilter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  unfilter_kernel<<<batch, threads, smem, stream>>>(filtered, out, h, w, bpp);
  return static_cast<int>(cudaGetLastError());
}
