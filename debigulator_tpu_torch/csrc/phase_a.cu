// Phase A for Hopper: per-cell Huffman decode, in two kernels that share
// one decode step: phase_a_kernel (match / literal-run / literal tapes) and
// phase_a_tape_kernel (one token tape; described at its definition).
//
// phase_a_kernel replaces the TPU kernel _phase_a13_kernel (debigulator_tpu/ops/
// phase_a_pallas.py:480, decode graph in _graph_to_scratch :87).  The TPU
// kernel builds the decode graph at all 64 bit positions of a 512-cell tile
// in VMEM (cells on lanes) and then chases every cell's chain in lockstep.
// Here the scanner-exact entry lets each thread decode its own cell's
// chain sequentially: one thread per cell, only the positions the chain
// visits are decoded, and no graph is stored.
//
// What bounds it on the H100: bytes.  Per cell it reads 16 bytes of
// stream words + entry and 4 bytes of block id, and writes 5 tapes of
// `slots` int32 plus two int32 -- 340 bytes at 16 slots.  Slot j of cell c
// is written at j * cells_pad + c, so a warp's 32 stores of one slot land
// on 128 contiguous bytes.  The per-block decode tables (416 int32) are
// read through L1: neighbouring cells share a block, so a warp's table
// reads broadcast.  Unused slots are zero-filled by the same thread, so the
// wrapper allocates with torch.empty and no memset runs.
//
// Semantics carried bit for bit from the reference:
//  * 15-length canonical probe in its lim-compare / telescoped-offset form;
//  * aug lookup is 0 outside the table and for an unmatched code;
//  * a run closes only when a match emits or at the end of the chain;
//  * entry field (entry_local + 1) in bits 0-7 of row 3, pend in bits 9-17;
//  * EOB moves the chain to 127; the chain stops at position >= 64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCellBits = 64;
constexpr int kInactive = 127;
constexpr int kTabW = 416;
constexpr int kTabLL = 96;
constexpr int kTabD = 384;
constexpr int kKindShift = 25;
constexpr int kNone = 0, kLit = 1, kDist = 2;

__device__ __forceinline__ uint32_t window_at(uint32_t w0, uint32_t w1,
                                              uint32_t w2, int p) {
  const uint32_t a = p < 32 ? w0 : w1;
  const uint32_t b = p < 32 ? w1 : w2;
  const int r = p & 31;
  return r ? ((a >> r) | (b << (32 - r))) : a;
}

// Canonical probe over count/first/base rows (par[0..15], par[16..31],
// par[32..47]); returns the table offset, or -1 for "no symbol" (the
// reference's unmatched code or an offset outside the table maps to aug 0).
__device__ __forceinline__ int probe(const int* __restrict__ par,
                                     uint32_t rev, int width, int* len_out) {
  int len = 1;
  int dl = par[32 + 1] - par[16 + 1];
  const int r = static_cast<int>(rev);
#pragma unroll
  for (int l = 1; l <= 15; ++l) {
    const int lim = (par[16 + l] + par[l]) << (15 - l);
    const bool s = r >= lim;
    len += s;
    if (l < 15 && s) {
      dl += (par[32 + l + 1] - par[16 + l + 1]) - (par[32 + l] - par[16 + l]);
    }
  }
  if (len > 15) {
    *len_out = 15;
    return -1;
  }
  *len_out = len;
  const int off = static_cast<int>(rev >> (15 - len)) + dl;
  return (off >= 0 && off < width) ? off : -1;
}

// One decode step of a cell's chain at bit position `pos` in litlen
// (mode 0) or distance (mode 1) state: the next position and the packed
// emission (kind << 25 | pending length << 16 | payload).  Shared by both
// Phase A kernels.
__device__ __forceinline__ void decode_step(const int* __restrict__ tab,
                                            uint32_t w0, uint32_t w1,
                                            uint32_t w2, int pos, int mode,
                                            int* nx_out, int* mt_out) {
  const uint32_t win = window_at(w0, w1, w2, pos);
  const uint32_t rev = __brev(win & 0x7FFFu) >> 17;
  int len;
  if (mode == 1) {
    const int off = probe(tab + 48, rev, 32, &len);
    const int aug = off >= 0 ? tab[kTabD + off] : 0;
    const int dbase = aug & 0x7FFF;
    const int deb = (aug >> 15) & 0xF;
    const int dextra = static_cast<int>(win >> len) & ((1 << deb) - 1);
    *nx_out = pos + len + deb;
    *mt_out = (kDist << kKindShift) | (dbase + dextra);
  } else {
    const int off = probe(tab, rev, 288, &len);
    const int aug = off >= 0 ? tab[kTabLL + off] : 0;
    const int lval = aug & 0x1FF;
    const int leb = (aug >> 9) & 0xF;
    const int is_len = (aug >> 13) & 1;
    const int is_eob = (aug >> 14) & 1;
    const int lextra = static_cast<int>(win >> len) & ((1 << leb) - 1);
    *nx_out = is_eob ? kInactive : pos + len + (is_len ? leb : 0);
    *mt_out = (is_len | is_eob)
                  ? ((kNone << kKindShift) |
                     (is_len ? (lval + lextra) << 16 : 0))
                  : ((kLit << kKindShift) | lval);
  }
}

__global__ void phase_a_kernel(const int* __restrict__ cellw,
                               const int* __restrict__ cell_block,
                               const int* __restrict__ tables, int cells_pad,
                               int slots, int* __restrict__ ma,
                               int* __restrict__ mb, int* __restrict__ ra,
                               int* __restrict__ rb, int* __restrict__ lit,
                               int* __restrict__ cnt,
                               int* __restrict__ outlen) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells_pad) return;
  const uint32_t w0 = static_cast<uint32_t>(cellw[c]);
  const uint32_t w1 = static_cast<uint32_t>(cellw[cells_pad + c]);
  const uint32_t w2 = static_cast<uint32_t>(cellw[2 * cells_pad + c]);
  const int row3 = cellw[3 * cells_pad + c];
  const int el = (row3 & 0xFF) - 1;
  int pos = el >= 0 ? (el >> 1) : kInactive;
  int mode = el >= 0 ? (el & 1) : 0;
  int pend = (row3 >> 9) & 0x1FF;
  const int* __restrict__ tab =
      tables + static_cast<int64_t>(cell_block[c]) * kTabW;

  int mc = 0, rc = 0, litc = 0, cur = 0;
  int run_dst = 0, run_lit0 = 0, run_len = 0;
  while (pos < kCellBits) {
    int nx, mt;
    decode_step(tab, w0, w1, w2, pos, mode, &nx, &mt);
    const int kind = mt >> kKindShift;
    const int payload = mt & 0xFFFF;
    const int pd = (mt >> 16) & 0x1FF;
    if (kind == kDist) {
      if (run_len > 0) {  // a match closes the open literal run
        if (rc < slots) {
          ra[rc * cells_pad + c] = run_dst;
          rb[rc * cells_pad + c] = (run_lit0 << 16) | run_len;
        }
        ++rc;
      }
      if (mc < slots) {
        ma[mc * cells_pad + c] = cur;
        mb[mc * cells_pad + c] = (pend << 16) | payload;
      }
      ++mc;
      run_len = 0;
      cur += pend;
      pend = 0;
    } else {
      if (kind == kLit) {
        if (litc < slots) lit[litc * cells_pad + c] = payload;
        if (run_len == 0) {
          run_dst = cur;
          run_lit0 = litc;
        }
        ++run_len;
        ++litc;
        ++cur;
      }
      if (pd > 0) pend = pd;
    }
    const int mo = (kind == kNone && pd > 0) ? 1 : 0;
    mode = mode == 1 ? 0 : mo;
    pos = nx;
  }
  if (run_len > 0) {
    if (rc < slots) {
      ra[rc * cells_pad + c] = run_dst;
      rb[rc * cells_pad + c] = (run_lit0 << 16) | run_len;
    }
    ++rc;
  }
  for (int j = mc; j < slots; ++j) {
    ma[j * cells_pad + c] = 0;
    mb[j * cells_pad + c] = 0;
  }
  for (int j = rc; j < slots; ++j) {
    ra[j * cells_pad + c] = 0;
    rb[j * cells_pad + c] = 0;
  }
  for (int j = litc; j < slots; ++j) lit[j * cells_pad + c] = 0;
  cnt[c] = (mc << 16) | (rc << 8) | litc;
  outlen[c] = cur;
}

// Token-tape Phase A, replacing the TPU kernel _phase_a_kernel
// (debigulator_tpu/ops/phase_a_pallas.py:232): the same chain, but every
// emission is one token in the cell's row of a cell-major (cells_pad, slots)
// tape: a literal byte, or 1 << 30 | len << 16 | dist for a match (the
// length is the pending one carried from the length symbol).  Slots past
// the cell's count are -1.  counts[c] may exceed `slots`: that is the
// caller's overflow flag, and nothing is written past the row.
//
// What bounds it on the H100: bytes, 20 read and 4 * slots + 4 written per
// cell.  A thread owns a row of slots * 4 bytes, so a warp's stores of one
// slot are strided; the whole row is still written exactly once.
__global__ void phase_a_tape_kernel(const int* __restrict__ cellw,
                                    const int* __restrict__ cell_block,
                                    const int* __restrict__ tables,
                                    int cells_pad, int slots,
                                    int* __restrict__ tape,
                                    int* __restrict__ counts) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells_pad) return;
  const uint32_t w0 = static_cast<uint32_t>(cellw[c]);
  const uint32_t w1 = static_cast<uint32_t>(cellw[cells_pad + c]);
  const uint32_t w2 = static_cast<uint32_t>(cellw[2 * cells_pad + c]);
  const int row3 = cellw[3 * cells_pad + c];
  const int el = (row3 & 0xFF) - 1;
  int pos = el >= 0 ? (el >> 1) : kInactive;
  int mode = el >= 0 ? (el & 1) : 0;
  int pend = (row3 >> 9) & 0x1FF;
  const int* __restrict__ tab =
      tables + static_cast<int64_t>(cell_block[c]) * kTabW;
  int* __restrict__ row = tape + static_cast<int64_t>(c) * slots;

  int cnt = 0;
  while (pos < kCellBits) {
    int nx, mt;
    decode_step(tab, w0, w1, w2, pos, mode, &nx, &mt);
    const int kind = mt >> kKindShift;
    const int payload = mt & 0xFFFF;
    const int pd = (mt >> 16) & 0x1FF;
    if (kind == kDist) {
      if (cnt < slots) row[cnt] = (1 << 30) | (pend << 16) | payload;
      ++cnt;
      pend = 0;
    } else {
      if (kind == kLit) {
        if (cnt < slots) row[cnt] = payload;
        ++cnt;
      }
      if (pd > 0) pend = pd;
    }
    const int mo = (kind == kNone && pd > 0) ? 1 : 0;
    mode = mode == 1 ? 0 : mo;
    pos = nx;
  }
  for (int j = cnt; j < slots; ++j) row[j] = -1;
  counts[c] = cnt;
}

}  // namespace

extern "C" int dbg_phase_a_tape(const int* cellw, const int* cell_block,
                                const int* tables, int cells_pad, int slots,
                                int* tape, int* counts, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (cells_pad + threads - 1) / threads;
  phase_a_tape_kernel<<<blocks, threads, 0, stream>>>(
      cellw, cell_block, tables, cells_pad, slots, tape, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dbg_phase_a(const int* cellw, const int* cell_block,
                           const int* tables, int cells_pad, int slots,
                           int* ma, int* mb, int* ra, int* rb, int* lit,
                           int* cnt, int* outlen, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (cells_pad + threads - 1) / threads;
  phase_a_kernel<<<blocks, threads, 0, stream>>>(
      cellw, cell_block, tables, cells_pad, slots, ma, mb, ra, rb, lit, cnt,
      outlen);
  return static_cast<int>(cudaGetLastError());
}
