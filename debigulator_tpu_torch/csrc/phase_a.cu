// Phase A for Hopper: per-cell Huffman decode, in two kernels that share
// one decode step: phase_a_kernel (match / literal-run / literal tapes) and
// phase_a_tape_kernel (one token tape; described at its definition), and a
// third, lut_kernel, that builds the first-level decode table both read.
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
// `slots` int32 plus two int32 -- 328 bytes at 16 slots, mostly the zeros
// of unused slots.  Two things keep it near that bound:
//  * The decode step reads one int32 of the first-level table (lut_kernel,
//    2 x 2^kLutBits entries a block, indexed by the window's low kLutBits
//    bits in stream order) through L1, and the same word for a litlen or a
//    distance symbol, so lanes in different modes take one path.  Only a
//    code longer than kLutBits, or a prefix whose bits do not decide the
//    canonical probe, runs the probe over the block's 47 table words.
//    Staging the table in shared memory per CTA was measured and was
//    slower: it takes shared memory from the tapes.
//  * A CTA of n cells stages the first rs = min(slots, kStageSlots) slots
//    of its five tapes slot-major in shared memory, [5][rs][n], zero-filled
//    first; a lane stores its records there (lane t at column t, so a
//    warp's stores hit 32 banks whatever its counts), and after a barrier
//    the CTA writes each of the 5 * rs rows' n contiguous int32 with
//    16-byte stores.  Slots rs..slots-1 (slots 32-128, which only a plan
//    with a cell of more than 16 tokens asks for) are zeroed with 16-byte
//    stores before that barrier's twin at the start, and the few records
//    that land there are stored directly; the kernel is built twice, and
//    at slots <= kStageSlots the copy without that store runs (the branch
//    in the chain loop cost 4-5% at 8 and 16 slots on the H100).  n = 2048
//    / rs, so the staging is 40 KB a CTA at any slots value and 5 CTAs
//    (640 or 1280 threads) fit on an SM: shared memory, not slots, caps
//    the cells in flight.
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
// First-level table entry: the aug bits the decode step reads (litlen 0-14,
// distance 0-18) in bits 0-19, the code length in bits 20-23, and bit 24
// set where the entry decides the probe.  An undecided entry is 0.
constexpr int kLutAugMask = 0xFFFFF;
constexpr int kLutLenShift = 20;
constexpr int kLutFinal = 1 << 24;
// Window bits the first-level table is indexed by: 9, not 10, because a
// block's table is then 4 KB and on the H100 at the 29 gzip streams both
// kernels ran a little faster than at 10, though 10 leaves fewer entries
// to the probe (0.13% against 0.20%).
constexpr int kLutBits = 9;
constexpr uint32_t kLutMask = (1u << kLutBits) - 1;
// Slots of each tape a CTA stages in shared memory (at most); later slots
// go to global memory directly.
constexpr int kStageSlots = 16;

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

// One first-level entry per thread: block g >> (kLutBits + 1), mode bit
// kLutBits, window bits g & kLutMask.  Those window bits are the top
// kLutBits bits of the reversed 15-bit code, so the entry covers the codes
// rev_lo..rev_hi that share them.  Every comparison rev >= lim_l of a
// length l <= kLutBits has the same answer over that range (lim_l's low
// 15 - l bits are zero), so the probe at rev_hi decides the whole range
// when its length is <= kLutBits (an unmatched code reports 15) and no
// longer length's limit lies at or below rev_hi.  Anything else (a longer
// code, an unmatched one, a limit inside the range) stays 0.
__global__ void lut_kernel(const int* __restrict__ tables, int64_t total,
                           int* __restrict__ lut) {
  static_assert(kLutBits < 15, "an unmatched code must not look final");
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int mode = static_cast<int>(g >> kLutBits) & 1;
  const int* __restrict__ tab = tables + (g >> (kLutBits + 1)) * kTabW;
  const int* __restrict__ par = tab + 48 * mode;
  const uint32_t top = __brev(static_cast<uint32_t>(g) & kLutMask) >> (32 - kLutBits);
  const uint32_t rev_hi = (top << (15 - kLutBits)) | ((1u << (15 - kLutBits)) - 1);
  const int r = static_cast<int>(rev_hi);
  int len;
  const int off = probe(par, rev_hi, mode ? 32 : 288, &len);
  bool final = len <= kLutBits;
  for (int l = kLutBits + 1; l <= 15; ++l) {
    final = final && r < ((par[16 + l] + par[l]) << (15 - l));
  }
  const int aug = off >= 0 ? tab[(mode ? kTabD : kTabLL) + off] : 0;
  lut[g] = final ? kLutFinal | (len << kLutLenShift) | (aug & kLutAugMask) : 0;
}

// One decode step of a cell's chain at bit position `pos` in litlen
// (mode 0) or distance (mode 1) state: the next position and the packed
// emission (kind << 25 | pending length << 16 | payload).  `lut` is the
// block's 2 x 2^kLutBits first-level table, `tab` its probe rows and aug
// columns.
// Shared by both Phase A kernels.
__device__ __forceinline__ void decode_step(const int* __restrict__ tab,
                                            const int* __restrict__ lut,
                                            uint32_t w0, uint32_t w1,
                                            uint32_t w2, int pos, int mode,
                                            int* nx_out, int* mt_out) {
  const uint32_t win = window_at(w0, w1, w2, pos);
  const int e = __ldg(lut + ((mode << kLutBits) | (win & kLutMask)));
  int len, aug;
  if (e & kLutFinal) {
    len = (e >> kLutLenShift) & 0xF;
    aug = e & kLutAugMask;
  } else {
    const uint32_t rev = __brev(win & 0x7FFFu) >> 17;
    const int off = probe(tab + 48 * mode, rev, mode ? 32 : 288, &len);
    aug = off >= 0 ? tab[(mode ? kTabD : kTabLL) + off] : 0;
  }
  if (mode == 1) {
    const int dbase = aug & 0x7FFF;
    const int deb = (aug >> 15) & 0xF;
    const int dextra = static_cast<int>(win >> len) & ((1 << deb) - 1);
    *nx_out = pos + len + deb;
    *mt_out = (kDist << kKindShift) | (dbase + dextra);
  } else {
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

// The cell's start state and its block's tables.
struct CellIn {
  uint32_t w0, w1, w2;
  int pos, mode, pend;
  const int* tab;
  const int* lut;
};

__device__ __forceinline__ CellIn load_cell(
    const int* __restrict__ cellw, const int* __restrict__ cell_block,
    const int* __restrict__ tables, const int* __restrict__ lut,
    int cells_pad, int c) {
  CellIn in;
  in.w0 = static_cast<uint32_t>(cellw[c]);
  in.w1 = static_cast<uint32_t>(cellw[cells_pad + c]);
  in.w2 = static_cast<uint32_t>(cellw[2 * cells_pad + c]);
  const int row3 = cellw[3 * cells_pad + c];
  const int el = (row3 & 0xFF) - 1;
  in.pos = el >= 0 ? (el >> 1) : kInactive;
  in.mode = el >= 0 ? (el & 1) : 0;
  in.pend = (row3 >> 9) & 0x1FF;
  const int blk = cell_block[c];
  in.tab = tables + static_cast<int64_t>(blk) * kTabW;
  in.lut = lut + (static_cast<int64_t>(blk) << (kLutBits + 1));
  return in;
}

// Slot j of a tape: staged at st + j * n while j < rs, else stored at
// gl + j * cells_pad while j < slots (kDirect: slots > rs), else dropped
// (the count says so).
template <bool kDirect>
__device__ __forceinline__ void put(int* st, int* gl, int j, int rs,
                                    int slots, int n, int64_t cells_pad,
                                    int v) {
  if (j < rs) {
    st[j * n] = v;
  } else if (kDirect && j < slots) {
    gl[j * cells_pad] = v;
  }
}

template <bool kDirect>
__global__ void phase_a_kernel(const int* __restrict__ cellw,
                               const int* __restrict__ cell_block,
                               const int* __restrict__ tables,
                               const int* __restrict__ lut,
                               int cells_pad, int slots,
                               int* __restrict__ tape,
                               int* __restrict__ cnt,
                               int* __restrict__ outlen) {
  extern __shared__ int4 stage4[];
  int* stage = reinterpret_cast<int*>(stage4);
  const int n = blockDim.x;
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * n;
  const int c = c0 + t;
  const int rs = min(slots, kStageSlots);
  // A row's segment is n / 4 int4; int4 i of a run of rows is int4
  // i % (n / 4) of row i / (n / 4).  Tape q's slot j is row q * slots + j
  // of the output, row q * rs + j of the staging while j < rs.
  const int shift = __ffs(n / 4) - 1;
  const int staged = rs * n / 4;  // int4 of one tape's staged rows
  for (int i = t; i < 5 * staged; i += n) stage4[i] = make_int4(0, 0, 0, 0);
  const int extra = (slots - rs) * n / 4;
  for (int q = 0; q < 5; ++q) {
    int* base = tape + static_cast<int64_t>(q * slots + rs) * cells_pad + c0;
    for (int i = t; i < extra; i += n) {
      const int r = i >> shift;
      reinterpret_cast<int4*>(base + static_cast<int64_t>(r) * cells_pad)
          [i - (r << shift)] = make_int4(0, 0, 0, 0);
    }
  }
  const CellIn in = load_cell(cellw, cell_block, tables, lut, cells_pad, c);
  __syncthreads();
  // Each tape's slot 0 in the staging and in the output (see put).
  int* const sma = stage + t;
  int* const smb = sma + rs * n;
  int* const sra = smb + rs * n;
  int* const srb = sra + rs * n;
  int* const slit = srb + rs * n;
  const int64_t tape_len = static_cast<int64_t>(slots) * cells_pad;
  int* const gma = tape + c;
  int* const gmb = gma + tape_len;
  int* const gra = gmb + tape_len;
  int* const grb = gra + tape_len;
  int* const glit = grb + tape_len;
  const int64_t cp = cells_pad;

  int pos = in.pos, mode = in.mode, pend = in.pend;
  int mc = 0, rc = 0, litc = 0, cur = 0;
  int run_dst = 0, run_lit0 = 0, run_len = 0;
  while (pos < kCellBits) {
    int nx, mt;
    decode_step(in.tab, in.lut, in.w0, in.w1, in.w2, pos, mode, &nx, &mt);
    const int kind = mt >> kKindShift;
    const int payload = mt & 0xFFFF;
    const int pd = (mt >> 16) & 0x1FF;
    if (kind == kDist) {
      if (run_len > 0) {  // a match closes the open literal run
        put<kDirect>(sra, gra, rc, rs, slots, n, cp, run_dst);
        put<kDirect>(srb, grb, rc, rs, slots, n, cp, (run_lit0 << 16) | run_len);
        ++rc;
      }
      put<kDirect>(sma, gma, mc, rs, slots, n, cp, cur);
      put<kDirect>(smb, gmb, mc, rs, slots, n, cp, (pend << 16) | payload);
      ++mc;
      run_len = 0;
      cur += pend;
      pend = 0;
    } else {
      if (kind == kLit) {
        put<kDirect>(slit, glit, litc, rs, slots, n, cp, payload);
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
    put<kDirect>(sra, gra, rc, rs, slots, n, cp, run_dst);
    put<kDirect>(srb, grb, rc, rs, slots, n, cp, (run_lit0 << 16) | run_len);
    ++rc;
  }
  cnt[c] = (mc << 16) | (rc << 8) | litc;
  outlen[c] = cur;
  __syncthreads();
  // The CTA's segment of a row is n int32 from column c0, 16-byte aligned
  // because cells_pad and c0 are multiples of n.
  for (int q = 0; q < 5; ++q) {
    int* base = tape + static_cast<int64_t>(q * slots) * cells_pad + c0;
    for (int i = t; i < staged; i += n) {
      const int r = i >> shift;
      reinterpret_cast<int4*>(base + static_cast<int64_t>(r) * cells_pad)
          [i - (r << shift)] = stage4[q * staged + i];
    }
  }
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
// cell.  The CTA's n cells own n * slots contiguous int32 of the tape.  The
// first rs = min(slots, kStageSlots) slots of each row are staged in
// shared memory, [n][rs + 1] pre-filled with -1 (the padding column
// spreads a warp's stores of different rows over the banks), and written
// out after a barrier with 16-byte stores; slots rs..slots-1 are set to -1
// with 16-byte stores before the first barrier, and the few tokens that
// land there are stored directly.
__global__ void phase_a_tape_kernel(const int* __restrict__ cellw,
                                    const int* __restrict__ cell_block,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ lut,
                                    int cells_pad, int slots,
                                    int* __restrict__ tape,
                                    int* __restrict__ counts) {
  extern __shared__ int4 stage4[];
  int* stage = reinterpret_cast<int*>(stage4);
  const int n = blockDim.x;
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * n;
  const int c = c0 + t;
  const int rs = min(slots, kStageSlots);
  const int w = rs + 1;
  int* region = tape + static_cast<int64_t>(c0) * slots;
  for (int i = t; i < n * w / 4; i += n) stage4[i] = make_int4(-1, -1, -1, -1);
  // Slots rs.. of each row: int4 i of the region is int4 i % (slots / 4)
  // of cell i / (slots / 4); slots and rs are multiples of 4.
  if (slots > rs) {
    int4* region4 = reinterpret_cast<int4*>(region);
    for (int i = t; i < n * slots / 4; i += n) {
      if ((i & (slots / 4 - 1)) >= rs / 4) region4[i] = make_int4(-1, -1, -1, -1);
    }
  }
  const CellIn in = load_cell(cellw, cell_block, tables, lut, cells_pad, c);
  __syncthreads();
  int* row = stage + t * w;
  int* own = region + t * slots;

  int pos = in.pos, mode = in.mode, pend = in.pend;
  int cn = 0;
  while (pos < kCellBits) {
    int nx, mt;
    decode_step(in.tab, in.lut, in.w0, in.w1, in.w2, pos, mode, &nx, &mt);
    const int kind = mt >> kKindShift;
    const int payload = mt & 0xFFFF;
    const int pd = (mt >> 16) & 0x1FF;
    int tok = -1;
    if (kind == kDist) {
      tok = (1 << 30) | (pend << 16) | payload;
      pend = 0;
    } else {
      if (kind == kLit) tok = payload;
      if (pd > 0) pend = pd;
    }
    if (tok >= 0) {
      if (cn < rs) {
        row[cn] = tok;
      } else if (cn < slots) {
        own[cn] = tok;
      }
      ++cn;
    }
    const int mo = (kind == kNone && pd > 0) ? 1 : 0;
    mode = mode == 1 ? 0 : mo;
    pos = nx;
  }
  counts[c] = cn;
  __syncthreads();
  // int4 i holds slots 4k..4k+3 (k = i % (rs / 4)) of cell i / (rs / 4).
  const int shift = __ffs(rs / 4) - 1;
  for (int i = t; i < n * rs / 4; i += n) {
    const int cell = i >> shift;
    const int e = 4 * (i - (cell << shift));
    const int* src = stage + cell * w + e;
    *reinterpret_cast<int4*>(region + cell * slots + e) =
        make_int4(src[0], src[1], src[2], src[3]);
  }
}

// Cells a CTA of either Phase A kernel takes at `slots`: 2048 over the
// staged slots (256 at 8 slots, else 128), so row 1's staging is 40 KB
// and row 6's 9 KB, both under the 48 KB a launch may ask for without an
// opt-in; a power of two that divides cells_pad (a multiple of 512).
int cta_cells(int slots) {
  return 2048 / (slots < kStageSlots ? slots : kStageSlots);
}

}  // namespace

extern "C" int dbg_phase_a_lut_bits() { return kLutBits; }

extern "C" int dbg_phase_a_lut(const int* tables, int nb, int* lut,
                               cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(nb) << (kLutBits + 1);
  if (total == 0) return 0;
  const int threads = 256;
  lut_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads,
               0, stream>>>(tables, total, lut);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dbg_phase_a_tape(const int* cellw, const int* cell_block,
                                const int* tables, const int* lut,
                                int cells_pad, int slots, int* tape,
                                int* counts, cudaStream_t stream) {
  if (cells_pad == 0) return 0;
  const int n = cta_cells(slots);
  const int rs = slots < kStageSlots ? slots : kStageSlots;
  phase_a_tape_kernel<<<cells_pad / n, n, 4ull * n * (rs + 1), stream>>>(
      cellw, cell_block, tables, lut, cells_pad, slots, tape, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dbg_phase_a(const int* cellw, const int* cell_block,
                           const int* tables, const int* lut, int cells_pad,
                           int slots, int* tape, int* cnt, int* outlen,
                           cudaStream_t stream) {
  if (cells_pad == 0) return 0;
  const int n = cta_cells(slots);
  const int rs = slots < kStageSlots ? slots : kStageSlots;
  if (slots > kStageSlots) {
    phase_a_kernel<true><<<cells_pad / n, n, 20ull * rs * n, stream>>>(
        cellw, cell_block, tables, lut, cells_pad, slots, tape, cnt, outlen);
  } else {
    phase_a_kernel<false><<<cells_pad / n, n, 20ull * rs * n, stream>>>(
        cellw, cell_block, tables, lut, cells_pad, slots, tape, cnt, outlen);
  }
  return static_cast<int>(cudaGetLastError());
}
