"""PNG scanline (un)filtering: host oracle, encoder filter search, and the
device unfilter (the port of debigulator_tpu/ops/unfilter.py,
ops/unfilter_device.py and ops/unfilter_pallas.py).

The reconstruction recurrence (PNG spec §9) couples byte (x, y) to
(x-bpp, y), (x, y-1) and (x-bpp, y-1): an anti-diagonal wavefront.  All
bytes on a diagonal d = x + y (x in pixels) are independent.

* ``unfilter_image`` is the NumPy oracle; it raises on a filter byte > 4.
* ``unfilter_plain`` sweeps the diagonals with tensor ops, on any device.
* ``unfilter`` is the wrapper: the plain version for CPU tensors, the
  CUDA kernel csrc/unfilter.cu (replacing ``_wavefront_kernel``) for CUDA
  tensors.  Both predict None for a filter byte > 4, as the reference's
  Pallas kernel does.
* ``unfilter_rowfast``/``unfilter_subfast`` are the prefix-sum forms for
  filter sets within {None, Up} and {None, Sub}.
* ``filter_row``/``filter_image_best`` (NumPy) and
  ``filter_image_best_device`` (tensor ops) are the encoder side: per-row
  best-of-5 by minimum sum of absolute signed residuals.
"""

from __future__ import annotations

import numpy as np
import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.device import plain_here as _plain_here
from debigulator_tpu_torch.ops import _kernels

#: Rows of one band of the CUDA kernel (one warp, a lane a row).
BAND_ROWS = 32


class FilterError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Host oracle and encoder side (NumPy)
# ---------------------------------------------------------------------------


def paeth(a, b, c):
    """Paeth predictor (PNG spec §9.4), vectorized over arrays."""
    a = a.astype(np.int32)
    b = b.astype(np.int32)
    c = c.astype(np.int32)
    p = a + b - c
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    return np.where(
        (pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)
    ).astype(np.uint8)


def unfilter_image(filtered: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """Reconstruct raw bytes from filtered scanlines (NumPy oracle).

    Args:
      filtered: (height * (1 + width*bpp),) uint8 — filter byte + row data.
    Returns (height, width*bpp) uint8 reconstructed bytes.
    """
    stride = width * bpp
    filtered = np.asarray(filtered, dtype=np.uint8).reshape(height, 1 + stride)
    ftypes = filtered[:, 0]
    if np.any(ftypes > 4):
        raise FilterError(f"invalid filter type {int(ftypes.max())}")
    rows = filtered[:, 1:]
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        f = int(ftypes[y])
        cur = rows[y]
        if f == C.PNG_FILTER_NONE:
            rec = cur.copy()
        elif f == C.PNG_FILTER_UP:
            rec = cur + prev
        elif f == C.PNG_FILTER_SUB:
            # Sub is a per-channel prefix-sum mod 256.
            rec = cur.reshape(-1, bpp).astype(np.uint32)
            rec = np.cumsum(rec, axis=0, dtype=np.uint32).astype(np.uint8).reshape(-1)
        elif f == C.PNG_FILTER_AVERAGE:
            rec = np.empty(stride, dtype=np.uint8)
            left = np.zeros(bpp, dtype=np.int32)
            for x in range(0, stride, bpp):
                up = prev[x : x + bpp].astype(np.int32)
                rec[x : x + bpp] = (
                    cur[x : x + bpp].astype(np.int32) + ((left + up) >> 1)
                ).astype(np.uint8)
                left = rec[x : x + bpp].astype(np.int32)
        else:  # Paeth
            rec = np.empty(stride, dtype=np.uint8)
            left = np.zeros(bpp, dtype=np.uint8)
            upleft = np.zeros(bpp, dtype=np.uint8)
            for x in range(0, stride, bpp):
                up = prev[x : x + bpp]
                rec[x : x + bpp] = cur[x : x + bpp] + paeth(left, up, upleft)
                left = rec[x : x + bpp]
                upleft = up
        out[y] = rec
        prev = rec
    return out


def filter_row(raw: np.ndarray, prev: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Apply PNG filter `ftype` to one raw row (encoder direction)."""
    raw = raw.astype(np.int32)
    prev = prev.astype(np.int32)
    left = np.zeros_like(raw)
    left[bpp:] = raw[:-bpp]
    upleft = np.zeros_like(prev)
    upleft[bpp:] = prev[:-bpp]
    if ftype == C.PNG_FILTER_NONE:
        out = raw
    elif ftype == C.PNG_FILTER_SUB:
        out = raw - left
    elif ftype == C.PNG_FILTER_UP:
        out = raw - prev
    elif ftype == C.PNG_FILTER_AVERAGE:
        out = raw - ((left + prev) >> 1)
    elif ftype == C.PNG_FILTER_PAETH:
        out = raw - paeth(
            left.astype(np.uint8), prev.astype(np.uint8), upleft.astype(np.uint8)
        ).astype(np.int32)
    else:
        raise FilterError(f"invalid filter type {ftype}")
    return (out & 0xFF).astype(np.uint8)


def filter_image_best(raw: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """Per-row best-of-5 filter search by minimum sum of |residual| as signed
    bytes (the stb/libpng heuristic).

    Filters depend only on *raw* neighbor rows, so all rows and all five
    candidates compute at once (no row recurrence — unlike unfiltering).
    Returns (height*(1+width*bpp),) uint8 filtered stream.
    """
    stride = width * bpp
    raw = np.asarray(raw, dtype=np.uint8).reshape(height, stride).astype(np.int32)
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    cands = np.stack(
        [
            raw,
            raw - left,
            raw - up,
            raw - ((left + up) >> 1),
            raw - paeth(left, up, upleft).astype(np.int32),
        ]
    ).astype(np.uint8)  # (5, h, stride), mod 256
    scores = np.abs(cands.astype(np.int8).astype(np.int32)).sum(axis=2)  # (5, h)
    best_f = scores.argmin(axis=0)  # (h,)
    out = np.empty((height, 1 + stride), dtype=np.uint8)
    out[:, 0] = best_f
    out[:, 1:] = cands[best_f, np.arange(height)]
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# Tensor forms
# ---------------------------------------------------------------------------


def _paeth_t(a, b, c):
    p = a + b - c
    pa = (p - a).abs()
    pb = (p - b).abs()
    pc = (p - c).abs()
    return torch.where((pa <= pb) & (pa <= pc), a, torch.where(pb <= pc, b, c))


def filter_image_best_device(raw: torch.Tensor, height: int, width: int,
                             bpp: int) -> torch.Tensor:
    """Tensor form of the filter search (same heuristic, ties to the lowest
    filter type): (h*w*bpp,) byte values -> (h*(1+w*bpp),) uint8 on raw's
    device."""
    stride = width * bpp
    raw = raw.reshape(height, stride).to(torch.int32)
    left = torch.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = torch.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = torch.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    cands = torch.stack([raw, raw - left, raw - up, raw - ((left + up) >> 1),
                         raw - _paeth_t(left, up, upleft)]) & 0xFF
    signed = torch.where(cands > 127, cands - 256, cands)
    scores = signed.abs().sum(dim=2)  # (5, h)
    # argmin over five rows with first-minimum ties, written out: torch's
    # argmin does not promise which of equal minima it returns.
    best = scores[0]
    best_f = torch.zeros(height, dtype=torch.int64, device=raw.device)
    for f in range(1, 5):
        better = scores[f] < best
        best = torch.where(better, scores[f], best)
        best_f = torch.where(better, f, best_f)
    chosen = torch.gather(cands, 0, best_f[None, :, None].expand(1, height, stride))[0]
    out = torch.cat([best_f[:, None], chosen], dim=1)
    return out.to(torch.uint8).reshape(-1)


def _as_batch(filtered: torch.Tensor, height: int, width: int, bpp: int):
    """(B, h, 1+stride) view of one image or a batch of same-shape images,
    and whether the caller passed a batch."""
    row = 1 + width * bpp
    if min(height, width) < 1 or not 1 <= bpp <= 8:
        raise ValueError(f"bad image shape h={height} w={width} bpp={bpp}")
    if filtered.dim() not in (1, 2) or filtered.shape[-1] != height * row:
        raise ValueError(
            f"filtered has shape {tuple(filtered.shape)}; expected "
            f"({height * row},) or (B, {height * row})")
    batched = filtered.dim() == 2
    return filtered.reshape(-1, height, row), batched


def unfilter_plain(filtered: torch.Tensor, height: int, width: int,
                   bpp: int) -> torch.Tensor:
    """Plain PyTorch unfilter, on any device: a sweep over the w+h-1
    anti-diagonals.  (h*(1+w*bpp),) or (B, ...) byte values -> (h, w*bpp)
    or (B, h, w*bpp) uint8.

    Row y+1 of the two carried arrays holds row y's value on the last two
    diagonals and row 0 stays zero, so `up` of the first scanline, and
    `left`/`upleft` at x = 0 (cells a diagonal did not reach), read zeros.
    """
    fil, batched = _as_batch(filtered, height, width, bpp)
    h, w = height, width
    nb = fil.shape[0]
    dev = fil.device
    ftype = fil[:, :, 0].to(torch.int32)[:, :, None]  # (B, h, 1)
    f = fil[:, :, 1:].reshape(nb, h, w, bpp).to(torch.int32)
    out = torch.zeros((nb, h, w, bpp), dtype=torch.uint8, device=dev)
    prev1 = torch.zeros((nb, h + 1, bpp), dtype=torch.int32, device=dev)
    prev2 = torch.zeros_like(prev1)
    for d in range(w + h - 1):
        y0, y1 = max(0, d - w + 1), min(h - 1, d)
        ys = torch.arange(y0, y1 + 1, device=dev)
        xs = d - ys
        left = prev1[:, y0 + 1 : y1 + 2]
        up = prev1[:, y0 : y1 + 1]
        upleft = prev2[:, y0 : y1 + 1]
        ft = ftype[:, y0 : y1 + 1]
        zero = torch.zeros_like(left)
        pred = torch.where(
            ft == C.PNG_FILTER_SUB, left,
            torch.where(ft == C.PNG_FILTER_UP, up,
                        torch.where(ft == C.PNG_FILTER_AVERAGE, (left + up) >> 1,
                                    torch.where(ft == C.PNG_FILTER_PAETH,
                                                _paeth_t(left, up, upleft),
                                                zero))))
        val = (f[:, ys, xs] + pred) & 0xFF
        out[:, ys, xs] = val.to(torch.uint8)
        cur = torch.zeros_like(prev1)
        cur[:, y0 + 1 : y1 + 2] = val
        prev2, prev1 = prev1, cur
    out = out.reshape(nb, h, w * bpp)
    return out if batched else out[0]


def unfilter_rowfast(filtered: torch.Tensor, height: int, width: int,
                     bpp: int) -> torch.Tensor:
    """Filter set within {None, Up}: a column cumsum mod 256 that restarts
    at each None row.  One image, (h, w*bpp) uint8 out."""
    fil = filtered.reshape(height, 1 + width * bpp)
    is_none = fil[:, 0] == C.PNG_FILTER_NONE
    f = fil[:, 1:].to(torch.int64)
    cs = torch.cumsum(f, 0)
    rows = torch.arange(height, device=fil.device)
    start = torch.cummax(torch.where(is_none, rows, 0), 0).values
    return ((cs - cs[start] + f[start]) & 0xFF).to(torch.uint8)


def unfilter_subfast(filtered: torch.Tensor, height: int, width: int,
                     bpp: int) -> torch.Tensor:
    """Filter set within {None, Sub}: per-row, per-channel cumsum mod 256.
    One image, (h, w*bpp) uint8 out."""
    fil = filtered.reshape(height, 1 + width * bpp)
    is_sub = (fil[:, 0] == C.PNG_FILTER_SUB)[:, None, None]
    f = fil[:, 1:].reshape(height, width, bpp).to(torch.int64)
    out = torch.where(is_sub, torch.cumsum(f, 1) & 0xFF, f)
    return out.reshape(height, width * bpp).to(torch.uint8)


def unfilter(filtered: torch.Tensor, height: int, width: int,
             bpp: int) -> torch.Tensor:
    """PNG reconstruction of one image (h*(1+w*bpp),) or a batch
    (B, h*(1+w*bpp)) of same-shape images, uint8 in, (h, w*bpp) or
    (B, h, w*bpp) uint8 out, bpp 1..8.  The plain version for CPU tensors,
    the CUDA kernel for CUDA tensors: bands of BAND_ROWS rows, one warp a
    band, handed off through flags in a small int32 tensor (a ticket
    counter, then one count per band), any height."""
    fil, batched = _as_batch(filtered, height, width, bpp)
    if fil.dtype != torch.uint8 or not fil.is_contiguous():
        raise ValueError("filtered must be a contiguous uint8 tensor")
    if _plain_here(fil):
        return unfilter_plain(filtered, height, width, bpp)
    nb = fil.shape[0]
    out = torch.empty((nb, height, width * bpp), dtype=torch.uint8,
                      device=fil.device)
    bands = -(-height // BAND_ROWS)
    sync = torch.zeros(1 + nb * bands, dtype=torch.int32, device=fil.device)
    _kernels.launch("dbg_unfilter", fil, out, nb, height, width, bpp, sync)
    unfilter.launches += 1
    return out if batched else out[0]


unfilter.launches = 0
