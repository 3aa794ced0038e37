"""End-to-end device pipelines: compressed bytes in, decoded bytes or
pixels out (the port of debigulator_tpu/models/pipeline.py).

Host work is container parsing (with the per-chunk CRC-32) and one native
block scan per stream; all DEFLATE symbol and LZ77 work runs on the device
through ops.inflate, the IDAT Adler-32 is a device reduction, PNG
reconstruction is the wavefront unfilter kernel and RGB -> RGBA expansion a
device concatenation.  Palette and gray expansion stay on the host, as in
the reference.  PyTorch runs eagerly, so there is one PNG path: the
reference's fused and unfused dispatches are the same sequence here.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import struct

import numpy as np
import torch

from debigulator_tpu_torch import constants as C
from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.models import png_codec
from debigulator_tpu_torch.models.bmp_codec import decode_bmp
from debigulator_tpu_torch.models.gzip_codec import (
    GzipError,
    _parse_header,
    decode_gzip,
)
from debigulator_tpu_torch.models.zlib_codec import parse_zlib_header
from debigulator_tpu_torch.native import get_lib
from debigulator_tpu_torch.ops import checksum as ck
from debigulator_tpu_torch.ops import inflate as inf
from debigulator_tpu_torch.ops.inflate import inflate_device
from debigulator_tpu_torch.ops.plan import CELL_BITS, LIT_ROW_CAP, scan_extent
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
from debigulator_tpu_torch.ops.unfilter import unfilter
from debigulator_tpu_torch.parallel.batch import decode_batch_device
from debigulator_tpu_torch.parallel.merged import build_merged_plan, decode_merged
from debigulator_tpu_torch.utils.manifest import JobManifest
from debigulator_tpu_torch.utils.profiling import named_scope


def decode_gzip_device(data, verify: bool = True, device="cuda") -> bytes:
    """gzip decode with all DEFLATE work on the device (multi-member)."""
    with named_scope("dbg.decode_gzip", request=True):
        dev = resolve_device(device)
        data = memoryview(data)
        n = len(data)
        if n == 0:
            raise GzipError("empty input is not a gzip stream")
        out_parts = []
        at = 0
        while at < n:
            with named_scope("dbg.parse"):
                p, _ = _parse_header(data, at)
            # One host scan per member, over the rest of the file where it
            # lies (the scan stops at the member's final block): the pass
            # that finds the member's end also records code lengths and
            # exact cell entries for the plan.
            with named_scope("dbg.scan"):
                scanned = scan_stream_cells(data[p:], CELL_BITS)
            with named_scope("dbg.parse"):
                end = p + (scanned[0][-1].end_bit + 7) // 8
                if end + 8 > n:
                    raise GzipError("truncated gzip footer")
                crc, isize = struct.unpack_from("<II", data, end)
                stream = bytes(data[p:end])
            out = inflate_device(stream, scanned=scanned, device=dev)
            if verify:
                with named_scope("dbg.check"):
                    if len(out) & 0xFFFFFFFF != isize:
                        raise GzipError(f"ISIZE mismatch: {len(out)} vs {isize}")
                    if ck.crc32(out) != crc:
                        raise GzipError("CRC-32 mismatch")
            out_parts.append(out)
            at = end + 8
        with named_scope("dbg.readback"):
            return b"".join(out_parts)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _expected_size(info: png_codec.PngInfo) -> int:
    return info.height * (1 + info.stride)


def _check_size(got: int, info: png_codec.PngInfo) -> None:
    if got != _expected_size(info):
        raise png_codec.PngError(
            f"decompressed size {got} != expected {_expected_size(info)}")


def _idat_adler(chunks: png_codec.PngChunks) -> int:
    return struct.unpack_from(">I", chunks.idat, len(chunks.idat) - 4)[0]


def _reconstruct(raw: torch.Tensor, info: png_codec.PngInfo) -> torch.Tensor:
    """Filtered scanlines (size,) or (B, size) uint8 on the device ->
    reconstructed rows (.., h, stride), RGB widened to RGBA (.., h, w*4)."""
    h, w = info.height, info.width
    recon = unfilter(raw, h, w, info.bpp)
    if info.color_type == C.PNG_COLOR_RGB:
        r3 = recon.reshape(*recon.shape[:-2], h, w, 3)
        alpha = torch.full((*r3.shape[:-1], 1), 255, dtype=r3.dtype,
                           device=r3.device)
        recon = torch.cat([r3, alpha], dim=-1).reshape(*recon.shape[:-2], h, w * 4)
    return recon


def _to_rgba(pix: torch.Tensor, chunks: png_codec.PngChunks) -> np.ndarray:
    """Device pixels of ``_reconstruct`` -> host (h, w, 4) RGBA."""
    info = chunks.info
    pix_np = pix.cpu().numpy()
    if info.color_type in (C.PNG_COLOR_RGBA, C.PNG_COLOR_RGB):
        return pix_np.reshape(info.height, info.width, 4)
    return png_codec.expand_to_rgba(pix_np, info, chunks.palette, chunks.trns)


def _decode_png_pixels(chunks: png_codec.PngChunks, dev: torch.device,
                       verify_adler: bool, scanned=None) -> torch.Tensor:
    """One parsed PNG -> device pixels: inflate, size check, Adler-32,
    unfilter, RGB expansion."""
    info = chunks.info
    with named_scope("dbg.parse"):
        stream = chunks.idat[2:]
    body, out_size = inf.inflate_device_dev(stream, scanned=scanned,
                                            device=dev)
    with named_scope("dbg.check"):
        _check_size(out_size, info)
        raw = body[:out_size]
        if verify_adler and ck.adler32_device(raw) != _idat_adler(chunks):
            raise png_codec.PngError("IDAT Adler-32 mismatch")
    with named_scope("dbg.unfilter"):
        return _reconstruct(raw.to(torch.uint8), info)


def decode_png_device(data, verify_crc: bool = True, verify_adler: bool = True,
                      device="cuda") -> np.ndarray:
    """PNG decode with inflate, Adler-32, unfilter and RGB -> RGBA expansion
    on the device; the only transfers are the compressed stream in, the
    Adler word and the final image out.  Returns (h, w, 4) RGBA uint8."""
    with named_scope("dbg.decode_png", request=True):
        dev = resolve_device(device)
        with named_scope("dbg.parse"):
            chunks = png_codec.parse_chunks(data, verify_crc=verify_crc)
            parse_zlib_header(chunks.idat)
        pix = _decode_png_pixels(chunks, dev, verify_adler)
        with named_scope("dbg.readback"):
            return _to_rgba(pix, chunks)


def decode_png_corpus_device(datas: list[bytes], verify_crc: bool = True,
                             verify_adler: bool = True, as_numpy: bool = True,
                             device="cuda"):
    """Corpus PNG decode, device-resident end to end.

    Merged inflate calls decode the images' IDAT streams (threaded host
    scan, then as many streams per call as fit under the literal-row cap),
    and on the still-resident body every bucket of same-shape images gets
    one Adler pass per image and ONE batched unfilter launch; all Adler
    words verify in a single stacked readback.  A stream whose literal
    rows alone exceed the cap decodes on its own through the chunked
    long-stream decode.

    as_numpy=False returns the per-image device tensors (before color
    expansion for palette and gray images): the device-resident timing
    hook.
    """
    with named_scope("dbg.decode_png_corpus", request=True):
        return _decode_png_corpus(datas, verify_crc, verify_adler, as_numpy,
                                  resolve_device(device))


def _decode_png_corpus(datas, verify_crc, verify_adler, as_numpy, dev):
    with named_scope("dbg.parse"):
        parsed = [png_codec.parse_chunks(d, verify_crc=verify_crc)
                  for d in datas]
        for ch in parsed:
            parse_zlib_header(ch.idat)
        streams = [ch.idat[2:] for ch in parsed]

    def scan(s):
        return scan_stream_cells(s, CELL_BITS)

    # The scans and the chunks' plans run on worker threads, whose spans a
    # profiler may not record: the main thread's waits carry their names.
    with named_scope("dbg.scan"):
        if len(streams) > 1:
            get_lib()  # load once before the pool
            workers = min(len(streams), max(2, os.cpu_count() or 2))
            with cf.ThreadPoolExecutor(max_workers=workers) as pool:
                scans = list(pool.map(scan, streams))
        else:
            scans = [scan(s) for s in streams]

    # Chunk the merged batch under the run-meta literal-row cap; the 2x
    # margin covers the merged plan's pow2 rounding of its bit extent.
    with named_scope("dbg.plan"):
        extents = [scan_extent(sc[0], sc[2]) for sc in scans]
        alone = [2 * cells * slots // 128 > LIT_ROW_CAP
                 for cells, slots in extents]
        chunks, cur, cur_cells, cur_slots = [], [], 0, 1
        for i, (cells_i, slots_i) in enumerate(extents):
            if alone[i]:
                continue
            new_slots = max(cur_slots, slots_i)
            if cur and 2 * (cur_cells + cells_i) * new_slots // 128 > LIT_ROW_CAP:
                chunks.append(cur)
                cur, cur_cells, new_slots = [], 0, slots_i
            cur.append(i)
            cur_cells += cells_i
            cur_slots = new_slots
        if cur:
            chunks.append(cur)

    pix_map: dict[int, torch.Tensor] = {}
    adlers, adler_idx = [], []

    def build(chunk):
        """Host prep of one chunk (merged plan and staging), run on a
        worker thread so it overlaps the previous chunk's device work."""
        mp = build_merged_plan([streams[i] for i in chunk],
                               scanned=[scans[i] for i in chunk])
        return mp, inf.stage_plan(mp.plan, dev)

    with cf.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(build, chunks[0]) if chunks else None
        for ci, chunk in enumerate(chunks):
            with named_scope("dbg.plan.wait"):
                mp, staged = fut.result()
                if ci + 1 < len(chunks):
                    fut = pool.submit(build, chunks[ci + 1])
            # Bucket the chunk's images by shape: one unfilter launch each.
            with named_scope("dbg.check"):
                buckets: dict = {}
                for k, (i, size) in enumerate(zip(chunk, mp.out_sizes)):
                    info = parsed[i].info
                    _check_size(size, info)
                    key = (info.height, info.width, info.bpp, info.color_type)
                    buckets.setdefault(key, []).append((i, mp.out_offsets[k]))
            body = inf.flagship_body(staged)
            for members in buckets.values():
                with named_scope("dbg.unfilter"):
                    info = parsed[members[0][0]].info
                    size = _expected_size(info)
                    raws = torch.stack([body[off : off + size]
                                        for _, off in members])
                    if verify_adler:
                        with named_scope("dbg.check"):
                            for j, (i, _) in enumerate(members):
                                adlers.append(ck.adler32_tensor(raws[j]))
                                adler_idx.append(i)
                    pix = _reconstruct(raws.to(torch.uint8), info)
                    for j, (i, _) in enumerate(members):
                        pix_map[i] = pix[j]
    for i, big in enumerate(alone):
        if big:
            pix_map[i] = _decode_png_pixels(parsed[i], dev, verify_adler,
                                            scanned=scans[i])
    if adlers:
        with named_scope("dbg.check"):
            got = torch.stack(adlers).cpu().tolist()  # one readback for the batch
            for i, g in zip(adler_idx, got):
                if g != _idat_adler(parsed[i]):
                    raise png_codec.PngError("IDAT Adler-32 mismatch")
    if not as_numpy:
        return [pix_map[i] for i in range(len(datas))]
    with named_scope("dbg.readback"):
        return [_to_rgba(pix_map[i], ch) for i, ch in enumerate(parsed)]


def decode_png_batch(datas: list[bytes], mesh=None, verify_crc: bool = True,
                     device="cuda") -> list[np.ndarray]:
    """Batch PNG decode: all IDAT streams inflate as one merged device
    call, or, with a ``mesh`` (``parallel.mesh.make_mesh``), as one batch
    split over its ``dp`` rows (``parallel.batch.decode_batch_device``);
    the scanlines return to the host, then each image is unfiltered on
    ``device`` and expanded on the host.  Outputs in input order."""
    dev = resolve_device(device)
    parsed = [png_codec.parse_chunks(d, verify_crc=verify_crc) for d in datas]
    for ch in parsed:
        parse_zlib_header(ch.idat)
    streams = [ch.idat[2:] for ch in parsed]
    if mesh is None:
        raws = decode_merged(streams, device=dev)
    else:
        raws = decode_batch_device(streams, mesh=mesh)
    images = []
    for ch, raw in zip(parsed, raws):
        info = ch.info
        _check_size(len(raw), info)
        filtered = torch.from_numpy(np.frombuffer(raw, np.uint8).copy()).to(dev)
        recon = unfilter(filtered, info.height, info.width, info.bpp)
        images.append(png_codec.expand_to_rgba(
            recon.cpu().numpy(), info, ch.palette, ch.trns))
    return images


@dataclasses.dataclass
class DecodeResult:
    """Batch decode result entry: a good flag and an error per item."""

    name: str
    good: bool
    data: np.ndarray | bytes | None
    error: str | None = None


def decode_corpus(paths, device="cuda",
                  manifest_path: str | None = None) -> list[DecodeResult]:
    """Decode a mixed list of .png/.gz/.bmp files.  One bad file poisons
    only its own entry.  PNG and gzip decode on ``device``; BMP is a host
    swizzle.

    ``device="host"`` is the reference's host-only mode (its
    ``device=False``): PNG through ``png_codec.decode_png`` and gzip
    through ``gzip_codec.decode_gzip``, both on the serial Python inflate,
    with no tensor work at all.  It has its own spelling because
    ``device="cpu"`` already means the port's device pipeline on CPU
    tensors.

    manifest_path: optional persisted completed-items manifest: items
    already recorded good are skipped (returned with data=None and
    good=True), and every completion appends a durable row, so a restarted
    job resumes at the remainder."""
    host_only = isinstance(device, str) and device == "host"
    dev = None if host_only else resolve_device(device)
    manifest = JobManifest(manifest_path) if manifest_path is not None else None
    results = []
    for path in paths:
        path = str(path)
        name = path.rsplit("/", 1)[-1]
        if manifest is not None and name in manifest \
                and manifest.entry(name)["good"]:
            # Only successful completions skip; failures retry.
            results.append(DecodeResult(name, True, None,
                                        "skipped: already completed"))
            continue
        try:
            with open(path, "rb") as f:
                blob = f.read()
            if name.endswith(".png"):
                out = (png_codec.decode_png(blob) if host_only
                       else decode_png_device(blob, device=dev))
            elif name.endswith(".gz"):
                out = (decode_gzip(blob) if host_only
                       else decode_gzip_device(blob, device=dev))
            elif name.endswith(".bmp"):
                out = decode_bmp(blob)
            else:
                out = None
            if out is None:
                results.append(DecodeResult(name, False, None, "unknown format"))
            else:
                results.append(DecodeResult(name, True, out))
        except Exception as e:  # noqa: BLE001 — per-item failure isolation
            results.append(DecodeResult(name, False, None,
                                        f"{type(e).__name__}: {e}"))
        if manifest is not None:
            r = results[-1]
            d = r.data
            blob_out = b"" if d is None else (
                d.tobytes() if hasattr(d, "tobytes") else bytes(d))
            manifest.record(name, r.good, size=len(blob_out),
                            crc32=ck.crc32(blob_out) if d is not None else 0)
    return results
