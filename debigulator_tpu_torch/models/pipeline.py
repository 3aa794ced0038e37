"""End-to-end device pipelines: compressed bytes in, decoded bytes out
(the gzip part of debigulator_tpu/models/pipeline.py).

Host work is container parsing and one native block scan per member; all
DEFLATE symbol and LZ77 work runs on the device through ops.inflate.
"""

from __future__ import annotations

import struct

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.models.gzip_codec import GzipError, _parse_header
from debigulator_tpu_torch.ops import checksum as ck
from debigulator_tpu_torch.ops.inflate import inflate_device
from debigulator_tpu_torch.ops.plan import CELL_BITS
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
from debigulator_tpu_torch.utils.logging import PhaseLog


def decode_gzip_device(data, verify: bool = True, device="cuda") -> bytes:
    """gzip decode with all DEFLATE work on the device (multi-member)."""
    dev = resolve_device(device)
    data = memoryview(data)
    n = len(data)
    if n == 0:
        raise GzipError("empty input is not a gzip stream")
    out_parts = []
    at = 0
    while at < n:
        plog = PhaseLog("gzip.decode_device")
        p, _ = _parse_header(data, at)
        payload = bytes(data[p:])
        # One host scan per member: the pass that finds the member's end
        # also records code lengths and exact cell entries for the plan.
        scanned = scan_stream_cells(payload, CELL_BITS)
        blocks = scanned[0]
        plog.mark("scan")
        end = p + (blocks[-1].end_bit + 7) // 8
        if end + 8 > n:
            raise GzipError("truncated gzip footer")
        out = inflate_device(payload[: end - p], scanned=scanned, device=dev)
        plog.mark("inflate")
        crc, isize = struct.unpack_from("<II", data, end)
        if verify:
            if len(out) & 0xFFFFFFFF != isize:
                raise GzipError(f"ISIZE mismatch: {len(out)} vs {isize}")
            if ck.crc32(out) != crc:
                raise GzipError("CRC-32 mismatch")
            plog.mark("crc")
        out_parts.append(out)
        member_start = at
        at = end + 8
        plog.done(member_bytes=at - member_start, out_bytes=len(out),
                  blocks=len(blocks), crc="ok" if verify else "skipped")
    return b"".join(out_parts)
