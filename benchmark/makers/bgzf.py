"""One BGZF file a pool item (SAM/BAM specification, section 4.1): the
configuration's text, ``streams`` rotations of it by ``rotation_step``
bytes end to end, cut into ``block_bytes`` blocks, each a gzip member at
zlib ``level`` with the ``BC`` extra field, then the empty end-of-file
member."""

from __future__ import annotations

import struct
import zlib

from benchmark import inputs


def bgzf_member(block: bytes, level: int) -> bytes:
    """One BGZF block: a gzip member with FEXTRA holding the ``BC``
    subfield, whose value is the member's size less one."""
    body = inputs.deflate_raw(block, level)
    extra = b"BC" + struct.pack("<HH", 2, len(body) + 25)
    head = (b"\x1f\x8b\x08\x04" + b"\0\0\0\0" + b"\0\xff"
            + struct.pack("<H", len(extra)) + extra)
    return head + body + struct.pack("<II", zlib.crc32(block), len(block))


def make(config: dict, traffic: dict, seed: int, k: int, pool):
    text = b"".join(inputs.rotations(inputs.text(config, seed, k),
                                     int(traffic["streams"]),
                                     int(traffic["rotation_step"])))
    size, level = int(traffic["block_bytes"]), int(traffic["level"])
    members = list(pool.map(lambda i: bgzf_member(text[i : i + size], level),
                            range(0, len(text), size)))
    members.append(bgzf_member(b"", level))  # the empty end-of-file block
    data = b"".join(members)
    payload = sum(len(m) - 26 for m in members)  # headers of 18, footers of 8
    return inputs.Item(args=data, texts=[text], in_bytes=payload,
                       out_bytes=len(text), inflated_bytes=len(text))
