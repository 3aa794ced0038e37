"""Block metadata and decode errors shared by the host scan and the plan.

The port's copy of ``BlockInfo``/``InflateError`` from
debigulator_tpu/ops/inflate_ref.py and ``HuffmanError`` from
debigulator_tpu/ops/huffman.py, without the serial host inflate.
"""

from __future__ import annotations

import dataclasses


class InflateError(ValueError):
    pass


class HuffmanError(ValueError):
    pass


@dataclasses.dataclass
class BlockInfo:
    """Metadata for one DEFLATE block (host pre-scan output)."""

    start_bit: int  # bit offset of BFINAL
    data_start_bit: int  # bit offset of first symbol (after tables)
    end_bit: int  # bit offset one past the block's last bit
    btype: int
    bfinal: bool
    out_start: int  # output byte offset where this block begins
    out_size: int  # decompressed size of this block
