"""RFC 1951 / 1950 / 1952 / PNG constants.

The port's own copy of debigulator_tpu/constants.py (RFC 1951
§3.2.5-§3.2.7, RFC 1950, RFC 1952 §2.3.1, PNG spec §9 and §11.2.2).
"""

from __future__ import annotations

import numpy as np

#: Maximum bits in any Huffman code (RFC 1951 §3.2.1).
MAX_BITS = 15

#: Length codes 257..285 -> (extra bits, base length) (RFC 1951 §3.2.5).
LENGTH_EXTRA_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0],
    dtype=np.int32,
)
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32,
)

#: Distance codes 0..29 -> (extra bits, base distance) (RFC 1951 §3.2.5).
DIST_EXTRA_BITS = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
     257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
     12289, 16385, 24577],
    dtype=np.int32,
)

#: Order in which code-length code lengths are stored (RFC 1951 §3.2.7).
CODE_LENGTH_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

#: LZ77 match lengths and window (RFC 1951 §2, §3.2.5).
MAX_MATCH_LENGTH = 258
MIN_MATCH_LENGTH = 3
WINDOW_SIZE = 32768


def fixed_litlen_lengths() -> np.ndarray:
    """Fixed-Huffman literal/length code lengths (RFC 1951 §3.2.6)."""
    lengths = np.empty(288, dtype=np.int32)
    lengths[0:144] = 8
    lengths[144:256] = 9
    lengths[256:280] = 7
    lengths[280:288] = 8
    return lengths


def fixed_dist_lengths() -> np.ndarray:
    """Fixed-Huffman distance code lengths: 32 five-bit codes (RFC 1951 §3.2.6)."""
    return np.full(32, 5, dtype=np.int32)


# Block types (BTYPE field, RFC 1951 §3.2.3).
BTYPE_STORED = 0
BTYPE_FIXED = 1
BTYPE_DYNAMIC = 2

# gzip (RFC 1952).
GZIP_MAGIC = b"\x1f\x8b"
GZIP_CM_DEFLATE = 8
# FLG bits (RFC 1952 §2.3.1).
GZIP_FTEXT = 1
GZIP_FHCRC = 2
GZIP_FEXTRA = 4
GZIP_FNAME = 8
GZIP_FCOMMENT = 16

# zlib (RFC 1950).
ZLIB_CM_DEFLATE = 8
ADLER_MOD = 65521

# PNG.
PNG_SIGNATURE = bytes([137, 80, 78, 71, 13, 10, 26, 10])

# Color types (PNG spec §11.2.2).
PNG_COLOR_GRAY = 0
PNG_COLOR_RGB = 2
PNG_COLOR_PALETTE = 3
PNG_COLOR_GRAY_ALPHA = 4
PNG_COLOR_RGBA = 6

#: Channels per pixel for each supported color type.
PNG_CHANNELS = {
    PNG_COLOR_GRAY: 1,
    PNG_COLOR_RGB: 3,
    PNG_COLOR_PALETTE: 1,
    PNG_COLOR_GRAY_ALPHA: 2,
    PNG_COLOR_RGBA: 4,
}

# Filter types (PNG spec §9).
PNG_FILTER_NONE = 0
PNG_FILTER_SUB = 1
PNG_FILTER_UP = 2
PNG_FILTER_AVERAGE = 3
PNG_FILTER_PAETH = 4

# The decode graph's per-state word and the token tape it is chased into,
# shared by ops/graph.py, ops/phase_a.py and ops/lz77.py.
#: meta = kind << META_KIND_SHIFT | payload.
META_KIND_SHIFT = 25
K_NONE, K_LIT, K_DIST = 0, 1, 2
#: A match token: TOK_MATCH_BIT | len << 16 | dist (a literal is its byte).
TOK_MATCH_BIT = 1 << 30

#: CRC-32 polynomial (reflected), shared by gzip and PNG.
CRC32_POLY = 0xEDB88320
