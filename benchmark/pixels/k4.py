"""Near-random samples (a frozen copy of the image of the program's
``tools/inputs.k4_png``): random bytes, every third row a copy of the
first, and the second sample 77 in every other column, so that the stream
is mostly literals with some long matches."""

from __future__ import annotations

import numpy as np


def make(rng: np.random.Generator, h: int, w: int, ch: int) -> np.ndarray:
    """(h, w, ch) uint8 samples."""
    base = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
    base[::3] = base[0]
    if ch > 1:
        base[:, ::2, 1] = 77
    return base
