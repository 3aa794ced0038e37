"""Samples with the structure of drawn or photographed images (a frozen
copy of the program's ``tools/inputs.smooth_pixels``): stepped gradients,
a band of low noise and flat rectangles, so the streams hold real matches
of many lengths."""

from __future__ import annotations

import numpy as np


def make(rng: np.random.Generator, h: int, w: int, ch: int) -> np.ndarray:
    """(h, w, ch) uint8 samples."""
    y, x = np.mgrid[0:h, 0:w]
    planes = []
    for _ in range(ch):
        kx, ky = (int(v) for v in rng.integers(1, 4, 2))
        planes.append(((x * kx + y * ky) // int(rng.integers(3, 9))) & 0xFF)
    img = np.stack(planes, -1).astype(np.uint8)
    band = slice(h // 4, h // 2)
    img[band] += rng.integers(0, 3, img[band].shape, dtype=np.uint8)
    img[h // 2 : h // 2 + h // 4, w // 3 : 2 * w // 3] = \
        rng.integers(0, 256, ch, dtype=np.uint8)
    img[-(h // 8 + 1) :, : w // 2] = rng.integers(0, 256, ch, dtype=np.uint8)
    return img
