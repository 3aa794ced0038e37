"""ASCII image preview (the port of debigulator_tpu/utils/preview.py): the
reference's README renders a decoded image as terminal art, which is
useful for eyeballing unfilter faults."""

from __future__ import annotations

import numpy as np

_RAMP = " .:-=+*#%@"


def ascii_preview(rgba: np.ndarray, width: int = 64) -> str:
    """Render (h, w, 4) RGBA as ASCII art (luminance ramp, alpha-weighted)."""
    rgba = np.asarray(rgba)
    h, w = rgba.shape[:2]
    step = max(1, w // width)
    small = rgba[:: step * 2, ::step]  # terminal cells are ~2x taller
    lum = (
        0.2126 * small[..., 0].astype(np.float32)
        + 0.7152 * small[..., 1].astype(np.float32)
        + 0.0722 * small[..., 2].astype(np.float32)
    )
    if small.shape[-1] == 4:
        lum = lum * (small[..., 3].astype(np.float32) / 255.0)
    idx = (lum / 255.0 * (len(_RAMP) - 1)).round().astype(int)
    return "\n".join("".join(_RAMP[i] for i in row) for row in idx)


def summary(rgba: np.ndarray) -> str:
    """``WxH avg_pixel=[...]``: the size and the mean of each channel."""
    rgba = np.asarray(rgba)
    avg = rgba.reshape(-1, rgba.shape[-1]).mean(axis=0)
    return (
        f"{rgba.shape[1]}x{rgba.shape[0]} "
        f"avg_pixel=[{', '.join(f'{x:.1f}' for x in avg)}]"
    )
