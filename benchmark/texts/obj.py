"""Wavefront-OBJ-like text (a frozen copy of the program's
``tools/inputs.obj_text``, its generator taken from the run's seed):
o / v / vt / vn / usemtl / s / f lines on a coarse grid, so that lines
repeat the way exported meshes do."""

from __future__ import annotations

import numpy as np


def make(rng: np.random.Generator, size: int) -> bytes:
    parts = ["# Blender v2.79 (sub 0) OBJ File: ''\n# www.blender.org\n"
             "mtllib sample.mtl\n"]
    total, n, obj = len(parts[0]), 0, 0
    while total < size:
        obj += 1
        nv = int(rng.integers(40, 120))
        v = rng.integers(-24, 25, (nv, 3)) / 8.0
        vt = rng.integers(0, 17, (nv, 2)) / 16.0
        vn = rng.integers(-1, 2, (nv, 3)).astype(float)
        lines = [f"o Mesh.{obj:03d}"]
        lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
        lines += [f"vt {u:.6f} {w:.6f}" for u, w in vt]
        lines += [f"vn {x:.4f} {y:.4f} {z:.4f}" for x, y, z in vn]
        lines += ["usemtl Material.001", "s off"]
        for _ in range(nv):
            idx = n + rng.integers(1, nv + 1, 3)
            lines.append("f " + " ".join(f"{a}/{a}/{a}" for a in idx))
        n += nv
        chunk = "\n".join(lines) + "\n"
        parts.append(chunk)
        total += len(chunk)
    return "".join(parts).encode()[:size]
