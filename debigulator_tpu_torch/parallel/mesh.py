"""Device meshes of the parallel layers (the port of
debigulator_tpu/parallel/mesh.py).

Axes:
  * ``dp``: data parallel over independent streams (gzip members, PNG
    IDAT streams, corpus files); a batch splits into one part a mesh row.
  * ``sp``: sequence parallel within one long stream; shards own
    consecutive output ranges and a shard needs only its left neighbour's
    32 KiB tail (the DEFLATE window), moved between the shards' devices.

A mesh is a (dp, sp) array of ``torch.device``.  A device may appear more
than once: torch has one CPU device where JAX's tests had eight virtual
ones, and a machine with one card builds a 4-shard ``sp`` mesh as
``make_mesh(dp=1, sp=4, devices=["cuda:0"] * 4)``; the schedule is the
same, only the moves between equal devices are no-ops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: np.ndarray  # (dp, sp) object array of torch.device

    @property
    def shape(self) -> dict:
        dp, sp = self.devices.shape
        return {"dp": dp, "sp": sp}


def make_mesh(dp: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh over ``devices`` (every CUDA device when None;
    raises when there is none).  dp * sp must equal the device count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no cuda device (torch.cuda.is_available() is "
                "False); pass devices=[...], e.g. ['cpu'] * n")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp * sp} != device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, sp))


def dp_sharding(mesh: Mesh) -> list[torch.device]:
    """The device of each part of a batch split over ``dp``: mesh row i's
    first device (the rest of the row would hold replicas)."""
    return list(mesh.devices[:, 0])


def replicated(mesh: Mesh) -> list[torch.device]:
    """Every distinct device of the mesh, in mesh order: where an array
    that every shard reads is placed once."""
    return list(dict.fromkeys(mesh.devices.reshape(-1)))
