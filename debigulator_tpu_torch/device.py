"""Resolve the ``device=`` argument of the port's entry points, and say
where a kernel wrapper runs its plain version."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """torch.device for ``device``; raises when CUDA is asked for and absent.

    There is no silent CPU fallback: a caller that wants the CPU (the
    tests, which run the kernels' plain versions) passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def plain_here(t: torch.Tensor) -> bool:
    """A kernel wrapper runs its plain version where its tensors lie on the
    CPU; on a CUDA tensor it launches its kernel or raises."""
    return t.device.type == "cpu"
