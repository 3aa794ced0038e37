"""``models/pipeline.decode_gzip_device``: one (multi-member) gzip file a
call, its bytes back in host memory, each member's CRC-32 and ISIZE
checked (``verify=True``)."""

from __future__ import annotations


def call(data: bytes, device):
    from debigulator_tpu_torch.models import pipeline

    return pipeline.decode_gzip_device(data, verify=True, device=device)


def outputs(result) -> list:
    """The call's outputs in the order of ``reference.expected``."""
    return [result]
