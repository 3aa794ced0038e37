"""Runtime configuration (the port of debigulator_tpu/utils/config.py):
switches that the reference's compile-time #defines held, settable at
run time.  Only the fields something reads are carried over: the JAX
package's ``verify_checksums``, ``strict`` and ``use_native_scanner`` have
no reader there (checksums are a ``verify=`` argument of each decode, the
native scan is switched off by ``DBG_NO_NATIVE``), and its compilation
cache has no counterpart here."""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    #: The default of ``ops.inflate.inflate_device_dev``'s ``use_kernels``:
    #: False sends every stream through the all-tensor-op v3 driver, with
    #: no CUDA kernel (the reference's ``use_pallas_lz77``).
    use_kernels: bool = True
    #: Verbosity: 0 silent, 1 decode summaries, 2 phase debug
    #: (read by utils.logging.log; CLIs raise it via -v/-vv).
    verbosity: int = int(os.environ.get("DBG_VERBOSITY", "0"))


_config = Config()


def get_config() -> Config:
    return _config
