"""Structured logging: the port of debigulator_tpu/utils/logging.py.
Lines go to stderr as ``[dbg] event key=value ...`` when the verbosity is
at least the line's level (1 a summary a call, 2 a line a span): the
larger of ``Config.verbosity`` (which the CLIs' -v/-vv raise) and the
``DBG_VERBOSITY`` environment variable, read at call time.  The timed
lines come from ``utils.profiling.named_scope``'s spans."""

from __future__ import annotations

import os
import sys

from debigulator_tpu_torch.utils.config import get_config


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def verbosity() -> int:
    """The larger of ``Config.verbosity`` and ``DBG_VERBOSITY``."""
    return max(get_config().verbosity,
               int(os.environ.get("DBG_VERBOSITY", "0")))


def log(level: int, event: str, **fields) -> None:
    """Emit one structured line iff the verbosity is at least ``level``."""
    if verbosity() < level:
        return
    kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
    sys.stderr.write(f"[dbg] {event}{' ' if kv else ''}{kv}\n")
