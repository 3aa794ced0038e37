"""Structured phase logging: the port's copy of debigulator_tpu's
``PhaseLog``.  Lines go to stderr as ``[dbg] event key=value ...`` when
the ``DBG_VERBOSITY`` environment variable is at least the line's level
(1 per-item summaries, 2 per-phase detail)."""

from __future__ import annotations

import os
import sys
import time


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def log(level: int, event: str, **fields) -> None:
    """Emit one structured line iff DBG_VERBOSITY >= level."""
    if int(os.environ.get("DBG_VERBOSITY", "0")) < level:
        return
    kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
    sys.stderr.write(f"[dbg] {event}{' ' if kv else ''}{kv}\n")


class PhaseLog:
    """Section timing that both logs (verbosity >= 2, per phase) and
    accumulates a summary for verbosity >= 1."""

    def __init__(self, event: str):
        self.event = event
        self.t0 = time.time()
        self.phases: list[tuple[str, float]] = []
        self._last = self.t0

    def mark(self, name: str) -> None:
        now = time.time()
        self.phases.append((name, now - self._last))
        self._last = now
        log(2, f"{self.event}.{name}", ms=(now - self.t0) * 1e3)

    def done(self, **fields) -> None:
        total = time.time() - self.t0
        detail = {f"{n}_ms": dt * 1e3 for n, dt in self.phases}
        log(1, self.event, total_ms=total * 1e3, **detail, **fields)
