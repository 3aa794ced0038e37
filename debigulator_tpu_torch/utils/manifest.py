"""Persisted job manifest: resumable corpus decode (SURVEY §5.4).

The reference persists nothing (every run is sub-second).  For huge
multi-member/corpus jobs the right checkpoint is NOT tensor state — a
codec has none — but a durable record of which items already completed,
so a restarted job (same machine or a different host in the fleet)
skips straight to the remainder.

Format: JSON-lines, one record per completed item
``{"name", "good", "size", "crc32"}`` — append-only (crash-safe: a torn
final line is ignored), human-readable, and mergeable across hosts by
concatenation (multihost manifests allgather the same rows in memory,
the reference's parallel.multihost.decode_batch_multihost).
"""

from __future__ import annotations

import json
import os


class JobManifest:
    """Append-only completed-items manifest."""

    def __init__(self, path: str):
        self.path = str(path)
        self._done: dict[str, dict] = {}
        if os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail line from a crash
                    self._done[rec["name"]] = rec

    def __contains__(self, name: str) -> bool:
        return name in self._done

    def __len__(self) -> int:
        return len(self._done)

    def entry(self, name: str) -> dict | None:
        return self._done.get(name)

    def record(self, name: str, good: bool, size: int = 0,
               crc32: int = 0) -> None:
        rec = {"name": name, "good": bool(good), "size": int(size),
               "crc32": int(crc32)}
        self._done[name] = rec
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
