"""The loader of the benchmark's parts, each a file found by its name:

- ``makers/<input>.py``: ``make(config, traffic, seed, k, pool)``, one pool
  item of a traffic file's ``input``;
- ``texts/<text>.py``: ``make(rng, size)``, the text of a configuration's
  ``text``;
- ``pixels/<pixels>.py``: ``make(rng, h, w, channels)``, the samples of a
  configuration's ``pixels``;
- ``entries/<entry>.py``: ``call(args, device)`` and ``outputs(result)``,
  how a traffic file's ``entry`` drives the program;
- ``metrics/<metric>.py``: ``read(run)``, one metric of ``BENCHMARK.json``.

A later change adds a configuration, a traffic mix or a metric by adding
such files, and edits none.
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
KINDS = ("makers", "texts", "pixels", "entries", "metrics")


def path(kind: str, name: str) -> pathlib.Path:
    """The file of part ``name`` of ``kind``."""
    if kind not in KINDS:
        raise ValueError(f"no kind of part {kind!r}")
    return HERE / kind / f"{name}.py"


@functools.cache
def load(kind: str, name: str):
    """The module of part ``name`` of ``kind``, loaded from its file."""
    p = path(kind, name)
    if not p.is_file():
        raise KeyError(f"no {kind} part {name!r}: {p.relative_to(HERE)} "
                       "does not exist")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
