"""Sanitizer layer (the port of debigulator_tpu/utils/sanitize.py): the
counterpart of the reference's AddressSanitizer build and of checkify's
three error sets, as a ``TorchDispatchMode`` that sees every tensor op.

* ``INDEX_CHECKS``: an index outside its dimension in a gather-like or
  scatter-like op (advanced indexing and ``index_put``, ``select``,
  ``gather``, ``scatter*``, ``index_select``, ``index_add``/``_copy``/
  ``_fill``, ``take``, ``put``, ``embedding``);
* ``FLOAT_CHECKS``: NaN or Inf in a floating-point output;
* ``DIV_CHECKS``: a zero divisor in integer division or remainder.

Each raises ``SanitizerError``, on the CPU and on the card alike.  A
device-side assert on the card is asynchronous and leaves the context
unusable, so index and divisor values are checked before the op runs (a
read-back per checked op: a debugging tool, not a production path).

``debug_mode()`` turns on the float checks for the block it encloses and
restores the previous state on exit; ``checkified(fn)`` runs ``fn`` under
all three sets (or the ``errors`` given).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

INDEX_CHECKS = frozenset({"index"})
FLOAT_CHECKS = frozenset({"float"})
DIV_CHECKS = frozenset({"div"})
ALL_CHECKS = INDEX_CHECKS | FLOAT_CHECKS | DIV_CHECKS

aten = torch.ops.aten

#: op -> (position of the dim argument, or "flat" over numel, or "list" of
#: per-dimension indices; position of the index; negative indices allowed)
_INDEXED = {
    aten.index: ("list", 1, True),
    aten.index_put: ("list", 1, True),
    aten.index_put_: ("list", 1, True),
    aten._index_put_impl_: ("list", 1, True),
    aten.select: (1, 2, True),
    aten.gather: (1, 2, False),
    aten.scatter: (1, 2, False),
    aten.scatter_: (1, 2, False),
    aten.scatter_add: (1, 2, False),
    aten.scatter_add_: (1, 2, False),
    aten.scatter_reduce: (1, 2, False),
    aten.scatter_reduce_: (1, 2, False),
    aten.index_select: (1, 2, False),
    aten.index_add: (1, 2, False),
    aten.index_add_: (1, 2, False),
    aten.index_copy: (1, 2, False),
    aten.index_copy_: (1, 2, False),
    aten.index_fill: (1, 2, False),
    aten.index_fill_: (1, 2, False),
    aten.take: ("flat", 1, True),
    aten.put: ("flat", 1, True),
    aten.put_: ("flat", 1, True),
    aten.embedding: (0, 1, False),
}
_DIVIDES = {aten.floor_divide, aten.floor_divide_, aten.remainder,
            aten.remainder_, aten.fmod, aten.fmod_, aten.div, aten.div_}


class SanitizerError(RuntimeError):
    """An op that checkify's error sets would flag."""


def _check_bounds(func, name: str, idx, size: int, negative: bool) -> None:
    if isinstance(idx, torch.Tensor):
        if idx.dtype in (torch.bool, torch.uint8) or not idx.numel():
            return
        lo, hi = int(idx.min()), int(idx.max())
    else:
        lo = hi = int(idx)
    if hi >= size or lo < (-size if negative else 0):
        raise SanitizerError(
            f"{func}: {name} index {lo if lo < 0 else hi} out of bounds for "
            f"size {size}")


def _check_index(func, args) -> None:
    where, pos, negative = _INDEXED[func.overloadpacket]
    if len(args) <= pos:
        return
    self, idx = args[0], args[pos]
    if where == "list":
        for d, t in enumerate(idx):
            if t is not None:
                _check_bounds(func, f"dim {d}", t, self.shape[d], negative)
    elif where == "flat":
        _check_bounds(func, "flat", idx, self.numel(), negative)
    else:
        dim = 0 if func.overloadpacket is aten.embedding else args[where]
        _check_bounds(func, f"dim {dim}", idx, self.shape[dim], negative)


def _check_divisor(func, args, kwargs) -> None:
    if len(args) < 2:
        return
    num, den = args[0], args[1]
    floating = any(isinstance(v, float) or (isinstance(v, torch.Tensor)
                                            and v.is_floating_point())
                   for v in (num, den))
    if floating:
        return  # a float quotient of zero shows as Inf or NaN instead
    if func.overloadpacket in (aten.div, aten.div_) and \
            kwargs.get("rounding_mode") is None:
        return  # true division of integers returns floats
    zero = bool((den == 0).any()) if isinstance(den, torch.Tensor) \
        else den == 0
    if zero:
        raise SanitizerError(f"{func}: integer division by zero")


def _check_finite(func, out) -> None:
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor) and t.is_floating_point() \
                and t.numel() and not bool(torch.isfinite(t).all()):
            raise SanitizerError(f"{func}: NaN or Inf in a float output")


class _Checks(TorchDispatchMode):
    """Runs every op it sees with the checks of ``errors``."""

    def __init__(self, errors):
        super().__init__()
        self.errors = frozenset(errors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if "index" in self.errors and packet in _INDEXED:
            _check_index(func, args)
        if "div" in self.errors and packet in _DIVIDES:
            _check_divisor(func, args, kwargs)
        out = func(*args, **kwargs)
        if "float" in self.errors:
            _check_finite(func, out)
        return out


def checks_in_force() -> frozenset:
    """The check sets of every sanitizer mode now active."""
    return frozenset().union(*(m.errors for m in
                               _get_current_dispatch_mode_stack()
                               if isinstance(m, _Checks)))


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Context: NaN and Inf checks on every op (with ``nans``); the previous
    state is back on exit."""
    with _Checks(FLOAT_CHECKS if nans else ()):
        yield


def checkified(fn, *, errors=None):
    """``fn`` run under the sanitizer: a callable that raises
    ``SanitizerError`` on an out-of-bounds index, a NaN or Inf, or an
    integer division by zero (``errors``: a union of the ``*_CHECKS``
    sets, all three by default)."""
    errs = ALL_CHECKS if errors is None else frozenset(errors)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _Checks(errs):
            try:
                return fn(*args, **kwargs)
            except IndexError as e:
                # Python indexing with an integer checks its bound on the
                # host before any op is dispatched.
                if "index" not in errs:
                    raise
                raise SanitizerError(str(e)) from e

    return run
