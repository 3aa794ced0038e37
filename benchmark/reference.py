"""The plain reference: what a correct decode of a pool item returns, and
the comparison that decides a run's ``correct``.

A lossless decoder's answer is the data its input was compressed from, so
the reference works that out from the generator's own source: the text
(or the rotations of it a batch holds) for gzip traffic, and for PNG
traffic each image's samples widened to RGBA by ``inputs.to_rgba``.  An
entry's ``outputs`` lists its result in the same order.  It
reads nothing the program made.  It imports numpy and the generator, and
nothing of the program.

Every output is compared byte for byte, its length with it.
"""

from __future__ import annotations

import numpy as np

from benchmark import inputs

#: The numbers compared, each with its limit.  The decode is lossless, so
#: every limit is 0 (PERF.md gives the readings they were set from).
LIMITS = {"calls_failed": 0, "calls_wrong": 0, "outputs_wrong": 0,
          "bytes_wrong": 0}


def expected(item: inputs.Item) -> list[np.ndarray]:
    """The outputs a correct call over ``item`` returns, as uint8 arrays:
    one for each text the item was made from, or one (h, w, 4) RGBA array
    for each image."""
    if item.texts is not None:
        return [np.frombuffer(t, np.uint8) for t in item.texts]
    return [inputs.to_rgba(im.pix, im.color_type, im.palette, im.trns)
            for im in item.images]


def bytes_wrong(got, want: np.ndarray) -> int:
    """Bytes of ``want`` that ``got`` does not reproduce: positions that
    differ, plus the difference in length (a missing output counts all of
    ``want``)."""
    if got is None:
        return int(want.size)
    if isinstance(got, (bytes, bytearray, memoryview)):
        g = np.frombuffer(got, np.uint8)
    else:
        g = np.asarray(got)
        if g.dtype != np.uint8 or g.shape != want.shape:
            return int(want.size) + abs(int(g.size) - int(want.size))
        g = g.reshape(-1)
    w = want.reshape(-1)
    n = min(g.size, w.size)
    return int(np.count_nonzero(g[:n] != w[:n])) + abs(int(g.size) - int(w.size))


def compare(samples, pool: list[inputs.Item], outputs) -> dict:
    """Compare each sampled call's result with the reference.

    samples: [(pool index, result)] of the calls kept after the window;
    ``outputs(result)`` lists a result's outputs (the entry's own).
    Returns the counts of calls, outputs and bytes that differ."""
    calls_wrong = outputs_wrong = wrong_bytes = 0
    for k, out in samples:
        want = expected(pool[k])
        got = list(outputs(out))
        got += [None] * (len(want) - len(got))
        per = [bytes_wrong(g, w) for g, w in zip(got, want)]
        extra = len(got) - len(want)  # outputs nobody asked for
        bad = sum(1 for b in per if b) + max(extra, 0)
        outputs_wrong += bad
        wrong_bytes += sum(per)
        calls_wrong += bool(bad)
    return {"calls_wrong": calls_wrong, "outputs_wrong": outputs_wrong,
            "bytes_wrong": wrong_bytes}


def control(item: inputs.Item) -> list[np.ndarray]:
    """The control: the reference put in the program's place, one bit short
    of the exact decode the configurations guarantee (every byte's low bit
    dropped, as a 7-bit decode would give).  Returns the outputs, in the
    order of ``expected``."""
    return [w & 0xFE for w in expected(item)]
