"""Whole runs on the CPU at a small size: the program's plain versions, the
harness's look for a card skipped.  A sound run is correct; the control
and each fault a cell can have planted under the timed path are not; the
result line has exactly the contract's keys; a run with no card fails."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import control, harness, run
from benchmark.tests.small import small_cell, workloads

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(name, call_for=None, trace=False, seed=2**31 + 11):
    return harness.run_cell(small_cell(name), seed, 0.5, trace,
                            device="cpu", call_for=call_for)


def _altered(outs):
    """The outputs with the first byte of the first changed."""
    first = np.array(outs[0], copy=True) if not isinstance(outs[0], bytes) \
        else np.frombuffer(outs[0], np.uint8).copy()
    first.reshape(-1)[0] ^= 1
    return [first] + outs[1:]


def _halved(outs):
    """Half of the batch left out: a list of several loses its second
    half; one output has its second half zeroed."""
    if len(outs) > 1:
        return outs[: len(outs) // 2]
    (one,) = outs
    one = np.array(one, copy=True) if not isinstance(one, bytes) \
        else np.frombuffer(one, np.uint8).copy()
    flat = one.reshape(-1)
    flat[flat.size // 2 :] = 0
    return [one]


def fault(kind: str, name: str):
    """A ``call_for`` that plants ``kind`` under the cell's real entry: the
    result's outputs, as the entry lists them, changed."""
    real = harness.load_entry(small_cell(name).traffic["entry"])

    def call_for(pool):
        harness.prepare(torch.device("cpu"))
        last = {}

        def call(args, device):
            outs = real.outputs(real.call(args, device))
            if kind == "stale":  # the state is left as the last call left it
                prev = last.get("outs")
                last["outs"] = outs
                return outs if prev is None else prev
            if kind == "half":
                return _halved(outs)
            return _altered(outs)

        return harness.Entry(call, list)

    return call_for


@pytest.mark.parametrize("name", workloads())
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert list(r) == KEYS
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] == 0 for k, c in r["checks"].items()
               if k != "calls_checked")
    assert {m["name"] for m in small_cell(name).end_to_end} - {"mem_peak_GB"} \
        == set(r["metrics"])


@pytest.mark.parametrize("name", workloads())
@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_faults_are_not_correct(name, kind):
    r = _run(name, call_for=fault(kind, name))
    assert not r["correct"]
    assert r["checks"]["calls_wrong"]["value"] >= 1


@pytest.mark.parametrize("name", workloads())
def test_control_is_not_correct(name):
    r = control.run_control(small_cell(name), 5, 0.5, device="cpu")
    assert not r["correct"]
    checks = r["checks"]
    assert checks["calls_wrong"]["value"] == checks["calls_checked"]["value"]
    assert checks["bytes_wrong"]["value"] > 0


def test_a_failed_call_is_not_correct():
    name = workloads()[0]
    real = harness.load_entry(small_cell(name).traffic["entry"])

    def call_for(pool):
        harness.prepare(torch.device("cpu"))
        n = {"i": 0}

        def call(args, device):
            n["i"] += 1
            if n["i"] == len(pool) + 1:  # the window's first call
                raise ValueError("CRC-32 mismatch")
            return real.call(args, device)

        return harness.Entry(call, real.outputs)

    r = _run(name, call_for=call_for)
    assert not r["correct"] and r["failed"] == 1
    assert r["checks"]["calls_failed"]["value"] == 1


@pytest.mark.parametrize("name", workloads())
def test_traced_line_keys(name):
    r = _run(name, trace=True)
    assert r["correct"], r["checks"]
    assert list(r) == KEYS[:-1] + ["breakdown", "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    # The CPU runs nothing on a device: every per-layer reader finds
    # nothing to read and the metric is left out.
    assert r["metrics"] == {}
    json.dumps(r)


def test_no_card_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", workloads()[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", workloads()[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_last_line_and_checks_on_stderr(monkeypatch, capsys):
    line = {"correct": True, "attempted": 3, "failed": 0,
            "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
            "device": {"platform": "gpu", "kind": "card", "count": 1,
                       "memory_peak_bytes": 5},
            "checks": {"calls_wrong": {"value": 0, "limit": 0},
                       "calls_checked": {"value": 3, "limit": 1}}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: line)
    monkeypatch.setattr(run, "card_line", lambda: "card, 700.00 W")
    assert run.main(["--workload", workloads()[0], "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert err.strip().splitlines()[-2:] == [
        "check calls_wrong 0 (at most 0)", "check calls_checked 3 (at least 1)"]


def test_forbidden_module_stops_the_run(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="jax"):
        _run(workloads()[0])


def test_control_differs_from_the_reference_in_every_output():
    from benchmark import inputs, reference

    cell = small_cell("png-corpus.decode")
    (item,) = inputs.make_pool(cell.config, {**cell.traffic, "pool": 1}, 9)
    ctl = reference.control(item)
    for got, want in zip(ctl, reference.expected(item)):
        assert reference.bytes_wrong(got, want) > 0
        assert np.array_equal(got | 1, want | 1)
