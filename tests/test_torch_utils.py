"""The port's utils: config and verbosity, the profiler hooks (a CPU trace
of a scoped call), the sanitizer (the mirror of tests/test_sanitize.py's
four tests, on the port's error class) and the ASCII preview against the
JAX package's."""

import zlib

import numpy as np
import pytest
import torch

from debigulator_tpu.utils import preview as jax_preview
from debigulator_tpu_torch.utils import config, logging, preview, profiling
from debigulator_tpu_torch.utils.sanitize import (
    FLOAT_CHECKS,
    SanitizerError,
    checkified,
    checks_in_force,
    debug_mode,
)


def test_config_fields_and_defaults():
    cfg = config.get_config()
    assert cfg is config.get_config()
    assert cfg.use_kernels is True
    assert isinstance(cfg.verbosity, int)
    assert not hasattr(cfg, "compilation_cache")
    assert not hasattr(config, "setup_jax_cache")


def test_verbosity_from_config_and_environment(monkeypatch, capsys):
    cfg = config.get_config()
    monkeypatch.setattr(cfg, "verbosity", 0)
    monkeypatch.delenv("DBG_VERBOSITY", raising=False)
    logging.log(1, "quiet", n=1)
    assert capsys.readouterr().err == ""
    monkeypatch.setattr(cfg, "verbosity", 1)
    logging.log(1, "said", n=1, ms=2.5)
    logging.log(2, "detail")
    assert capsys.readouterr().err == "[dbg] said n=1 ms=2.500\n"
    monkeypatch.setattr(cfg, "verbosity", 0)
    monkeypatch.setenv("DBG_VERBOSITY", "2")
    logging.log(2, "from_env")
    assert capsys.readouterr().err == "[dbg] from_env\n"


def test_use_kernels_config_selects_the_tensor_op_driver(monkeypatch):
    """Config.use_kernels is the default of inflate_device's use_kernels:
    off, the flagship's Phase A wrapper is never reached."""
    from debigulator_tpu_torch.ops import inflate

    data = b"config switch " * 300
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = c.compress(data) + c.flush()
    called = []
    real = inflate.phase_a
    monkeypatch.setattr(inflate, "phase_a",
                        lambda *a: called.append(1) or real(*a))
    assert inflate.inflate_device(raw, device="cpu") == data
    assert called
    called.clear()
    monkeypatch.setattr(config.get_config(), "use_kernels", False)
    assert inflate.inflate_device(raw, device="cpu") == data
    assert not called


def test_trace_op_summary_finds_the_scope(tmp_path):
    """A CPU trace of a scoped call: the scope and its ops are listed, with
    times in ms, largest first; the flagship's own scopes show too."""
    from debigulator_tpu_torch.ops import inflate

    data = b"trace the flagship " * 2000
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = c.compress(data) + c.flush()
    x = torch.randn(600, 600)
    with profiling.device_trace(str(tmp_path), device="cpu") as logdir:
        with profiling.named_scope("scoped_matmul"):
            for _ in range(4):
                x = x @ x / 600
        assert inflate.inflate_device(raw, device="cpu") == data
    assert logdir == str(tmp_path)
    assert list(tmp_path.glob("*.json"))
    rows = profiling.trace_op_summary(logdir, top=50)
    names = [name for _, name in rows]
    assert "scoped_matmul" in names
    assert [ms for ms, _ in rows] == sorted((ms for ms, _ in rows),
                                            reverse=True)
    # Scopes shorter than 100 us drop out, so only the long ones are sure.
    assert {"phase_a_huffman", "phase_b_lz77"} <= set(names)
    # The same file gzipped is read as well.
    import gzip

    f = next(tmp_path.glob("*.json"))
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "t.json.gz").write_bytes(gzip.compress(f.read_bytes()))
    doubled = dict((n, ms) for ms, n in profiling.trace_op_summary(logdir, 50))
    assert doubled["scoped_matmul"] == pytest.approx(
        2 * dict((n, ms) for ms, n in rows)["scoped_matmul"])


def test_device_trace_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        with profiling.device_trace(str(tmp_path)):
            pass


def test_checkify_catches_oob_index():
    g = checkified(lambda x, i: x[i])
    x = torch.arange(8)
    assert int(g(x, torch.tensor(3))) == 3
    with pytest.raises(SanitizerError):
        g(x, torch.tensor(99))
    with pytest.raises(SanitizerError):
        g(x, torch.tensor([1, 99]))
    with pytest.raises(SanitizerError):
        checkified(lambda t: t.gather(0, torch.tensor([8])))(x)
    with pytest.raises(SanitizerError):
        checkified(lambda t: torch.zeros(4).index_add_(
            0, torch.tensor([4]), torch.ones(1)))(x)


def test_checkify_catches_nan():
    g = checkified(lambda x: torch.log(x))
    g(torch.tensor(2.0))
    with pytest.raises(SanitizerError):
        g(torch.tensor(-1.0))


def test_checkify_catches_zero_divisor():
    x = torch.arange(1, 9)
    assert checkified(lambda t: t // 2)(x).tolist() == (x // 2).tolist()
    with pytest.raises(SanitizerError):
        checkified(lambda t: t // torch.zeros_like(t))(x)
    with pytest.raises(SanitizerError):
        checkified(lambda t: t % 0)(x)


def test_debug_mode_restores_flag():
    prev = checks_in_force()
    with debug_mode():
        assert FLOAT_CHECKS <= checks_in_force()
        with pytest.raises(SanitizerError):
            torch.tensor([0.0]) / 0.0
    assert checks_in_force() == prev
    assert torch.isnan(torch.tensor([0.0]) / 0.0).all()


def test_checkified_tensor_op_inflate_bit_exact():
    """The port's all-tensor-op v3 decode runs clean under every check (no
    out-of-bounds gather, NaN or zero divisor) and stays bit-exact."""
    from debigulator_tpu_torch.ops.inflate import inflate_device

    data = b"sanitizer pass over the oracle pipeline " * 40
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    stream = c.compress(data) + c.flush()
    g = checkified(lambda s: inflate_device(s, device="cpu",
                                            use_kernels=False))
    assert g(stream) == data


def test_preview_matches_jax():
    rng = np.random.default_rng(4)
    for shape in ((37, 90, 4), (20, 16, 3), (9, 200, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        assert preview.ascii_preview(img) == jax_preview.ascii_preview(img)
        assert preview.ascii_preview(img, width=20) == \
            jax_preview.ascii_preview(img, width=20)
        assert preview.summary(img) == jax_preview.summary(img)


def test_trace_kernel_summary_sums_kernel_events(tmp_path):
    """Kernel events of a card's trace, however short, summed by name with
    their launch counts; other events and CPU traces give nothing."""
    import json

    events = [{"ph": "X", "cat": "kernel", "name": "k_a(int*)", "dur": 12},
              {"ph": "X", "cat": "kernel", "name": "k_a(int*)", "dur": 8},
              {"ph": "X", "cat": "kernel", "name": "k_b(int*)", "dur": 30},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 500}]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    rows = profiling.trace_kernel_summary(str(tmp_path))
    assert rows == [(0.03, 1, "k_b(int*)"), (0.02, 2, "k_a(int*)")]
    assert profiling.trace_op_summary(str(tmp_path)) == [(0.5, "aten::add")]
    with profiling.device_trace(str(tmp_path / "cpu"), device="cpu"):
        torch.ones(4).sum()
    assert profiling.trace_kernel_summary(str(tmp_path / "cpu")) == []
