"""The port's CLIs (debigulator_tpu_torch/cli/cuda_{gz,png,bmp}.py) with
--device cpu beside the repository's cli/tpu_*.py on the same files: the
files written are byte-identical, the exit codes and the stderr lines
equal (times masked).  The reference CLIs run their host paths (--host,
encode, roundtrip); the port's runs its device path on the CPU too."""

import gzip
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from debigulator_tpu_torch.cli import cuda_bmp, cuda_gz, cuda_png
from debigulator_tpu_torch.models import bmp_codec
from torch_png_cases import CASES, make_case
from torch_stream_cases import words

CLI = Path(__file__).resolve().parents[1] / "cli"


def reference_cli(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  CLI / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def masked(err: str) -> list[str]:
    """stderr lines with times, rates and file locations masked."""
    err = re.sub(r"[\d.]+ (ms|MB/s)\b", r"T \1", err)
    return [re.sub(r"\S*/", "", line) for line in err.splitlines()]


def run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr()


@pytest.fixture
def text_gz(tmp_path):
    data = words(20_000, seed=7)
    path = tmp_path / "text.gz"
    path.write_bytes(gzip.compress(data, 6) + gzip.compress(data[:900], 9))
    return path, data + data[:900]


def test_gz_decode_matches_reference(tmp_path, text_gz, capsys):
    ref = reference_cli("tpu_gz")
    path, data = text_gz
    outs = {}
    for tag, main, extra in (("ref", ref.main, ["--host"]),
                             ("host", cuda_gz.main, ["--host"]),
                             ("cpu", cuda_gz.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.out"
        rc, cap = run(main, ["decode", str(path), "-o", str(out), *extra],
                      capsys)
        assert rc == 0
        outs[tag] = (out.read_bytes(), masked(cap.err))
    assert outs["ref"][0] == outs["host"][0] == outs["cpu"][0] == data
    assert outs["ref"][1] == outs["host"][1] == outs["cpu"][1]


def test_gz_decode_repeat_and_trace(tmp_path, text_gz, capsys, monkeypatch):
    from debigulator_tpu_torch.utils.config import get_config

    # -v raises the process's verbosity for good, as the reference's does.
    monkeypatch.setattr(get_config(), "verbosity", get_config().verbosity)
    path, data = text_gz
    out = tmp_path / "o"
    rc, cap = run(cuda_gz.main, ["-v", "decode", str(path), "-o", str(out),
                                 "--device", "cpu", "--repeat", "2",
                                 "--trace", str(tmp_path / "tr")], capsys)
    assert rc == 0 and out.read_bytes() == data
    assert "trace written to" in cap.err and "top ops:" in cap.err
    assert "phase_a_huffman" in cap.err
    assert list((tmp_path / "tr").glob("*.json"))
    assert re.search(r"steady [\d.]+ ms", cap.err)


def test_gz_encode_matches_reference(tmp_path, capsys):
    ref = reference_cli("tpu_gz")
    data = words(6_000, seed=8)
    outs = {}
    for tag, main in (("ref", ref.main), ("port", cuda_gz.main)):
        src = tmp_path / tag / "sample.obj"
        src.parent.mkdir()
        src.write_bytes(data)
        rc, cap = run(main, ["encode", str(src)], capsys)
        assert rc == 0
        outs[tag] = (Path(str(src) + ".gz").read_bytes(), masked(cap.err))
    assert outs["ref"] == outs["port"]
    assert gzip.decompress(outs["port"][0]) == data
    assert b"sample.obj\x00" in outs["port"][0][:30]


def test_gz_decode_defaults_to_the_card(text_gz):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_gz.main(["decode", str(text_gz[0]), "-o", "/dev/null"])


@pytest.fixture
def pngs(tmp_path):
    paths = []
    for ct, h, w in CASES:
        png, _ = make_case(ct, h, w, seed=ct)
        p = tmp_path / f"case{ct}.png"
        p.write_bytes(png)
        paths.append(str(p))
    return paths


def test_png_decode_matches_reference(pngs, capsys):
    ref = reference_cli("tpu_png")
    got = {}
    for tag, main, extra in (("ref", ref.main, ["--host"]),
                             ("host", cuda_png.main, ["--host"]),
                             ("cpu", cuda_png.main, ["--device", "cpu"])):
        rc, cap = run(main, ["decode", *pngs, "--bench", "--preview", *extra],
                      capsys)
        assert rc == 0
        got[tag] = (cap.out, masked(cap.err))
    assert got["ref"] == got["host"] == got["cpu"]
    assert len(got["cpu"][1]) == len(pngs) + 1  # a line an image, the total


@pytest.mark.parametrize("ch", [3, 4])
def test_png_encode_matches_reference(tmp_path, ch, capsys):
    ref = reference_cli("tpu_png")
    rng = np.random.default_rng(ch)
    img = (rng.integers(0, 256, (23, 17, ch)) // 64 * 64).astype(np.uint8)
    img[1::3] = img[0]
    raw = tmp_path / "img.raw"
    img.tofile(raw)
    outs = {}
    for tag, main, extra in (("ref", ref.main, []),
                             ("port", cuda_png.main, ["--device", "cpu"])):
        out = tmp_path / f"{tag}.png"
        rc, cap = run(main, ["encode", str(raw), "17x23", "-o", str(out),
                             *extra], capsys)
        assert rc == 0
        outs[tag] = (out.read_bytes(), masked(cap.err)[0].split("->")[0])
    assert outs["ref"] == outs["port"]
    from debigulator_tpu_torch.models.png_codec import decode_png

    back = decode_png(outs["port"][0])
    assert np.array_equal(back[..., :ch], img)


def test_png_roundtrip_matches_reference(pngs, capsys):
    ref = reference_cli("tpu_png")
    rc_ref, cap_ref = run(ref.main, ["roundtrip", *pngs[:3]], capsys)
    rc, cap = run(cuda_png.main, ["roundtrip", *pngs[:3], "--device", "cpu"],
                  capsys)
    assert rc == rc_ref == 0
    assert masked(cap.err) == masked(cap_ref.err)
    assert cap.err.count("RGBA-bit-exact") == 3


def test_bmp_matches_reference(tmp_path, capsys):
    ref = reference_cli("tpu_bmp")
    img = np.random.default_rng(3).integers(0, 256, (13, 7, 4), dtype=np.uint8)
    src = tmp_path / "a.bmp"
    src.write_bytes(bmp_codec.encode_bmp(img))
    outs = {}
    for tag, main in (("ref", ref.main), ("port", cuda_bmp.main)):
        out = tmp_path / f"{tag}.bmp"
        rc, cap = run(main, ["roundtrip", str(src), "-o", str(out)], capsys)
        rc_i, cap_i = run(main, ["info", str(src)], capsys)
        outs[tag] = (rc, rc_i, out.read_bytes(), masked(cap.err),
                     masked(cap_i.out))
    assert outs["ref"] == outs["port"]
    assert outs["port"][:2] == (0, 0)
    assert outs["port"][2] == src.read_bytes()


def test_cli_modules_run_as_scripts():
    """Each CLI runs as ``python -m`` and as its pyproject script."""
    import subprocess
    import sys

    root = Path(__file__).resolve().parents[1]
    text = (root / "pyproject.toml").read_text()
    for name in ("gz", "png", "bmp"):
        assert f'cuda-{name} = "debigulator_tpu_torch.cli.cuda_{name}:main"' \
            in text
    r = subprocess.run([sys.executable, "-m", "debigulator_tpu_torch.cli.cuda_gz",
                        "--help"], capture_output=True, text=True, cwd=root,
                       timeout=120)
    assert r.returncode == 0 and "decode" in r.stdout
