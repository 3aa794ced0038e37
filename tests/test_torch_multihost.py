"""The port's multi-process decode (parallel/multihost.py) on
torch.distributed: a world of two gloo processes on the CPU decodes
``_mk_streams()`` exactly, and each holds the whole manifest, equal to
zlib's sizes and CRC-32s.  The slow mirror of tests/test_multihost.py
gates the scaling efficiency as the reference does."""

import subprocess
import sys
import zlib

import pytest
import torch

from debigulator_tpu_torch.parallel import multihost as mh


def test_two_process_gloo_world_decodes_exactly():
    streams, datas = mh._mk_streams()
    assert [zlib.decompress(s, -15) for s in streams] == datas
    want = [[1, len(d), zlib.crc32(d)] for d in datas]
    outs = mh.cluster(2, "cpu", timeout=600)
    assert len(outs) == 2
    for rank, so in enumerate(outs):
        assert f"proc {rank}/2: 4 streams" in so and "manifest complete" in so
        assert mh.worker_field(so, "MANIFEST") == want
        # The CPU runs the kernels' plain versions: no launch is counted.
        assert mh.worker_field(so, "LAUNCHES") == {
            "phase_a": 0, "compact": 0, "walk": 0}
        assert mh.decode_ms(so) > 0


def test_decode_batch_multihost_defaults_to_the_card(monkeypatch):
    """The default device is the rank's card; without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    monkeypatch.setattr(mh.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(mh.dist, "get_world_size", lambda: 1)
    streams, _ = mh._mk_streams(1)
    with pytest.raises(RuntimeError, match="cuda"):
        mh.decode_batch_multihost(streams)


@pytest.mark.slow
def test_two_process_cluster_decode():
    r = subprocess.run(
        [sys.executable, "-m", "debigulator_tpu_torch.parallel.multihost",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "MULTIHOST OK" in r.stdout
    eff = float(r.stdout.rsplit("scaling_efficiency=", 1)[1].split()[0])
    # The decode window (start-up excluded) covers the decode and the
    # all-gather on the same total silicon, so ideal is 1.0; the gate
    # bounds the distributed machinery's cost at 20%.
    assert eff >= 0.8, f"scaling efficiency {eff} below the 0.80 target"
