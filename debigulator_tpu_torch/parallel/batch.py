"""Data-parallel batch decode over a device mesh (the port of
debigulator_tpu/parallel/batch.py, on the all-tensor-op v3 core).

The unit of data parallelism is an independent DEFLATE stream (gzip
member, PNG IDAT stream, corpus file).  Host plans with the scanner's
exact cell entries are padded to common shapes and stacked on a leading
batch axis; each stream then decodes through ``ops.graph.build_graph``,
``chase_cells`` and ``ops.inflate.resolve_tape_torch`` (the twins of the
reference's ``build_graph_v3``, ``chase_cells`` and ``resolve_tape_xla``:
no kernel runs here, as in the reference).  A loop over the batch rows
stands in for ``vmap``; over a mesh the batch splits into ``dp`` equal
parts, one a mesh row's device, and the outputs gather in stream order.

``ring_tail_exchange`` is the one-hop neighbour move that the
split-stream decode needs between its shards.
"""

from __future__ import annotations

import numpy as np
import torch

from debigulator_tpu_torch.device import resolve as resolve_device
from debigulator_tpu_torch.ops import plan as pl
from debigulator_tpu_torch.ops.graph import build_graph, chase_cells
from debigulator_tpu_torch.ops.inflate import resolve_tape_torch
from debigulator_tpu_torch.ops.scanner import scan_stream_cells
from debigulator_tpu_torch.parallel.mesh import Mesh, dp_sharding


def _pad_to(arr: np.ndarray, shape: tuple[int, ...], fill=0) -> np.ndarray:
    out = np.full(shape, fill, arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def stack_plans(plans: list[pl.PlanV3]) -> tuple[dict, dict]:
    """Pad and stack per-stream plans into batched numpy arrays (the
    reference's dict, key for key) and the static dims."""
    nb_max = max(p.ll_count.shape[0] for p in plans)
    n_bits = max(p.n_bits for p in plans)
    cells_max = n_bits // pl.CELL_BITS
    nbytes = n_bits // 8 + 16
    out_max = pl._round_pow2(max(max(p.out_size, 1) for p in plans), 1 << 8)
    stored_max = max(1, max(p.stored_pos.shape[0] for p in plans))
    slots = max(p.slots for p in plans)
    if not all(p.exact_entries for p in plans):
        raise ValueError("the batch path needs exact cell entries")

    def stk(get, shape, fill=0):
        return np.stack([_pad_to(get(p), shape, fill) for p in plans])

    batched = {
        "vbytes": stk(lambda p: p.vbytes, (nbytes,)),
        "cell_block": stk(lambda p: p.cell_block, (cells_max,)),
        "cell_entry": stk(lambda p: p.cell_entry, (cells_max,), fill=-1),
        "cell_pend": stk(lambda p: p.cell_pend, (cells_max,)),
        "ll_count": stk(lambda p: p.ll_count, (nb_max, 16)),
        "ll_first": stk(lambda p: p.ll_first, (nb_max, 16)),
        "ll_base": stk(lambda p: p.ll_base, (nb_max, 16)),
        "ll_aug_flat": stk(lambda p: p.ll_aug.reshape(-1), (nb_max * 288,)),
        "d_count": stk(lambda p: p.d_count, (nb_max, 16)),
        "d_first": stk(lambda p: p.d_first, (nb_max, 16)),
        "d_base": stk(lambda p: p.d_base, (nb_max, 16)),
        "d_aug_flat": stk(lambda p: p.d_aug.reshape(-1), (nb_max * 32,)),
        "block_next_entry": stk(
            lambda p: p.block_next_entry, (nb_max,), fill=pl.TERMINAL),
        "bne_cell": stk(
            lambda p: p.block_next_entry[p.cell_block].astype(np.int32),
            (cells_max,), fill=pl.TERMINAL),
        "block_out_base": stk(lambda p: p.block_out_base, (nb_max,)),
        "stored_pos": stk(lambda p: p.stored_pos, (stored_max,), fill=out_max),
        "stored_val": stk(lambda p: p.stored_val, (stored_max,)),
    }
    dims = {"n_bits": n_bits, "slots": slots, "out_size": out_max}
    return batched, dims


def _inflate_one(arrays: dict, n_bits: int, slots: int, out_size: int):
    """One stream of a stacked batch: (out (out_size,) uint8, overflow)."""
    nxt, meta = build_graph(arrays, n_bits)
    tape, overflow, _, _ = chase_cells(
        nxt, meta, arrays["cell_entry"], n_bits, slots,
        exact=True, cell_pend=arrays["cell_pend"])
    out = resolve_tape_torch(
        tape, arrays["cell_block"], arrays["block_out_base"], out_size,
        arrays["stored_pos"], arrays["stored_val"])
    return out, overflow


def batched_inflate(batched: dict, n_bits: int, slots: int, out_size: int):
    """Decode every row of a stacked batch (tensors on one device): (out
    (batch, out_size) uint8, overflow (batch,) bool)."""
    outs, flags = [], []
    for i in range(batched["vbytes"].shape[0]):
        out, overflow = _inflate_one({k: v[i] for k, v in batched.items()},
                                     n_bits, slots, out_size)
        outs.append(out)
        flags.append(overflow)
    return torch.stack(outs), torch.stack(flags)


def sharded_inflate(mesh: Mesh, batched: dict, dims: dict):
    """The batch split over ``dp``: part i decodes on mesh row i's device;
    outputs gather in order on the first part's device."""
    dp = mesh.shape["dp"]
    bsz = batched["vbytes"].shape[0]
    if bsz % dp:
        raise ValueError(f"batch {bsz} not divisible by dp={dp}")
    per = bsz // dp
    outs, flags = [], []
    for i, dev in enumerate(dp_sharding(mesh)):
        part = {k: torch.from_numpy(np.ascontiguousarray(
                    v[i * per : (i + 1) * per])).to(dev)
                for k, v in batched.items()}
        out, overflow = batched_inflate(part, dims["n_bits"], dims["slots"],
                                        dims["out_size"])
        outs.append(out)
        flags.append(overflow)
    home = outs[0].device
    return (torch.cat([o.to(home) for o in outs]),
            torch.cat([f.to(home) for f in flags]))


def plan_streams(streams: list[bytes]) -> list[pl.PlanV3]:
    """Per-stream plans with the native scanner's exact cell entries."""
    plans = []
    for s in streams:
        blocks, lengths, cells = scan_stream_cells(s, pl.CELL_BITS)
        if cells is None:
            raise RuntimeError(
                "batch decode requires the native scanner (exact entries)")
        plans.append(pl.build_plan_v3(s, blocks, lengths, cells=cells))
    return plans


def _decode(plans, mesh: Mesh | None, slots: int | None, dev):
    """(out (batch, out_size) uint8, overflow (batch,)) for the plans at
    ``slots`` (each plan's own bound when None)."""
    batched, dims = stack_plans(plans)
    if slots is not None:
        dims["slots"] = slots
    if mesh is None:
        return batched_inflate(
            {k: torch.from_numpy(v).to(dev) for k, v in batched.items()},
            dims["n_bits"], dims["slots"], dims["out_size"])
    pad = (-len(plans)) % mesh.shape["dp"]
    if pad:
        batched = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                   for k, v in batched.items()}
    return sharded_inflate(mesh, batched, dims)


def decode_batch_device(streams: list[bytes], mesh: Mesh | None = None,
                        slots: int | None = None,
                        device="cuda") -> list[bytes]:
    """Decode a list of raw DEFLATE streams as one batch: on ``device``,
    or split over the mesh's ``dp`` rows (the batch padded up to a multiple
    of dp with copies of its last stream).  A tape overflow is decoded
    once more at CELL_BITS slots, which no cell exceeds."""
    dev = resolve_device(device) if mesh is None else None
    plans = plan_streams(streams)
    out, overflow = _decode(plans, mesh, slots, dev)
    if bool(overflow.any()):
        if slots == pl.CELL_BITS:
            raise RuntimeError("tape overflow at the exact slot bound")
        out, overflow = _decode(plans, mesh, pl.CELL_BITS, dev)
        if bool(overflow.any()):
            raise RuntimeError("tape overflow at the exact slot bound")
    out_np = out.cpu().numpy()
    return [out_np[i, : p.out_size].tobytes() for i, p in enumerate(plans)]


def ring_tail_exchange(xs: list[torch.Tensor], tail: int) -> list[torch.Tensor]:
    """One-hop neighbour exchange of each shard's last ``tail`` elements:
    shard i (i > 0) receives shard i-1's tail on its own device, shard 0
    receives zeros (the stream has no window before it)."""
    out = [torch.zeros_like(xs[0][-tail:])]
    out += [x[-tail:].to(nxt.device) for x, nxt in zip(xs[:-1], xs[1:])]
    return out
