"""The cells of BENCHMARK.json cut to a size the CPU runs in seconds: the
same files, with the text, the stream count, the BGZF blocks, the images
and the IDAT chunks made small.

Besides those, the tests drive the cells whose files are kept but which
BENCHMARK.json does not hold (PERF.md, Open questions), so that a later
change can add them with BENCHMARK.json entries alone."""

from __future__ import annotations

import json

from benchmark import harness

#: A corpus of every color type the port decodes.
SMALL_IMAGES = [["rgba", 6, 32, 40], ["rgb", 2, 17, 23], ["pal", 3, 9, 13],
                ["gray", 0, 20, 20], ["graya", 4, 11, 7], ["tiny", 3, 2, 3]]


#: Kept cells: name -> (configuration, traffic).
KEPT = {"png-corpus.decode": ("png-corpus", "decode")}


def _spec() -> dict:
    return json.loads((harness.REPO / "BENCHMARK.json").read_text())


def _kept(name: str) -> harness.Cell:
    config, traffic = KEPT[name]
    spec = _spec()
    cells = {w["name"] for w in spec["workloads"]}

    def reports(m):  # what a png cell of BENCHMARK.json reports
        return set(m.get("workloads", cells)) & {"png-4k.single"}

    return harness.Cell(
        name=name,
        config=json.loads((harness.HERE / "configs" / f"{config}.json").read_text()),
        traffic=json.loads((harness.HERE / "traffic" / f"{traffic}.json").read_text()),
        chips=1,
        end_to_end=[m for m in spec["end_to_end"] if reports(m)],
        per_layer=[m for m in spec["per_layer"] if reports(m)])


def small_cell(name: str) -> harness.Cell:
    cell = _kept(name) if name in KEPT else harness.load_cell(name)
    if "text" in cell.config:
        cell.config["text_bytes"] = 12000
        cell.traffic["streams"] = 3
        cell.traffic["block_bytes"] = 5000
    elif len(cell.config["images"]) > 1:
        cell.config["images"] = SMALL_IMAGES
        cell.config["idat_chunk"] = 64
    else:
        (spec,) = cell.config["images"]
        cell.config["images"] = [[spec[0], spec[1], 48, 48]]
        cell.config["idat_chunk"] = 2048
    return cell


def workloads() -> list[str]:
    return [w["name"] for w in _spec()["workloads"]] + list(KEPT)
