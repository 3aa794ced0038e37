"""The configuration's images as one pool item: one PNG for each entry of
``config["images"]`` ([name, color type, height, width]), at the zlib
levels of ``config["levels"]`` in turn."""

from __future__ import annotations

from benchmark import inputs


def make(config: dict, traffic: dict, seed: int, k: int, pool):
    specs, levels = config["images"], config["levels"]
    images = list(pool.map(
        lambda j: inputs.png_image(config, inputs.rng_for(seed, k, 1, j),
                                   specs[j], int(levels[j % len(levels)])),
        range(len(specs))))
    return inputs.images_item(images)
