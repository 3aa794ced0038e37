"""debigulator_tpu_torch: the PyTorch + CUDA port of debigulator_tpu.

The flagship DEFLATE decode runs on an NVIDIA Hopper card: a native host
scan and plan, then three hand-written CUDA kernels (Phase A Huffman
decode, compact, LZ77 walk) with PyTorch glue between them.  Every public
entry point takes ``device=`` and defaults to ``"cuda"``; the CPU runs the
kernels' plain PyTorch versions and is used only when asked for.

The package imports torch and numpy only: nothing of JAX and nothing of
debigulator_tpu (it keeps its own copies of the host helpers it needs).
"""

__version__ = "0.1.0"
