"""Command-line front ends of the port: ``cuda_gz``, ``cuda_png`` and
``cuda_bmp`` (the counterparts of the repository's ``cli/tpu_*.py``)."""
