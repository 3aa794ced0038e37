"""The benchmark of debigulator_tpu_torch on one H100: see README.md."""
