"""Superseded decode generations, kept as the reference keeps them: the
host-fed v10 path and the v14 driver (the port of debigulator_tpu/ops/
archive/)."""
