"""Small scripts that run on a machine with an NVIDIA card."""
