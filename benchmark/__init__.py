"""The benchmark of stateright_tpu_torch on one NVIDIA card (see README.md)."""
