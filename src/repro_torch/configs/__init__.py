"""Registered model configs (importing this package registers them)."""
from repro_torch.configs import mamba2_780m, sage_dit  # noqa: F401
