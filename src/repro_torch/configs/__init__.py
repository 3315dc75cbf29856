"""Registered model configs (importing this package registers them)."""
from repro_torch.configs import sage_dit  # noqa: F401
