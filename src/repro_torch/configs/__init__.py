"""Registered model configs (importing this package registers them)."""
from repro_torch.configs import (  # noqa: F401
    granite_20b,
    mamba2_780m,
    phi3_mini_3_8b,
    qwen1_5_32b,
    qwen3_32b,
    sage_dit,
)
