"""Registered model configs (importing this package registers them)."""
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_lite_16b,
    granite_20b,
    kimi_k2_1t_a32b,
    llama_3_2_vision_11b,
    mamba2_780m,
    phi3_mini_3_8b,
    qwen1_5_32b,
    qwen3_32b,
    recurrentgemma_2b,
    sage_dit,
    seamless_m4t_large_v2,
)
