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

#: the assigned LM architectures, in the JAX package's order (the dry
#: run's ``--all`` grid)
ASSIGNED = [
    "qwen1.5-32b",
    "mamba2-780m",
    "phi3-mini-3.8b",
    "granite-20b",
    "seamless-m4t-large-v2",
    "llama-3.2-vision-11b",
    "qwen3-32b",
    "kimi-k2-1t-a32b",
    "recurrentgemma-2b",
    "deepseek-v2-lite-16b",
]
