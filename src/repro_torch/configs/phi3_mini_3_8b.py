"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064, RoPE SwiGLU GQA.  [arXiv:2404.14219]
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064,
        mlp_kind="swiglu", rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab=512,
        mlp_kind="swiglu",
    )


register("phi3-mini-3.8b", full, smoke)
