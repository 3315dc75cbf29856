"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-8B family scaled per assignment]
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        d_ff=25600, vocab=151936, head_dim=128,
        qk_norm=True, mlp_kind="swiglu", rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=32,
        qk_norm=True, mlp_kind="swiglu", rope_theta=1e6,
    )


register("qwen3-32b", full, smoke)
