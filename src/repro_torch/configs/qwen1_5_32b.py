"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family scaled per assignment]
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
        d_ff=27392, vocab=152064,
        qkv_bias=True, mlp_kind="swiglu", rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab=512,
        qkv_bias=True, mlp_kind="swiglu", rope_theta=1e6,
    )


register("qwen1.5-32b", full, smoke)
