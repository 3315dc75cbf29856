"""granite-20b [dense] — 52L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576
vocab=49152, llama-arch, code.  [arXiv:2405.04324]

d_ff = 4*d_model -> non-gated GELU MLP.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152,
        mlp_kind="gelu", rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
        d_ff=1024, vocab=512,
        mlp_kind="gelu",
    )


register("granite-20b", full, smoke)
