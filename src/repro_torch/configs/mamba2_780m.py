"""mamba2-780m [ssm] — 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]
"""
from repro_torch.config import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=48, n_kv_heads=48,  # SSD heads
        d_ff=0, vocab=50280, tie_embeddings=True,
        pattern=("ssm",),
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                      chunk=128),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
        d_ff=0, vocab=512, tie_embeddings=True,
        pattern=("ssm",),
        ssm=SSMConfig(d_state=32, head_dim=64, expand=2, conv_kernel=4,
                      chunk=32),
    )


register("mamba2-780m", full, smoke)
