"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206, enc-dec multimodal.  [arXiv:2308.11596]

Transformer backbone only, as in the JAX package: the mel-spectrogram +
conformer conv frontend is a stub, and callers pass precomputed frame
embeddings as ``extras["frames"]`` (enc_input_dim=1024).  24 encoder + 24
decoder layers.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256206,
        mlp_kind="gelu",
        enc_layers=24, enc_input_dim=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="encdec",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab=512,
        mlp_kind="gelu",
        enc_layers=2, enc_input_dim=256,
    )


register("seamless-m4t-large-v2", full, smoke)
