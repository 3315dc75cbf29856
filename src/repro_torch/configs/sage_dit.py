"""sage-dit — the paper's own model as a latent DiT.

28L d_model=1152 16H, patch 2 over 64x64x4 latents (4096 -> 1024
tokens), text cond 77x768.  ``sage-dit-100m`` is the end-to-end training
example scale (~100M); the smoke variant runs in unit tests.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="sage-dit", family="dit",
        n_layers=28, d_model=1152, n_heads=16, n_kv_heads=16,
        d_ff=4608, vocab=0,
        mlp_kind="gelu", qk_norm=True,
        latent_size=64, latent_channels=4, patch=2,
        cond_dim=768, cond_len=77,
    )


def dit_100m() -> ModelConfig:
    return ModelConfig(
        name="sage-dit-100m", family="dit",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=0,
        mlp_kind="gelu", qk_norm=True,
        latent_size=32, latent_channels=4, patch=2,
        cond_dim=256, cond_len=64,   # byte-level prompts need ~48 tokens
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="sage-dit-smoke", family="dit",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=0,
        mlp_kind="gelu", qk_norm=True,
        latent_size=8, latent_channels=4, patch=2,
        # byte-level prompts are ~40 chars; cond_len must cover the full
        # caption or grouped prompts collapse to identical conditioning
        cond_dim=64, cond_len=48,
    )


register("sage-dit", full, smoke)
register("sage-dit-100m", dit_100m, smoke)
