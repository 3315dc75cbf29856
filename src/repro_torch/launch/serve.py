"""Serving launcher: batched decode loop (prefill -> N greedy decode steps
with the state cache), reporting tokens/s and cache bytes — plus the SAGE
shared-prefix mode (one trunk prefill, forked to the batch).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        [--smoke] [--batch 4 --prompt-len 64 --gen 32] [--shared-prefix] \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b --smoke --device cpu

Any ported family serves: ``mamba2-780m`` (SSM states), the dense
configs (``phi3-mini-3.8b``, ``qwen3-32b``, ``qwen1.5-32b``,
``granite-20b``: KV caches of ``prompt_len + gen + 8`` rows), the hybrid
``recurrentgemma-2b`` (RG-LRU states and local-attention rings of
``min(window, prompt_len + gen + 8)`` rows), the MoE configs
``deepseek-v2-lite-16b`` (MLA latent caches) and ``kimi-k2-1t-a32b``, the
VLM ``llama-3.2-vision-11b`` and the encdec ``seamless-m4t-large-v2``
(cross-attention layers: each cache adds the memory's K/V).  As in the JAX
launcher, the VLM's image embeddings ``(batch, n_image_tokens,
vision_dim)`` and encdec's frames ``(batch, 32, enc_input_dim)`` are zeros
(in shared-prefix mode their first row); with bias-free layers a zero
memory makes every cross-attention add exactly 0.

The device defaults to CUDA and raises without a GPU.  The weights are
random, drawn from seed 0, and cast to the activation dtype once; the
prompts come from numpy's ``RandomState(0)``, as in the JAX launcher, so
both see the same tokens.  On a CUDA device every decode step replays a
CUDA graph (``serving.runners.DecodeRunner``, the counterpart of the JAX
launcher's ``jax.jit(decode_step)``: one graph for every position, which
it reads from the device), captured before the decode clock starts; the
prefill stays eager.  On the CPU the decode steps run eagerly.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import get_config
from repro_torch.models import transformer as tfm
from repro_torch.serving.kvcache import cache_bytes, fork_model_cache
from repro_torch.serving.runners import DecodeRunner


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launcher_extras(cfg, batch: int, n_frames: int = 32
                    ) -> Dict[str, np.ndarray]:
    """The launchers' zero memory inputs: the VLM's ``image_embeds`` and
    encdec's ``n_frames`` ``frames`` (the serving launcher's 32; the
    training launcher's ``max(seq // 4, 16)``), none for the other
    families."""
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = np.zeros(
            (batch, cfg.n_image_tokens, cfg.vision_dim), np.float32)
    if cfg.family == "encdec":
        extras["frames"] = np.zeros((batch, n_frames, cfg.enc_input_dim),
                                    np.float32)
    return extras


def serve(arch: str = "mamba2-780m", *, smoke: bool = False, batch: int = 4,
          prompt_len: int = 64, gen: int = 32, shared_prefix: bool = False,
          device="cuda", model: Optional[tfm.LM] = None) -> Dict:
    """One prefill and ``gen`` greedy decode steps over ``batch`` requests.
    ``model`` reuses weights already on the device (else they are drawn
    from seed 0, as the JAX launcher draws its own from ``PRNGKey(0)``).
    Returns counts and host-clock times, each ending in a device sync:
    ``prefill_s``, ``capture_s`` (the decode graphs'; 0 on the CPU),
    ``decode_s``, ``decode_tok_s``, ``cache_bytes``, ``cast_bytes`` (the
    weights cast once), ``token_steps``, and the generated ``tokens``
    (batch, gen) with the last ``logits`` (batch, 1, V)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if model is None:
        model = tfm.LM(cfg, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    cast = model.cast_weights_()
    rng = np.random.RandomState(0)
    max_len = prompt_len + gen + 8
    extras = launcher_extras(cfg, batch)

    _sync(dev)
    t0 = time.perf_counter()
    if shared_prefix:            # SAGE analogue: one trunk, fork, decode
        prompt = rng.randint(0, cfg.vocab, (1, prompt_len))
        logits, trunk = tfm.prefill(model, prompt,
                                    {k: v[:1] for k, v in extras.items()},
                                    max_len=max_len)
        cache = fork_model_cache(trunk, batch)
        steps_cost = prompt_len + batch * gen
    else:
        prompts = rng.randint(0, cfg.vocab, (batch, prompt_len))
        logits, cache = tfm.prefill(model, prompts, extras, max_len=max_len)
        steps_cost = batch * (prompt_len + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = logits[:, -1:].argmax(dim=-1)
    if tok.shape[0] == 1 and batch > 1:
        tok = tok.repeat_interleave(batch, dim=0)
    if dev.type == "cuda":
        decode = DecodeRunner(model)
        if gen:
            decode.capture(cache, tok)
    else:
        decode = functools.partial(tfm.decode_step, model)
    out = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(gen):
        logits, cache = decode(cache, tok, prompt_len + i)
        tok = logits.argmax(dim=-1)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"arch": cfg.name, "batch": batch, "prompt_len": prompt_len,
            "gen": gen, "shared_prefix": shared_prefix, "device": str(dev),
            "prefill_s": t_prefill,
            "capture_s": getattr(decode, "capture_s", 0.0),
            "decode_s": t_decode,
            "decode_tok_s": batch * gen / max(t_decode, 1e-9),
            "cache_bytes": cache_bytes(cache), "cast_bytes": cast,
            "token_steps": steps_cost,
            "tokens": torch.cat(out, dim=1).cpu().numpy() if out else
            np.zeros((batch, 0), np.int64),
            "logits": logits}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--shared-prefix", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = serve(args.arch, smoke=args.smoke, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen,
              shared_prefix=args.shared_prefix, device=args.device)
    print(f"arch={r['arch']} batch={r['batch']} prompt={r['prompt_len']} "
          f"gen={r['gen']} shared_prefix={r['shared_prefix']} "
          f"device={r['device']}")
    print(f"prefill {r['prefill_s']:.2f}s | capture {r['capture_s']:.2f}s "
          f"| decode {r['decode_s']:.2f}s "
          f"({r['decode_tok_s']:.1f} tok/s) | "
          f"cache {r['cache_bytes'] / 2 ** 20:.1f} MiB | "
          f"token-steps {r['token_steps']}")


if __name__ == "__main__":
    main()
