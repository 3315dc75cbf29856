"""SAGE's insight on an assigned LLM architecture: semantic shared-prefix
prefill.  Each group's requests share a prompt prefix; the prefix is
prefilled once, the KV cache forked at the branch point, and each member
decodes its own tail (the AR analogue of the paper's shared phase).  The
twin of the JAX package's ``examples/shared_prefill_llm.py``, with its
flags and output, plus ``--device`` and ``--seed``.

With ``--trunk-cache`` the prefill trunk also rides the unified semantic
cache (``payload="ar_prefix"`` in the same
:class:`~repro_torch.serving.trunk_cache.TrunkCache` the diffusion
scheduler uses): groups drawn from a small prefix pool hit the cached
(logits, KV cache) pair and skip the prefill.

    PYTHONPATH=src python -m repro_torch.examples.shared_prefill_llm \\
        --arch phi3-mini-3.8b [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.shared_prefill_llm \\
        --trunk-cache --groups 6 --prefix-pool 2 --cache-index lsh

``main()`` runs the architecture's smoke config with random weights drawn
from ``--seed``; the prompts come from numpy's ``RandomState(0)``, as in
the JAX example, so both serve the same tokens and print the same counts.
:func:`serve_groups` takes any model (the full-width one too).  The
device defaults to CUDA and raises without a GPU.
"""
import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import get_config
from repro_torch.models import transformer as tfm
from repro_torch.serving.shared_prefill import (cached_prefix_prefill,
                                                shared_prefix_prefill)
from repro_torch.serving.trunk_cache import TrunkCache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_groups(model: tfm.LM, *, groups: int = 3, members: int = 4,
                 prefix: int = 48, tail: int = 16,
                 cache: Optional[TrunkCache] = None, prefix_pool: int = 2,
                 log=print) -> List[Dict]:
    """The example's loop on ``model``: ``groups`` groups of ``members``
    requests, each a ``prefix``-token shared prefix and a ``tail``-token
    tail of its own, drawn from ``RandomState(0)`` as the JAX example
    draws them (with ``cache``, the prefixes come from a pool of
    ``prefix_pool``).  Each group goes through ``shared_prefix_prefill``,
    or ``cached_prefix_prefill`` with ``cache``; ``log`` gets the JAX
    example's line per group.  Returns one record a group: its
    ``tokens``, last ``logits``, forked ``caches``, ``stats``, and host
    seconds ending in a device sync, ``wall_s`` (the call) and
    ``prefill_s`` (its trunk prefill, 0 on a hit)."""
    rng = np.random.RandomState(0)
    vocab, dev = model.cfg.vocab, model.device
    S = prefix + tail
    pool = [rng.randint(0, vocab, (1, prefix))
            for _ in range(max(1, prefix_pool))]
    spent = {"prefill_s": 0.0}

    def prefill_fn(t, max_len):
        _sync(dev)
        t0 = time.perf_counter()
        out = tfm.prefill(model, t, max_len=max_len)
        _sync(dev)
        spent["prefill_s"] += time.perf_counter() - t0
        return out

    def decode_fn(c, tok, pos):
        return tfm.decode_step(model, c, tok, pos)

    records = []
    for g in range(groups):
        shared = (pool[g % len(pool)] if cache is not None
                  else rng.randint(0, vocab, (1, prefix)))
        tokens = np.concatenate(
            [shared.repeat(members, 0),
             rng.randint(0, vocab, (members, tail))], axis=1)
        spent["prefill_s"] = 0.0
        _sync(dev)
        t0 = time.perf_counter()
        if cache is not None:
            # token-derived pseudo-embedding: enough to route the lookup
            # (real deployments use the prompt tower's pooled embedding)
            emb = np.asarray(tokens, np.float32)
            logits, caches, _, stats = cached_prefix_prefill(
                prefill_fn, decode_fn, tokens, max_len=S + 32, cache=cache,
                embeds=emb)
            tag = " [cache hit]" if stats["trunk_cache_hit"] else ""
        else:
            logits, caches, _, stats = shared_prefix_prefill(
                prefill_fn, decode_fn, tokens, max_len=S + 32)
            tag = ""
        _sync(dev)
        records.append({"tokens": tokens, "logits": logits,
                        "caches": caches, "stats": stats,
                        "wall_s": time.perf_counter() - t0,
                        "prefill_s": spent["prefill_s"]})
        log(f"group {g}: prefix={stats['prefix_len']} "
            f"steps={stats['token_steps']} vs naive "
            f"{stats['token_steps_naive']} -> saving "
            f"{stats['saving']:.1%}{tag}")
    return records


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--groups", type=int, default=3)
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--prefix", type=int, default=48)
    ap.add_argument("--tail", type=int, default=16)
    ap.add_argument("--trunk-cache", action="store_true",
                    help="serve prefill trunks from the unified semantic "
                         "cache (payload='ar_prefix')")
    ap.add_argument("--cache-index", choices=["scan", "lsh"],
                    default="scan",
                    help="candidate generation for the cache's "
                         "similarity search")
    ap.add_argument("--prefix-pool", type=int, default=2,
                    help="with --trunk-cache: number of distinct shared "
                         "prefixes groups draw from (repeats -> hits)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    model = tfm.LM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    model.cast_weights_()
    cache = None
    if args.trunk_cache:
        cache = TrunkCache(tau_trunk=0.95, index=args.cache_index)
    t0 = time.time()
    records = serve_groups(model, groups=args.groups, members=args.members,
                           prefix=args.prefix, tail=args.tail, cache=cache,
                           prefix_pool=args.prefix_pool)
    saving = np.mean([r["stats"]["saving"] for r in records])
    print(f"\narch={args.arch} mean prefill-compute saving "
          f"{saving:.1%} across {args.groups} groups "
          f"({time.time() - t0:.1f}s, smoke-size weights)")
    if cache is not None:
        st = cache.stats
        print(f"unified trunk cache [{cache.index.name}]: "
              f"{st['hits']} hits / {st['misses']} misses, "
              f"{len(cache)} entries, {cache.bytes} B "
              f"(ar_prefix payloads share the diffusion cache's "
              f"budget/admission/index)")
    return records


if __name__ == "__main__":
    main()
