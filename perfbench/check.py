"""What decides ``correct``: the groups, NFE shares, latents and images a
window served, held to the plain float32 reference
(``perfbench.reference``), which works them out again from the seed's
weights, prompts and noise.

Numbers compared, each beside its limit (the workload's ``check``):

* ``group_mismatch`` — offline: batches whose groups (sets of prompts)
  differ from the reference's greedy clique cover of the batch, where a
  decision between similarities within ``SIM_TIE`` of each other may go
  either way; open: served groups that are not a clique of the
  reference's similarity graph or hold more than ``group_size`` members.
  Exact: limit 0.
* ``nfe_share_mismatch`` — served requests whose NFE share is not the
  paper's for its group's size at the configured fork step.  Exact.
* ``failed`` — requests of the window not served: refused, shed, never
  back within the drain, or an image with a non-finite value.  Limit 0.
* ``latent_l1_err`` — over the members of groups drawn from the seed, the
  largest ||z - z_ref||_1 / ||z_ref||_1 between the latent the program
  handed its VAE decoder and the reference's, sampled from the same noise
  and prompts: the text tower, grouping, the DiT with its attention, CFG
  and the DDIM updates, from the start.  The L1 norm, because the
  program's rounding moves a few elements of a latent far (an x0 clipped
  the other way) and the bulk a little: the squared norm is all the few.
* ``decode_rel_err`` — over the same members, the largest
  ||image - D(z)||_2 / ||D(z)||_2 between the program's image and the
  reference decoder D run on the program's own latent: the VAE decoder by
  itself.

Each limit lies between the program's readings over a dozen seeds and
the control's (``perfbench/control.py``; ``PERF.md``).
"""
from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import weights as W
from perfbench.reference import model as M
from perfbench.reference import sampling as S

#: cosine similarities closer than this are equal to float32 rounding: the
#: program's text tower and the reference's differ by rounding alone, and
#: a grouping decision between two such similarities may go either way
#: (PERF.md gives the readings it was set from)
SIM_TIE = 1e-5


def reference_weights(config: dict, seed: int, device):
    m, t = config["model"], config["text"]
    return (W.draw(M.dit_shapes(m), seed, W.DIT, device),
            W.draw(M.text_shapes(t), seed, W.TEXT, device),
            W.draw(M.vae_shapes(m["latent_channels"]), seed, W.VAE, device))


class Reference:
    """The reference model of one configuration and seed on ``device``;
    ``mm`` is its matrix product and ``conv`` its decoder's convolution
    (the control lowers both)."""

    def __init__(self, config: dict, seed: int, device, mm=M.f32_mm,
                 conv=F.conv2d, rows: int = 8):
        if torch.device(device).type == "cuda":
            M.no_tf32()
        self.config, self.seed, self.device = config, seed, \
            torch.device(device)
        self.mm, self.conv = mm, conv
        self.rows = rows                 # DiT rows a reference call
        self.dit, self.text, self.vae = reference_weights(config, seed,
                                                          device)

    @torch.no_grad()
    def embed(self, prompts: List[str], block: int = 64):
        """(token features, pooled) of each prompt; the text tower runs in
        float32 whatever ``mm`` is."""
        feats, pooled = [], []
        L = self.config["model"]["cond_len"]
        for i in range(0, len(prompts), block):
            f, p = M.text_forward(self.text, self.config["text"],
                                  M.tokenize(prompts[i:i + block], L,
                                             self.device))
            feats.append(f)
            pooled.append(p)
        return torch.cat(feats), torch.cat(pooled).cpu().numpy()

    @torch.no_grad()
    def latents(self, groups: List[List[str]], gids: List[int]
                ) -> List[np.ndarray]:
        """Each group's final latents, sampled together, in member order."""
        m = self.config["model"]
        block = self.rows

        def eps_fn(z, t, c):
            return torch.cat([M.dit_forward(self.dit, m, z[i:i + block],
                                            t[i:i + block], c[i:i + block],
                                            self.mm)
                              for i in range(0, z.shape[0], block)])
        shape = (1, m["latent_size"], m["latent_size"], m["latent_channels"])
        noise = torch.cat([W.group_noise(self.seed, g, shape, self.device)
                           for g in gids])
        conds = [self.embed(g)[0] for g in groups]
        lat = S.sample_groups(eps_fn, self.config["sage"], noise, conds)
        return [z.cpu().numpy() for z in lat]

    @torch.no_grad()
    def decode(self, z: np.ndarray) -> np.ndarray:
        """Images of latents (B, h, w, C)."""
        out = M.vae_decode(self.vae, torch.as_tensor(z, device=self.device),
                           self.conv)
        return out.cpu().numpy()


def served_groups(window) -> Dict[int, list]:
    """gid -> the window's requests in it, in member order."""
    out = collections.defaultdict(list)
    for r in window.requests:
        if r.gid >= 0:
            out[r.gid].append(r)
    return dict(out)


def rel_err(got, want, order: int = 2) -> float:
    """||got - want|| / ||want|| in the L1 or L2 norm; infinite where
    ``got`` is missing, misshapen or not finite."""
    if got is None:
        return float("inf")
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    d, w = (got - want).ravel(), want.ravel()
    return float(np.linalg.norm(d, order)
                 / max(np.linalg.norm(w, order), 1e-30))


def pick_groups(window, seed: int, k: int) -> List[int]:
    """``k`` served groups, drawn from the seed."""
    from perfbench.harness import served
    gids = sorted(g for g, rs in served_groups(window).items()
                  if all(served(r) for r in rs))
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 11])
    return sorted(rng.choice(gids, size=min(k, len(gids)),
                             replace=False).tolist()) if gids else []


def passed(numbers: Dict[str, dict]) -> bool:
    """``correct``: every number compared within its limit."""
    return all(n["value"] <= n["limit"] for n in numbers.values())


def judge(config: dict, wl: dict, window, seed: int, device
          ) -> Dict[str, dict]:
    from perfbench.harness import served
    lim = wl["check"]
    ref = Reference(config, seed, device, rows=int(lim["rows"]))
    sage, width = config["sage"], config["serving"]["group_size"]
    groups = served_groups(window)
    tau = sage["tau_min"]
    mismatch = 0
    if wl["loop"] == "offline":
        by_batch = collections.defaultdict(dict)
        for g, rs in groups.items():
            by_batch[rs[0].batch][g] = frozenset(r.prompt for r in rs)
        for b, prompts in enumerate(window.batches):
            _, pooled = ref.embed(prompts)
            index = {p: i for i, p in enumerate(prompts)}
            got = set(by_batch[b].values())
            want = {frozenset(prompts[i] for i in c)
                    for c in S.clique_groups(
                        S.similarity(pooled), tau, width, tie=SIM_TIE,
                        served=[[index[p] for p in g] for g in got])}
            mismatch += got != want
    else:
        for g, rs in groups.items():
            _, pooled = ref.embed([r.prompt for r in rs])
            mismatch += (len(rs) > width or not S.is_clique(
                S.similarity(pooled), range(len(rs)), tau, tie=SIM_TIE))
    nfe_bad = sum(abs(r.nfe_share - S.nfe_per_member(sage, len(rs))) > 1e-9
                  for rs in groups.values() for r in rs)
    failed = sum(not served(r) for r in window.requests)
    picked = pick_groups(window, seed, int(lim["groups"]))
    members = [groups[g] for g in picked]
    lat_err = dec_err = float("inf")
    if picked:
        want = ref.latents([[r.prompt for r in rs] for rs in members],
                           picked)
        lat_err = max(rel_err(r.latent, z, 1) for rs, zs in
                      zip(members, want) for r, z in zip(rs, zs))
        dec_err = max(rel_err(r.image, ref.decode(r.latent[None])[0])
                      if r.latent is not None else float("inf")
                      for rs in members for r in rs)
    return {"group_mismatch": {"value": mismatch, "limit": 0},
            "nfe_share_mismatch": {"value": nfe_bad, "limit": 0},
            "failed": {"value": failed, "limit": 0},
            "latent_l1_err": {"value": lat_err,
                              "limit": float(lim["latent_l1_err"])},
            "decode_rel_err": {"value": dec_err,
                               "limit": float(lim["decode_rel_err"])}}
