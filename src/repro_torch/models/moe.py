"""Mixture-of-Experts MLP with top-k routing.

Dispatch is sort-based with static capacity, as in the JAX package:
token-choice pairs are sorted by expert id inside fixed-size token
*groups*, packed into an (E, C, d) buffer, run through a batched expert
matmul, and brought back with the router weights.  Every shape is static
(group size, capacity), and nothing reads a count back to the host, so a
decode step holding an MoE layer can be captured in a CUDA graph.

Both directions are gathers, never a scatter-add: a buffer slot (e, c)
reads the c-th entry routed to expert e (or zero past the expert's
count, or past the capacity: a dropped entry), and a token reads its k
entries' slots through the inverse of the sort and sums them over k in a
fixed order.  So the result does not depend on the order in which
atomics land, and a replayed graph equals the eager step bitwise.

Shared experts (DeepSeek-style) are a fused always-on MLP.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import cast, dense_init, dot


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(tokens * top_k * cf / n_experts) + 1
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


class MoE(nn.Module):
    """``init_moe``'s tree: ``router`` (d, E), the experts' ``wi`` / ``wg``
    (E, d, ff) and ``wo`` (E, ff, d), stacked per expert, and the shared
    experts' ``shared.wi`` / ``wg`` / ``wo`` when ``n_shared``."""

    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        m = cfg.moe
        d, ff = cfg.d_model, m.d_ff_expert
        kw = dict(device=device, generator=generator)
        E = m.n_routed
        self.router = nn.Parameter(dense_init(d, E, **kw))

        def experts(d_in: int, d_out: int) -> torch.Tensor:
            # one draw an expert; on the meta device nothing is drawn, and
            # the stack is made at once (kimi-k2's 60 x 3 stacks of 384
            # would take minutes one by one)
            if torch.device(device).type == "meta":
                return torch.empty((E, d_in, d_out), device=device)
            return torch.stack([dense_init(d_in, d_out, **kw)
                                for _ in range(E)])

        self.wi = nn.Parameter(experts(d, ff))
        self.wg = nn.Parameter(experts(d, ff))
        self.wo = nn.Parameter(experts(ff, d))
        if m.n_shared:
            sf = m.n_shared * ff
            self.shared = nn.ParameterDict({
                "wi": nn.Parameter(dense_init(d, sf, **kw)),
                "wg": nn.Parameter(dense_init(d, sf, **kw)),
                "wo": nn.Parameter(dense_init(sf, d, **kw))})


def init_moe(cfg: ModelConfig, *, device, generator) -> MoE:
    return MoE(cfg, device=device, generator=generator)


def _route_group(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 n_experts: int, capacity: int):
    """Pack token groups.  x (G,T,d); idx/w (G,T,k) -> buffer (G, E*C, d)
    plus the metadata :func:`_unroute_group` reads, in the tokens' (t, j)
    order: each entry's slot, its weight times its keep flag, and the keep
    flag (False: dropped for capacity)."""
    G, T, k = idx.shape
    dev = x.device
    flat_e = idx.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = order // k
    # rank of each sorted entry within its expert
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(T * k, device=dev) - first
    keep = rank < capacity
    slot = torch.where(keep, se * capacity + rank.clamp_max(capacity - 1),
                       torch.zeros_like(se))
    # slot (e, c) holds the entry at sorted position start_e + c, if any
    experts = torch.arange(n_experts, device=dev).expand(G, n_experts)
    start = torch.searchsorted(se, experts.contiguous(), side="left")
    count = torch.searchsorted(se, experts.contiguous(), side="right") - start
    c = torch.arange(capacity, device=dev)
    src = (start[..., None] + c).clamp_max(T * k - 1).reshape(G, -1)
    filled = (c < count[..., None]).reshape(G, -1)
    tok = torch.gather(stok, 1, src)                              # (G, E*C)
    buf = torch.gather(x, 1, tok[..., None].expand(-1, -1, x.shape[-1]))
    buf = torch.where(filled[..., None], buf, torch.zeros_like(buf))
    # each (t, j) entry's place in the sort
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(T * k, device=dev).expand(G, -1))
    ws = torch.gather(w.reshape(G, T * k), 1, order)
    sw = ws * keep.to(ws.dtype)
    return buf, tuple(torch.gather(t, 1, inv) for t in (slot, sw, keep))


def _unroute_group(out_buf: torch.Tensor, meta, T: int) -> torch.Tensor:
    """out_buf (G, E*C, d) -> y (G, T, d): each token's k weighted slots,
    summed over k in order."""
    slot, sw, _ = meta                                            # (G, T*k)
    G, d = out_buf.shape[0], out_buf.shape[-1]
    vals = torch.gather(out_buf, 1, slot[..., None].expand(-1, -1, d))
    vals = vals * sw[..., None].to(out_buf.dtype)
    return vals.reshape(G, T, -1, d).sum(dim=2)


def _router(p: MoE, cfg: ModelConfig, xt: torch.Tensor):
    """Router probabilities (f32), the top-k weights renormalised and their
    expert ids."""
    logits = xt.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    wk, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    wk = wk / torch.sum(wk, dim=-1, keepdim=True)
    return probs, wk, idx


def _shared(p: MoE, xt: torch.Tensor) -> torch.Tensor:
    sp = p.shared
    return dot(F.silu(dot(xt, sp["wg"])) * dot(xt, sp["wi"]), sp["wo"])


def apply_moe(p: MoE, cfg: ModelConfig, x: torch.Tensor,
              group_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (out (B,S,D), aux load-balance loss scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    probs, wk, idx = _router(p, cfg, xt)

    # aux loss: mean prob per expert * mean assignment fraction (Switch)
    me = torch.mean(probs, dim=0)
    experts = torch.arange(m.n_routed, device=x.device)
    ce = torch.mean((idx[..., None] == experts).float().sum(dim=1), dim=0)
    aux = m.router_aux_coef * m.n_routed * torch.sum(me * ce)

    g = group_size or min(T, 4096)
    n_groups = -(-T // g)
    pad = n_groups * g - T
    xt_p, idx_p, wk_p = xt, idx, wk
    if pad:
        xt_p = F.pad(xt, (0, 0, 0, pad))
        idx_p = F.pad(idx, (0, 0, 0, pad))
        wk_p = F.pad(wk, (0, 0, 0, pad))
    xg = xt_p.reshape(n_groups, g, d)
    ig = idx_p.reshape(n_groups, g, m.top_k)
    wg_ = wk_p.reshape(n_groups, g, m.top_k).to(x.dtype)

    C = _capacity(g, m.top_k, m.n_routed, m.capacity_factor)
    buf, meta = _route_group(xg, ig, wg_, m.n_routed, C)
    ebuf = buf.reshape(n_groups, m.n_routed, C, d)

    # batched expert MLP: (G,E,C,d) x (E,d,f)
    h = (F.silu(torch.einsum("gecd,edf->gecf", ebuf, cast(p.wg, x.dtype)))
         * torch.einsum("gecd,edf->gecf", ebuf, cast(p.wi, x.dtype)))
    out_buf = torch.einsum("gecf,efd->gecd", h, cast(p.wo, x.dtype))
    out_buf = out_buf.reshape(n_groups, m.n_routed * C, d)

    y = _unroute_group(out_buf, meta, g).reshape(n_groups * g, d)[:T]
    if m.n_shared:
        y = y + _shared(p, xt)
    return y.reshape(B, S, d), aux


def apply_moe_dense_ref(p: MoE, cfg: ModelConfig,
                        x: torch.Tensor) -> torch.Tensor:
    """Oracle: compute every expert densely and mix with router weights.
    Matches :func:`apply_moe` when nothing is dropped.  Test-only."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs, wk, idx = _router(p, cfg, xt)
    wfull = torch.zeros_like(probs).scatter(1, idx, wk)
    h = (F.silu(torch.einsum("td,edf->tef", xt, cast(p.wg, x.dtype)))
         * torch.einsum("td,edf->tef", xt, cast(p.wi, x.dtype)))
    ey = torch.einsum("tef,efd->ted", h, cast(p.wo, x.dtype))
    y = torch.einsum("ted,te->td", ey, wfull.to(x.dtype))
    if m.n_shared:
        y = y + _shared(p, xt)
    return y.reshape(B, S, d)
