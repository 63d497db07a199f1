"""Mixture-of-experts FFN with capacity-based gather/scatter dispatch (the
port of ``repro.models.moe``).

Tokens are processed in ``num_groups`` groups (the serving engine passes
1), each with its own expert capacity.  A (E, C) token-index table is
built from a cumsum over the one-hot expert choices in (token, choice)
order, tokens are gathered into (E, C, D) buffers through a zero pad row,
every expert runs its dense SwiGLU FFN over its C slots (batched
products), and the weighted results are added back to token order
(``index_add_``).
A (token, choice) past its expert's capacity is dropped: it adds nothing.
Top-k weights are renormalized (mixtral style); the Switch-style balance
loss is returned beside the output; arctic's parallel dense FFN
(``moe_dense_ff``) is added on the same normed input.

The rounding points are the reference's: the router product in x's dtype,
then float32 for the softmax, top-k and weights; the expert products, the
SiLU (its logistic expanded and rounded as XLA rounds it), the weight
multiply and the scatter-add in x's dtype.  Ties in the router's
probabilities go to the lower expert index, as in ``jax.lax.top_k`` (a
stable descending sort; ``torch.topk`` makes no such promise).

The capacity comes from shapes alone and nothing is read back to the host,
so a call never waits on the device.  The table is built with one spare
column that every dropped slot writes, then cut off: no write lands out of
range, which on the card would be a device-side assert.

Every (token, choice) competes for the same capacity, so a call's output
for one token depends on the other tokens of its group: a batched decode
step's lanes are coupled once an expert overflows.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import silu


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The router and the stacked expert weights (arctic's dense FFN is a
    SwiGLU of width ``moe_dense_ff`` beside them)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
            "w_down": (e, f, d)}


def expert_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = math.ceil(cfg.num_experts_per_tok * tokens_per_group
                  * cfg.moe_capacity_factor / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # >=4, rounded up to a multiple of 4


def swiglu(x, w_gate, w_up, w_down):
    """``silu(x @ w_gate) * (x @ w_up) @ w_down`` in x's dtype, batched
    over experts when the weights are (E, ., .)."""
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


def top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


def _groups(x: torch.Tensor, cfg: ModelConfig, num_groups: int):
    """(groups, tokens a group, expert capacity) of a call on x (B, S, D)."""
    t = x.shape[0] * x.shape[1]
    g = num_groups if t % num_groups == 0 else 1
    tg = t // g
    return g, tg, min(expert_capacity(tg, cfg), tg * cfg.num_experts_per_tok)


def _route(p, x: torch.Tensor, cfg: ModelConfig, g: int, tg: int):
    """The router's f32 probabilities (G, Tg, E), the renormalized top-k
    weights (G, Tg, k), each (token, choice)'s expert (G, Tg*k) in that
    order, its one-hot (G, Tg*k, E) int32 and its slot within its expert
    (G, Tg*k), counted from 0 in (token, choice) order."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = (x.reshape(g * tg, x.shape[-1]) @ p["router"]).float()
    probs = torch.softmax(logits.reshape(g, tg, e), dim=-1)
    top_w, top_e = top_k(probs, k)                                # (G,Tg,k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = top_e.reshape(g, tg * k)                             # (G,TK)
    oh = torch.zeros((g, tg * k, e), dtype=torch.int32, device=x.device)
    oh.scatter_(2, e_flat[..., None], 1)
    pos = (oh.cumsum(1) - 1).gather(2, e_flat[..., None])[..., 0]  # (G,TK)
    return probs, top_w, e_flat, oh, pos


@torch.no_grad()
def dropped_choices(p, x: torch.Tensor, cfg: ModelConfig,
                    num_groups: int = 1) -> torch.Tensor:
    """How many (token, choice) pairs ``moe_ffn(p, x, cfg, num_groups)``
    drops past their expert's capacity: an int64 scalar on x's device."""
    g, tg, c = _groups(x, cfg, num_groups)
    return (_route(p, x, cfg, g, tg)[-1] >= c).sum()


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, num_groups: int = 1):
    """x: (B, S, D) -> (y (B, S, D), aux loss f32 scalar).  ``p`` holds
    ``router``, ``w_gate``, ``w_up``, ``w_down`` and, with
    ``moe_dense_ff``, the ``dense`` MLP.  ``num_groups`` must divide B*S
    (else one group)."""
    bsz, s, d = x.shape
    g, tg, c = _groups(x, cfg, num_groups)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dtype, dev = x.dtype, x.device

    xt = x.reshape(g, tg, d)
    # ---- slot of each (token, choice) within its expert, in that order
    probs, top_w, e_flat, oh, pos = _route(p, x, cfg, g, tg)
    # aux (Switch): E * mean_e(fraction of choices * mean probability)
    ce = oh.reshape(g, tg, k, e).sum(2).float().mean(1)           # (G,E)
    aux = e * (probs.mean(1) * ce).sum(-1).mean()
    pos_c = torch.where(pos < c, pos, c)     # dropped -> the spare column

    # ---- (E, C) gather table; sentinel tg points at a zero pad row
    slot = e_flat * (c + 1) + pos_c                               # (G,TK)
    tok = torch.arange(tg, device=dev).repeat_interleave(k).expand(g, -1)
    idx = torch.full((g, e * (c + 1)), tg, dtype=torch.int64, device=dev)
    idx.scatter_(1, slot, tok)
    wts = torch.zeros((g, e * (c + 1)), dtype=torch.float32, device=dev)
    wts.scatter_(1, slot, top_w.reshape(g, tg * k))
    idx = idx.reshape(g, e, c + 1)[:, :, :c]                      # (G,E,C)
    wts = wts.reshape(g, e, c + 1)[:, :, :c]

    # rows of the padded (G * (tg + 1), D) token matrix
    rows = idx + (torch.arange(g, device=dev) * (tg + 1))[:, None, None]
    rows = rows.permute(1, 0, 2).reshape(e, g * c)                # (E,G*C)
    xt_pad = torch.cat([xt, x.new_zeros((g, 1, d))], 1).reshape(-1, d)
    gathered = xt_pad[rows]                                       # (E,G*C,D)

    # ---- expert FFN over every expert's slots
    y_exp = swiglu(gathered, p["w_gate"], p["w_up"], p["w_down"])  # (E,G*C,D)
    w_rows = wts.permute(1, 0, 2).reshape(e, g * c, 1).to(dtype)
    y_exp = y_exp * w_rows

    # ---- combine: scatter-add back to token order, pad rows dropped
    out = x.new_zeros((g * (tg + 1), d))
    out.index_add_(0, rows.reshape(-1), y_exp.reshape(-1, d))
    y = out.reshape(g, tg + 1, d)[:, :tg].reshape(bsz, s, d)

    if cfg.moe_dense_ff:
        if cfg.mlp_kind != "swiglu":
            raise ValueError(f"dense FFN kind {cfg.mlp_kind!r}")
        dn = p["dense"]
        y = y + swiglu(x, dn["w_gate"], dn["w_up"], dn["w_down"])
    return y, aux
