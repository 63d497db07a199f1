"""The plain reference of the decoder stacks the benchmark serves and
trains (qwen3-4b, mixtral-8x22b at their configurations' sizes).

Float32 PyTorch, TF32 off, layer by layer, with no kernel, cache or
batching: the weights of one layer are drawn again from the seed
(``weights.draw_group``), applied to every sequence, and dropped.  The
equations are those the configuration file states:

- ``x = embed[tokens] * sqrt(d_model)``;
- each layer: ``h = rmsnorm(x) * (1 + norm1)``; q, k, v projections of h;
  with ``use_qk_norm`` each head's q and k normed over ``head_dim`` with
  gains (1 + q_norm), (1 + k_norm); rotary embedding (rotate-half,
  ``rope_theta``) on q and k; causal softmax attention, a key at position
  j visible from position i when ``i - window < j <= i`` (``sliding_window``;
  0 is no window), scale 1/sqrt(head_dim), grouped-query heads; ``x += o
  @ wo``; ``h = rmsnorm(x) * (1 + norm2)``; a SwiGLU MLP ``(silu(h @
  w_gate) * (h @ w_up)) @ w_down``, or with ``num_experts`` the router's
  softmax in float32, its ``num_experts_per_tok`` largest weights
  renormalized to sum 1, and those experts' SwiGLUs summed with them, no
  token dropped; ``x +=`` the MLP's output;
- logits ``rmsnorm(x) * (1 + final_norm)`` times ``embed^T / sqrt(d_model)``
  (tied) or ``@ head``.

``quant="fp8"`` computes every projection (and the head) in fp8 with
float32 accumulation, as per-tensor fp8 recipes do: weights and inputs in
e4m3, each scaled by one factor for the tensor (its largest magnitude to
the type's largest value), and under autograd the incoming gradient of
each product in e5m2: the control of the cells' comparisons.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench import weights as W

QUERY_BLOCK = 1024
F8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """Float32 products in float32: TF32 off for the duration."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def _f8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to an fp8 type with one scale for the tensor (its amax to
    the type's largest value), returned in float32."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp_min(1e-12) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _F8Matmul(torch.autograd.Function):
    """fp8 training's products: e4m3 operands forward, and backward the
    incoming gradient in e5m2 against the e4m3 operands."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _f8(x), _f8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _f8(g, torch.float8_e5m2)
        dx = gq @ wq.T
        dw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    """x (..., n) @ w (n, m) in float32, or in fp8 (``quant="fp8"``)."""
    if quant is None:
        return x @ w
    if quant != "fp8":
        raise ValueError(quant)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _F8Matmul.apply(x, w)
    return _f8(x) @ _f8(w)


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + gain)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotate-half rotary embedding of x (S, H, D) at ``positions`` (S,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = positions.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, window: int):
    """Causal grouped-query attention of one sequence: q (S, H, D), k and
    v (S, Hkv, D), in blocks of queries."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)        # (H, S, D)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    j = torch.arange(s, device=q.device)
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, s)
        i = j[lo:hi, None]
        vis = j[None, :] <= i
        if window:
            vis &= j[None, :] > i - window
        sc = torch.einsum("qhd,hkd->hqk", q[lo:hi], k) * d ** -0.5
        sc = sc.masked_fill(~vis[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,hkd->qhd", torch.softmax(sc, -1), v)
    return out


def swiglu(h, w_gate, w_up, w_down, quant):
    return matmul(F.silu(matmul(h, w_gate, quant)) * matmul(h, w_up, quant),
                  w_down, quant)


def moe(c: dict, w: Dict[str, torch.Tensor], h: torch.Tensor, quant):
    """The dropless mixture: every token's top-k experts, renormalized."""
    probs = torch.softmax(matmul(h, w["router"], quant), dim=-1)
    top_w, top_e = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(c["num_experts"]):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(h[tok], w["w_gate"][e], w["w_up"][e], w["w_down"][e],
                   quant)
        out.index_add_(0, tok, y * top_w[tok, slot, None])
    return out


def layer(c: dict, w: Dict[str, torch.Tensor], x: torch.Tensor,
          quant: Optional[str] = None) -> torch.Tensor:
    """One decoder layer over one sequence x (S, d), float32."""
    s, d = x.shape
    hq, hkv, hd = c["num_heads"], c["num_kv_heads"], W.head_dim(c)
    eps = c["norm_eps"]
    pos = torch.arange(s, device=x.device)
    h = rmsnorm(x, w["norm1"], eps)
    q = matmul(h, w["wq"], quant).view(s, hq, hd)
    k = matmul(h, w["wk"], quant).view(s, hkv, hd)
    v = matmul(h, w["wv"], quant).view(s, hkv, hd)
    if c.get("use_qk_norm"):
        q, k = rmsnorm(q, w["q_norm"], eps), rmsnorm(k, w["k_norm"], eps)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    o = attention(q, k, v, c.get("sliding_window", 0))
    x = x + matmul(o.reshape(s, hq * hd), w["wo"], quant)
    h = rmsnorm(x, w["norm2"], eps)
    if c.get("num_experts"):
        return x + moe(c, w, h, quant)
    return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"], quant)


def embed(c: dict, table: torch.Tensor, tokens: torch.Tensor):
    return table[tokens.long()] * math.sqrt(c["d_model"])


def head(c: dict, g: Dict[str, torch.Tensor], x: torch.Tensor,
         quant: Optional[str] = None) -> torch.Tensor:
    x = rmsnorm(x, g["final_norm"], c["norm_eps"])
    if "head" in g:
        return matmul(x, g["head"], quant)
    return matmul(x / math.sqrt(c["d_model"]), g["embed"].T, quant)


@torch.no_grad()
def logits_at(c: dict, seed: int, seqs: Sequence[torch.Tensor],
              at: Sequence[torch.Tensor], device,
              quant: Optional[str] = None) -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (S_i,) the logits (len(at[i]),
    V) at positions ``at[i]``: a full forward pass of each, layer by
    layer, with the layers' weights drawn from ``seed``."""
    groups = W.groups(c)
    with exact_f32():
        g = W.draw_group(seed, *groups[0], device, torch.float32)
        xs = [embed(c, g["embed"], t.to(device)) for t in seqs]
        del g
        for name, leaves in groups[1:]:
            w = W.draw_group(seed, name, leaves, device, torch.float32)
            xs = [layer(c, w, x, quant) for x in xs]
            del w
        g = W.draw_group(seed, *groups[0], device, torch.float32)
        return [head(c, g, x[p.to(device).long()], quant)
                for x, p in zip(xs, at)]
