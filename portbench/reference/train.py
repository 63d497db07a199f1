"""The plain reference of the training cell: the first train steps of a
dense decoder in float32 from the seed's weights, as the configuration
states them.

Each step: the next-token cross-entropy over the batch (the logits at
positions 0..S-2 against the tokens at 1..S-1, the mean over every row
and position), its gradient by autograd (each layer recomputed in the
backward, which changes no number), the global gradient norm over every
leaf, each gradient scaled by min(1, clip / norm), then AdamW in float32:
mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, p -= lr ((mu / c1) /
(sqrt(nu / c2) + eps) + wd p) with c1 = 1 - b1^t, c2 = 1 - b2^t, weight
decay on every leaf and the configuration's learning rate from the first
step (a constant schedule after a one-step warm-up).

``quant="fp8"`` computes every projection's products in fp8 (e4m3
forward, the gradients in e5m2): the control.  ``rows`` keeps only
the first rows of each batch (a planted fault).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import weights as W
from portbench.reference import transformer as T

BETAS = (0.9, 0.95)
EPS = 1e-8


def _layer(c, w, x, quant):
    """One layer over a batch of sequences (B, S, d)."""
    return torch.stack([T.layer(c, w, xi, quant) for xi in x])


def loss(c: Dict, params: Dict, tokens: torch.Tensor,
         quant: Optional[str] = None) -> torch.Tensor:
    g = params["embed"]
    x = T.embed(c, g["embed"], tokens)
    for i in range(c["num_layers"]):
        x = checkpoint(_layer, c, params[f"layer{i}"], x, quant,
                       use_reentrant=False)
    logits = T.head(c, g, x, quant)
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                           tokens[:, 1:].reshape(-1).long())


def train_steps(c: Dict, t: Dict, seed: int, batches: List[torch.Tensor],
                device, quant: Optional[str] = None,
                rows: Optional[int] = None) -> Dict:
    """Losses of each step, each leaf's first gradient norm as AdamW gets
    it (after clipping), and each leaf's change over the steps, keyed
    ``<group>.<leaf>``."""
    groups = W.groups(c)
    b1, b2 = BETAS
    params = {name: {k: v.requires_grad_(True) for k, v in W.draw_group(
        seed, name, leaves, device, torch.float32).items()}
        for name, leaves in groups}
    keys = [(g, k) for g, d in params.items() for k in d]
    mu = {gk: torch.zeros_like(params[gk[0]][gk[1]]) for gk in keys}
    nu = {gk: torch.zeros_like(params[gk[0]][gk[1]]) for gk in keys}
    out: Dict = {"loss": [], "grad_norm": {}, "change": {}}
    lr, wd, clip = t["learning_rate"], t["weight_decay"], t["grad_clip"]
    with T.exact_f32():
        for step, tokens in enumerate(batches, start=1):
            tokens = tokens.to(device)[:rows]
            value = loss(c, params, tokens, quant)
            value.backward()
            out["loss"].append(float(value.detach()))
            norm = torch.stack([params[g][k].grad.square().sum()
                                for g, k in keys]).sum().sqrt()
            scale = torch.clamp_max(clip / torch.clamp_min(norm, 1e-12), 1.0)
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            with torch.no_grad():
                for gk in keys:
                    p = params[gk[0]][gk[1]]
                    grad = p.grad.mul_(scale)
                    if step == 1:
                        out["grad_norm"][".".join(gk)] = float(grad.norm())
                    mu[gk].mul_(b1).add_(grad, alpha=1 - b1)
                    nu[gk].mul_(b2).addcmul_(grad, grad, value=1 - b2)
                    p.grad = None
                    delta = (mu[gk] / c1) / ((nu[gk] / c2).sqrt() + EPS)
                    p.sub_(delta.add_(p * wd).mul_(lr))
        with torch.no_grad():
            for name, lv in groups:
                init = W.draw_group(seed, name, lv, device, torch.float32)
                for k, v in init.items():
                    out["change"][f"{name}.{k}"] = float(
                        (params[name][k] - v).norm())
    return out
