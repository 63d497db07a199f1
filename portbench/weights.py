"""Weights drawn from the seed, the same for the program and the reference.

A model's leaves fall in groups: ``embed`` (the table, the final norm's
gain and an untied head) and one group a layer.  Each group has a
``torch.Generator`` of its own, seeded from (seed, group), and draws its
leaves in a fixed order straight into tensors of the type they are served
in (bf16 projections, f32 norm gains), one ``normal_`` a leaf on the
device.  So the benchmark fills the program's tensors in place at set-up,
and the reference draws one group again, alone, when it needs that layer.

Leaves and their layouts are the benchmark's own, named as below; the
projections are (inputs, outputs) matrices.  Standard deviations:
1/sqrt(d_model) for the embedding table (the model scales a row by
sqrt(d_model): the embedding enters the residual stream at unit size),
1/sqrt(fan-in) for a projection (the inputs of ``wo`` are all its heads'
values) and ``RESIDUAL_GAIN`` times that for the two that write the
residual stream (``wo``, ``w_down``), 0.1 for a norm gain, which the
model reads as (1 + gain).  So the layers' outputs, not the input token,
decide the logits: with the embedding as large as the layers' sum, a tied
head mostly repeats the last token, whatever the layers compute.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str, float]   # name, shape, dtype, std

GAIN_STD = 0.1
# the layers' outputs into the residual stream (``wo``, ``w_down``) drawn
# this many times 1/sqrt(fan-in): after a few layers the embedding is a
# small part of the stream, as in trained models
RESIDUAL_GAIN = 4.0


def head_dim(c: dict) -> int:
    return c.get("head_dim") or c["d_model"] // c["num_heads"]


def embed_leaves(c: dict) -> List[Leaf]:
    d, v = c["d_model"], c["vocab_size"]
    out = [("embed", (v, d), "bf16", d ** -0.5),
           ("final_norm", (d,), "f32", GAIN_STD)]
    if not c.get("tie_embeddings", True):
        out.append(("head", (d, v), "bf16", d ** -0.5))
    return out


def layer_leaves(c: dict) -> List[Leaf]:
    d, h, hkv, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], \
        head_dim(c)
    f = c["d_ff"]
    out: List[Leaf] = [
        ("norm1", (d,), "f32", GAIN_STD),
        ("wq", (d, h * hd), "bf16", d ** -0.5),
        ("wk", (d, hkv * hd), "bf16", d ** -0.5),
        ("wv", (d, hkv * hd), "bf16", d ** -0.5),
        ("wo", (h * hd, d), "bf16", RESIDUAL_GAIN * (h * hd) ** -0.5),
    ]
    if c.get("use_qk_norm"):
        out += [("q_norm", (hd,), "f32", GAIN_STD),
                ("k_norm", (hd,), "f32", GAIN_STD)]
    out.append(("norm2", (d,), "f32", GAIN_STD))
    e = c.get("num_experts", 0)
    if e:
        out += [("router", (d, e), "bf16", d ** -0.5),
                ("w_gate", (e, d, f), "bf16", d ** -0.5),
                ("w_up", (e, d, f), "bf16", d ** -0.5),
                ("w_down", (e, f, d), "bf16", RESIDUAL_GAIN * f ** -0.5)]
    else:
        out += [("w_gate", (d, f), "bf16", d ** -0.5),
                ("w_up", (d, f), "bf16", d ** -0.5),
                ("w_down", (f, d), "bf16", RESIDUAL_GAIN * f ** -0.5)]
    return out


def groups(c: dict) -> List[Tuple[str, List[Leaf]]]:
    """Every group in drawing order: ``embed``, then ``layer<i>``."""
    return [("embed", embed_leaves(c))] + [
        (f"layer{i}", layer_leaves(c)) for i in range(c["num_layers"])]


def group_seed(seed: int, group: str) -> int:
    """A 63-bit generator seed from the run's seed and the group's name."""
    digest = hashlib.sha256(f"{int(seed)}:{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def fill_group(seed: int, group: str, leaves: List[Leaf],
               targets: Dict[str, torch.Tensor]) -> None:
    """Draw ``group``'s leaves into ``targets`` (each a contiguous tensor of
    the leaf's size and type, in any shape), in order, in place."""
    dev = next(iter(targets.values())).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(group_seed(seed, group))
    for name, shape, _, std in leaves:
        t = targets[name]
        if t.numel() != math.prod(shape) or not t.is_contiguous():
            raise ValueError(f"{group}.{name}: target {tuple(t.shape)} is "
                             f"not a contiguous {shape}")
        t.normal_(0.0, std, generator=gen)


def draw_group(seed: int, group: str, leaves: List[Leaf], device,
               dtype=None) -> Dict[str, torch.Tensor]:
    """``group``'s leaves as new tensors in their own shapes, drawn as
    ``fill_group`` draws them; with ``dtype`` cast to it afterwards (the
    reference's float32 copy of the served values)."""
    out = {name: torch.empty(shape, device=device, dtype=torch.bfloat16
                             if kind == "bf16" else torch.float32)
           for name, shape, kind, _ in leaves}
    fill_group(seed, group, leaves, out)
    if dtype is not None:
        out = {k: v.to(dtype) for k, v in out.items()}
    return out
