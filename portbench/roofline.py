"""The yardstick: the H100's published peaks and the operations and bytes
that a kernel launch or a model step needs on its inputs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s
of HBM.  A launch's bound is the larger of its bytes over the bandwidth and
its operations over the peak; a multiply-add is two operations.  Counts
follow the inputs: the keys each query or lane can see (causal pairs,
window, ring slots that hold a position), each input byte read once and
each output byte written once.  ``bound`` and ``train_flops`` are
``chip_smoke.py``'s arithmetic, restated on the configuration's sizes.
"""
from __future__ import annotations

from typing import Dict

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS
            ) -> float:
    """The least seconds a launch can take."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def attention_work(pairs: float, q_rows: float, kv_rows: float, hq: int,
                   hkv: int, d: int, elt: int = 2) -> Dict[str, float]:
    """A forward attention launch: ``pairs`` visible (query, key)
    positions, each 4 d operations a query head (QK^T and PV); bytes of
    ``q_rows`` query rows read and written and ``kv_rows`` key and value
    rows read."""
    return {"flops": 4.0 * d * hq * pairs,
            "bytes": float(elt * d * (2 * hq * q_rows + 2 * hkv * kv_rows))}


def attention_bwd_work(pairs: float, q_rows: float, kv_rows: float, hq: int,
                       hkv: int, d: int, elt: int = 2) -> Dict[str, float]:
    """The flash backward of the same launch: QK^T recomputed, dV, dP,
    dQ and dK (10 d operations a pair and query head); q, o, dO read and
    dQ written a query row, k, v read and dK, dV written a key row."""
    return {"flops": 10.0 * d * hq * pairs,
            "bytes": float(elt * d * (4 * hq * q_rows + 4 * hkv * kv_rows))}


def norm_work(rows: float, width: int, reads: int, writes: int,
              elt: int = 2) -> Dict[str, float]:
    """A norm form over ``rows`` rows: ``reads`` row-sized inputs and
    ``writes`` outputs (the gain's bytes are negligible); a handful of
    operations an element, never the bound."""
    return {"flops": 4.0 * rows * width,
            "bytes": float(elt * rows * width * (reads + writes))}


def causal_pairs(s: int, window: int = 0) -> int:
    """Visible (query, key) pairs of a causal prompt of ``s`` tokens with
    positions 0..s-1 (a key j visible from i when i - window < j <= i)."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def dense_params(c: dict) -> Dict[str, int]:
    """Weights a token multiplies, by kind: ``attn`` (q, k, v, o), ``mlp``
    (a dense MLP, or the active experts' share and the router), ``head``
    (the logits projection) per layer or model."""
    d, h, hkv = c["d_model"], c["num_heads"], c["num_kv_heads"]
    hd = c.get("head_dim") or d // h
    attn = d * hd * (2 * h + 2 * hkv)
    f = c["d_ff"]
    if c.get("num_experts"):
        mlp = c["num_experts_per_tok"] * 3 * d * f + d * c["num_experts"]
    else:
        mlp = 3 * d * f
    return {"attn": attn, "mlp": mlp, "head": d * c["vocab_size"]}


def token_flops(c: dict, position: int, logits: bool) -> float:
    """Model operations of one token at ``position`` in a forward pass:
    2 per weight it multiplies (an MoE's active experts only) and, a layer,
    4 d per query head and visible key; the head's when ``logits``."""
    p = dense_params(c)
    hd = c.get("head_dim") or c["d_model"] // c["num_heads"]
    w = c.get("sliding_window") or 0
    keys = min(position + 1, w) if w else position + 1
    per_layer = 2 * (p["attn"] + p["mlp"]) + 4 * hd * c["num_heads"] * keys
    return c["num_layers"] * per_layer + (2 * p["head"] if logits else 0)


def span_flops(c: dict, start: int, stop: int, logits: int) -> float:
    """Model operations of the tokens at positions [start, stop) in one
    forward pass, ``logits`` of them through the head."""
    n = stop - start
    if n <= 0:
        return 0.0
    p = dense_params(c)
    hd = c.get("head_dim") or c["d_model"] // c["num_heads"]
    w = c.get("sliding_window") or 0
    if w:
        keys = sum(min(i + 1, w) for i in range(start, stop))
    else:
        keys = (stop * (stop + 1) - start * (start + 1)) // 2
    return (c["num_layers"] * (2 * (p["attn"] + p["mlp"]) * n
                               + 4 * hd * c["num_heads"] * keys)
            + 2 * p["head"] * logits)


def train_flops(c: dict, batch: int, seq: int) -> float:
    """Model operations of one train step (``chip_smoke.train_flops`` on a
    dense stack): 6 per weight per token over every projection and the
    head, and 6 S D per query head and layer per token for causal
    attention's two products (S at most the window); remat's recompute not
    counted."""
    p = dense_params(c)
    if c.get("num_experts"):
        raise ValueError("train_flops counts dense stacks only")
    hd = c.get("head_dim") or c["d_model"] // c["num_heads"]
    w = c.get("sliding_window") or 0
    span = min(seq, w) if w else seq
    mats = c["num_layers"] * (p["attn"] + p["mlp"])
    attn = c["num_layers"] * c["num_heads"] * 6 * span * hd
    return batch * seq * (6 * (mats + p["head"]) + attn)
