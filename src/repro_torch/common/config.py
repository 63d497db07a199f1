"""Model configuration (the port's copy of ``repro.common.config``).

A single ``ModelConfig`` describes every architecture family.  Fields,
properties and the per-layer pattern helpers are those of the JAX package;
only the dtypes differ: ``torch.bfloat16``/``torch.float32`` stand where the
reference pins ``jnp`` dtypes.

Weights are *stored* in ``dtype``.  The JAX package keeps float32 masters
and casts them to ``dtype`` at every use, so storing the cast values gives
the same numbers at half the memory.  Norm gains are the one exception: the
reference reads them in float32 (``(1 + scale)`` in f32), so the port keeps
them in float32 too.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

# Block kinds ----------------------------------------------------------------
ATTN = "attn"          # self attention (global or local decided by attn_pattern)
SSM = "ssm"            # Mamba2 SSD mixer
RGLRU = "rglru"        # RG-LRU recurrent block (Griffin)
CROSS = "cross"        # cross-attention to encoder/stub embeddings (VLM)

GLOBAL = "global"
LOCAL = "local"


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  One instance per arch."""

    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # -- attention ------------------------------------------------------
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    local_rope_theta: float = 0.0     # 0 -> use rope_theta for local layers too
    sliding_window: int = 0           # >0: width of local/SWA attention
    attn_pattern: Tuple[str, ...] = (GLOBAL,)   # cycled per *attention* layer
    logit_softcap: float = 0.0        # 0 -> disabled
    attn_scale: float = 0.0           # 0 -> 1/sqrt(head_dim)

    # -- block layout ---------------------------------------------------
    block_pattern: Tuple[str, ...] = (ATTN,)    # cycled per layer
    num_image_tokens: int = 0
    num_codebooks: int = 0

    # -- mlp / moe ------------------------------------------------------
    mlp_kind: str = "swiglu"          # swiglu|geglu|gelu
    num_experts: int = 0              # 0 -> dense mlp
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_dense_ff: int = 0

    # -- ssm (mamba2 / SSD) ---------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4

    # -- rg-lru ----------------------------------------------------------
    rglru_c: float = 8.0
    rglru_expand: int = 0

    # -- misc -------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    max_seq_len: int = 8192
    dtype: Any = torch.bfloat16        # activation/compute and weight storage dtype
    param_dtype: Any = torch.float32   # the reference's master dtype (norm gains)
    remat: bool = True
    scan_layers: bool = True

    # ---------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def rglru_width(self) -> int:
        return self.rglru_expand or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Block kind for every layer (len == num_layers)."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def attn_kinds(self) -> Tuple[str, ...]:
        """global/local label for every layer.  The attention pattern
        advances only on attention layers (gemma3: 5 local then 1 global)."""
        out = []
        ai = 0
        for k in self.layer_kinds():
            if k in (ATTN, CROSS):
                out.append(self.attn_pattern[ai % len(self.attn_pattern)])
                ai += 1
            else:
                out.append(GLOBAL)
        return tuple(out)

    @property
    def pattern_period(self) -> int:
        """Length of the repeating (block, attn) pattern."""
        a, b = len(self.block_pattern), len(self.attn_pattern)
        return a * b // math.gcd(a, b)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.pattern_period

    @property
    def num_tail_layers(self) -> int:
        return self.num_layers - self.num_periods * self.pattern_period

    def period_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """(block_kind, attn_kind) for one pattern period."""
        ks, aks = self.layer_kinds(), self.attn_kinds()
        p = self.pattern_period
        return tuple(zip(ks[:p], aks[:p]))

    def tail_kinds(self) -> Tuple[Tuple[str, str], ...]:
        ks, aks = self.layer_kinds(), self.attn_kinds()
        start = self.num_periods * self.pattern_period
        return tuple(zip(ks[start:], aks[start:]))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: num_heads not a multiple of "
                             "num_kv_heads")
        if self.num_experts and not (
                0 < self.num_experts_per_tok <= self.num_experts):
            raise ValueError(f"{self.name}: bad num_experts_per_tok")
        for k in self.layer_kinds():
            if k not in (ATTN, SSM, RGLRU, CROSS):
                raise ValueError(f"{self.name}: unknown block kind {k!r}")

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        from repro_torch.models import model as _m
        return _m.count_params(self)
