"""Sharding specs: logical layout rules -> partition specs (the port's copy
of ``repro.sharding.specs``).

Layout (single-pod mesh ("data","model"); multi-pod adds a leading "pod"
axis folded into the FSDP/data group):

  * TP ("model")   : attention heads, FFN hidden, experts (EP), vocab
  * FSDP ("data"+"pod") : the non-TP dim of every large parameter
    (ZeRO-3-style gather-on-use: ``sharding.placement``)
  * batch          : ("pod","data") on the leading batch dim of activations
  * sequence       : KV/SSM caches shard sequence over "data" when
    batch < data ways (long_500k decode)

A spec is a plain tuple with one entry per tensor dim: an axis name,
``None`` (replicated) or a tuple of names (the dim split over several
axes, the first outermost), the reference's ``PartitionSpec`` without JAX.
``placements(mesh, spec)`` turns one into a DTensor's placements.  Every
function takes any mesh object with ``axis_names`` and a ``shape``: a dict
of sizes by axis (the port's ``sharding.mesh.Mesh``, a test's fake mesh) or
a tuple in axis order (a ``torch.distributed`` ``DeviceMesh``).

The rules match the reference's parameter-tree paths.  The port names a
parameter per layer (``layers.3.attn.wq``, ``final_norm``); the reference
stacks the layers of each period slot (``periods/<slot>/attn/wq`` with a
leading ``num_periods`` dim) and names the leaves of its norms ``scale``.
``ref_path`` maps the one to the other, and a per-layer leaf gets the
reference's spec less the stacking dim.  Optimizer state (``opt/mu``,
``opt/nu``, ``opt/master``) and error-feedback residuals (``ef``) inherit
the spec of their parameter.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.common.config import ModelConfig, ParallelConfig, ShapeConfig

Spec = Tuple[Any, ...]


def P(*entries) -> Spec:
    """A spec: one entry per dim (``PartitionSpec``'s spelling)."""
    return tuple(entries)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Each axis's size by name, from a dict ``shape`` or a tuple one."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), tuple(shape)))


def fsdp_axes(mesh, pc: ParallelConfig):
    """Axes that shard the non-TP param dim (ZeRO/FSDP group)."""
    if not pc.fsdp_params:
        return None
    axes = [a for a in ("pod", "data") if a in axis_names(mesh)]
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def batch_axes(mesh):
    axes = [a for a in ("pod", "data") if a in axis_names(mesh)]
    return tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)


def _data_ways(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


# --------------------------------------------------------------- param rules
# (regex on the '/'-joined reference path) -> list of candidate specs in
# priority order; the first whose every dim divides the leaf shape wins
# (e.g. MoE: expert-parallel when num_experts % tp == 0, else
# tensor-parallel WITHIN each expert — mixtral's 8 experts on a 16-way
# model axis).
def _param_rules(fsdp):
    M = "model"
    return [
        # embeddings / heads — vocab-parallel, D replicated (Megatron-style)
        (r"embed/table$",        lambda: [P(M, None)]),
        (r"head/w$",             lambda: [P(None, M), P(fsdp, M)]),
        # attention
        (r"attn/wq$",            lambda: [P(fsdp, M, None)]),
        (r"attn/wk$",            lambda: [P(fsdp, M, None)]),
        (r"attn/wv$",            lambda: [P(fsdp, M, None)]),
        (r"attn/wo$",            lambda: [P(M, None, fsdp)]),
        (r"attn/(q_norm|k_norm)/scale$", lambda: [P(None)]),
        # dense mlp (and arctic's dense-residual path)
        (r"(mlp|dense)/w_(up|gate)$",  lambda: [P(fsdp, M)]),
        (r"(mlp|dense)/w_down$",       lambda: [P(M, fsdp)]),
        # moe: EP first, expert-internal TP as fallback
        (r"moe/router$",         lambda: [P(fsdp, None)]),
        (r"moe/w_(up|gate)$",    lambda: [P(M, fsdp, None), P(None, fsdp, M)]),
        (r"moe/w_down$",         lambda: [P(M, None, fsdp), P(None, M, fsdp)]),
        # mamba2 ssd
        (r"ssm/in_proj$",        lambda: [P(fsdp, M)]),
        (r"ssm/conv_w$",         lambda: [P(None, M)]),
        (r"ssm/conv_b$",         lambda: [P(M)]),
        (r"ssm/(dt_bias|a_log|d_skip)$", lambda: [P(None)]),
        (r"ssm/norm/scale$",     lambda: [P(M)]),
        (r"ssm/out_proj$",       lambda: [P(M, fsdp)]),
        # rg-lru
        (r"rec/w_(x|y)$",        lambda: [P(fsdp, M)]),
        (r"rec/conv_w$",         lambda: [P(None, M)]),
        (r"rec/conv_b$",         lambda: [P(M)]),
        (r"rec/w_(a|i)$",        lambda: [P(None, M)]),
        (r"rec/(b_a|b_i|lam)$",  lambda: [P(M)]),
        (r"rec/w_out$",          lambda: [P(M, fsdp)]),
        # norms
        (r"norm\d?/scale$",      lambda: [P(None)]),
        (r"final_norm/scale$",   lambda: [P(None)]),
    ]


# the port's leaves whose reference leaf is a dict with one array under
# another name
_LEAF_NAMES = {"embed": "embed/table", "head": "head/w",
               "final_norm": "final_norm/scale"}
_SCALE_LEAVES = re.compile(r"(norm1|norm2|q_norm|k_norm|ssm/norm)$")
_STATE_PREFIX = re.compile(r"^(params/|ef/|(opt/)?(mu|nu|master)/)")


def ref_path(name: str) -> str:
    """The reference's path (less its period stacking) of the port's
    parameter ``name`` (``layers.3.attn.q_norm`` ->
    ``layers/3/attn/q_norm/scale``); a train-state path's prefix
    (``params/``, ``opt/mu/``, ``opt/nu/``, ``opt/master/``, ``ef/``) is
    dropped."""
    name = _STATE_PREFIX.sub("", name)
    if name in _LEAF_NAMES:
        return _LEAF_NAMES[name]
    path = name.replace(".", "/")
    return path + "/scale" if _SCALE_LEAVES.search(path) else path


def _ways(entry, mesh) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def sanitize(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop sharding on dims the mesh cannot divide evenly.

    E.g. 8 kv-heads on a 16-way model axis -> replicate the kv projections
    (Megatron-style KV duplication for GQA when tp > kv_heads); batch=1
    (long_500k) -> replicate batch.  Every layout decision stays in one
    place instead of per-call hacks."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        out.append(entry if dim % _ways(entry, mesh) == 0 else None)
    return P(*out)


def _divisible(spec: Spec, shape: Tuple[int, ...], mesh) -> bool:
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return all(dim % _ways(e, mesh) == 0 for dim, e in zip(shape, entries))


def spec_for_param_path(path: str, rank_or_shape, mesh,
                        pc: ParallelConfig) -> Spec:
    """Spec of one parameter leaf, by the port's name (or a train-state
    path, ``ref_path``).  When a shape is given, candidate specs are tried
    in priority order and the first fully-divisible one wins; the final
    fallback is the sanitized first candidate."""
    shape = None if isinstance(rank_or_shape, int) else tuple(rank_or_shape)
    rank = rank_or_shape if shape is None else len(shape)
    fsdp = fsdp_axes(mesh, pc)
    clean = ref_path(path)
    for pattern, maker in _param_rules(fsdp):
        if re.search(pattern, clean):
            cands = maker()
            out = None
            for spec in cands:
                pad = rank - len(spec)
                if pad > 0:
                    spec = P(*([None] * pad + list(spec)))
                if out is None:
                    out = spec             # default: first candidate
                if shape is not None and _divisible(spec, shape, mesh):
                    return spec
            return out if shape is None else sanitize(out, shape, mesh)
    return P(*([None] * rank))      # scalars / small leftovers: replicate


def state_specs(state_shapes, mesh, pc: ParallelConfig):
    """Spec tree matching a train-state tree (leaves with a ``shape``:
    tensors, meta tensors, numpy arrays), e.g. ``steps.checkpoint_tree``'s
    ``{"params", "opt": {"mu", "nu"[, "master"], "step"}[, "ef"]}``."""
    from repro_torch.common.tree import tree_paths, unflatten

    return unflatten({p: spec_for_param_path(p, tuple(x.shape), mesh, pc)
                      for p, x in tree_paths(state_shapes)})


# ------------------------------------------------------------- batch specs
def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                pc: ParallelConfig) -> Dict[str, Spec]:
    """Input specs for a train/prefill batch."""
    b_ax = batch_axes(mesh)
    ways = _data_ways(mesh)
    bdim = b_ax if shape.global_batch % max(ways, 1) == 0 and ways > 1 else None
    specs = {
        "tokens": P(bdim, None) if cfg.family != "audio" else P(bdim, None, None),
        "labels": P(bdim, None),
        "mask": P(bdim, None),
    }
    if cfg.family == "vlm":
        specs["enc"] = P(bdim, None, None)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                pc: ParallelConfig) -> List[Dict[str, Spec]]:
    """Specs of the decode cache (``model.init_cache``: one dict a layer),
    from its shapes on the ``meta`` device.

    batch >= data ways  -> shard batch over ("pod","data")
    batch  < data ways  -> sequence-parallel cache: shard the KV sequence
    dim over "data" (long_500k), batch replicated.  Recurrent states (SSM /
    RG-LRU) have no sequence dim: they shard heads/width over "model" and
    batch where possible."""
    from repro_torch.models import model as model_lib

    b_ax = batch_axes(mesh)
    ways = _data_ways(mesh)
    batch_sharded = shape.global_batch % max(ways, 1) == 0 and ways > 1
    bdim = b_ax if batch_sharded else None
    seq_ax = None if batch_sharded or not pc.seq_shard_cache else "data"

    cache = model_lib.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta")

    def spec_one(name: str, rank: int) -> Spec:
        if name == "pos":
            return P(*([None] * rank))
        if name in ("k", "v"):
            # (B, S, Hkv, hd).  Batch-sharded decode shards the SEQUENCE
            # over "model" (flash-decode split-S): kv heads rarely divide
            # tp=16, and contracting over a model-sharded S costs only a
            # (B,H,1) partial-softmax reduction instead of gathering the
            # multi-GB cache.
            if batch_sharded:
                return P(bdim, "model", None, None)
            return P(bdim, seq_ax, "model", None)
        if name == "state":                # SSD state (B, H, N, P)
            return P(bdim, "model", None, None)
        if name == "conv":                 # conv tail (B, W-1, C)
            return P(bdim, None, "model")
        if name == "h":                    # RG-LRU state (B, W)
            return P(bdim, "model")
        return P(*([None] * rank))

    return [{name: sanitize(spec_one(name, t.dim()), tuple(t.shape), mesh)
             for name, t in layer.items()} for layer in cache]


def logits_spec(mesh, shape: ShapeConfig,
                cfg: Optional[ModelConfig] = None) -> Spec:
    b_ax = batch_axes(mesh)
    ways = _data_ways(mesh)
    bdim = b_ax if shape.global_batch % max(ways, 1) == 0 and ways > 1 else None
    spec = P(bdim, None, "model")
    if cfg is not None:
        seq = 1 if shape.is_decode else shape.seq_len
        spec = sanitize(spec, (shape.global_batch, seq, cfg.vocab_size), mesh)
        if spec == P(bdim, None, None) and \
                seq % axis_sizes(mesh)["model"] == 0 and seq > 1:
            # vocab can't shard evenly (mamba2/minicpm): emit logits
            # SEQUENCE-sharded instead of replicated — turns a full
            # (B,S,V) all-gather into a 1/tp-sized all-to-all
            spec = P(bdim, "model", None)
    return spec


# ---------------------------------------------------------------- placements
def placements(mesh, spec: Spec) -> list:
    """A DTensor's placements for ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that splits tensor dim d, ``Replicate()`` on the others.  A
    tensor dim split over several axes (``("pod", "data")``) is split in
    that order, outermost first, as DTensor splits a dim named on several
    mesh dims in mesh order; so those axes must stand in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(dim)
    return out
