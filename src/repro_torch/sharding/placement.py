"""The train state on a ``DeviceMesh``, and the compute around it: the work
GSPMD does for the reference from its sharding specs.

**State is stored as the specs say.**  ``place_state`` turns every leaf of
a train state (the parameters, the f32 masters, both moments, the step
and the error-feedback residuals) into a DTensor whose placements are its
spec's (``specs.placements``); a parameter stays a ``nn.Parameter`` of the
same ``Model``, now holding a DTensor.

**Compute is data-parallel; what a layer needs it gathers on use.**  Each
rank runs the model on its own rows of the batch (``batch_rows``).  The
model runs on a skeleton of itself on the ``meta`` device
(``GatheredModel``): before a block runs, its leaves are gathered to plain
local tensors over every mesh dim they are sharded on and installed in the
skeleton's block; they are freed after use, and under remat gathered
again when the block is recomputed in the backward (ZeRO-3's
gather-on-use, the reference's model at ``sharding/specs.py``).  The
embedding, the final norm and the head are gathered once a forward.  The
kernels see only those plain, contiguous, local tensors.

**Gradients go back to each leaf's placement** (the gather's backward,
``to_placement``): summed over the batch axes (a reduce-scatter on a mesh
dim that shards the leaf, an all-reduce where it is replicated) and sliced
over the other axes, where every rank computed the same gradient.
Ranks of the model axis therefore repeat their data group's compute:
splitting heads and FFN widths across it is later work.
"""
from __future__ import annotations

from contextlib import contextmanager
from functools import partial
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

from repro_torch.models import blocks as blk
from repro_torch.models import model as model_lib

BATCH_AXES = ("pod", "data")


# --------------------------------------------------------------- the state
def state_tree(state) -> dict:
    """The train state's leaves as a tree, by the paths the specs and the
    checkpoint use: ``params/<name>``, ``opt/{mu,nu,master}/<name>``,
    ``opt/step``, ``ef/<name>`` (no copies)."""
    o = state["opt"]
    tree = {"params": dict(state["model"].named_parameters()),
            "opt": {"mu": o["mu"], "nu": o["nu"], "master": o["master"],
                    "step": o["step"]}}
    if "ef" in state:
        tree["ef"] = state["ef"]
    return tree


def place_state(state, mesh, spec_fn: Callable[[str], tuple]):
    """Place every leaf of ``state`` (``steps.train_state``'s layout) on
    ``mesh`` by ``spec_fn(path)`` (paths of ``state_tree``), in place: the
    model's parameters become DTensor parameters, the optimizer's and the
    residuals' leaves DTensors.  Every rank passes the same state.  A leaf
    is let go once placed, so the state never needs twice its memory."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.specs import placements

    def put(path, t):
        return distribute_tensor(t.detach(), mesh,
                                 placements(mesh, spec_fn(path)))

    def put_all(prefix, leaves):
        placed = {}
        for k in list(leaves):
            placed[k] = put(f"{prefix}/{k}", leaves.pop(k))
        return placed

    model = state["model"]
    for name in [n for n, _ in model.named_parameters()]:
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = nn.Parameter(
            put(f"params/{name}", mod._parameters[leaf]), requires_grad=False)
    o = state["opt"]
    for part in ("mu", "nu", "master"):
        o[part] = put_all(f"opt/{part}", o[part])
    o["step"] = put("opt/step", o["step"].to(mesh.device_type))
    if "ef" in state:
        state["ef"] = put_all("ef", state["ef"])
    return state


def place_by_specs(state, mesh) -> Tuple[dict, Dict[str, tuple]]:
    """``state`` placed on ``mesh`` by the reference's specs
    (``specs.state_specs`` for ``mesh``'s ``ParallelConfig``), and the spec
    of every path, the map a restore places its leaves by
    (``ft.elastic.reshard_leaf``)."""
    from repro_torch.common.tree import tree_paths
    from repro_torch.launch.mesh import parallel_config_for
    from repro_torch.sharding import specs as sp

    spec_map = dict(tree_paths(sp.state_specs(
        state_tree(state), mesh, parallel_config_for(mesh))))
    return place_state(state, mesh, spec_map.__getitem__), spec_map


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the storage itself, no copy); a plain tensor
    as it is."""
    if hasattr(t, "to_local"):
        with torch.no_grad():
            return t.to_local()
    return t


# ------------------------------------------------------------- collectives
def _gather_dim(x, d: int, group, n: int):
    """``x`` concatenated along ``d`` over the ``n`` ranks of ``group``:
    one all-gather into a stacked buffer, and a copy to interleave it only
    where ``d`` is not the first dim of more than one rank's shards."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    out = out.view((n,) + tuple(x.shape))
    if n == 1:
        return out[0]
    if d == 0:
        return out.view((n * x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat(out.unbind(0), dim=d)


def gather_full(x, mesh, pls) -> torch.Tensor:
    """The whole tensor from this rank's shard: gathered over each mesh dim
    that shards it, the innermost first (DTensor splits the outermost
    first)."""
    for i in reversed(range(len(pls))):
        if pls[i].is_shard():
            x = _gather_dim(x, pls[i].dim, mesh.get_group(i), mesh.size(i))
    return x.contiguous()


def to_placement(g, mesh, pls) -> torch.Tensor:
    """A whole tensor's gradient on this rank back to the leaf's placement,
    mesh dims outermost first: summed over the batch axes (a reduce-scatter
    where a batch dim shards the leaf's first dim; else an all-reduce, in
    place, and the slice), sliced on the others, where every rank computed
    the same gradient."""
    import torch.distributed as dist

    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    for i, pl in enumerate(pls):
        n, group = mesh.size(i), mesh.get_group(i)
        if names[i] in BATCH_AXES:
            g = g.contiguous()
            if pl.is_shard() and pl.dim == 0:
                out = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]),
                                  dtype=g.dtype, device=g.device)
                dist.reduce_scatter_tensor(out, g, group=group)
                g = out
                continue
            dist.all_reduce(g, group=group)
        if pl.is_shard():
            g = g.chunk(n, dim=pl.dim)[coord[i]]
    return g.contiguous()


class _Gather(torch.autograd.Function):
    """Shard -> whole tensor; backward: whole gradient -> the shard's."""

    @staticmethod
    def forward(ctx, x, mesh, pls):
        ctx.mesh, ctx.pls = mesh, pls
        return gather_full(x, mesh, pls)

    @staticmethod
    def backward(ctx, g):
        return to_placement(g, ctx.mesh, ctx.pls), None, None


def all_reduce_over(t: torch.Tensor, mesh, axes, op=None) -> torch.Tensor:
    """``t`` reduced (a sum unless ``op``) in place over each of ``axes``
    that ``mesh`` has."""
    import torch.distributed as dist

    op = dist.ReduceOp.SUM if op is None else op
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in axes:
            dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


def batch_rows(mesh) -> Tuple[int, int]:
    """(this rank's index over the batch axes, their number of ranks)."""
    coord, idx, ways = mesh.get_coordinate(), 0, 1
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in BATCH_AXES:
            idx, ways = idx * mesh.size(i) + coord[i], ways * mesh.size(i)
    return idx, ways


def global_sq_norm_terms(grads: Dict[str, torch.Tensor], params, mesh
                         ) -> torch.Tensor:
    """Each leaf's f32 sum of squares over the whole leaf, in sorted name
    order (``tree_global_norm``'s), from every rank's shard: a rank adds its
    shard's sum where its coordinate is 0 on every mesh dim that replicates
    the leaf (a replicated leaf is counted once), and one all-reduce over
    each mesh dim sums them."""
    coord = mesh.get_coordinate()
    terms = []
    for name in sorted(grads):
        g = grads[name]
        pls = params[name].placements
        once = all(pl.is_shard() or coord[i] == 0 for i, pl in enumerate(pls))
        s = g.float().square().sum()
        terms.append(s if once else torch.zeros_like(s))
    terms = torch.stack(terms)
    return all_reduce_over(terms, mesh, mesh.mesh_dim_names)


# --------------------------------------------------- the gathered compute
class GatheredModel:
    """The compute view of a model whose parameters are DTensors: a skeleton
    ``Model`` on the ``meta`` device into which each use installs gathered
    tensors (module docstring)."""

    def __init__(self, model: model_lib.Model, mesh):
        self.cfg, self.mesh = model.cfg, mesh
        self.skel = model_lib.Model(model.cfg, "meta")
        self.pls = {n: tuple(p.placements)
                    for n, p in model.named_parameters()}
        self._slot: Dict[str, Tuple[nn.Module, str]] = {}
        for name, _ in self.skel.named_parameters():
            mod_name, _, leaf = name.rpartition(".")
            self._slot[name] = (self.skel.get_submodule(mod_name)
                                if mod_name else self.skel, leaf)
        self._layer_names: Dict[int, List[str]] = {
            id(layer): [f"layers.{i}.{n}" for n, _ in layer.named_parameters()]
            for i, layer in enumerate(self.skel.layers)}
        self._top = [n for n in self._slot if not n.startswith("layers.")]

    def leaves(self, model: model_lib.Model) -> Dict[str, torch.Tensor]:
        """This rank's shard of every parameter, as fresh leaves that
        require grad and share the DTensors' storage."""
        return {n: local(p).detach().requires_grad_()
                for n, p in model.named_parameters()}

    def gather(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self.mesh, self.pls[name])

    @contextmanager
    def _installed(self, full: Dict[str, torch.Tensor]):
        saved = []
        try:
            for name, t in full.items():
                mod, leaf = self._slot[name]
                saved.append((mod, leaf, mod._parameters[leaf]))
                mod._parameters[leaf] = t
            yield
        finally:
            for mod, leaf, p in saved:
                mod._parameters[leaf] = p

    def _apply_block(self, leaves, layer, *args, **kw):
        full = {n: self.gather(n, leaves[n])
                for n in self._layer_names[id(layer)]}
        with self._installed(full):
            return blk.apply_block(layer, *args, **kw)

    def forward(self, leaves: Dict[str, torch.Tensor], tokens, **kw):
        """``model.forward`` on this rank's rows, its leaves gathered on
        use; ``kw`` as ``model.forward``'s."""
        top = {n: self.gather(n, leaves[n]) for n in self._top}
        with self._installed(top):
            return model_lib.forward(self.skel, tokens, self.cfg,
                                     apply=partial(self._apply_block, leaves),
                                     **kw)
