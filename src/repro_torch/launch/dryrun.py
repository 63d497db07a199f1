"""Multi-pod dry run: one step of every (arch x shape x mesh) cell traced
on fake tensors in a fake world, as rank 0 (the port of
``repro.launch.dryrun``, which lowers and compiles each cell on 512 forced
host devices).

For each cell:
  * a fake process group of 256 ranks (``16x16``) or 512 (``2x16x16``)
    with this process as rank 0 (``torch.distributed``'s ``fake``
    backend: a collective returns at once and moves nothing), and the
    production ``DeviceMesh`` over it (``launch.mesh``);
  * under ``FakeTensorMode`` (tensors with shapes, dtypes and devices but
    no storage) rank 0's inputs, built shard by shard: each state leaf's
    local shard by its spec (``sharding.specs``), wrapped as a DTensor, as
    the reference's ``in_shardings`` hand a device its shards (nothing is
    scattered);
  * one step of the port's own path for the cell's kind (``build_cell``),
    traced under ``Trace``, a dispatch mode that counts what rank 0
    computes, moves and holds;
  * one JSON record under ``experiments/dryrun_torch/``.

The fake tensors claim the CPU, so ``kernels/ops.py`` takes the plain
versions (the record says ``"route": "plain"``), as the reference's host
dry run lowers ``ref.py``.  Nothing executes.

Decode is single-controller in the port: one process issues every
sequence shard's writes and partial attention (``serving.spmd_decode``).
On a mesh of distinct cards the shard of lane block 0, sequence shard 0
lives on the query's card, rank 0, which also runs the rest of the step
for every lane and the combine; the dry run lays out and issues that
shard alone and stands its partial states in for the other shards'
(``spmd_decode.lead_shard_only``), whose work is other cards'.

Record keys:
  status            ``OK``; ``SKIP`` (``long_500k`` for an arch outside
                    ``LONG_CONTEXT_OK``, with ``reason``); ``FAIL`` (with
                    ``error`` and ``traceback``; the sweep goes on)
  arch, shape, mesh (``16x16`` | ``2x16x16``), num_devices
  route             ``plain``: the kernels' plain versions were traced
  layout            decode only: ``tp`` (weights whole on the lead card,
                    bf16) and ``spmd_decode`` (whether the split-S decode
                    ran)
  build_s           seconds to build the fake state and inputs
  lower_s           seconds to trace the step (eager mode has no compile)
  flops             rank 0's floating-point operations over the step, by
                    ``torch.utils.flop_counter``'s formulas (those of
                    ``FlopCounterMode``: matmuls, convolutions, attention)
  bytes_accessed    every op's input and output bytes, summed: unfused
                    eager traffic (views and collectives left out)
  collective_bytes  result-buffer bytes of rank 0's collectives by the
                    reference's kind names (``all-gather``,
                    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
                    ``collective-permute``) and ``total``; a decode step's
                    combine counts rank 0's (m, l, acc) partial states as
                    ``all-reduce`` (the reference's ``pmax``/``psum``)
  memory.argument_bytes  rank 0's inputs when the step starts: its state
                    shards and batch rows (train, prefill); decode: the
                    whole weights, its shard of the cache and the tokens
  memory.output_bytes    the step's outputs (train: metrics; prefill:
                    logits; decode: logits)
  memory.peak_bytes      the most bytes of live tensors on rank 0 at once
                    over the step, the arguments included

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
import traceback
import weakref
from contextlib import contextmanager, nullcontext
from functools import partial
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.common.config import (SHAPES, ModelConfig, ParallelConfig,
                                       ShapeConfig, TrainConfig)
from repro_torch.common.tree import tree_paths
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh, parallel_config_for
from repro_torch.models import model as model_lib
from repro_torch.serving import spmd_decode as spmd
from repro_torch.sharding import context as shctx
from repro_torch.sharding import placement as pl
from repro_torch.sharding import specs as sp
from repro_torch.sharding.mesh import make_mesh as make_serving_mesh
from repro_torch.training import steps as steps_lib

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# archs with unbounded full attention cannot serve a 500k context
# (see DESIGN.md §4) — recorded as SKIP cells.
LONG_CONTEXT_OK = {"mamba2-780m", "gemma3-27b", "mixtral-8x22b",
                   "recurrentgemma-9b"}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors standing in for every model input of this cell,
    the reference's shapes and dtypes (decode's cache: ``init_cache``'s
    list of layer dicts)."""
    b, s = shape.global_batch, shape.seq_len

    def sds(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"tokens": sds((b, s, cfg.d_model), torch.bfloat16)}
        else:
            batch = {"tokens": sds((b, s), torch.int32)}
        batch["labels"] = sds((b, s), torch.int32)
        batch["mask"] = sds((b, s), torch.float32)
        if cfg.family == "vlm":
            batch["enc"] = sds((b, cfg.num_image_tokens, cfg.d_model),
                               torch.bfloat16)
        return batch
    # decode: one new token against a cache of seq_len capacity
    if cfg.family == "audio":
        tok = sds((b, 1, cfg.d_model), torch.bfloat16)
    else:
        tok = sds((b, 1), torch.int32)
    return {"tokens": tok,
            "cache": model_lib.init_cache(cfg, b, s, device="meta"),
            "cache_index": sds((), torch.int32)}


# --------------------------------------------------------------- the world
@contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks, this process rank 0,
    for the ``with`` body."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_like(t: torch.Tensor, dims=None) -> torch.Tensor:
    """A tensor of ``t``'s dtype (and ``dims``, else its shape) on the CPU;
    under ``FakeTensorMode`` it has no storage."""
    return torch.empty(t.shape if dims is None else dims, dtype=t.dtype)


def _local_dims(mesh, shape, pls) -> Tuple[int, ...]:
    """Rank 0's shard of a tensor of ``shape`` placed by ``pls`` (the specs
    only shard dims their axes divide)."""
    dims = list(shape)
    for i, p in enumerate(pls):
        if p.is_shard():
            dims[p.dim] //= mesh.size(i)
    return tuple(dims)


def _dtensor(mesh, t: torch.Tensor, spec) -> torch.Tensor:
    """Rank 0's shard of a tensor shaped like ``t`` (a ``meta`` stand-in)
    by ``spec``, as a DTensor of ``t``'s global shape."""
    from torch.distributed.tensor import DTensor

    pls = sp.placements(mesh, spec)
    local = _fake_like(t, _local_dims(mesh, t.shape, pls))
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=t.shape, stride=t.stride())


def _install(model: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Put ``params`` into ``model`` by name, as parameters that need no
    gradient (``placement.place_state``'s form)."""
    for name, t in params.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)


def _sharded_state(cfg: ModelConfig, mesh, pc: ParallelConfig,
                   tc: Optional[TrainConfig]):
    """Rank 0's train state (``tc``) or parameters (``tc`` None) by the
    reference's specs: the layout ``placement.place_by_specs`` gives, built
    from the shapes of ``Model(cfg, "meta")`` without the whole leaves."""
    model = model_lib.Model(cfg, "meta")
    params = dict(model.named_parameters())
    tree: Dict[str, Any] = {"params": params}
    if tc is not None:
        f32 = torch.float32
        like = {k: p.to(f32) for k, p in params.items()}
        tree["opt"] = {"mu": like, "nu": like,
                       "master": {k: like[k] for k, p in params.items()
                                  if p.dtype != f32},
                       "step": torch.zeros((), dtype=torch.int32,
                                           device="meta")}
        if tc.grad_compression == "int8_ef":
            tree["ef"] = like
    specs = dict(tree_paths(sp.state_specs(tree, mesh, pc)))
    placed = {path: _dtensor(mesh, t, specs[path])
              for path, t in tree_paths(tree)}
    _install(model, {k: placed[f"params/{k}"] for k in params})
    if tc is None:
        return model
    opt = {part: {k: placed[f"opt/{part}/{k}"] for k in tree["opt"][part]}
           for part in ("mu", "nu", "master")}
    opt["step"] = placed["opt/step"]
    state = {"model": model, "opt": opt}
    if "ef" in tree:
        state["ef"] = {k: placed[f"ef/{k}"] for k in params}
    return state


def _whole_model(cfg: ModelConfig) -> model_lib.Model:
    """Every weight whole, in the dtype the port stores it."""
    model = model_lib.Model(cfg, "meta")
    _install(model, {k: _fake_like(p) for k, p in model.named_parameters()})
    return model


def _state_leaves(state) -> List[torch.Tensor]:
    """Every leaf of a (placed) train state or model, as rank 0 holds it:
    a DTensor's local shard."""
    tree = (pl.state_tree(state) if isinstance(state, dict) else
            dict(state.named_parameters()))
    return [pl.local(t) for _, t in tree_paths(tree)]


def _batch_rows(batch: Dict[str, torch.Tensor], mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's rows of each input of a global batch: its block over the
    batch axes (``placement.batch_rows``), the rows the sharded step
    takes."""
    idx, ways = pl.batch_rows(mesh)
    per = next(iter(batch.values())).shape[0] // ways
    return {k: t[idx * per:(idx + 1) * per] for k, t in batch.items()}


# --------------------------------------------------------------- the cells
class Cell(NamedTuple):
    """A cell's step ``fn(*args)``; ``resident``: the tensors on rank 0's
    device when it starts (its state shards and batch rows, or decode's
    weights, cache shard and tokens); ``spmd_decode``: whether a decode
    step runs the split-S decode."""
    fn: Any
    args: tuple
    resident: List[torch.Tensor]
    spmd_decode: Optional[bool] = None


def make_prefill_step(cfg: ModelConfig, mesh, num_groups: int):
    """``model.forward`` over a model whose parameters are placed on
    ``mesh``, under ``no_grad``: each rank runs its rows of the global
    batch (``placement.batch_rows``), its leaves gathered on use
    (``placement.GatheredModel``); returns this rank's logits."""
    groups = max(num_groups // pl.batch_rows(mesh)[1], 1)
    views: Dict[int, pl.GatheredModel] = {}

    @torch.no_grad()
    def prefill_fwd(model, batch):
        view = views.get(id(model))
        if view is None:
            view = views[id(model)] = pl.GatheredModel(model, mesh)
        rows = _batch_rows(batch, mesh)
        tokens = rows["tokens"]
        if tokens.dim() == 2:
            tokens = tokens.long()
        logits, _ = view.forward(
            {n: pl.local(p) for n, p in model.named_parameters()}, tokens,
            enc=rows.get("enc"), num_groups=groups)
        return logits

    return prefill_fwd


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, pc: ParallelConfig,
               *, decode_layout: str = "tp", spmd_decode: bool = True) -> Cell:
    """The cell's step and rank 0's fake inputs, under a ``FakeTensorMode``
    (the caller's).  ``mesh``: a ``DeviceMesh`` over the world.

    ``decode_layout`` and ``spmd_decode`` are the reference's
    ``REPRO_DECODE_LAYOUT`` and ``REPRO_SPMD_DECODE``, with its defaults:
    ``"tp"`` serves bf16 weights that no data rank shards (the port keeps
    them whole on the lead card); ``"fsdp"`` would split them over the
    model axis, which the port's decode does not do (ROADMAP.md §3 item
    19)."""
    num_groups = pc.data_ways
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        tc = TrainConfig(total_steps=1000)
        state = _sharded_state(cfg, mesh, pc, tc)
        batch = {k: _fake_like(t) for k, t in specs.items()}
        fn = steps_lib.make_train_step(cfg, tc, num_groups=num_groups,
                                       mesh=mesh)
        return Cell(fn, (state, batch), _state_leaves(state)
                    + list(_batch_rows(batch, mesh).values()))

    if shape.kind == "prefill":
        specs.pop("labels"), specs.pop("mask")
        model = _sharded_state(cfg, mesh, pc, None)
        batch = {k: _fake_like(t) for k, t in specs.items()}
        return Cell(make_prefill_step(cfg, mesh, num_groups), (model, batch),
                    _state_leaves(model)
                    + list(_batch_rows(batch, mesh).values()))

    if decode_layout != "tp":
        raise NotImplementedError(
            f"decode layout {decode_layout!r}: the port's decode keeps the "
            "weights whole on each lead card and splits no weight over the "
            "model axis (ROADMAP.md §3 item 19)")
    ways = pc.data_ways
    batch_sharded = shape.global_batch % max(ways, 1) == 0 and ways > 1
    use_spmd = batch_sharded and shape.seq_len % pc.tp == 0 and spmd_decode
    model = _whole_model(cfg)
    tokens = _fake_like(specs["tokens"])
    cache_index = _fake_like(specs["cache_index"])
    cache = [{k: _fake_like(t) for k, t in layer.items()}
             for layer in specs["cache"]]
    serving = nullcontext
    if use_spmd:
        names = sp.axis_names(mesh)
        dims = tuple(sp.axis_sizes(mesh)[a] for a in names)
        grid = make_serving_mesh(dims, names, ["cpu"] * mesh.size())
        b_ax = ("pod", "data") if "pod" in names else "data"
        with spmd.lead_shard_only():
            cache = spmd.shard_cache(cache, grid, batch_axis=b_ax,
                                     seq_axis="model")
        serving = partial(shctx.serving_mesh, grid, batch_axis=b_ax,
                          seq_axis="model")
    held = [t.parts[0][0] if isinstance(t, spmd.Sharded) else t
            for layer in cache for t in layer.values()]

    @torch.no_grad()
    def serve_step(model, cache, tokens, cache_index):
        with serving():
            return model_lib.decode_step(model, cache, tokens, cache_index,
                                         cfg)

    return Cell(serve_step, (model, cache, tokens, cache_index),
                _state_leaves(model) + held + [tokens, cache_index], use_spmd)


# ------------------------------------------------------------ the counting
_KINDS = (("reduce_scatter", "reduce-scatter"), ("gather", "all-gather"),
          ("reduce", "all-reduce"), ("to_all", "all-to-all"),
          ("alltoall", "all-to-all"))


def _collective_kind(func) -> Optional[str]:
    """The reference's kind name of a ``c10d`` (or functional) collective
    op, else the op's own name; None for an op that moves no data (a
    barrier, a wait) or is no collective."""
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    if "barrier" in name or "wait" in name:
        return None
    for key, kind in _KINDS:
        if key in name:
            return kind
    return name.strip("_")


def _nbytes(tensors: Iterable) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


class Trace(TorchDispatchMode):
    """Counts what rank 0 computes, moves and holds over the ops run in its
    ``with`` body: ``flops`` (``torch.utils.flop_counter``'s formulas),
    ``bytes_accessed`` (inputs and outputs of every op that is neither a
    view nor a collective), ``calls`` ((kind, result bytes) of every
    collective; ``combine``, given to ``spmd_decode.lead_shard_only``,
    adds a decode combine's rank-0 partial states as an ``all-reduce``),
    and live bytes (each storage from its first op to its release,
    ``meta`` tensors left out) with their ``peak``, ``resident`` counted
    from the start.

    A gloo process group's worker thread holds a collective's tensors
    until just after the collective completes.  Where the step has dropped
    one by then, the worker releases it, and that release waits for the
    interpreter's lock, which the step's thread hands over at a time that
    depends on the threads: it could land after the next op's allocations
    and count toward their peak.  So in a gloo world the trace hands the
    lock over before the first op after a collective, for as long as the
    worker's releases keep arriving (``_await_workers``): they then land
    where a fake world, whose collectives hold nothing, releases the same
    tensors."""

    def __init__(self, resident: Iterable[torch.Tensor] = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.calls: List[Tuple[str, int]] = []
        self._live: Dict[int, int] = {}
        self.live = self.peak = 0
        self._owner = threading.get_ident()
        self._foreign = 0            # releases run by another thread
        self._after_collective = False
        self._real = torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_backend() == "gloo"
        for t in resident:
            self._hold(t, t.numel() * t.element_size())
        self.argument_bytes = self.live

    def _hold(self, t: torch.Tensor, nbytes: Optional[int] = None) -> None:
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes() if nbytes is None else nbytes
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        if threading.get_ident() != self._owner:
            self._foreign += 1
        self.live -= self._live.pop(key, 0)

    def _await_workers(self, step_s: float = 0.002, most_s: float = 0.2
                       ) -> None:
        """Hand the interpreter's lock to the process group's threads
        until a wait of ``step_s`` brings no release from them (at most
        ``most_s`` in all)."""
        deadline = time.monotonic() + most_s
        while True:
            seen = self._foreign
            time.sleep(step_s)
            if self._foreign == seen or time.monotonic() > deadline:
                return

    def combine(self, states) -> None:
        self.calls.append(("all-reduce", _nbytes(states[0][0])))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._after_collective:
            self._after_collective = False
            self._await_workers()
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is not None:
            result = out if func.namespace == "_c10d_functional" else args[0]
            self.calls.append((kind, _nbytes(tree_leaves(result))))
            self._after_collective = self._real
            return out
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            self.bytes_accessed += _nbytes(tree_leaves((args, kwargs))) + \
                _nbytes(outs)
            for t in outs:
                self._hold(t)
        return out


def collective_bytes(calls: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Sum result-buffer bytes per collective kind from the counted calls
    (``Trace.calls``), and their ``total``."""
    out: Dict[str, float] = {}
    for kind, nbytes in calls:
        out[kind] = out.get(kind, 0.0) + nbytes
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw
               ) -> Dict[str, Any]:
    """Build and trace one cell on ``mesh`` (a ``DeviceMesh`` of the
    current, fake, world) under a fresh ``FakeTensorMode``: the record's
    measured keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    pc = parallel_config_for(mesh)
    t0 = time.perf_counter()
    with FakeTensorMode():
        cell = build_cell(cfg, shape, mesh, pc, **kw)
        t1 = time.perf_counter()
        with Trace(cell.resident) as tr, spmd.lead_shard_only(tr.combine):
            out = cell.fn(*cell.args)
        t2 = time.perf_counter()
    if shape.kind == "train":
        out = out[1]
    elif shape.kind == "decode":
        out = out[0]
    rec = {"route": "plain",
           "build_s": round(t1 - t0, 2), "lower_s": round(t2 - t1, 2),
           "flops": float(tr.flops),
           "bytes_accessed": float(tr.bytes_accessed),
           "collective_bytes": collective_bytes(tr.calls),
           "memory": {"argument_bytes": tr.argument_bytes,
                      "output_bytes": _nbytes(tree_leaves(out)),
                      "peak_bytes": tr.peak},
           "num_devices": mesh.size()}
    if shape.kind == "decode":
        rec["layout"] = kw.get("decode_layout", "tp")
        rec["spmd_decode"] = cell.spmd_decode
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, save: bool = True,
             **kw) -> Dict[str, Any]:
    """One cell's record (module docstring); ``kw``: ``build_cell``'s
    decode switches."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16"}
    if shape_name == "long_500k" and cfg.name not in LONG_CONTEXT_OK:
        rec["status"] = "SKIP"
        rec["reason"] = "unbounded full attention; 500k context infeasible " \
                        "(DESIGN.md §4)"
        return _save(rec) if save else rec
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            rec.update(trace_cell(cfg, shape, mesh, **kw))
        rec["status"] = "OK"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return _save(rec) if save else rec


def _save(rec: Dict[str, Any]) -> Dict[str, Any]:
    os.makedirs(OUT_DIR, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh'].replace('x','_')}.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


H100_BYTES = 80e9                 # one card's memory


def table(records: Iterable[Dict[str, Any]]) -> str:
    """The records as Markdown rows: rank 0's TFLOP, collective and memory
    GB (1e9 bytes), and whether its arguments exceed one H100's 80 GB."""
    head = ("| arch | shape | mesh | status | TFLOP | all-gather GB | "
            "all-reduce GB | reduce-scatter GB | argument GB | peak GB | "
            "args > 80 GB |\n|" + "---|" * 11)
    rows = [head]
    for r in records:
        cells = [r["arch"], r["shape"], r["mesh"], r["status"]]
        if r["status"] == "OK":
            coll, mem = r["collective_bytes"], r["memory"]
            cells += [f"{r['flops'] / 1e12:.4g}"]
            cells += [f"{coll.get(k, 0.0) / 1e9:.4g}" for k in
                      ("all-gather", "all-reduce", "reduce-scatter")]
            cells += [f"{mem['argument_bytes'] / 1e9:.4g}",
                      f"{mem['peak_bytes'] / 1e9:.4g}",
                      "yes" if mem["argument_bytes"] > H100_BYTES else "no"]
        else:
            cells += [r.get("error", r.get("reason", ""))[:80]] + [""] * 6
        rows.append("| " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--decode-layout", default="tp", choices=["tp", "fsdp"],
                    help="the reference's REPRO_DECODE_LAYOUT")
    ap.add_argument("--no-spmd-decode", action="store_true",
                    help="the reference's REPRO_SPMD_DECODE=0")
    ap.add_argument("--table", action="store_true",
                    help="print the records as Markdown rows at the end")
    args = ap.parse_args(argv)

    archs = ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    kw = dict(decode_layout=args.decode_layout,
              spmd_decode=not args.no_spmd_decode)

    results = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, **kw)
                tag = "OK " if rec["status"] == "OK" else rec["status"]
                extra = ""
                if rec["status"] == "OK":
                    extra = (f"build={rec['build_s']}s lower={rec['lower_s']}s "
                             f"flops={rec['flops']:.3e} "
                             f"coll={rec['collective_bytes']['total']:.3e}B "
                             f"args={rec['memory']['argument_bytes']:.3e}B "
                             f"peak={rec['memory']['peak_bytes']:.3e}B")
                elif rec["status"] == "FAIL":
                    extra = rec["error"][:160]
                print(f"[{tag}] {arch:22s} {shape:12s} {rec['mesh']:8s} {extra}",
                      flush=True)
                results.append(rec)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\ndry-run: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"of {len(results)} cells in {time.perf_counter() - t0:.1f} s")
    if args.table:
        print(table(results))
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
