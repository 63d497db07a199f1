"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) on the CPU.

* ``input_specs`` against the reference's for every arch and shape
  (shapes and dtypes, the decode cache leaf by leaf).  The reference's are
  computed in one subprocess: importing ``repro.launch.dryrun`` forces 512
  host devices on JAX, which must not reach this process's JAX.
* ``run_cell(..., "long_500k", ...)`` skips exactly the archs the
  reference skips, with its reason.
* Dry equals real: the smoke granite-8b train step and prefill on a
  (2, 2) mesh, and mixtral-8x22b's at dp 2, traced on fake tensors in a
  fake world, count the flops, the collective bytes by kind, the argument
  bytes and the peak bytes that one real step counts on rank 0 of a gloo
  world of the same size (``_torch_dist_ranks.dryrun_real``).
* A prefill cell's all-gathers are its specs' gathers, leaf by leaf; a
  decode cell on a (2, 4) mesh counts, as all-reduce bytes, each
  attention layer's (m, l, acc) partial states of rank 0's shard.
* The module imports neither ``jax`` nor ``repro`` and sets no
  environment variable.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

import _torch_dist_ranks as ranks
from repro_torch.common.config import (ATTN, SHAPES, ParallelConfig,
                                       ShapeConfig)
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import specs as tsp

REPO = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(REPO, "src")

_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro.launch import dryrun as J      # forces 512 host devices: here only
from repro.common.config import SHAPES
from repro.common.tree import tree_paths
from repro.configs import ARCHS, get_config
specs, skips = {}, {}
for arch in ARCHS:
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        specs[f"{arch}/{name}"] = {
            p: [list(x.shape), str(x.dtype)]
            for p, x in tree_paths(J.input_specs(cfg, shape))}
    if cfg.name not in J.LONG_CONTEXT_OK:
        skips[arch] = J.run_cell(arch, "long_500k", False, save=False)
print(json.dumps({"specs": specs, "skips": skips,
                  "long_ok": sorted(J.LONG_CONTEXT_OK)}))
"""


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run([sys.executable, "-c", _REFERENCE, SRC],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _ref_cache_path(cfg, i: int):
    """The reference's cache path of the port's layer ``i`` and whether it
    is period-stacked (``init_cache``'s ``periods``/``tail``)."""
    p_len = cfg.pattern_period
    if i < cfg.num_periods * p_len:
        return f"cache/periods/{i % p_len}", True
    return f"cache/tail/{i - cfg.num_periods * p_len}", False


def test_input_specs_match_reference(reference):
    """Every arch x shape: the same inputs with the same shapes and dtypes;
    the decode cache's every leaf, less the period dim of a stacked one."""
    assert sorted(ARCHS) == sorted({k.split("/")[0]
                                    for k in reference["specs"]})
    for key, want in reference["specs"].items():
        arch, shape_name = key.split("/")
        cfg = get_config(arch)
        got = {}
        for name, x in dryrun.input_specs(cfg, SHAPES[shape_name]).items():
            if name != "cache":
                got[name] = [list(x.shape), str(x.dtype)]
                continue
            for i, layer in enumerate(x):
                base, stacked = _ref_cache_path(cfg, i)
                for leaf, t in layer.items():
                    dims = list(t.shape)
                    if stacked:
                        dims = [cfg.num_periods] + dims
                    path = f"{base}/{leaf}"
                    entry = [dims, str(t.dtype)]
                    assert got.setdefault(path, entry) == entry, (key, path)
        got = {p: [d, t.replace("torch.", "")] for p, (d, t) in got.items()}
        assert got == want, key


def test_long_context_skips_match_reference(reference, monkeypatch):
    """``long_500k`` is a SKIP, with the reference's reason, exactly for the
    archs outside ``LONG_CONTEXT_OK``; the others go on to be traced (the
    trace itself stubbed out here)."""
    assert sorted(dryrun.LONG_CONTEXT_OK) == reference["long_ok"]
    monkeypatch.setattr(dryrun, "trace_cell", lambda *a, **kw: {})
    for arch in ARCHS:
        rec = dryrun.run_cell(arch, "long_500k", False, save=False)
        if arch in reference["skips"]:
            assert rec == reference["skips"][arch], arch
        else:
            assert rec["status"] == "OK", rec


CASES = [("granite-8b", (2, 2), 8), ("mixtral-8x22b", (2, 1), 8)]


@pytest.mark.parametrize("arch,shape,batch", CASES)
def test_dry_run_equals_a_real_step(arch, shape, batch, tmp_path):
    """The train step and the prefill forward of the smoke ``arch`` (its
    own dtypes) on ``shape``: the fake world's trace counts what rank 0 of
    a real gloo world counts over one step, collectives by kind, flops,
    argument bytes (the real ones summed over its local shards and its
    rows of the batch) and peak bytes (on the same, plain, route)."""
    world = shape[0] * shape[1]
    seq = 16
    ranks.run_group(world, [
        ("dryrun_real", dict(out=kind, arch=arch, shape=shape, kind=kind,
                             batch=batch, seq=seq))
        for kind in ("train", "prefill")], str(tmp_path))
    cfg = get_smoke_config(arch)
    for kind in ("train", "prefill"):
        real = torch.load(tmp_path / f"{kind}.pt")
        with dryrun.fake_world(world):
            mesh = make_mesh(*shape, device="cpu")
            dry = dryrun.trace_cell(cfg, ShapeConfig(kind, kind, seq, batch),
                                    mesh)
        assert dry["collective_bytes"] == real["collective_bytes"], kind
        assert dry["collective_bytes"]["all-gather"] > 0, kind
        assert dry["flops"] == real["flops"] > 0, kind
        assert dry["memory"]["argument_bytes"] == real["argument_bytes"], kind
        assert dry["memory"]["peak_bytes"] == real["peak_bytes"] > \
            real["argument_bytes"], kind


class _Mesh:
    """Axis names and sizes: what the specs read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def test_prefill_gathers_every_leaf_once():
    """granite-8b smoke prefill on (2, 2): the all-gather bytes are, leaf
    by leaf, its specs' gathers (model axis first, then data), each
    counted at its result's size, and nothing else is a collective."""
    cfg = get_smoke_config("granite-8b")
    mesh = _Mesh({"data": 2, "model": 2})
    want = 0
    for name, p in dryrun.model_lib.Model(cfg, "meta").named_parameters():
        spec = tsp.spec_for_param_path(f"params/{name}", tuple(p.shape),
                                       mesh, ParallelConfig(dp=2, tp=2))
        axes = {a for e in spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        size = p.numel() * p.element_size() // 2 ** len(axes)
        for axis in ("model", "data"):
            if axis in axes:
                size *= 2
                want += size
    with dryrun.fake_world(4):
        rec = dryrun.trace_cell(cfg, ShapeConfig("p", "prefill", 16, 8),
                                make_mesh(2, 2, device="cpu"))
    assert rec["collective_bytes"] == {"all-gather": want, "total": want}


def test_decode_cell_counts_partial_states_as_all_reduce():
    """qwen3-4b smoke decode on a (2, 4) mesh, 8 lanes over a 32-slot ring:
    each attention layer's combine joins rank 0's (m, l, acc), 2·B·H·4 +
    B·H·D·4 bytes at its 4 lanes, and nothing else is a collective; the
    arguments are the whole weights, rank 0's slots of every ring and the
    tokens."""
    cfg = get_smoke_config("qwen3-4b")
    b, s = 8, 32
    with dryrun.fake_world(8):
        mesh = make_mesh(2, 4, device="cpu")
        rec = dryrun.trace_cell(cfg, ShapeConfig("d", "decode", s, b), mesh)
    assert rec["spmd_decode"] is True and rec["layout"] == "tp"
    lanes, h, d = b // 2, cfg.num_heads, cfg.resolved_head_dim
    n_attn = sum(k == ATTN for k in cfg.layer_kinds())
    per_layer = 2 * lanes * h * 4 + lanes * h * d * 4
    assert rec["collective_bytes"] == {"all-reduce": n_attn * per_layer,
                                       "total": n_attn * per_layer}
    weights = sum(p.numel() * p.element_size() for p in
                  dryrun.model_lib.Model(cfg, "meta").parameters())
    hkv = cfg.num_kv_heads
    ring = lanes * (s // 4) * hkv * d * cfg.dtype.itemsize * 2 + \
        lanes * (s // 4) * 4
    tokens = b * 4 + 4
    assert rec["memory"]["argument_bytes"] == \
        weights + cfg.num_layers * ring + tokens
    assert rec["flops"] > 0 and rec["memory"]["output_bytes"] == \
        b * cfg.vocab_size * cfg.dtype.itemsize


def test_fsdp_decode_layout_is_refused():
    """The reference's fsdp decode layout splits weights over the model
    axis, which the port's decode does not do: a FAIL naming the item."""
    with dryrun.fake_world(8):
        mesh = make_mesh(2, 4, device="cpu")
        with pytest.raises(NotImplementedError, match="item 19"):
            dryrun.trace_cell(get_smoke_config("qwen3-4b"),
                              ShapeConfig("d", "decode", 32, 8), mesh,
                              decode_layout="fsdp")


def test_dryrun_imports_neither_jax_nor_repro_and_sets_no_environment():
    """Importing the module and running a cell (a fake world of 4, granite
    smoke prefill) pull in no ``jax`` and no ``repro`` module and leave
    the environment as it was."""
    code = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
before = dict(os.environ)
from repro_torch.common.config import ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import specs as tsp
with dryrun.fake_world(4):
    rec = dryrun.trace_cell(get_smoke_config("granite-8b"),
                            ShapeConfig("p", "prefill", 16, 8),
                            make_mesh(2, 2, device="cpu"))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"bad": bad, "env": dict(os.environ) == before,
                  "flops": rec["flops"]}))
"""
    out = subprocess.run(
        [sys.executable, "-c", code, SRC], capture_output=True, text=True,
        timeout=120, check=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "env": True, "flops": res["flops"]}
    assert res["flops"] > 0
