"""The port's host logic of multi-device training against the JAX
package: ``ShapeConfig``/``SHAPES``/``ParallelConfig``,
``count_active_params``, the sharding specs of every leaf of every arch on
both production meshes (evaluated on fake meshes, as
``tests/test_sharding_data.py`` does), the cache and logits specs, the
elastic plan, cluster detection, and the refusals that keep the card from
being hidden."""
import dataclasses

import jax
import pytest
import torch

from repro.common import config as jconfig
from repro.common.tree import tree_paths as jtree_paths
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.ft import elastic as jelastic
from repro.launch import multihost as jmultihost
from repro.models import model as JM
from repro.sharding import specs as jsp
from repro.training import steps as jsteps
from repro_torch.common import config as tconfig
from repro_torch.common.tree import tree_paths as ttree_paths
from repro_torch.configs import get_config as tget
from repro_torch.ft import elastic as telastic
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import multihost as tmultihost
from repro_torch.models import model as TM
from repro_torch.sharding import placement
from repro_torch.sharding import specs as tsp
from repro_torch.sharding.mesh import make_mesh as make_local_mesh


class FakeMesh:
    """Axis-name/size stand-in so spec logic is testable without devices."""

    def __init__(self, shape_map):
        self.shape = dict(shape_map)
        self.axis_names = tuple(shape_map)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
}


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_shape_and_parallel_configs_match_reference():
    assert _fields(tconfig.ShapeConfig) == _fields(jconfig.ShapeConfig)
    assert _fields(tconfig.ParallelConfig) == _fields(jconfig.ParallelConfig)
    assert list(tconfig.SHAPES) == list(jconfig.SHAPES)
    for name, shape in jconfig.SHAPES.items():
        mine = tconfig.SHAPES[name]
        assert dataclasses.asdict(mine) == dataclasses.asdict(shape)
        assert mine.is_decode == shape.is_decode
    pc = dict(dp=4, tp=2, pods=3)
    assert tconfig.ParallelConfig(**pc).data_ways == \
        jconfig.ParallelConfig(**pc).data_ways == 12


@pytest.mark.parametrize("arch", JARCHS)
def test_count_active_params_matches_reference(arch):
    assert TM.count_active_params(tget(arch)) == \
        JM.count_active_params(jget(arch))
    assert TM.count_params(tget(arch)) == JM.count_params(jget(arch))


def _ref_layer_path(cfg, name: str):
    """The reference's path of the port's parameter ``name`` and whether it
    is period-stacked (``bridge._layer_tree``'s mapping)."""
    path = tsp.ref_path(name)
    if not path.startswith("layers/"):
        return path, False
    _, i, rest = path.split("/", 2)
    i, p_len = int(i), cfg.pattern_period
    if i < cfg.num_periods * p_len:
        return f"periods/{i % p_len}/{rest}", True
    return f"tail/{i - cfg.num_periods * p_len}/{rest}", False


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", JARCHS)
def test_param_specs_match_reference_every_leaf(arch, mesh_name):
    """``spec_for_param_path`` and ``state_specs`` give every parameter and
    optimizer leaf of every arch the reference's spec, less the period
    dim of a stacked leaf, on both production meshes."""
    mesh = MESHES[mesh_name]
    pc = tconfig.ParallelConfig()
    jcfg, tcfg = jget(arch), tget(arch)
    jstate = jax.eval_shape(
        lambda: jsteps.init_train_state(jax.random.PRNGKey(0), jcfg))
    want = {p: tuple(s) for p, s in
            jtree_paths(jsp.state_specs(jstate, mesh, jconfig.ParallelConfig()))}
    shapes = {p: tuple(x.shape) for p, x in jtree_paths(jstate)}
    model = TM.Model(tcfg, "meta")
    tree = {"params": dict(model.named_parameters()),
            "opt": {part: dict(model.named_parameters())
                    for part in ("mu", "nu", "master")}}
    got = dict(ttree_paths(tsp.state_specs(tree, mesh, pc)))
    seen = set()
    for name, p in model.named_parameters():
        ref, stacked = _ref_layer_path(tcfg, name)
        for prefix, jprefix in (("params", "params"), ("opt/mu", "opt/mu"),
                                ("opt/nu", "opt/nu"),
                                ("opt/master", "params")):
            jpath = f"{jprefix}/{ref}"
            exp = want[jpath][1:] if stacked else want[jpath]
            assert shapes[jpath][stacked:] == tuple(p.shape), (name, jpath)
            assert got[f"{prefix}/{name}"] == exp, (name, prefix)
            assert tsp.spec_for_param_path(f"{prefix}/{name}", p.shape, mesh,
                                           pc) == exp
            seen.add(jpath)
    # every reference leaf but the step is some port leaf's
    assert seen == {p for p in want if p != "opt/step"}


def test_param_specs_by_rank_and_fsdp_switch():
    """The rank-only form and ``fsdp_params=False``, as the reference's
    ``test_big_params_are_2d_sharded`` / ``test_fsdp_disabled_replicates``
    ask (the port's leaves have no period dim)."""
    mesh = MESHES["2x16x16"]
    pc = tconfig.ParallelConfig()
    assert tsp.spec_for_param_path("layers.0.attn.wq", 3, mesh, pc) == \
        (("pod", "data"), "model", None)
    assert tsp.spec_for_param_path(
        "layers.0.attn.wq", 3, MESHES["16x16"],
        tconfig.ParallelConfig(fsdp_params=False)) == (None, "model", None)
    assert tsp.spec_for_param_path("opt/step", (), mesh, pc) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["gemma3-27b", "mamba2-780m",
                                  "recurrentgemma-9b", "mixtral-8x22b",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("shape_name", ["long_500k", "decode_32k"])
def test_cache_specs_match_reference(arch, mesh_name, shape_name):
    """``cache_specs`` (built on the meta device) equals the reference's
    for every layer's leaves, less the period dim; at long_500k the KV
    caches shard their sequence over "data"."""
    mesh = MESHES[mesh_name]
    shape = tconfig.SHAPES[shape_name]
    tcfg, jcfg = tget(arch), jget(arch)
    want = {p: tuple(s) for p, s in jtree_paths(jsp.cache_specs(
        jcfg, jconfig.SHAPES[shape_name], mesh, jconfig.ParallelConfig()))}
    got = tsp.cache_specs(tcfg, shape, mesh, tconfig.ParallelConfig())
    assert len(got) == tcfg.num_layers
    seen = set()
    for i, layer in enumerate(got):
        ref, stacked = _ref_layer_path(tcfg, f"layers.{i}.x")
        base = ref.rsplit("/", 1)[0]
        for leaf, spec in layer.items():
            exp = want[f"{base}/{leaf}"]
            assert spec == (exp[1:] if stacked else exp), (i, leaf)
            seen.add(f"{base}/{leaf}")
            if shape_name == "long_500k" and leaf == "k" and "pos" in layer:
                assert "data" in str(spec)
    assert seen == set(want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", JARCHS)
def test_logits_and_batch_specs_match_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    tcfg, jcfg = tget(arch), jget(arch)
    for name, shape in tconfig.SHAPES.items():
        jshape = jconfig.SHAPES[name]
        assert tsp.logits_spec(mesh, shape, tcfg) == \
            tuple(jsp.logits_spec(mesh, jshape, jcfg))
        assert tsp.logits_spec(mesh, shape) == \
            tuple(jsp.logits_spec(mesh, jshape))
        pc = tconfig.ParallelConfig()
        got = tsp.batch_specs(tcfg, shape, mesh, pc)
        want = jsp.batch_specs(jcfg, jshape, mesh, jconfig.ParallelConfig())
        assert got == {k: tuple(v) for k, v in want.items()}


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    assert tsp.placements(mesh, (("pod", "data"), "model", None)) == \
        [Shard(0), Shard(0), Shard(1)]
    assert tsp.placements(mesh, (None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError):
        tsp.placements(mesh, (("data", "pod"),))


def test_parallel_config_for_any_mesh():
    want = tconfig.ParallelConfig(dp=16, tp=16, pods=2)
    assert tmesh.parallel_config_for(MESHES["2x16x16"]) == want
    local = make_local_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    assert tmesh.parallel_config_for(local) == \
        tconfig.ParallelConfig(dp=2, tp=4)

    class TupleMesh:                    # a DeviceMesh's spelling
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 3, 4)
    assert tmesh.parallel_config_for(TupleMesh()) == \
        tconfig.ParallelConfig(dp=3, tp=4, pods=2)


# ------------------------------------------------------------------ elastic
RESCALE_CASES = [  # (dp, tp, pods, available, min_tp): the reference's tests
    (16, 16, 2, 256, 1), (16, 16, 2, 24, 1), (2, 4, 1, 6, 1),
    (2, 6, 1, 8, 2), (2, 4, 1, 1, 1), (1, 8, 1, 12, 1),
]


def _plan(mod, dp, tp, pods, avail, min_tp):
    cfg = (jconfig if mod is jelastic else tconfig).ParallelConfig(
        dp=dp, tp=tp, pods=pods)
    try:
        p = mod.plan_rescale(cfg, avail, min_tp=min_tp, reason="r")
    except ValueError as e:
        return ("ValueError", str(e))
    return (p.old_devices, p.new_devices, p.new_dp, p.new_tp, p.reason,
            p.shrink)


def test_plan_rescale_matches_reference():
    cases = list(RESCALE_CASES)
    cases += [(1, 4, 1, 2, 4), (1, 1, 1, 0, 1)]      # the infeasible ones
    for dp in (1, 2, 3, 4, 8):
        for tp in (1, 2, 3, 4, 6, 8, 16):
            for avail in (1, 2, 3, 5, 6, 7, 8, 12, 16, 24, 31, 32, 64):
                for min_tp in (1, 2, 4):
                    cases.append((dp, tp, 1, avail, min_tp))
    for case in cases:
        assert _plan(telastic, *case) == _plan(jelastic, *case), case
    assert _plan(telastic, 2, 4, 1, 6, 1)[1:4] == (6, 3, 2)
    assert _plan(telastic, 1, 4, 1, 2, 4)[0] == "ValueError"


# ---------------------------------------------------------- cluster detection
CLUSTER_VARS = ("SLURM_NTASKS", "SLURM_STEP_NODELIST", "SLURM_NODELIST",
                "SLURM_PROCID", "SLURM_LOCALID", "REPRO_PORT",
                "REPRO_NUM_PROCESSES", "REPRO_COORDINATOR", "REPRO_PROCESS_ID",
                "REPRO_LOCAL_RANK", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")

ENVS = {
    "empty": {},
    "slurm": {"SLURM_NTASKS": "8", "SLURM_STEP_NODELIST": "node[3-6],node9",
              "SLURM_PROCID": "5", "SLURM_LOCALID": "1", "REPRO_PORT": "9000"},
    "slurm_one_task": {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
    "repro": {"REPRO_NUM_PROCESSES": "4", "REPRO_COORDINATOR": "h0:1234",
              "REPRO_PROCESS_ID": "2"},
    # the process's card: REPRO_LOCAL_RANK, else LOCAL_RANK (the
    # reference has no local rank)
    "repro_local_rank": {"REPRO_NUM_PROCESSES": "4",
                         "REPRO_COORDINATOR": "h0:1234",
                         "REPRO_PROCESS_ID": "3", "REPRO_LOCAL_RANK": "3",
                         "LOCAL_RANK": "1"},
    "repro_launcher_local_rank": {"REPRO_NUM_PROCESSES": "4",
                                  "REPRO_COORDINATOR": "h0:1234",
                                  "REPRO_PROCESS_ID": "1", "LOCAL_RANK": "1"},
    "slurm_over_repro": {"SLURM_NTASKS": "2", "SLURM_NODELIST": "a,b",
                         "SLURM_PROCID": "1", "REPRO_NUM_PROCESSES": "4",
                         "REPRO_COORDINATOR": "h0:1", "REPRO_PROCESS_ID": "3"},
}


@pytest.mark.parametrize("env", list(ENVS))
def test_detect_cluster_matches_reference(env, monkeypatch):
    for k in CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    got, want = tmultihost.detect_cluster(), jmultihost.detect_cluster()
    assert (got.coordinator, got.num_processes, got.process_id) == \
        (want.coordinator, want.num_processes, want.process_id)
    assert got.is_multiprocess == want.is_multiprocess
    want_local = {"slurm": 1, "repro_local_rank": 3,
                  "repro_launcher_local_rank": 1}.get(env, 0)
    assert got.local_rank == want_local


def test_detect_cluster_under_torchrun(monkeypatch):
    for k in CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in {"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "29500"}.items():
        monkeypatch.setenv(k, v)
    env = tmultihost.detect_cluster()
    assert env == tmultihost.ClusterEnv("10.0.0.2:29500", 4, 3, 1)
    assert env.is_multiprocess
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")      # REPRO_* first
    monkeypatch.setenv("REPRO_COORDINATOR", "h:1")
    monkeypatch.setenv("REPRO_PROCESS_ID", "0")
    assert tmultihost.detect_cluster().num_processes == 2


# ------------------------------------------------------------------ refusals
def test_no_fallback_hides_the_card():
    """Without a card: ``initialize(device="cuda")`` raises before touching
    a process group, the production mesh refuses a world that is not 256
    or 512 ranks, and certification counts no device."""
    import torch.distributed as dist
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        tmultihost.initialize(tmultihost.ClusterEnv("", 1, 0))
    assert not dist.is_initialized()
    for multi_pod in (False, True):
        with pytest.raises(ValueError):
            tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    ok, why = tmultihost.certify_host()
    assert not ok and "0 local devices" in why
    with pytest.raises(RuntimeError):
        tmesh.make_host_mesh()


def test_state_tree_paths_match_the_checkpoint():
    """The placement tree holds the checkpoint's paths plus the masters."""
    from repro_torch.common.tree import tree_paths
    from repro_torch.training import steps as S
    cfg = tget("qwen3-4b").replace(num_layers=1, d_model=64, num_heads=4,
                                   num_kv_heads=2, head_dim=16, d_ff=128,
                                   vocab_size=256, dtype=torch.bfloat16)
    state = S.init_train_state(cfg, 0, "cpu")
    tree = placement.state_tree(state)
    ck = {p for p, _ in tree_paths(S.checkpoint_tree(state))}
    mine = {p for p, _ in tree_paths(tree)}
    assert ck <= mine
    assert mine - ck == {f"opt/master/{k}" for k in state["opt"]["master"]}
