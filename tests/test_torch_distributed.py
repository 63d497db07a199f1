"""Multi-rank training on the port, held against the JAX package: worlds of
2, 4 and 8 gloo ranks on the CPU (``_torch_dist_ranks.py`` runs the ranks,
each spawned group with its own timeout), and GPipe on a single-process
mesh of CPU devices.

* The sharded train step (``make_train_step(mesh=...)``) over 3 steps of
  granite-8b smoke (f32) on (2, 2) and (4, 1) meshes and on 2 pods x 2
  data ranks (a ("pod", "data", "model") mesh), with masks that give
  the ranks different token counts, against JAX's single-device
  ``jax.jit(make_train_step)`` on the same (bridged) weights: loss and
  parameters within 5e-5, as the reference's own multi-device test asks;
  with two microbatches and ``int8_ef`` too; mixtral-8x22b smoke at dp 2
  against ``make_train_step(num_groups=2)``.
* Save on (2, 2), restore into a world of 2 on (1, 2) (``plan_rescale``'s
  plan) and (2, 1) through ``reshard_state``: bit-equal.  The save
  gathers one whole leaf at a time, to the host on rank 0.
* ``make_compressed_allreduce`` over 8 ranks against the JAX one on 8
  forced host devices, within 1e-6.
* ``pipeline_forward`` over 4 and 2 stages against JAX's ``forward``.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro.common.config import TrainConfig as JTC
from repro.configs import get_smoke_config as jsmoke
from repro.models import model as JM
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.models import model as TM
from repro_torch.sharding.mesh import make_mesh as make_local_mesh
from repro_torch.training import pipeline as tpipe

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LR = 1e-3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(rng, vocab, b=8, s=16):
    """Batches whose masks differ by rows, so that every split of the rows
    over ranks gives the ranks different token counts."""
    out = []
    for _ in range(ranks.STEPS):
        toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
        mask = np.ones((b, s), np.float32)
        for r in range(b):
            mask[r, s - (3 * r) % s:] = 0.0
        mask[b - 1, 2:] = 0.0
        out.append({"tokens": toks, "labels": toks, "mask": mask})
    return out


def _reference(arch, tc_kw, batches, num_groups=1):
    """JAX's single-device steps: the initial params (numpy), each step's
    metrics and the final params, as port-named tensors."""
    jc = jsmoke(arch).replace(dtype=jnp.float32, param_dtype=jnp.float32)
    js = jsteps.init_train_state(jax.random.PRNGKey(0), jc)
    if tc_kw.get("grad_compression") == "int8_ef":
        from repro.training import optimizer as jopt
        js["ef"] = jopt.ef_init(js["params"])
    init = _np_tree(js["params"])
    step = jax.jit(jsteps.make_train_step(jc, JTC(**tc_kw),
                                          num_groups=num_groups))
    metrics = []
    for bt in batches:
        js, m = step(js, {k: jnp.asarray(v) for k, v in bt.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    tcfg = tsmoke(arch).replace(dtype=torch.float32)
    final = dict(bridge.params_from_numpy(_np_tree(js["params"]), tcfg, "cpu")
                 .named_parameters())
    return init, metrics, final


def _check(got, want_metrics, want_params, loss_tol, param_tol):
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=loss_tol,
                                       err_msg=f"step {i + 1} {k}")
    params = got["tree"]["params"]
    assert set(params) == set(want_params)
    for name, w in want_params.items():
        np.testing.assert_allclose(params[name].numpy(), w.detach().numpy(),
                                   atol=param_tol, rtol=0, err_msg=name)


DENSE = dict(learning_rate=LR, total_steps=10, warmup_steps=2)


def test_sharded_steps_on_four_ranks_match_single_device_jax(tmp_path):
    """granite-8b smoke on (2, 2), (4, 1) and (2 pods, 2, 1), ragged masks,
    and on (2, 2) with two microbatches and int8 error feedback, against
    JAX's
    single-device step; then the (2, 2) state saved for the rescale test
    below (run in this group's directory)."""
    rng = np.random.default_rng(11)
    batches = _batches(rng, 256)
    init, jm, jp = _reference("granite-8b", DENSE, batches)
    ef_kw = dict(DENSE, microbatches=2, grad_compression="int8_ef")
    _, jm_ef, jp_ef = _reference("granite-8b", ef_kw, batches)
    common = dict(arch="granite-8b", jparams=init, batches=batches)
    tasks = [("sharded_steps", dict(common, out="dense22", shape=(2, 2),
                                    tc_kw=DENSE,
                                    ckpt=str(tmp_path / "ckpt"))),
             ("sharded_steps", dict(common, out="dense41", shape=(4, 1),
                                    tc_kw=DENSE)),
             # (dp, tp, pods) = 2 pods of 2 data ranks: FSDP over the
             # ("pod", "data") pair, the batch over both
             ("sharded_steps", dict(common, out="pods", shape=(2, 1, 2),
                                    tc_kw=DENSE)),
             ("sharded_steps", dict(common, out="ef22", shape=(2, 2),
                                    tc_kw=ef_kw))]
    ranks.run_group(4, tasks, str(tmp_path))
    for out in ("dense22", "dense41", "pods"):
        got = torch.load(tmp_path / f"{out}.pt")
        _check(got, jm, jp, loss_tol=5e-5, param_tol=5e-5)
    # int8 error feedback: AdamW's first updates are lr * sign(g), and a
    # quantization step can flip an element's sign (test_torch_training's
    # bound for int8_ef)
    got = torch.load(tmp_path / "ef22.pt")
    _check(got, jm_ef, jp_ef, loss_tol=1e-4, param_tol=2 * LR * ranks.STEPS)

    # elastic: the (2, 2) checkpoint restored into a world of 2
    ranks.run_group(2, [("restore_rescaled", dict(
        ckpt=str(tmp_path / "ckpt"), saved="dense22", old=(2, 2),
        meshes=[(2, 1)]))], str(tmp_path))
    assert torch.load(tmp_path / "restored.pt")["plan"] == (1, 2)


def test_sharded_checkpoint_gathers_one_leaf_at_a_time(tmp_path):
    """A (2, 2) state's checkpoint: each rank holds at most one whole leaf
    at a time, rank 0 gets the whole tree on the host, bit-equal to the
    state before it was placed, and the other ranks nothing."""
    ranks.run_group(4, [("checkpoint_leaf_by_leaf", dict(
        arch="granite-8b", shape=(2, 2)))], str(tmp_path))
    got = torch.load(tmp_path / "leaf_by_leaf.pt")
    assert got["leaves"] > 0 and got["gathered"] > got["leaves"] // 2


def test_sharded_moe_step_at_dp2_matches_jax_groups(tmp_path):
    """mixtral-8x22b smoke at dp 2: each rank runs its own capacity group,
    against JAX's ``make_train_step(num_groups=2)`` on one device."""
    batches = _batches(np.random.default_rng(12), 256)
    init, jm, jp = _reference("mixtral-8x22b", DENSE, batches, num_groups=2)
    ranks.run_group(2, [("sharded_steps", dict(
        arch="mixtral-8x22b", jparams=init, batches=batches, out="moe",
        shape=(2, 1), tc_kw=DENSE))], str(tmp_path))
    got = torch.load(tmp_path / "moe.pt")
    _check(got, jm, jp, loss_tol=5e-5, param_tol=5e-5)
    assert all(m["aux"] > 0 for m in got["metrics"])


def test_int8_compressed_allreduce_matches_jax(tmp_path):
    """Eight ranks' int8 all-reduce-mean against the JAX one on eight forced
    host devices (run at once, in a subprocess), within 1e-6."""
    x = (np.random.default_rng(0).standard_normal((8, 128)) * 0.02
         ).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(f"""
        import jax, numpy as np
        from repro.training.compression import make_compressed_allreduce
        x = np.load({str(tmp_path / "x.npy")!r})
        mesh = jax.make_mesh((8,), ("data",))
        out = make_compressed_allreduce(mesh, "data")({{"g": x}})["g"]
        np.save({str(tmp_path / "jax.npy")!r}, np.asarray(out))
        """)
    jax_run = subprocess.Popen([sys.executable, "-c", code], env=env,
                               stderr=subprocess.PIPE, text=True)
    try:
        ranks.run_group(8, [("compressed_allreduce", dict(x=x))],
                        str(tmp_path))
    finally:
        _, err = jax_run.communicate(timeout=120)
    assert jax_run.returncode == 0, err[-3000:]
    got = torch.load(tmp_path / "compressed.pt").numpy()
    want = np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == (1, 128)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    tol = np.abs(x).max() / 127.0 + 1e-6      # the reference's own bound
    assert np.abs(got[0] - x.mean(0)).max() <= tol


@pytest.mark.parametrize("arch,layers,stages,micro,batch", [
    ("granite-8b", 4, 4, 4, 8),
    ("gemma3-27b", 12, 2, 2, 4),       # 2 periods of 5 local + 1 global
])
def test_pipeline_forward_matches_jax(arch, layers, stages, micro, batch):
    """GPipe over a stage axis of CPU devices against JAX's plain forward
    on the same weights, within 1e-4."""
    torch.set_num_threads(2)
    jc = jsmoke(arch).replace(num_layers=layers, param_dtype=jnp.float32,
                              dtype=jnp.float32)
    params = JM.init_model(jax.random.PRNGKey(0), jc)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (batch, 32),
                                           0, jc.vocab_size))
    want, _ = jax.jit(lambda p, t: JM.forward(p, t, jc))(params, tokens)
    tcfg = tsmoke(arch).replace(num_layers=layers, dtype=torch.float32)
    model = bridge.params_from_numpy(_np_tree(params), tcfg, "cpu")
    mesh = make_local_mesh((stages,), ("stage",), ["cpu"] * stages)
    got = tpipe.pipeline_forward(mesh, "stage", model,
                                 torch.from_numpy(tokens).long(), tcfg,
                                 num_microbatches=micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert tpipe.bubble_fraction(stages, micro) == \
        (stages - 1) / (micro + stages - 1)
    with pytest.raises(ValueError):
        tpipe.pipeline_forward(mesh, "stage", model,
                               torch.from_numpy(tokens).long(), tcfg,
                               num_microbatches=3)


def test_sharded_step_and_pipeline_launches_on_the_cards_route(monkeypatch):
    """On a world of one gloo rank, with the card's route taken on the CPU
    (``test_torch_train_kernels._fake_card``), a sharded train step
    launches each kernel as often as ``chip_smoke.expected_train_launches``
    holds phases 3p and 15 to, and ``pipeline_forward`` as
    ``expected_pipeline_launches`` says."""
    import torch.distributed as dist

    import chip_smoke
    from test_torch_train_kernels import _fake_card
    from repro_torch.common.config import TrainConfig
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import placement
    from repro_torch.training import steps as S

    torch.set_num_threads(2)
    calls = {}
    _fake_card(monkeypatch, calls)
    cfg = tsmoke("qwen3-4b").replace(num_layers=4, d_model=128, head_dim=64,
                                     dtype=torch.float32)
    multihost.initialize(multihost.ClusterEnv("", 1, 0), device="cpu")
    try:
        mesh = make_host_mesh("cpu")
        state, _ = placement.place_by_specs(S.init_train_state(cfg, 0, "cpu"),
                                            mesh)
        batch = _batches(np.random.default_rng(3), cfg.vocab_size, b=2)[0]
        S.make_train_step(cfg, TrainConfig(), mesh=mesh)(state, batch)
    finally:
        dist.destroy_process_group()
    want = chip_smoke.expected_train_launches(cfg, cfg.remat)
    fwd = ("rmsnorm", "rmsnorm_pair", "add_rmsnorm")
    bwd = tuple(f"{k}_bwd" for k in fwd)
    got = {"flash_attention": calls["flash_attention"],
           "flash_attention_bwd": calls["flash_attention_bwd"],
           "rmsnorm": sum(calls.get(k, 0) for k in fwd),
           "rmsnorm_bwd": sum(calls.get(k, 0) for k in bwd)}
    assert got == {k: want[k] for k in got}

    calls.clear()
    model = TM.init_model(cfg, 0, "cpu")
    mesh = make_local_mesh((4,), ("stage",), ["cpu"] * 4)
    tokens = torch.randint(0, cfg.vocab_size, (8, 16))
    tpipe.pipeline_forward(mesh, "stage", model, tokens, cfg, 4)
    want = chip_smoke.expected_pipeline_launches(cfg, 4)
    assert calls["flash_attention"] == want["flash_attention"] == 16
    assert sum(calls.get(k, 0) for k in fwd) == want["rmsnorm"]
    assert not any(calls.get(k) for k in bwd + ("flash_attention_bwd",))


def test_bringup_on_one_cpu_rank(monkeypatch):
    """``multihost.bringup`` without a cluster's variables: a world of one
    gloo rank joined in-process, certification, the (1, 1) global mesh,
    and the host's heartbeat in the MP table."""
    import torch.distributed as dist

    from repro_torch.core.telemetry import MaintainProfileTable
    from repro_torch.launch import multihost

    for k in ("SLURM_NTASKS", "REPRO_NUM_PROCESSES", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    table = MaintainProfileTable()
    env, mesh, publisher = multihost.bringup(mp_table=table, device="cpu")
    try:
        assert (env.num_processes, env.process_id) == (1, 0)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert table.get("host0").profile.device_id == "host0"
        with pytest.raises(ValueError):
            multihost.global_mesh(dp=2, device="cpu")
    finally:
        publisher.stop()
        dist.destroy_process_group()


def test_sharded_train_loop_resumes_bit_for_bit(tmp_path):
    """``train_loop(mesh=...)`` on a world of one gloo rank, bf16 with f32
    masters: 4 straight steps equal 2, a checkpoint, a restore placed leaf
    by leaf (``reshard_leaf``) and 2 more, bit for bit; and equal to the
    unsharded ``train_loop``."""
    import torch.distributed as dist

    from repro_torch.common.config import TrainConfig
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.sharding.placement import local

    torch.set_num_threads(2)
    cfg = tsmoke("qwen3-4b").replace(dtype=torch.bfloat16)
    tc = TrainConfig(learning_rate=1e-3, total_steps=10, warmup_steps=2)
    kw = dict(global_batch=4, seq_len=32, log_every=0)
    ckpt = str(tmp_path / "ckpt")
    multihost.initialize(multihost.ClusterEnv("", 1, 0), device="cpu")
    try:
        mesh = make_host_mesh("cpu")
        straight = train_loop(cfg, tc, steps=4, mesh=mesh, **kw)
        train_loop(cfg, tc, steps=2, ckpt_dir=ckpt, mesh=mesh, **kw)
        resumed = train_loop(cfg, tc, steps=2, ckpt_dir=ckpt, resume=True,
                             mesh=mesh, log_fn=lambda *_: None, **kw)
    finally:
        dist.destroy_process_group()
    plain = train_loop(cfg, tc, steps=4, device="cpu", **kw)
    la = [h["loss"] for h in straight["history"]]
    assert [h["loss"] for h in resumed["history"]] == la[2:]
    assert [h["loss"] for h in plain["history"]] == la
    sa, sb = straight["state"], resumed["state"]
    for (name, a), b, c in zip(sa["model"].named_parameters(),
                               sb["model"].parameters(),
                               plain["state"]["model"].parameters()):
        assert torch.equal(local(a), local(b)), name
        assert torch.equal(local(a), c), name
    for part in ("master", "mu", "nu"):
        for name, t in sa["opt"][part].items():
            assert torch.equal(local(t), local(sb["opt"][part][name])), name
