"""The rank side of ``test_torch_distributed.py``: what each spawned gloo
rank runs.  It imports the port only (no JAX), so a rank starts quickly;
the test holds what the ranks write against the JAX package.

``run_group`` starts ``world`` ranks with the ``spawn`` method over a
``FileStore`` (no TCP port to collide under pytest-xdist), each joining
through ``launch.multihost.initialize(device="cpu")`` with a 60 s
collective timeout, and kills them all if they have not finished within
the group's timeout.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback

import numpy as np
import torch

STEPS = 3


def run_group(world: int, tasks, workdir: str, timeout_s: float = 120.0):
    """Run ``tasks`` (a list of (name, kwargs)) on ``world`` ranks; raise
    AssertionError with the ranks' tracebacks on failure or expiry."""
    ctx = mp.get_context("spawn")
    store = os.path.join(workdir, f"store{world}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, tasks, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errors = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung or errors or any(p.exitcode for p in procs):
        raise AssertionError(
            f"ranks {hung} still running after {timeout_s} s; exit codes "
            f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))


def _rank_main(rank, world, store_path, tasks, workdir):
    import torch.distributed as dist

    from repro_torch.launch import multihost

    torch.set_num_threads(1)
    try:
        env = multihost.ClusterEnv("", world, rank)
        multihost.initialize(env, device="cpu",
                             store=dist.FileStore(store_path, world),
                             timeout_s=60.0)
        for name, kw in tasks:
            TASKS[name](rank, workdir, **kw)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:                                 # noqa: BLE001
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _save(workdir, name, obj, rank):
    if rank == 0:
        torch.save(obj, os.path.join(workdir, f"{name}.pt"))


def _model(cfg, jparams):
    from repro_torch import bridge
    return bridge.params_from_numpy(jparams, cfg, "cpu")


def sharded_steps(rank, workdir, *, out, arch, shape, tc_kw, jparams,
                  batches, ckpt=None):
    """``STEPS`` sharded train steps of the smoke ``arch`` (f32) from the
    bridged weights on the mesh ``make_mesh(*shape)`` ((dp, tp) or (dp,
    tp, pods)); rank 0 writes every step's metrics
    and the parameters after the last, gathered (and with ``ckpt`` saves
    the checkpoint there)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh, parallel_config_for
    from repro_torch.sharding import placement
    from repro_torch.training import steps as S

    mesh = make_mesh(*shape, device="cpu")
    pc = parallel_config_for(mesh)
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    tc = TrainConfig(**tc_kw)
    state = S.train_state(_model(cfg, jparams), tc)
    state, _ = placement.place_by_specs(state, mesh)
    step = S.make_train_step(cfg, tc, num_groups=pc.data_ways, mesh=mesh)
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    tree = S.checkpoint_tree(state)
    _save(workdir, out, {"metrics": metrics, "tree": tree}, rank)
    if ckpt and rank == 0:
        CheckpointManager(ckpt).save(STEPS, tree)


def restore_rescaled(rank, workdir, *, ckpt, saved, old, meshes):
    """Restore the checkpoint at ``ckpt`` onto the mesh ``plan_rescale``
    plans from ``old`` = (dp, tp) for this world, and onto each of
    ``meshes``, through ``reshard_state``: each leaf's shard of the size its
    placement says, and the gathered tree bit-equal to the one saved."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.config import ParallelConfig
    from repro_torch.common.tree import tree_paths
    from repro_torch.ft.elastic import plan_rescale, reshard_state
    from repro_torch.launch.mesh import make_mesh, parallel_config_for
    from repro_torch.sharding import specs as sp

    saved_tree = torch.load(os.path.join(workdir, f"{saved}.pt"))["tree"]
    want = dict(tree_paths(saved_tree))
    plan = plan_rescale(ParallelConfig(dp=old[0], tp=old[1]),
                        available_devices=dist.get_world_size())
    mgr = CheckpointManager(ckpt)
    tree = mgr.restore(mgr.latest_step(), saved_tree)
    for shape in [(plan.new_dp, plan.new_tp)] + list(meshes):
        mesh = make_mesh(*shape, device="cpu")
        sizes = sp.axis_sizes(mesh)
        specs = dict(tree_paths(sp.state_specs(tree, mesh,
                                               parallel_config_for(mesh))))
        placed = reshard_state(tree, mesh, specs.__getitem__)
        for path, dt in tree_paths(placed):
            assert torch.equal(dt.full_tensor(), want[path]), (shape, path)
            local = list(want[path].shape)
            for d, entry in enumerate(specs[path]):
                for a in () if entry is None else (
                        entry if isinstance(entry, tuple) else (entry,)):
                    local[d] //= sizes[a]
            assert list(dt.to_local().shape) == local, (shape, path)
    _save(workdir, "restored", {"plan": (plan.new_dp, plan.new_tp)}, rank)


def checkpoint_leaf_by_leaf(rank, workdir, *, arch, shape):
    """``checkpoint_tree`` of the smoke ``arch``'s state placed on
    ``make_mesh(*shape)``, with ``DTensor.full_tensor`` watched: when a leaf
    is gathered, no whole leaf gathered before it is still alive on this
    rank.  Rank 0's tree is on the host, bit-equal to the state before it
    was placed; the other ranks get ``None``."""
    import weakref

    from torch.distributed.tensor import DTensor

    from repro_torch.common.tree import tree_paths
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import placement
    from repro_torch.training import steps as S

    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    state = S.init_train_state(cfg, 0, "cpu")
    want = {p: t.detach().clone()
            for p, t in tree_paths(S.checkpoint_tree(state))}
    state, _ = placement.place_by_specs(state, make_mesh(*shape,
                                                         device="cpu"))
    full_tensor, alive, held = DTensor.full_tensor, [], []

    def watched(self, *args, **kw):
        held.append(sum(r() is not None for r in alive))
        out = full_tensor(self, *args, **kw)
        # a replicated leaf's whole tensor may be its own shard: not a copy
        shard = self.to_local().untyped_storage().data_ptr()
        if out.untyped_storage().data_ptr() != shard:
            alive.append(weakref.ref(out))
        return out

    DTensor.full_tensor = watched
    try:
        tree = S.checkpoint_tree(state)
    finally:
        DTensor.full_tensor = full_tensor
    assert len(held) == len(want), (len(held), len(want))
    assert max(held) == 0, held
    assert len(alive) > 0.5 * len(want), len(alive)    # most leaves sharded
    if rank:
        assert tree is None
        return
    got = dict(tree_paths(tree))
    assert set(got) == set(want)
    for path, t in got.items():
        assert t.device.type == "cpu" and torch.equal(t, want[path]), path
    _save(workdir, "leaf_by_leaf", {"leaves": len(got),
                                    "gathered": len(alive)}, rank)


def compressed_allreduce(rank, workdir, *, x):
    """``make_compressed_allreduce`` over "data" of an (8, 1) mesh, each
    rank holding row ``rank`` of ``x``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.compression import make_compressed_allreduce

    world = x.shape[0]
    mesh = make_mesh(world, 1, device="cpu")
    fn = make_compressed_allreduce(mesh, "data")
    out = fn({"g": torch.from_numpy(np.asarray(x[rank:rank + 1]))})["g"]
    allout = [torch.empty_like(out) for _ in range(world)]
    torch.distributed.all_gather(allout, out)
    for o in allout:                     # the same on every rank
        assert torch.equal(o, out)
    _save(workdir, "compressed", out, rank)


def dryrun_real(rank, workdir, *, out, arch, shape, kind, batch, seq):
    """One real step of the smoke ``arch`` on ``make_mesh(*shape)``, the
    dry run's counterpart: the train step (``kind`` "train") or the
    prefill forward ("prefill") of ``launch.dryrun.build_cell``, from
    seeded weights placed by the specs and a seeded batch of the dry run's
    input shapes and dtypes, under ``dryrun.Trace``.  Rank 0 writes the
    counted flops, collectives and peak bytes and, summed here leaf by
    leaf, the bytes of its local shards and of its rows of the batch."""
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.common.tree import tree_paths
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, parallel_config_for
    from repro_torch.sharding import placement
    from repro_torch.training import steps as S

    mesh = make_mesh(*shape, device="cpu")
    pc = parallel_config_for(mesh)
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    data = {}
    for k, t in dryrun.input_specs(cfg, ShapeConfig(out, kind, seq,
                                                    batch)).items():
        if t.dtype == torch.int32:
            data[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                    dtype=torch.int32)
        else:
            data[k] = torch.rand(t.shape, generator=gen).to(t.dtype)
    tc = TrainConfig(total_steps=1000)
    state, _ = placement.place_by_specs(S.init_train_state(cfg, 0, "cpu", tc),
                                        mesh)
    if kind == "train":
        fn = S.make_train_step(cfg, tc, num_groups=pc.data_ways, mesh=mesh)
        args = (state, data)
        tree = placement.state_tree(state)
    else:
        del data["labels"], data["mask"]
        fn = dryrun.make_prefill_step(cfg, mesh, pc.data_ways)
        args = (state["model"], data)
        tree = dict(state["model"].named_parameters())
    rows = batch // pc.data_ways          # rank 0: the first rows
    resident = [placement.local(t) for _, t in tree_paths(tree)] + \
        [t[:rows] for t in data.values()]
    with dryrun.Trace(resident) as tr:
        fn(*args)
    _save(workdir, out, {"flops": tr.flops,
                         "collective_bytes": dryrun.collective_bytes(tr.calls),
                         "argument_bytes": sum(t.nbytes for t in resident),
                         "peak_bytes": tr.peak}, rank)


TASKS = {"sharded_steps": sharded_steps, "restore_rescaled": restore_rescaled,
         "checkpoint_leaf_by_leaf": checkpoint_leaf_by_leaf,
         "compressed_allreduce": compressed_allreduce,
         "dryrun_real": dryrun_real}
