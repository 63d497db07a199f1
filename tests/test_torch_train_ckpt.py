"""The port's checkpoint manager and training launcher on the CPU: the
JAX package's checkpoint tests (``tests/test_checkpoint_ft.py``) and
training-loop tests (``tests/test_training.py``) run on the port.

The reference's ``test_train_resume_bitexact`` and
``test_loss_decreases_end_to_end`` fail on its host mesh, so resume is held
port against port: 6 straight steps against 3 steps, a checkpoint, a
restore and 3 more, bit for bit, with bf16 weights and f32 masters (the
checkpoint holds the masters; restore rebuilds the bf16 copies).
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.ft.monitor import StragglerMonitor
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import train_loop


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "layers": {"0": {"a": torch.ones(3)},
                                  "1": {"a": torch.zeros(3)}}},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


# ----------------------------------------------------------------- checkpoint
def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(10, st)
    back = mgr.restore(10, _state(1))
    for (pa, a), (pb, b) in zip(_leaves(st), _leaves(back)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, _state(1))
    mgr.save_async(2, _state(2))
    mgr.wait()
    assert mgr.latest_step() == 2
    assert torch.equal(mgr.restore(2, _state())["params"]["w"],
                       _state(2)["params"]["w"])


def test_async_save_snapshots_before_returning(tmp_path):
    """The state may change at once: the save holds its values at the
    call."""
    mgr = CheckpointManager(str(tmp_path))
    st = _state(3)
    want = st["params"]["w"].clone()
    mgr.save_async(1, st)
    st["params"]["w"].add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore(1, _state())["params"]["w"], want)


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]


def test_interrupted_write_never_corrupts(tmp_path):
    """A killed writer leaves its ``.tmp`` directory: it does not shadow
    the last good step, which restores."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state(5))
    os.makedirs(str(tmp_path / "step_000000009.tmp0"))
    assert mgr.latest_step() == 5
    back = mgr.restore(5, _state())
    assert torch.equal(back["params"]["w"], _state(5)["params"]["w"])
    assert mgr.restore_latest(_state())[0] == 5


def test_killed_writer_leaves_tmp_and_previous_step_loads(tmp_path,
                                                          monkeypatch):
    """A writer that dies after its shard, before the publish: its
    ``.tmp`` directory stays, no step appears, and the previous one
    restores."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state(5))

    def killed(src, dst):
        raise KeyboardInterrupt("killed before publishing")
    monkeypatch.setattr(os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(6, _state(6))
    monkeypatch.undo()
    assert os.path.isdir(str(tmp_path / "step_000000006.tmp0"))
    assert mgr.all_steps() == [5]
    assert torch.equal(mgr.restore(5, _state())["params"]["w"],
                       _state(5)["params"]["w"])


def test_restore_missing_key_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2)})
    with pytest.raises(KeyError):
        mgr.restore(1, {"a": torch.ones(2), "b": torch.ones(2)})


def test_bf16_leaf_is_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="master"):
        mgr.save(1, {"w": torch.ones(2, dtype=torch.bfloat16)})
    assert mgr.latest_step() is None


# ------------------------------------------------------------------- launcher
def _params(out):
    return {n: p.detach().clone()
            for n, p in out["state"]["model"].named_parameters()}


def test_train_resume_bitexact(tmp_path):
    """6 straight steps == 3 steps + checkpoint + restore + 3 steps, bit for
    bit: the bf16 parameters, their f32 masters, the moments and the
    losses."""
    torch.set_num_threads(2)
    cfg = get_smoke_config("qwen3-4b")            # bf16 weights, f32 masters
    assert cfg.dtype == torch.bfloat16
    tc = TrainConfig(learning_rate=1e-3, total_steps=6, warmup_steps=2)
    kw = dict(global_batch=2, seq_len=32, log_every=0, device="cpu")
    straight = train_loop(cfg, tc, steps=6, **kw)
    d = str(tmp_path / "a")
    first = train_loop(cfg, tc, steps=3, ckpt_dir=d, **kw)
    logs = []
    resumed = train_loop(cfg, tc, steps=3, ckpt_dir=d, resume=True,
                         log_fn=logs.append, **kw)
    assert logs == ["resumed from step 3"]
    assert [h["step"] for h in resumed["history"]] == [4, 5, 6]
    assert [h["loss"] for h in first["history"] + resumed["history"]] == \
        [h["loss"] for h in straight["history"]]
    a, b = _params(straight), _params(resumed)
    for name in a:
        assert a[name].dtype == b[name].dtype and torch.equal(a[name],
                                                              b[name]), name
    sa, sb = straight["state"]["opt"], resumed["state"]["opt"]
    assert sa["master"] and int(sa["step"]) == int(sb["step"]) == 6
    for part in ("master", "mu", "nu"):
        for name, t in sa[part].items():
            assert torch.equal(t, sb[part][name]), (part, name)
    assert CheckpointManager(d).latest_step() == 6


def test_loss_decreases_end_to_end():
    torch.set_num_threads(2)
    cfg = get_smoke_config("qwen3-4b")
    tc = TrainConfig(learning_rate=1e-3, total_steps=60, warmup_steps=5,
                     schedule="cosine")
    mon = StragglerMonitor()
    out = train_loop(cfg, tc, global_batch=4, seq_len=64, steps=60,
                     log_every=0, device="cpu", monitor=mon)
    first = np.mean([h["loss"] for h in out["history"][:5]])
    last = np.mean([h["loss"] for h in out["history"][-5:]])
    assert last < first - 0.15, (first, last)
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert list(mon.stats) == ["host0"] and mon.stats["host0"].count == 60


def test_train_loop_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(get_smoke_config("qwen3-4b"), TrainConfig(),
                   global_batch=2, seq_len=8, steps=1)


def test_train_cli_smoke(capsys):
    """``python -m repro_torch.launch.train --arch qwen3-4b --smoke --device
    cpu --steps 20``, in this process as the serve CLI's tests run it."""
    torch.set_num_threads(2)
    train_cli.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                    "--steps", "20"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("done: 20 steps"), lines
    assert sum(line.startswith("step ") for line in lines) == 2
