"""``correct`` at a size a CPU test holds: each cell's run is correct, its
control (the reference in fp8 in the program's place) is not, and the
faults a cell can have, planted under the timed path, turn it false."""
import time

import numpy as np
import pytest
import torch

from portbench import check, harness, program, serve, train
from portbench.tests import _tiny

SEED = 2 ** 31 + 77
SERVE = ["mixtral-8x22b.chat"]


@pytest.fixture
def card():
    """Skip where there is no CUDA card (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the cell at its own size")


def _serve(cell, seconds=2.0):
    w = _tiny.workload(cell)
    c = _tiny.config(w["config"])
    r, checks, ok, _ = serve.run(cell, w, c, SEED, seconds, True,
                                 time.perf_counter(), device="cpu")
    return r, checks, ok


@pytest.mark.parametrize("cell", SERVE)
def test_serve_cell_is_correct(cell):
    r, checks, ok = _serve(cell)
    assert ok, checks
    assert r.failed == 0 and r.attempted > 0
    assert checks["served_tokens"]["value"] > 0
    spec = harness.load("workloads", cell)["check"]
    assert set(checks) == {"mean_logit_gap", "served_tokens"}
    assert {k for k in spec if k.endswith("_limit")} == \
        {"mean_logit_gap_limit"}


@pytest.mark.parametrize("cell", SERVE)
def test_a_token_altered_where_produced_is_not_correct(cell, monkeypatch):
    from repro_torch.serving.engine import Replica
    step = Replica._step

    def altered(rep, *a, **kw):
        return (step(rep, *a, **kw) + 7) % rep.cfg.vocab_size
    monkeypatch.setattr(Replica, "_step", altered)
    _, checks, ok = _serve(cell)
    assert not ok, checks


@pytest.mark.parametrize("cell", SERVE)
def test_serve_control_reads_past_the_program(cell):
    """The fp8 reference in the program's place reads several times the
    program's number on the same prompts and served tokens (a fixed set
    of requests, served together, so no window's timing picks them)."""
    from concurrent.futures import ThreadPoolExecutor
    w = _tiny.workload(cell)
    c = _tiny.config(w["config"])
    sess = serve.Session(c, SEED, "cpu")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, 256, int(n)).astype(np.int32)
               for n in (20, 45, 60, 80, 100, 120)]
    with ThreadPoolExecutor(len(prompts)) as ex:
        res = list(ex.map(lambda ip: sess.fleet.submit(program.request(
            ip[0], ip[1], 16, 1e6, 0.0)), enumerate(prompts)))
    sess.stop()
    sample = [(p, np.asarray(r.tokens)) for p, r in zip(prompts, res)]
    prog = check.mean_gap(check.logit_gaps(c, SEED, sample, "cpu"))
    ctrl = check.mean_gap(check.logit_gaps(c, SEED, sample, "cpu",
                                           quant="fp8"))
    assert ctrl > 3 * max(prog, 1e-4), (prog, ctrl)
    assert prog <= w["check"]["mean_logit_gap_limit"] < ctrl


def _train(monkeypatch=None, fault=None):
    w = _tiny.workload("qwen3-4b.train")
    c = _tiny.config("qwen3-4b")
    if fault is not None:
        make = program.train_step

        def faulty(cfg, tc):
            return fault(cfg, tc, make(cfg, tc))
        monkeypatch.setattr(program, "train_step", faulty)
    return train.run("qwen3-4b.train", w, c, SEED, 1.0, True,
                     time.perf_counter(), device="cpu")


def test_train_cell_is_correct():
    r, checks, ok, _ = _train()
    assert ok, checks
    assert r.attempted > 0 and r.failed == 0


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.training.steps import make_loss_fn

    def unchanged(cfg, tc, step):
        loss_fn = make_loss_fn(cfg, tc)

        def run(state, batch):
            with torch.no_grad():
                batch = {k: v for k, v in batch.items()}
                _, m = loss_fn(state["model"], batch)
            return state, m
        return run
    _, checks, ok, _ = _train(monkeypatch, unchanged)
    assert not ok, checks
    assert checks["grad_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    def half(cfg, tc, step):
        def run(state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(state, {k: v[:rows] for k, v in batch.items()})
        return run
    _, checks, ok, _ = _train(monkeypatch, half)
    assert not ok, checks


def test_train_control_reads_past_the_program():
    w = _tiny.workload("qwen3-4b.train")
    c = _tiny.config("qwen3-4b")
    got = train.readings(w, c, SEED, True, device="cpu")
    spec = w["check"]
    assert all(v <= spec[f"{k}_limit"] for k, v in got["program"].items())
    assert any(v > spec[f"{k}_limit"] for k, v in got["control"].items())
    assert any(v > spec[f"{k}_limit"] for k, v in got["half_batch"].items())


@pytest.mark.card
@pytest.mark.parametrize("cell", SERVE + ["qwen3-4b.train"])
def test_control_at_the_cells_size_on_the_card(cell, card):
    """The readings the limits are set from, at the cell's own size, on
    three seeds: the program within its limit, the control past it."""
    from portbench import limits
    w = harness.load("workloads", cell)
    c = harness.load("configs", w["config"])
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        if w["kind"] == "serve":
            got = limits.serve_readings(w, c, seed, 20.0, True)
            lim = w["check"]["mean_logit_gap_limit"]
            assert got["program"] <= lim < got["control"]
        else:
            got = train.readings(w, c, seed, True)
            spec = w["check"]
            assert all(v <= spec[f"{k}_limit"]
                       for k, v in got["program"].items())
            assert any(v > spec[f"{k}_limit"]
                       for k, v in got["control"].items())
