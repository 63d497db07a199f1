"""The training cell's run: set-up, the measured window, and the check.

Set-up draws the weights on the card from the seed, builds the program's
train state (bf16 weights, f32 masters, AdamW) and its train step, and
drives that same state through its first ``FIRST`` steps with the
window's own feed, reading after step 1 each leaf's first gradient as the
optimizer got it (AdamW's first moment over 1 - beta1) and after the last
each leaf's change (the f32 master against the seed's weights).  The
window runs further steps, each ending in a synchronise, until
``--seconds`` have passed.  Then the peak memory is read, the state is
freed, and the reference follows the first steps (``check.trained``).
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Any, Dict

import torch

from portbench import harness, program
from portbench import weights as W
from portbench.traffic import batches

FIRST = 3                 # steps the reference follows
KERNELS = ("flash_attention", "rmsnorm", "flash_attention_bwd",
           "rmsnorm_bwd")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class Session:
    """The program's train state and step for one training cell."""

    def __init__(self, c: Dict[str, Any], feed: Dict[str, Any], seed: int,
                 device="cuda"):
        self.c, self.seed, self.device = c, seed, device
        self.feed = feed
        cfg = program.model_config(c)
        self.tc = program.train_config(c)
        if device == "cuda":
            program.build_kernels(KERNELS)
        model = program.build_model(c, cfg, seed, device)
        self.names = program.leaf_names(c, model)
        self.state = program.train_state(model, self.tc)
        self.step = program.train_step(cfg, self.tc)
        self.index = 0

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        tok = batches.batch(self.feed, self.c["vocab_size"], self.seed, i,
                            self.device)
        return {"tokens": tok, "labels": tok}

    def one(self):
        self.state, m = self.step(self.state, self.batch(self.index))
        self.index += 1
        if self.device == "cuda":
            torch.cuda.synchronize()
        return m

    @torch.no_grad()
    def first_steps(self) -> Dict[str, Any]:
        """The first ``FIRST`` steps, with the readings the check needs."""
        out: Dict[str, Any] = {"loss": [], "grad_norm": {}, "change": {}}
        opt = self.state["opt"]
        b1 = self.tc.beta1
        with torch.enable_grad():
            for i in range(FIRST):
                out["loss"].append(float(self.one()["loss"]))
                if i == 0:
                    out["grad_norm"] = {
                        k: float(opt["mu"][n].norm()) / (1 - b1)
                        for k, n in self.names.items()}
        params = dict(self.state["model"].named_parameters())
        for g, leaves in W.groups(self.c):
            init = W.draw_group(self.seed, g, leaves, self.device,
                                torch.float32)
            for k, v in init.items():
                n = self.names[f"{g}.{k}"]
                now = opt["master"].get(n, params[n]).float()
                out["change"][f"{g}.{k}"] = float(
                    (now.reshape(v.shape) - v).norm())
        return out

    def free(self) -> None:
        self.state = self.step = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


def run(cell: str, w: Dict[str, Any], c: Dict[str, Any], seed: int,
        seconds: float, trace: bool, t_start: float, device="cuda",
        hooks_cls=None, profile_s: float = 0.0):
    """One run; returns (Run, checks, correct, device dict)."""
    from portbench import check
    from portbench import trace as tr

    sess = Session(c, w["traffic"], seed, device)
    first = sess.first_steps()
    r = harness.Run(cell, w, c, "train")
    prof = None
    if trace:
        r.spans = tr.Spans()
        r.hooks = (hooks_cls or tr.Hooks)(r.spans)
        r.hooks.install_train()
        if device == "cuda":
            tr.Profile.warm()
            prof = tr.Profile()
    r.setup_s = time.perf_counter() - t_start
    log(f"set-up {r.setup_s:.2f} s; first losses {first['loss']}")
    losses = []
    t0 = time.perf_counter()
    r.window_ns = (time.time_ns(), 0)
    started = stopped = prof is None
    while True:
        el = time.perf_counter() - t0
        if not started and el >= (seconds - profile_s) / 2:
            prof.start(r.hooks)
            prof.begin()
            started = True
        elif started and not stopped and \
                (time.time_ns() - prof.t0) / 1e9 >= profile_s:
            stopped = prof.stop() or el + profile_s > seconds
            if not stopped:
                prof.start(r.hooks)
                prof.begin()
        t_step = time.time_ns()
        losses.append(sess.one()["loss"])
        if r.spans is not None:
            r.spans.add("train_step", t_step, time.time_ns())
        if time.perf_counter() - t0 >= seconds:
            break
    r.window_s = time.perf_counter() - t0
    r.window_ns = (r.window_ns[0], time.time_ns())
    if not stopped:
        prof.stop()
    if r.hooks is not None:
        r.hooks.remove()
    r.profile = prof
    r.steps = [{"loss": float(x)} for x in losses]
    r.attempted = len(losses)
    r.failed = sum(1 for s in r.steps if not math.isfinite(s["loss"]))
    log(f"window: {r.attempted} steps in {r.window_s:.3f} s, "
        f"{r.failed} not finite")
    dev = harness.device_info(1, prof) if device == "cuda" else {}
    feed = [sess.batch(i)["tokens"] for i in range(FIRST)]
    sess.free()
    checks, correct = check.trained(c, seed, first, feed, w["check"],
                                    device)
    return r, checks, correct, dev


def readings(w: Dict[str, Any], c: Dict[str, Any], seed: int,
             control: bool, device="cuda") -> Dict[str, Any]:
    """The compared numbers of one seed for the limits: the program's
    first steps against the reference, and with ``control`` the fp8
    reference and the reference on half of each batch (a planted fault)
    in the program's place."""
    from portbench import check
    from portbench.reference import train as ref
    sess = Session(c, w["traffic"], seed, device)
    first = sess.first_steps()
    feed = [sess.batch(i)["tokens"] for i in range(FIRST)]
    sess.free()
    want = ref.train_steps(c, c["train"], seed, feed, device)
    out = {"seed": seed, "program": check.train_gaps(first, want)}
    if control:
        low = ref.train_steps(c, c["train"], seed, feed, device, quant="fp8")
        out["control"] = check.train_gaps(low, want)
        half = ref.train_steps(c, c["train"], seed, feed, device,
                               rows=w["traffic"]["batch"] // 2)
        out["half_batch"] = check.train_gaps(half, want)
    return out
