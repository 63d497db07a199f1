"""A serving cell's run: set-up, the measured window, and the check.

Set-up draws the weights on the card, builds the replicas (each warms
every path and measures its step curve, the program's own start), serves
the traffic's warm-up requests, and in a traced run starts the profiler
once, while the card is idle.  The window drives ``ServingFleet.submit``
with the cell's open-loop traffic for ``--seconds``: each request is sent
at its due time and timed from then.  A traced run's slice opens
``FILL_S`` into the window, once the lanes have filled; the profiler runs
from before the window until the requests have drained, since handing
its events back mid-window stalled the replicas for seconds.  When the window
closes no request is sent; the ones in flight are waited for, at most
``DRAIN_S`` seconds.  Then the fleet stops, the peak memory is read, the
program's state is freed, and the reference judges a sample of the
finished requests (``check.served``).
"""
from __future__ import annotations

import gc
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from portbench import check, harness, program
from portbench.traffic import requests as traffic

DRAIN_S = 60.0
# seconds into the window at which a traced run's slice opens: a median
# chat request lives ~5 s (its prefill, then 128 tokens at ~35 ms), so by
# then the lanes hold what they hold all window
FILL_S = 12.0


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Outcome:
    ask: Any
    result: Any = None            # RequestResult
    start_ms: float = 0.0         # due time, monotonic
    done: bool = False            # returned
    counted: bool = False         # returned before the drain ended

    @property
    def ok(self) -> bool:
        return self.counted and self.result.ok \
            and len(self.result.tokens) == self.ask.max_new_tokens


def kernels_for(c: Dict[str, Any]):
    s = c["serve"]
    decode = "paged_decode_attention" if s.get("paged") else \
        "decode_attention"
    return ["flash_attention", "rmsnorm", decode]


def _submit(fleet, ask, created_ms: float):
    req = program.request(ask.index, ask.prompt, ask.max_new_tokens,
                          ask.deadline_ms, created_ms)
    return fleet.submit(req)


def warm(fleet, asks) -> None:
    """Serve the warm-up requests, all at once, and wait for them."""
    if not asks:
        return
    with ThreadPoolExecutor(max_workers=len(asks)) as ex:
        futs = [ex.submit(_submit, fleet, a, time.monotonic() * 1e3)
                for a in asks]
        for f in futs:
            r = f.result()
            if not r.ok:
                raise harness.BenchError(f"warm-up request failed: {r.error}")


def open_loop(fleet, gen, seconds: float, t0: float, pool) -> List[Outcome]:
    """Send each request at its due time; TTFT counts from then."""
    outs = [Outcome(a) for a in gen.asks]
    futs = []
    late = 0.0

    def one(o: Outcome):
        o.result = _submit(fleet, o.ask, o.start_ms)
        o.done = True

    for o in outs:
        due = t0 + o.ask.due_s
        now = time.monotonic()
        if due > now:
            time.sleep(due - now)
        else:
            late = max(late, now - due)
        o.start_ms = due * 1e3
        futs.append(pool.submit(one, o))
    gen.late_s = late
    return outs, futs


class Session:
    """The program under test for one serving cell: the model with the
    seed's weights and the fleet of replicas over it."""

    def __init__(self, c: Dict[str, Any], seed: int, device="cuda"):
        self.c, self.seed, self.device = c, seed, device
        self.cfg = program.model_config(c)
        if device == "cuda":
            program.build_kernels(kernels_for(c))
        self.model = program.build_model(c, self.cfg, seed, device)
        self.fleet = program.build_fleet(c, self.cfg, self.model)

    def window(self, gen, seconds: float, r: harness.Run, prof=None,
               profile_s: float = 0.0) -> None:
        """Drive ``gen``'s traffic for ``seconds``, then drain; fills ``r``
        with the outcomes and the counters' deltas."""
        fleet = self.fleet
        c0, s0 = program.counters(fleet), dict(fleet.stats)
        pool = ThreadPoolExecutor(max_workers=512)
        t0 = time.monotonic()
        close = t0 + seconds
        r.window_ns = (time.time_ns(), time.time_ns() + int(seconds * 1e9))
        holder: Dict[str, Any] = {}
        th = threading.Thread(target=lambda: holder.update(
            zip(("outs", "futs"), open_loop(fleet, gen, seconds, t0, pool))))
        th.start()
        if prof is not None:
            at = min(FILL_S, max(0.0, (seconds - profile_s) / 2))
            time.sleep(max(0.0, t0 + at - time.monotonic()))
            prof.begin()
            time.sleep(profile_s)
            prof.end()
        time.sleep(max(0.0, close - time.monotonic()))
        c_close = program.counters(fleet)
        th.join()
        outs, futs = holder["outs"], holder["futs"]
        wait(futs, timeout=max(0.0, close + DRAIN_S - time.monotonic()))
        end = time.monotonic()
        for o in outs:
            o.counted = o.done
        c_end = program.counters(fleet)
        r.pool = pool
        r.window_s = seconds
        r.close_ms, r.drain_end_ms = close * 1e3, end * 1e3
        r.outcomes = [o for o in outs if o.start_ms < close * 1e3]
        r.counters = {k: c_close[k] - c0[k] for k in c0}
        r.counters_drained = {k: c_end[k] - c0[k] for k in c0}
        r.placements = {k: fleet.stats.get(k, 0) - s0.get(k, 0)
                        for k in fleet.stats}
        r.profile = prof
        r.attempted = len(r.outcomes)
        r.failed = sum(1 for o in r.outcomes if not o.ok)
        log(f"open loop: {len(r.outcomes)} due, generator at most "
            f"{gen.late_s * 1e3:.1f} ms late")
        log(f"window: {r.attempted} requests, {r.failed} not ok; counters "
            f"{r.counters}; placements {r.placements}")

    def stop(self, r: Optional[harness.Run] = None) -> None:
        """Stop the fleet (callers still waiting get what they have) and
        free the program's state."""
        self.fleet.stop()
        if r is not None and getattr(r, "pool", None) is not None:
            r.pool.shutdown(wait=True)
            r.pool = None
        self.fleet = self.model = None
        gc.collect()
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()


def run(cell: str, w: Dict[str, Any], c: Dict[str, Any], seed: int,
        seconds: float, trace: bool, t_start: float, device="cuda",
        hooks_cls=None, profile_s: float = 0.0):
    """One run; returns (Run, checks, correct, device dict)."""
    from portbench import trace as tr

    sess = Session(c, seed, device)
    gen = traffic.make(w["traffic"], c["vocab_size"], seed, seconds)
    warm(sess.fleet, gen.warm)
    r = harness.Run(cell, w, c, "serve")
    prof = None
    if trace:
        r.spans = tr.Spans()
        r.hooks = (hooks_cls or tr.Hooks)(r.spans)
        r.hooks.install_serve()
        if device == "cuda":
            tr.Profile.warm()
            prof = tr.Profile()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    r.setup_s = time.perf_counter() - t_start
    log(f"set-up {r.setup_s:.2f} s")
    if prof is not None:
        prof.start(r.hooks)
    sess.window(gen, seconds, r, prof, profile_s)
    if prof is not None:
        prof.stop()
    dev = harness.device_info(1, prof) if device == "cuda" else {}
    sess.stop(r)
    if r.hooks is not None:
        r.hooks.remove()
    sample = check.serve_sample(r.outcomes, seed, w["check"])
    checks, correct = check.served(c, seed, sample, w["check"], device)
    return r, checks, correct, dev
