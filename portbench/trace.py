"""The traced run's instruments: spans the benchmark's own wrappers record
around the program's calls, the launches of its kernels with their
shapes, and one slice of the window under ``torch.profiler`` (CUPTI).
The profiler records the device's activity only (``ACTIVITIES``): the
CUDA runtime's launch calls come with it, and the host's operators, whose
recording slowed a host-paced step by a quarter, stay out.

Wrappers go in only with ``--trace 1``: ``Hooks.install`` replaces the
module attributes and methods the program calls through, and
``Hooks.remove`` puts them back.  Spans carry wall-clock nanoseconds
(``time.time_ns``, the profiler's own clock) and the calling thread, so a
device kernel is charged to the span its launch came from: the CUDA
runtime's launch event shares the kernel's correlation id.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

# kernel name fragment -> class (``chip_smoke._kernel_class``'s table)
KERNEL_CLASSES = (
    ("flash_bwd_", "flash_attention_bwd"), ("ncclDevKernel", "nccl"),
    ("ncclKernel", "nccl"), ("norm_bwd_kernel", "rmsnorm_bwd"),
    ("dscale_kernel", "rmsnorm_bwd"),
    ("paged_decode_tc_kernel", "paged_decode_attention"),
    ("paged_decode_f32_kernel", "paged_decode_attention"),
    ("decode_tc_kernel", "decode_attention"),
    ("decode_f32_kernel", "decode_attention"),
    ("flash_tc_kernel", "flash_attention"),
    ("flash_f32_kernel", "flash_attention"), ("combine_splits", "combine"),
    ("norm_group_kernel", "rmsnorm"), ("norm_block_kernel", "rmsnorm"),
    ("ssd_kernel", "ssd"), ("ssd_chunk_out_kernel", "ssd"),
    ("ssd_chunk_state_kernel", "ssd"), ("ssd_state_pass_kernel", "ssd"),
    ("rglru_one_tile_kernel", "rglru"), ("rglru_staged_kernel", "rglru"),
    ("ssd_bwd_", "ssd_bwd"), ("rglru_bwd_kernel", "rglru_bwd"))


# the least busy share of a slice that holds the device's work: every cell
# keeps the card busier (8% or more of a slice)
MIN_BUSY = 0.01


def kernel_class(name: str) -> str:
    for key, cls in KERNEL_CLASSES:
        if key in name:
            return cls
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


class Spans:
    """Closed spans (name, native thread id, start ns, end ns, info),
    appended from any thread."""

    def __init__(self):
        self.items: List[tuple] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int, info=None) -> None:
        with self._lock:
            self.items.append((name, threading.get_native_id(), t0, t1,
                               info or {}))

    def named(self, name: str, lo: int = 0, hi: int = 1 << 62) -> List[tuple]:
        """Spans called ``name`` that end within [lo, hi]."""
        return [s for s in self.items if s[0] == name and lo <= s[3] <= hi]


class Hooks:
    """The wrappers of one traced run.  ``recording`` limits the kernel
    launch records to the profiled slice; spans are kept all run."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.launches: List[dict] = []
        self.launches_delta: Dict[str, int] = {}
        self.recording = False
        self._saved: List[tuple] = []

    # -- install / remove -----------------------------------------------
    def _swap(self, owner, attr: str, fn) -> None:
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def remove(self) -> None:
        while self._saved:
            owner, attr, fn = self._saved.pop()
            setattr(owner, attr, fn)

    def install_serve(self) -> None:
        from repro_torch.serving.engine import Replica
        spans = self.spans
        decode, prefill = Replica._decode_step, Replica._advance_prefill

        def decode_step(rep, active):
            pos = [int(rep._idx[lane]) for lane in active]
            t0 = time.time_ns()
            try:
                return decode(rep, active)
            finally:
                spans.add("decode_step", t0, time.time_ns(),
                          {"replica": rep.name, "positions": pos})

        def advance_prefill(rep, job, occupancy=0):
            start, t0 = job.consumed, time.time_ns()
            first = job.lane_cache is None
            try:
                return prefill(rep, job, occupancy)
            finally:
                spans.add("prefill_chunk", t0, time.time_ns(),
                          {"replica": rep.name, "start": start,
                           "stop": job.consumed, "first": first,
                           "matched": job.matched})

        self._swap(Replica, "_decode_step", decode_step)
        self._swap(Replica, "_advance_prefill", advance_prefill)
        self._install_kernels()

    def install_train(self) -> None:
        from repro_torch.training import optimizer as opt
        spans, update = self.spans, opt.adamw_update

        def adamw_update(*a, **kw):
            t0 = time.time_ns()
            try:
                return update(*a, **kw)
            finally:
                spans.add("adamw_update", t0, time.time_ns())

        self._swap(opt, "adamw_update", adamw_update)
        self._install_kernels()

    def _install_kernels(self) -> None:
        """Record each launch of the attention kernels and the norm forms
        (its shapes, and copies of the position planes the counts need)
        while ``recording``."""
        from repro_torch.kernels import ops
        hooks = self

        def clone(t):
            return None if t is None else t.detach().clone()

        def wrap(name, make):
            fn = getattr(ops, name)

            def wrapped(*a, **kw):
                if hooks.recording:
                    rec = make(*a, **kw)
                    rec["op"] = name
                    rec["grad"] = torch.is_grad_enabled()
                    hooks.launches.append(rec)
                return fn(*a, **kw)
            self._swap(ops, name, wrapped)

        def flash(q, k, v, *, q_pos, k_pos, causal=True, window=0,
                  k_cache=None, cache_pos=None, **_):
            return dict(q=tuple(q.shape), k=tuple(k.shape),
                        hkv=k.shape[2], causal=causal, window=window,
                        q_pos=clone(q_pos), k_pos=clone(k_pos),
                        cache_pos=clone(cache_pos),
                        ring=None if k_cache is None else k_cache.shape[1])

        def decode(q, k_cache, v_cache, *, cache_len, pos=None, window=0,
                   **_):
            return dict(q=tuple(q.shape), hkv=k_cache.shape[2],
                        window=window, cache_len=clone(cache_len),
                        pos=clone(pos), n=k_cache.shape[1])

        def paged(q, k_pages, v_pages, pos_pages, tables, *, cache_len,
                  window=0, **_):
            return dict(q=tuple(q.shape), hkv=k_pages.shape[2],
                        window=window, cache_len=clone(cache_len),
                        tables=clone(tables), page=k_pages.shape[1])

        def norm(x, *a, **_):
            return dict(rows=x.numel() // x.shape[-1], width=x.shape[-1],
                        elt=x.element_size())

        def pair(q, k, *a, **_):
            return dict(rows=q.numel() // q.shape[-1] + k.numel()
                        // k.shape[-1], width=q.shape[-1],
                        elt=q.element_size())

        wrap("flash_attention", flash)
        wrap("decode_attention", decode)
        wrap("paged_decode_attention", paged)
        wrap("rmsnorm", norm)
        wrap("rmsnorm_pair", pair)
        wrap("add_rmsnorm", norm)


def _activities():
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA]


class Profile:
    """One slice of the window under the profiler, read back as device
    kernels and the launches they came from.  ``start`` turns the profiler
    on, ``begin`` and ``end`` bound the slice, and ``stop`` turns the
    profiler off (ending the slice if still open) and reads its events;
    ``recorded`` says whether the slice holds the device's work.  The
    profiler may run on either side of the slice: started while the card
    is idle it records every kernel, and handing its events back holds
    the interpreter for seconds, so a serving run stops it once the
    requests have drained."""

    def __init__(self):
        self.kernels: List[tuple] = []      # (name, start ns, end ns, corr)
        self.launch: Dict[int, tuple] = {}  # corr -> (thread id, start ns)
        self.t0 = self.t1 = 0
        self.recorded = False
        self._hooks: Optional[Hooks] = None

    @staticmethod
    def warm() -> None:
        """Start CUPTI once in set-up (its first start takes seconds)."""
        from torch.profiler import profile
        with profile(activities=_activities()):
            torch.ones(8, device="cuda").sum().item()

    def start(self, hooks: Optional[Hooks] = None) -> None:
        from torch.profiler import profile
        self.kernels, self.launch = [], {}
        self._hooks = hooks
        self._prof = profile(activities=_activities())
        self._prof.__enter__()

    def begin(self) -> None:
        """Open the slice: launches are recorded, kernels counted from
        now."""
        hooks = self._hooks
        if hooks is not None:
            from repro_torch.kernels import ops
            hooks.launches = []
            self._launches0 = ops.kernel_launches()
            hooks.recording = True
        self.t0, self.t1 = time.time_ns(), 0

    def end(self) -> None:
        """Close the slice: no more launch records, kernels counted up to
        now."""
        if self.t1:
            return
        self.t1 = time.time_ns()
        hooks = self._hooks
        if hooks is not None:
            from repro_torch.kernels import ops
            hooks.recording = False
            now = ops.kernel_launches()
            hooks.launches_delta = {k: now[k] - self._launches0[k]
                                    for k in now}

    def stop(self) -> bool:
        """End the slice and the profiler and read the events; whether the
        slice recorded the device's work (the profiler now and then
        returns a slice with no kernel, only copies: under ``MIN_BUSY`` of
        it busy)."""
        self.end()
        self._prof.__exit__(None, None, None)
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if self.t0 < e.end_ns() and e.start_ns() < self.t1:
                    self.kernels.append((e.name(), e.start_ns(), e.end_ns(),
                                         e.correlation_id()))
            elif e.correlation_id() and e.name().startswith("cu"):
                self.launch[e.correlation_id()] = (e.start_thread_id(),
                                                   e.start_ns())
        self._prof = None
        self.recorded = self.busy_s() >= MIN_BUSY * self.window_s()
        return self.recorded

    # -- reductions -------------------------------------------------------
    def in_slice(self) -> List[tuple]:
        """Kernels clipped to the slice."""
        out = []
        for n, s, e, c in self.kernels:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                out.append((n, s, e, c))
        return out

    def busy_intervals(self) -> List[List[int]]:
        ivs = sorted([s, e] for _, s, e, _ in self.in_slice())
        merged: List[List[int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for n, s, e, _ in self.in_slice():
            by[n] += (e - s) / 1e9
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def class_s(self, classes) -> float:
        return sum(e - s for n, s, e, _ in self.in_slice()
                   if kernel_class(n) in classes) / 1e9

    def charge(self, spans: Spans, names) -> Dict[str, float]:
        """Device seconds of the slice's kernels by the span (of ``names``)
        their launch came from: the span on the launching thread that held
        the launch time, or, where the thread ids do not match, the one
        span of any thread that held it."""
        by_thread: Dict[int, List[tuple]] = defaultdict(list)
        every: List[tuple] = []
        for s in spans.items:
            if s[0] in names and s[3] >= self.t0 and s[2] <= self.t1:
                by_thread[s[1]].append(s)
                every.append(s)
        out: Dict[str, float] = defaultdict(float)
        for n, s, e, c in self.in_slice():
            hit = self.launch.get(c)
            if hit is None:
                out["(no launch)"] += (e - s) / 1e9
                continue
            tid, ts = hit
            cand = [x for x in by_thread.get(tid, ()) if x[2] <= ts <= x[3]]
            if not cand:
                cand = [x for x in every if x[2] <= ts <= x[3]]
            out[cand[0][0] if len(cand) == 1 else
                ("(ambiguous)" if cand else "(no span)")] += (e - s) / 1e9
        return dict(out)

    def idle_gaps(self, spans: Spans, top: int = 10) -> List[list]:
        """Idle seconds of the slice by what the host was doing: the names
        of the benchmark's spans open across the middle of each gap."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        by: Dict[str, float] = defaultdict(float)
        items = [s for s in spans.items
                 if s[3] >= self.t0 and s[2] <= self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            open_ = sorted({s[0] for s in items if s[2] <= mid <= s[3]})
            by[" + ".join(open_) or "no span open"] += (b - a) / 1e9
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]
