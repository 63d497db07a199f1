#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port only and imports nothing of JAX or of the JAX package.
Phases (any failure exits non-zero; nothing is caught and turned into
success):

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
   builds the CUDA kernels from the checkout's sources (one nvcc per
   source, all at once);
2. kernels against their plain versions, on the card, at main-path shapes
   in bf16 and f32, then timings (kernel, plain version, one PyTorch
   library call as a yardstick) beside each kernel's bound;
3. identity: qwen3-4b at full width, depth cut to 4 layers, in f32 with
   TF32 off, serves 3 greedy prompts through a ``ServingFleet``; every
   stream must equal the replica's ``generate_sequential`` and the port's
   plain path on the CPU, and the last-step logits must agree;
4. serve: qwen3-4b at full config (36 layers, d_model 2560, vocab 151936,
   bf16), 2 replicas sharing weights, 8 slots, capacity 2048, DDS; 12
   requests (one sampled) must all come back ``ok``, and the launch
   counters must prove every kernel ran on that path, as often as the
   engine's own step and chunk counters say.

Standard output ends with the JSON ``{"kernels": ...}`` summary, the card
line, and ``{"ok": true, "device": {...}}`` as the last line.
``--details PATH`` also writes every measurement (step profiles, nvcc's
register and shared-memory report) to PATH as JSON.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

SEED = 0
DETAILS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def host_ms(fn, iters: int = 20, flush=None) -> float:
    """Median time of one call of ``fn`` between CUDA events recorded
    around it, the L2 cache flushed before each call.  The device idles
    until the host has issued the launch, so this includes the host's
    launch overhead, not only the kernel."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_events(fn, skip=frozenset()):
    """Device-side events (kernels, copies) of one profiled run of ``fn``
    (CUPTI through ``torch.profiler``), as (name, duration_us) pairs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name not in skip]


def device_ms(fn, flush, iters: int = 20) -> float:
    """Device time of one call of ``fn``: the summed durations of the
    kernels it launches, from the profiler, with the L2 cache flushed
    before each call (the main path finds these operands cold, other
    layers having run in between).  The flush's own kernel is excluded."""
    for _ in range(3):
        fn()
    skip = frozenset(n for n, _ in device_events(flush.zero_))

    def run():
        for _ in range(iters):
            flush.zero_()
            fn()

    evs = device_events(run, skip)
    if not evs:
        raise RuntimeError("the profiler recorded no device time")
    return sum(d for _, d in evs) / iters / 1e3


def timed(fn, flush) -> dict:
    return {"ms": device_ms(fn, flush), "host_ms": host_ms(fn, flush=flush)}


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- phase 2 data
def ring_positions(rng, b, n, lens, holes=0.0):
    """(B, n) int32 ring pos planes as a ring of depth n holds them after
    writing positions 0..len-1 at slot p % n; a share ``holes`` of slots is
    then marked empty (-1)."""
    import numpy as np
    pos = np.full((b, n), -1, np.int64)
    for i, ln in enumerate(lens):
        p = np.arange(max(0, ln - n), ln)
        pos[i, p % n] = p
    if holes:
        pos[rng.random((b, n)) < holes] = -1
    return pos.astype(np.int32)


def check_kernels(dev):
    """Phase 2: every kernel against its plain version on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk

    rng = np.random.default_rng(SEED)
    hq, hkv, d = 32, 8, 128
    scale = d ** -0.5
    # Tolerances.  f32: kernel and plain version compute the same f32 math
    # in another order, so 2e-5 absolute (outputs are O(1)).  bf16: the
    # output is rounded once to bf16 (2^-8 relative) and the plain decode
    # path also rounds its probabilities to bf16 before P.V, so 2e-2
    # absolute; RMSNorm outputs reach several units, so there two bf16
    # roundings of the largest |reference| (2^-7 relative).
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    results = {"decode_attention": [], "flash_attention": [], "rmsnorm": []}

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    def record(name, case, got, exp, dtype, lanes=None):
        if lanes is not None:
            got, exp = got[lanes], exp[lanes]
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {case}: non-finite output")
        err = (got.float() - exp.float()).abs().max().item()
        lim = tol[dtype]
        if name == "rmsnorm" and dtype == torch.bfloat16:
            lim = 2.0 ** -7 * max(1.0, exp.float().abs().max().item())
        log(f"  {name:16s} {case:56s} {str(dtype)[6:]:8s} "
            f"max|err| {err:.3e}  tol {lim:.1e}")
        if not err <= lim:
            raise AssertionError(f"{name} {case} {dtype}: {err} > {lim}")
        results[name].append(err)

    # decode: B=8, ragged cache_len in 1..2048, with and without pos,
    # window 0 and 16; plus a wrapped ring (cache_len up to 2n) with holes
    b, n = 8, 2048
    lens = np.concatenate([[1, 2048], rng.integers(1, 2049, size=b - 2)])
    wrapped = rng.integers(n // 2, 2 * n, size=b)
    for dtype in (torch.bfloat16, torch.float32):
        q = t(rng.standard_normal((b, 1, hq, d)), dtype)
        kc = t(rng.standard_normal((b, n, hkv, d)), dtype)
        vc = t(rng.standard_normal((b, n, hkv, d)), dtype)
        for window in (0, 16):
            for use_pos, ls, holes in ((False, lens, 0.0), (True, lens, 0.0),
                                       (True, wrapped, 0.1)):
                cl = torch.as_tensor(ls, dtype=torch.int32, device=dev)
                pos = (torch.from_numpy(ring_positions(rng, b, n, ls, holes))
                       .to(dev) if use_pos else None)
                kw = dict(cache_len=cl, pos=pos, window=window, scale=scale)
                exp = dk.decode_attention_plain(q, kc, vc, **kw)
                # a lane with no visible slot is discarded by the engine:
                # compare lanes with at least one
                if pos is None:
                    lanes = torch.ones(b, dtype=torch.bool, device=dev)
                else:
                    vis = (pos >= 0) & (pos < cl[:, None])
                    if window:
                        vis &= pos > cl[:, None] - 1 - window
                    lanes = vis.any(1)
                case = (f"B8 n2048 {'pos' if use_pos else 'len'} w{window}"
                        f"{' wrapped+holes' if holes else ''}")
                # the auto split count (flash-decoding + combine) and the
                # single pass
                for splits in (None, 1):
                    got = dk.decode_attention(q, kc, vc, splits=splits, **kw)
                    record("decode_attention",
                           f"{case} splits={splits or 'auto'}", got, exp,
                           dtype, lanes)

    # flash: whole prompt S=512, and a 32-token chunk over a 2048-slot ring
    s = 512
    c, start_full, start_part = 32, 2500, 700
    for dtype in (torch.bfloat16, torch.float32):
        q = t(rng.standard_normal((1, s, hq, d)), dtype)
        k = t(rng.standard_normal((1, s, hkv, d)), dtype)
        v = t(rng.standard_normal((1, s, hkv, d)), dtype)
        ar = torch.arange(s, dtype=torch.int32, device=dev)
        for window, cap in ((0, 0.0), (16, 0.0), (0, 30.0)):
            kw = dict(q_pos=ar, k_pos=ar, causal=True, window=window,
                      scale=scale, softcap=cap)
            record("flash_attention", f"prompt S512 w{window} cap{cap:g}",
                   fk.flash_attention(q, k, v, **kw),
                   fk.flash_attention_plain(q, k, v, **kw), dtype)
        qc = t(rng.standard_normal((1, c, hq, d)), dtype)
        kc = t(rng.standard_normal((1, n + c, hkv, d)), dtype)
        vc = t(rng.standard_normal((1, n + c, hkv, d)), dtype)
        for start in (start_full, start_part):
            ring = ring_positions(rng, 1, n, [start])
            qp = torch.arange(start, start + c, dtype=torch.int32, device=dev)
            kp = torch.cat([torch.from_numpy(ring).to(dev), qp[None]], 1)
            for window in (0, 16):
                kw = dict(q_pos=qp, k_pos=kp, causal=True, window=window,
                          scale=scale)
                exp = fk.flash_attention_plain(qc, kc, vc, **kw)
                for splits in (None, 1):
                    record("flash_attention",
                           f"chunk C32 ring2048 start{start} w{window} "
                           f"splits={splits or 'auto'}",
                           fk.flash_attention(qc, kc, vc, splits=splits, **kw),
                           exp, dtype)

    # rmsnorm: 8 x 2560 (d_model) and 8 x 32 x 128 (headwise qk-norm)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((8, 2560), (8, 32, 128)):
            x = t(rng.standard_normal(shape), dtype)
            sc = t(0.5 * rng.standard_normal(shape[-1]), torch.float32)
            record("rmsnorm", "x" + "x".join(map(str, shape)),
                   rk.rmsnorm(x, sc, 1e-6), rk.rmsnorm_plain(x, sc, 1e-6),
                   dtype)
    return {k: max(v) for k, v in results.items()}


def time_kernels(dev):
    """Kernel, plain and library times at the shapes the serve phase runs
    most, in bf16, with each kernel's bound from these inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk

    rng = np.random.default_rng(SEED + 1)
    bf = torch.bfloat16
    hq, hkv, d, n = 32, 8, 128, 2048
    scale = d ** -0.5
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)

    def timings(kernel, plain, library):
        """Device ms of the kernel, its plain version and the library call,
        plus the kernel's host-inclusive single-call time."""
        k = timed(kernel, flush)
        return {"ms": k["ms"], "host_ms": k["host_ms"],
                "plain_ms": device_ms(plain, flush),
                "library_ms": (None if library is None
                               else device_ms(library, flush))}

    def sdpa(q, k, v, **kw):
        """One library call of the same attention (heads-first layout)."""
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if gqa:
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)
        rep = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1), **kw)

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, bf)

    # decode: 8 lanes, ragged lengths, ring pos plane (the ring site)
    b = 8
    lens = rng.integers(1, n + 1, size=b)
    q, kc, vc = rnd((b, 1, hq, d)), rnd((b, n, hkv, d)), rnd((b, n, hkv, d))
    cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    pos = torch.from_numpy(ring_positions(rng, b, n, lens)).to(dev)
    kw = dict(cache_len=cl, pos=pos, window=0, scale=scale)
    valid = (pos >= 0) & (pos < cl[:, None])
    rows_read = int(valid.sum())
    mask = valid[:, None, None, :]
    nbytes = (rows_read * hkv * d * 2 * 2 + int(np.minimum(lens, n).sum()) * 4
              + 2 * q.numel() * 2 + b * 4)
    flops = 4 * hq * d * rows_read
    bms, by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    rows["decode_attention"] = dict(
        shape=(f"B={b} n={n} Hq={hq} Hkv={hkv} D={d} bf16 pos ragged, "
               f"{dk.auto_splits(b, hkv, n, dev)} splits"),
        **timings(lambda: dk.decode_attention(q, kc, vc, **kw),
                  lambda: dk.decode_attention_plain(q, kc, vc, **kw),
                  lambda: sdpa(q, kc, vc, attn_mask=mask, scale=scale)),
        single_pass_ms=device_ms(
            lambda: dk.decode_attention(q, kc, vc, splits=1, **kw), flush),
        bound_ms=bms, bound_by=by)

    # flash: the chunk the engine runs most, 32 queries over a full ring
    c, start = 32, 2500
    qc, kc2, vc2 = rnd((1, c, hq, d)), rnd((1, n + c, hkv, d)), rnd((1, n + c, hkv, d))
    qp = torch.arange(start, start + c, dtype=torch.int32, device=dev)
    kp = torch.cat([torch.from_numpy(ring_positions(rng, 1, n, [start])).to(dev),
                    qp[None]], 1)
    kw = dict(q_pos=qp, k_pos=kp, causal=True, window=0, scale=scale)
    vis = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[None, :, None])
    pairs = int(vis.sum())
    keys_read = int(vis.any(1).sum())
    nbytes = keys_read * hkv * d * 2 * 2 + 2 * qc.numel() * 2 + 4 * (n + 2 * c)
    bms, by = bound(nbytes, 4 * hq * d * pairs, PEAK_BF16_FLOPS)
    rows["flash_attention"] = dict(
        shape=(f"chunk C={c} over n+C={n + c} keys Hq={hq} Hkv={hkv} D={d} "
               f"bf16, {fk.auto_splits(1, c, hq, n + c, dev)} splits"),
        **timings(lambda: fk.flash_attention(qc, kc2, vc2, **kw),
                  lambda: fk.flash_attention_plain(qc, kc2, vc2, **kw),
                  lambda: sdpa(qc, kc2, vc2, attn_mask=vis[:, None],
                               scale=scale)),
        single_pass_ms=device_ms(
            lambda: fk.flash_attention(qc, kc2, vc2, splits=1, **kw), flush),
        bound_ms=bms, bound_by=by)
    # whole-prompt prefill S=512, reported beside the chunk
    s = 512
    qs, ks, vs = rnd((1, s, hq, d)), rnd((1, s, hkv, d)), rnd((1, s, hkv, d))
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    kw = dict(q_pos=ar, k_pos=ar, causal=True, window=0, scale=scale)
    pairs = s * (s + 1) // 2
    bms, by = bound(2 * qs.numel() * 2 + 2 * ks.numel() * 2 + 2 * s * 4,
                    4 * hq * d * pairs, PEAK_BF16_FLOPS)
    DETAILS["flash_attention_prompt512"] = dict(
        **timings(lambda: fk.flash_attention(qs, ks, vs, **kw),
                  lambda: fk.flash_attention_plain(qs, ks, vs, **kw),
                  lambda: sdpa(qs, ks, vs, is_causal=True, scale=scale)),
        bound_ms=bms, bound_by=by)

    # rmsnorm: the decode step's d_model rows (8 lanes x 2560)
    x = rnd((8, 2560))
    sc = torch.zeros(2560, device=dev)
    w = (1.0 + sc).to(bf)
    bms, by = bound(2 * x.numel() * 2 + sc.numel() * 4, 4 * x.numel(),
                    PEAK_F32_FLOPS)
    rows["rmsnorm"] = dict(
        shape="8 x 2560 bf16",
        **timings(lambda: rk.rmsnorm(x, sc, 1e-6),
                  lambda: rk.rmsnorm_plain(x, sc, 1e-6),
                  (lambda: F.rms_norm(x, (2560,), weight=w, eps=1e-6))
                  if hasattr(F, "rms_norm") else None),
        bound_ms=bms, bound_by=by)
    xh = rnd((8, 32, 128))
    sh = torch.zeros(128, device=dev)
    DETAILS["rmsnorm_headwise_8x32x128"] = dict(
        **timings(lambda: rk.rmsnorm(xh, sh, 1e-6),
                  lambda: rk.rmsnorm_plain(xh, sh, 1e-6), None),
        bound_ms=bound(2 * xh.numel() * 2 + 512, 0, PEAK_F32_FLOPS)[0])
    return rows


# ---------------------------------------------------------------- phase 3
def cpu_plain_stream(model, cfg, prompt, new_tokens, ceiling):
    """The port's plain path on the CPU: chunked prefill in the replica's
    bucket widths, then greedy decode steps.  Returns (tokens, last logits)."""
    import torch
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, 1, 1024, model.device)
    done = 0
    while done < len(prompt):
        w = 1
        while w * 2 <= min(ceiling, len(prompt) - done):
            w *= 2
        toks = torch.as_tensor(prompt[done:done + w], dtype=torch.int64,
                               device=model.device)[None]
        logits, cache = M.prefill_chunk(model, cache, toks, done, cfg)
        done += w
    out = []
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    for i in range(new_tokens):
        out.append(int(tok[0, 0]))
        if i == new_tokens - 1:
            break
        logits, cache = M.decode_step(model, cache, tok, len(prompt) + i, cfg)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
    return out, logits[0, -1].float().cpu()


def identity_phase(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policies import make_policy
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Replica, Request, ServingFleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3-4b").replace(num_layers=4, dtype=torch.float32)
    model = M.init_model(cfg, SEED, dev)
    cpu_model = M.Model(cfg, "cpu")
    cpu_model.load_state_dict(model.state_dict())
    rep = Replica("identity0", cfg, model, slots=4, capacity=1024,
                  prefill_chunk_tokens=32)
    fleet = ServingFleet(make_policy("DDS"), source="identity0",
                         coordinator="identity0", admission_margin=0.0)
    fleet.add_replica(rep)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(2, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (40, 200, 700)]
    new = 16
    with ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(fleet.submit, Request(i, p, new, 1e9))
                for i, p in enumerate(prompts)]
        res = [f.result() for f in futs]
    worst = 0.0
    for i, (p, r) in enumerate(zip(prompts, res)):
        if r.outcome != "ok":
            raise AssertionError(f"identity request {i}: {r.outcome} {r.error}")
        fleet_toks = r.tokens.tolist()
        seq = rep.generate_sequential(Request(100 + i, p, new, 1e9)).tolist()
        cpu_toks, cpu_last = cpu_plain_stream(cpu_model, cfg, p, new, 32)
        gpu_toks, gpu_last = cpu_plain_stream(model, cfg, p, new, 32)
        err = (gpu_last - cpu_last).abs().max().item()
        worst = max(worst, err)
        log(f"  prompt {len(p):4d}: fleet == sequential {fleet_toks == seq}, "
            f"fleet == cpu plain {fleet_toks == cpu_toks}, card plain == cpu "
            f"plain {gpu_toks == cpu_toks}, last logits max|diff| {err:.3e}")
        if not (fleet_toks == seq == cpu_toks == gpu_toks):
            raise AssertionError(
                f"identity prompt {len(p)}: fleet {fleet_toks} seq {seq} "
                f"cpu {cpu_toks} card {gpu_toks}")
        # f32 throughout with TF32 off: the two devices differ only in the
        # order of their sums; 1e-3 on O(1) logits leaves two orders of
        # magnitude while a masking or position fault moves them by O(1)
        if not err <= 1e-3:
            raise AssertionError(f"identity logits differ by {err}")
    fleet.stop()
    DETAILS["identity"] = dict(prompts=[40, 200, 700], new_tokens=new,
                               last_logits_max_abs_diff=worst, tol=1e-3)
    del model, rep, fleet
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def _kernel_class(name: str) -> str:
    for key, cls in (("decode_kernel", "decode_attention"),
                     ("flash_kernel", "flash_attention"),
                     ("rmsnorm_kernel", "rmsnorm")):
        if key in name:
            return cls
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def step_profile(rep, cfg, dev, at: int = 1024):
    """Host wall time and device-busy time of one batched decode step (all
    lanes at position ``at``) and one widest-bucket prefill chunk, on
    scratch caches, with device time by kernel class."""
    import numpy as np
    import torch
    from repro_torch.models import model as M

    cache = M.init_cache(cfg, rep.slots, rep.capacity, dev)
    lane = M.init_cache(cfg, 1, rep.capacity, dev)
    for layer in cache + lane:      # rings holding positions 0 .. at-1
        n = layer["pos"].shape[1]
        p = torch.arange(max(0, at - n), at, dtype=torch.int32, device=dev)
        layer["pos"][:, (p % n).long()] = p
    tok = np.zeros((rep.slots, 1), np.int64)
    idx = np.full((rep.slots,), at, np.int32)
    buf = rep._zeros_tokens(rep.prefill_chunk_tokens)
    out = {}
    for name, fn in (
            ("decode_step", lambda: rep._step(rep.params, cache, tok, idx)),
            ("prefill_chunk", lambda: rep._prefill_chunk(rep.params, lane,
                                                         buf, at))):
        for _ in range(2):
            fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = sorted(walls)[len(walls) // 2]
        evs = device_events(fn)
        busy = sum(d for _, d in evs) / 1e3
        by_class, by_name = {}, {}
        for n_, d_ in evs:
            c_ = _kernel_class(n_)
            by_class[c_] = by_class.get(c_, 0.0) + d_ / 1e3
            by_name[n_[:90]] = by_name.get(n_[:90], 0.0) + d_ / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out[name] = dict(wall_ms=wall, device_ms=busy,
                         idle_share=1.0 - busy / wall, device_events=len(evs),
                         device_ms_by_class=by_class, top_kernels_ms=top)
        log(f"  {name} at position {at}: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms (idle {100 * (1 - busy / wall):.0f}%), "
            f"{len(evs)} device events; by class "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_class.items())))
    return out


def serve_phase(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_fleet
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request

    cfg = get_config("qwen3-4b")
    t0 = time.perf_counter()
    fleet = build_fleet(cfg, "DDS", replicas=2, slots=8, capacity=2048,
                        prefill_chunk_tokens=32, seed=SEED, device=dev,
                        verbose=False)
    build_s = time.perf_counter() - t0
    reps = list(fleet.replicas.values())
    for r in reps:
        log(f"  {r.name}: warmup {r.warmup_s:.2f} s; step ms by occupancy "
            + ", ".join(f"{int(x)}:{y:.2f}" for x, y in
                        zip(r.profile.step_curve.xs, r.profile.step_curve.ys))
            + f"; chunk({r.prefill_chunk_tokens}) "
              f"{r.profile.prefill_chunk_ms:.2f} ms")
    DETAILS["serve_build_s"] = build_s
    DETAILS["step_curve_ms"] = {r.name: list(r.profile.step_curve.ys)
                                for r in reps}

    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(64, 1025, size=12)
    reqs = [Request(i, rng.integers(2, cfg.vocab_size, size=(int(n),))
                    .astype(np.int32), 32, 600_000.0)
            for i, n in enumerate(lens)]
    reqs[5].temperature, reqs[5].top_p, reqs[5].seed = 0.8, 0.95, 1234

    before = {r.name: (r.decode_steps, r.prefill_chunks, r.whole_prefills)
              for r in reps}
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(reqs)) as ex:
        res = list(ex.map(fleet.submit, reqs))
    wall = time.perf_counter() - t0
    launches = ops.kernel_launches()
    steps = sum(r.decode_steps - before[r.name][0] for r in reps)
    chunks = sum(r.prefill_chunks - before[r.name][1] for r in reps)
    wholes = sum(r.whole_prefills - before[r.name][2] for r in reps)

    for i, r in enumerate(res):
        if r.outcome != "ok":
            raise AssertionError(f"request {i}: {r.outcome} {r.error}")
        toks = np.asarray(r.tokens)
        if len(toks) != 32 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {i}: bad tokens {toks}")
    layers = cfg.num_layers
    expect = {"decode_attention": layers * steps,
              "flash_attention": layers * (chunks + wholes),
              "rmsnorm": (4 * layers + 1) * (steps + chunks + wholes)}
    log(f"  launches {launches}; expected {expect} from {steps} decode "
        f"steps, {chunks} chunks, {wholes} whole prefills")
    for k, v in expect.items():
        if not (launches[k] > 0 and launches[k] == v):
            raise AssertionError(f"{k}: {launches[k]} launches, expected {v}")

    # finite logits of the served model on a served prompt
    cache = M.init_cache(cfg, 1, 2048, dev)
    lg, _ = M.prefill_chunk(reps[0].params, cache,
                            torch.as_tensor(reqs[0].prompt[:32], device=dev,
                                            dtype=torch.int64)[None], 0, cfg)
    if not torch.isfinite(lg).all():
        raise AssertionError("non-finite logits")

    DETAILS["step_profile"] = step_profile(reps[0], cfg, dev)

    gen = sum(len(r.tokens) for r in res)
    ttft = sorted(r.ttft_ms for r in res)
    stats = dict(requests=len(res), ok=sum(r.ok for r in res),
                 placements=dict(fleet.stats), wall_s=wall,
                 tokens_per_s=gen / wall, generated_tokens=gen,
                 prompt_tokens=int(lens.sum()),
                 ttft_p50_ms=ttft[len(ttft) // 2],
                 ttft_p99_ms=ttft[min(int(len(ttft) * 0.99), len(ttft) - 1)],
                 decode_steps=steps, prefill_chunks=chunks,
                 whole_prefills=wholes, launches=launches,
                 warmup_s={r.name: r.warmup_s for r in reps},
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log(f"  {stats['ok']}/{len(res)} ok, placements {stats['placements']}, "
        f"{gen} tokens in {wall:.2f} s = {stats['tokens_per_s']:.1f} tok/s, "
        f"TTFT p50 {stats['ttft_p50_ms']:.0f} ms p99 "
        f"{stats['ttft_p99_ms']:.0f} ms")
    fleet.stop()
    DETAILS["serve"] = stats
    return launches


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", default="",
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    took = build.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    DETAILS["build_logs"] = {k: build.build_log(k) for k in build.SOURCES}

    log("phase 2: kernels against their plain versions")
    errs = check_kernels(dev)
    rows = time_kernels(dev)

    log("phase 3: identity (qwen3-4b width, 4 layers, f32, TF32 off)")
    identity_phase(dev)

    log("phase 4: serve (qwen3-4b full config, bf16, 2 replicas, DDS)")
    launches = serve_phase(dev)

    meta = {
        "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:85"),
        "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:75"),
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                    "src/repro/kernels/rmsnorm.py:31"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"], "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
        if "single_pass_ms" in r:
            kernels[-1]["single_pass_ms"] = r["single_pass_ms"]
    DETAILS["kernels"] = kernels
    DETAILS["card"] = card
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                    exist_ok=True)
        with open(args.details, "w") as f:
            json.dump(DETAILS, f, indent=1)
    for k, v in DETAILS.items():
        if k not in ("build_logs", "kernels"):
            log(f"  {k}: {json.dumps(v)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
