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
2. kernels against their plain versions, on the card, at main-path
   shapes in bf16 and f32 (the attention kernels also at recurrentgemma's
   D 256, 16 query heads over 1 KV head, window 2048; ring decode and flash
   also at the shapes phase 8 serves minicpm-2b with, D 64 and 36 query
   heads over 36 KV heads: 8 lanes over ragged and wrapped 2048-slot rings,
   chunks of 1, 8 and 32 over empty, partial, full and wrapped rings, and
   prompts of 64, 512 and 1024; all three attention kernels also at the
   MoE archs' GQA ratios, where a 64-row flash tile ends part way through
   a token's heads: ratio 6 (48 query heads over 8, D 128, window 4096,
   8 lanes over ragged and wrapped 4096-slot rings) and ratio 7 (56 over
   8, 2048-slot rings; paged decode over pages of 16 with shared, absent
   and stale pages and an empty lane), flash chunks of 1, 17 and 32 over
   empty, partial, full and wrapped rings through both key sources and
   prompts of 64 and 1024, and a cross over ratios 3, 5, 6 and 7 at D
   64/128/256; ring decode, paged decode and flash also at musicgen-medium's
   D 64, 24 query heads over 24 (chunks of 1, 8 and 32, prompts of 64, 512
   and 1024, pages of 16), and ring decode and whole prompts of 64 and 512
   at llama-3.2-vision-90b's self-attention shapes, 64 over 8 at D 128;
   that arch's cross-attention forms at 64 over 8 at D 128 over 1601 image
   tokens, 8 lanes with distinct keys: flash not causal, 1, 17, 64 and 512
   queries over all 1601 keys, and the contiguous decode kernel (no
   ``pos``) with every slot visible; flash and ring
   decode also over GQA ratios 1-16 at D 64/128/256, chunks of 1, 17 and
   32 queries over empty, partial and wrapped rings passed as the ring
   arguments, window and softcap, prompts of 512 and 2304, and bf16 flash
   within 0.75 of a bf16 spacing of the f32 oracle, which holds its P
   hi/lo split; paged decode also over GQA ratios 1-16 at D 64/128/256,
   pages of 8, 16 and 12, shared prefix pages, absent entries, stale pos
   rows, an empty lane, window and softcap, bf16 within 3 spacings of the
   f32 oracle (it rounds P once, as its oracle does); ``ssd`` at mamba2's
   widths with chunks of 32, 128, 100 and 2, and over chunks of 1, 2, 17,
   32, 100 and 128 in one chunk and several, bf16 within 0.75 spacings of
   the f32 oracle, which holds its hi/lo splits; the norm kernel's four
   entry points (norm, qk pair, residual add, Mamba2's gated norm) over
   widths 64 to 8192 (musicgen-medium's 1536, minicpm-2b's 2304, mixtral's
   6144, arctic's 7168 and llama-3.2-vision's 8192 among them) and an odd one, 1 to 1280 rows, the residual sum
   bit-equal to ``x + y``; ``rglru`` from one token to 2300 on both of its
   paths, 1 and 8 rows, width 4096 and an odd one), then timings (kernel,
   plain version, one PyTorch library call as a yardstick where one
   exists) beside each kernel's bound, and for the tensor-core attention
   kernels the same launch with nothing visible (and for paged decode with
   one visible slot), after a flush that leaves the L2 clean and with no
   flush, and (decode) one PyTorch reduction streaming the same bytes;
   ``ssd`` also at one token (its fixed cost), with the prompt's time split
   by kernel; the norm and ``rglru`` at one row / one token (their fixed
   costs), each norm form beside the unfused expression it replaces, and
   the host issue cost of a call (N back-to-back calls between two syncs);
   the cross-attention forms at llama-3.2-vision's shapes (flash, 8 lanes of
   512 queries over 1601 keys, not causal; contiguous decode over 1601
   slots) beside their bounds and SDPA over the same keys;
   (2t) the four backward kernels against their plain versions: flash's
   (dQ, dK, dV from the forward's log-sum-exp, which is held against the
   plain version's too) at qwen3-4b's training shape (B 2, S 1024, 32
   query heads over 8 of 128) in bf16 and f32, minicpm-2b's D 64 MHA, GQA
   ratios 1-16 at D 64/128 with a window and empty key slots, S 77 and
   1000, and 100 queries over 333 keys not causal, and recurrentgemma-9b's
   D 256, 16 over 1, window 2048 (S 1024 and 2300, GQA 4 with holes, not
   causal), and with a softcap of 50 (q drawn 16 times wider, so that the
   cap bites) at D 64, 128 and 256, causal and windowed, GQA and MQA, not
   causal over more keys with holes, in both dtypes; ``ops.flash_attention``
   under grad with the softcap launching the forward and the backward
   kernel once each, its gradients within one spacing, and with a ring
   still raising ``NotImplementedError``; the norm's (the norm, the qk pair, the residual add and
   Mamba2's gated norm; dx, dz and the gains' gradients) at widths 128
   (the pair at 2048 x 32 and 2048 x 8 rows), 2560 and 2304 at 2048 rows,
   3072 (gated; also 1536 and 4096, whose tiles differ), 999, 64, 4096
   and 8192; ``ssd``'s (dx, d dt, d a_log, dB,
   dC, d d_skip) at mamba2-780m's widths, chunks of 128 (B 2, S 1024), 100
   and 2, one chunk and several, and in bf16 at 47 heads (B 2, S 1024,
   whose last head group is short); ``rglru``'s (dx, d log_a, d gate) from 1
   to 2300 steps on both of its paths at width 4096 and 999, with log_a
   exactly 0 at a few steps (d log_a inf or NaN where the plain version
   has them), and the forward's checkpoint for it (y bit-identical with and
   without, the checkpoint against the plain f32 states at the tile
   boundaries); bf16 within one bf16 spacing of the f32 oracle, f32 within
   2e-5 (a per-head sum over every (b, s) within 1e-5 of its terms'
   magnitudes; d log_a plus its 1 / (1 - a^2) conditioning); two launches
   of each at the training shapes bit-identical; then (phase 2c) their
   times at qwen3-4b's and the recurrent stacks' (``ssd``, ``rglru``, the
   gated norm, flash at D 256)
   training shapes beside their bounds, their plain versions and the
   flash backward at D 128 and D 256 also with the softcap (by launch, and
   the forward with it), the
   autograd backward of SDPA and of ``F.rms_norm`` as yardsticks (the
   add form's is the norm's alone: no PyTorch call adds the sum's
   gradient), each launch of a call apart (flash: delta, dK/dV, dQ; the
   norm: row pass, dscale pass), the flash forward with its
   log-sum-exp and the ``rglru`` forward with its checkpoint (``rglru_bwd``
   is timed given it, as training runs it);
   (2b) the MoE FFN (``models.moe.moe_ffn``, plain PyTorch around the
   kernels) against ``ref.moe_ffn_reference``, a loop over tokens and
   choices, on one layer at full width (mixtral-8x22b in f32 and bf16,
   arctic-480b in bf16): an 8-row decode batch and a 32-token chunk, of
   normal and of identical rows, the identical ones dropping choices at
   the published capacity factor;
   (2m, about 26 s) the serving mesh, (1, 4): four sequence shards on the
   one card: ``spmd_decode_attention`` at qwen3-4b's decode (8 lanes
   ragged up to 8192 slots, 32 over 8 heads of 128, the longest lanes'
   slots over three and four shards) and at recurrentgemma-9b's local
   layer (16 over 1 of 256, window 2048 over a 4096 ring that wraps), and
   ``spmd_paged_decode_attention`` (pages of 16, a pool of 4100 rows with
   the dump row, shared, absent and stale pages, a lane with no page),
   f32 and bf16, against the plain decode over ``gather_cache`` (f32
   2e-5, bf16 2^-7, of max(1, max|ref|); the empty lane zeros), the
   written K/V and pos equal to the unsharded write; the partials and
   combine launches on one shard against their plain versions, and
   combined bit for bit the ordinary launch at the same splits; then the
   sharded call's device time (the writes, four partials launches and the
   combine), its attention alone, the unsharded kernel's and the bound;
3. identity: qwen3-4b at full width, depth cut to 4 layers, in f32 with
   TF32 off, serves 3 greedy prompts through a ``ServingFleet``; every
   stream must equal the replica's ``generate_sequential`` and the port's
   plain path on the CPU, and the last-step logits must agree;
   then a paged replica with the prefix cache, on the card and on the
   CPU, must emit the card's ring streams for a shared page-aligned system
   prompt, a full hit (copy-on-write), a capacity-length prompt and a
   mid-stream join;
   then mamba2-780m (4 layers) and recurrentgemma-9b (5 layers: one
   rglru/rglru/attn period and two rglru) at full width in f32: fleet
   streams equal ``generate_sequential`` (whole-prompt against chunked
   prefill) and the CPU plain path on short prompts, recurrentgemma also on
   a 2300-token prompt across its 2048-token window (capacity 4096); a
   paged replica emits the ring streams with mid-stream joins (for
   recurrentgemma the 2300-token prompt too, its local rings wrapping in
   paged mode), and the prefix cache is refused;
   then minicpm-2b at full width (D 64, MHA, vocab 122753), 4 layers, in
   f32: the same checks as qwen3-4b's ring path, card against CPU;
   then (3e, 3f) the MoE archs at full width in f32, mixtral-8x22b and
   arctic-480b at 1 layer (the depth one card holds in f32, and the host
   beside it): B=1 greedy streams of 40 and 200 prompt tokens on the
   card equal to the CPU's, last logits within 1e-3, and a fixed batch of
   8 lanes (6 with one prompt, so the batched MoE drops choices) over 8
   decode steps, tokens equal and logits within 1e-3; whether the fleet's
   stream equals ``generate_sequential`` is logged, since MoE couples a
   batch's lanes once an expert overflows; for mixtral-8x22b (3e) also
   the loss, ce, aux and every parameter's gradient of one batch of 1 x
   136 tokens card against CPU within 1e-3, with the (token, choice) pairs
   its MoE calls drop counted;
   then (3g) llama-3.2-vision-90b at full width, one period (4 self + 1
   cross layers, 25.5 GB of f32 weights on the card and again on the host)
   through the model functions, since no replica serves a cross stack: 4
   lanes with their own seeded stub encoder states (1601 x 8192) and
   64-token prompts, ``prefill(enc=...)`` and 16 greedy decode steps, tokens
   equal card against CPU and every step's logits within 1e-3; then (3h)
   musicgen-medium at full width, 4 layers, as qwen3-4b's phase 3 (ring
   and paged with the prefix cache, card against CPU); then (3i) training:
   qwen3-4b at full width, 2 layers, f32: every parameter's gradient of one
   batch (2 x 256 tokens) on the card nonzero and within 1e-4 of its
   largest on the CPU, then 3 ``make_train_step`` steps on both from the
   same weights and ``SyntheticDataset`` batches (loss, ce, grad norm, lr;
   parameters within 2 lr a step; launches equal to
   ``expected_train_launches``), then in bf16 with f32 masters 4 straight
   ``train_loop`` steps equal to 2 steps, a checkpoint, a restore and 2
   more, bit for bit; then (3m, about 23 s) a sharded replica: qwen3-4b
   at full width, 4 layers, f32, on a (1, 4) mesh of the card, capacity
   1024 (256 slots a shard), ring with a lane joining mid-stream and a
   700-token prompt over three shards, then paged with the prefix cache
   (a restore and a copy-on-write across shards): greedy streams equal to
   the unsharded replica's and the CPU plain path's, the plain path's
   steps under the mesh on the card within 1e-3 of the CPU's last logits,
   launches as ``expected_launches`` states for the mesh; then (3p) the
   distributed trainer on a world of one NCCL rank (joined in-process
   over a FileStore under build/, destroyed after): qwen3-4b at full
   width, 4 layers, f32, 3 sharded steps on a (1, 1) ``DeviceMesh``
   against ``make_train_step`` (loss, ce, grad norm, lr and every
   parameter within 1e-6 relative, bit-equality logged; launches as
   ``expected_train_launches``), the int8 all-reduce over the world equal
   to ``dequantize(quantize(x))``, ``pipeline_forward`` over 4 stages on
   the card within 1e-5 of ``forward`` (launches as
   ``expected_pipeline_launches``), and in bf16 with f32 masters at 1
   layer 4 straight ``train_loop(mesh=...)`` steps equal to 2, a checkpoint, a
   restore placed leaf by leaf (``ft.elastic.reshard_leaf``) and 2 more,
   bit for bit;
4. serve: qwen3-4b at full width, depth cut to 18 of its 36 layers
   (``SERVE_LAYERS``; d_model 2560, vocab 151936, bf16), 2 replicas
   sharing weights, 8 slots, capacity 2048, DDS; 12
   requests (one sampled) must all come back ``ok``, and the launch
   counters must prove every kernel ran on that path, as often as the
   engine's own step and chunk counters say;
5. paged serve: the same fleet in paged mode with the prefix cache (pages
   of 16, 512 pages per replica), 12 requests sharing a 512-token system
   prompt, one equal to it: all ``ok``, prefix hits, fewer tokens
   prefilled than the prompts hold, at least one copy-on-write, the paged
   kernel launched 18 times per decode step, and no page held by a lane
   once the fleet stops;
6. serve mamba2-780m at full width, depth cut to 12 of its 48 layers
   (``SERVE_LAYERS``; bf16, capacity 2048) as in phase 4: 12 ``ssd``
   launches per prefill chunk, no attention launch;
7. serve recurrentgemma-9b at full width, depth cut to 9 of its 38
   layers (three (rglru, rglru, attn) periods; bf16, capacity 4096, one
   prompt of 2300 tokens) as in phase 4: 6 ``rglru`` and 3
   ``flash_attention`` launches per chunk, 3 ``decode_attention`` per
   decode step;
8. chaos: minicpm-2b at full width, depth cut to 10 of its 40 layers
   (``CHAOS_LAYERS``; d_model 2304, 36 heads of 64 over 36 KV heads, vocab
   122753, bf16), two DDS replicas over one set
   of weights (8 lanes, capacity 2048), fresh for each fault, which lands
   on ``replica0`` once it decodes (heartbeat 20 ms, staleness alarm
   100 ms, progress timeout 1000 ms): a crash under phase 4's 12 requests
   (all ``ok``, none lost, replica0 the only one evicted, greedy streams
   equal to ``generate_sequential`` on the survivor, the sampled stream
   equal to its undisturbed run); a hang, evicted by the progress
   watchdog while its heartbeats go on, then healed and stopped without
   a leak; slow(4x), after which the victim's one-lane step estimate has
   grown at least 2.5x and DDS places the next requests on the other
   replica; a partition, evicted by staleness while its decode loop runs
   on, then healed and rejoined.  The launches of the four scenarios
   equal what the engine counters of every replica imply, the crashed and
   hung ones included; it prints each fault-to-eviction time, the
   failovers and the survivor's tokens/s.  The streams are held against
   the same replica's kernels here; phase 2 holds those kernels against
   their plain versions at these shapes, and phase 3 the 4-layer stack on
   the card against the CPU;
9. serve mixtral-8x22b at full width, depth cut to 4 layers
   (``SERVE_LAYERS``; bf16, 20 GB of weights; 56 layers do not fit one
   card) as in phase 4, capacity 8192 so the local rings hold the whole
   4096 window, the last prompt 4600 tokens so they wrap: per step 4
   ``decode_attention`` and 9 ``rmsnorm`` launches, per chunk 4
   ``flash_attention`` and 9;
10. paged serve with the prefix cache, arctic-480b at full width, depth
   cut to 2 layers (bf16, 55 GB of weights) as in phase 5: per step 2
   ``paged_decode_attention`` and 5 ``rmsnorm`` launches;
11. serve musicgen-medium at full width, depth cut to 12 of its 48 layers
   (``SERVE_LAYERS``; bf16, capacity 2048) as in phase 4: per step 12
   ``decode_attention`` and 25 ``rmsnorm`` launches, per chunk 12
   ``flash_attention`` and 25;
12. llama-3.2-vision-90b generation at full width, depth cut to 20 layers
   (16 self + 4 cross, bf16, 38.4 GB of weights; 100 layers need about
   176 GB): 8 lanes with their own stub encoder states, 512-token prompts,
   one batched ``prefill(enc=...)`` and 32 greedy decode steps; per step 20
   ``decode_attention`` launches (4 contiguous over the image tokens) and
   41 ``rmsnorm``, per prefill 20 ``flash_attention`` (4 not causal) and
   41; prefill ms, step wall and device-busy ms, tokens/s and peak memory;
13. train qwen3-4b at its full config (36 layers, bf16 weights with f32
   masters, remat, AdamW, cosine) through ``launch.train.train_loop``: 6
   steps of 2 x 1024 tokens, finite losses, per step 72 ``flash_attention``,
   36 ``flash_attention_bwd``, 217 ``rmsnorm`` and 109 ``rmsnorm_bwd``
   launches (``expected_train_launches``); step wall ms, tokens/s, one
   profiled step's device-busy ms and idle share, model operations against
   989 TFLOP/s, peak memory;
14. serve qwen3-4b at full width, depth cut to 9 of its 36 layers
   (``MESH_SERVE_LAYERS``; bf16), from a DDS fleet of
   two replicas sharing weights: ``replica0`` sharded on a (1, 4) mesh of
   the card, ``replica1`` unsharded, both 8 lanes at capacity 8192 (2048
   slots a shard); 12 requests of 64-6000 prompt tokens, 32 new tokens
   each, one sampled: all ``ok``, every lane free after, launches as
   ``expected_launches`` states for each replica (per decode step of the
   sharded one, 4 partials launches and a combine per attention layer);
   tokens/s, TTFT, each replica's step curve, ``step_profile`` of the
   sharded step at positions 1024 and 6000 and of the unsharded one at
   6000, peak memory;
15. the sharded trainer: qwen3-4b at phase 13's config and batch through
   ``train_loop(mesh=make_host_mesh())`` on a world of one NCCL rank, the
   state stored as DTensors by the reference's specs, every block's
   weights gathered on use and every gradient reduced by NCCL over groups
   of one: finite losses within 1e-3 relative of phase 13's, launches as
   ``expected_train_launches``, peak memory within phase 13's plus 2 GB;
   step wall ms, tokens/s, one profiled step's device-busy ms, idle share
   and host time by operator, the device ms of gathering every weight
   once and of reducing every gradient once; then ``pipeline_forward``
   of the 36 layers in bf16 over 4 stages of the card, 4 microbatches of
   2 x 1024, against one forward of 8 x 1024: ms of each, each
   microbatch's logits bit-equal to a forward of its own rows, and the
   largest logit difference against the whole batch within
   ``PIPE_BF16_SPACINGS`` bf16 spacings of max|ref| (argmax agreement
   recorded);
16. the multi-pod dry run (``launch.dryrun``) under this machine's torch:
   ``run_cell`` of qwen3-4b ``train_4k`` and ``decode_32k`` on the 16x16
   fake world (256 ranks, fake tensors) and a ``long_500k`` SKIP, each
   record printed; then the dry cell of qwen3-4b at full config, 2 x 1024
   tokens on a fake world of one rank, against one sharded step of the
   same on a world of one NCCL rank (``make_host_mesh``), both counted by
   ``dryrun.Trace``: collective bytes equal by kind, the dry argument
   bytes equal to the real local state and batch; the dry peak printed
   beside ``torch.cuda.max_memory_allocated`` with their ratio (the card's
   kernels do not hold what the plain route does), not held; its seconds,
   within 60;
17. train the recurrent stacks through ``launch.train.train_loop`` (bf16
   weights, f32 masters, remat, AdamW, cosine; 4 steps of 2 x 1024
   tokens): mamba2-780m at its full config (48 layers) and
   recurrentgemma-9b at 9 layers (three (rglru, rglru, attn) periods,
   which peak at 56.8 GB), launches equal to
   ``expected_train_launches``, finite losses; step time, tokens/s, the
   share of 989 TFLOP/s, one profiled step's device-busy time and idle
   share, peak memory.  Phase 3r, after 3i, holds both stacks card
   against CPU as 3i holds qwen3-4b (f32, full width, without the
   resume): mamba2-780m at 2 layers over 2 x 256 tokens, 3 steps;
   recurrentgemma-9b at 3 layers, one (rglru, rglru, attn) period, over
   1 x 136 tokens, 1 step;
18. train mixtral-8x22b at full width, 1 of its 56 layers (2.91 B
   parameters: ~47 GB of bf16 weights, f32 masters and moments; 2 layers
   would hold 86.6 GB), as phase 13 through ``train_loop``: 4 steps of 2 x
   1024 tokens, launches equal to ``expected_train_launches`` (the MoE FFN
   launches no kernel), finite losses and a positive aux loss at every
   step; step time, tokens/s, the share of 989 TFLOP/s (the experts
   counted for their capacity slots), one profiled step's device-busy time
   and idle share, AdamW alone, peak memory.

Standard output ends with the JSON ``{"kernels": ...}`` summary (the six
forward kernels and the four backward ones), the card line, and ``{"ok":
true, "device": {...}}`` as the last line.  ``--details PATH`` also writes
every measurement (step profiles, nvcc's register and shared-memory
report) to PATH as JSON.  ``--only 2t,2c,3i,13`` builds and runs only
those phases of the training slice, then stops without a summary: a quick
check of a change on the card, not the smoke test (``--only 2t,2c,17``
for work on the backward kernels, 2c printing each launch apart: flash's
delta, dK/dV, at D 256 ``flash_bwd_dkdv_reduce`` (the head groups'
partials), dQ; ``ssd``'s ``ssd_bwd_states_tc``, carry, ``ssd_bwd_chunk_tc``,
reduce, params; ``--only 2m,3m,14`` for the serving
mesh, ``--only 3p,13,15`` for the distributed trainer, ``--only 16`` for
the dry run, ``--only 3r,17`` for the recurrent stacks' training,
``--only 2t,2c,3e,18`` for the softcap backward and MoE training).  The summary's decode rows count the partials launches of a mesh
path with the kernel's (the same kernel, unmerged) and list them, the
combine's and the sharded call's times under ``mesh``.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

SEED = 0
DETAILS = {}


# The depths of the serve phases, which check what does not depend on the
# depth (the engine's path, the launch counts, the streams, paging), cut to
# a half or a quarter so that the whole script ends within its 1,200 s on a
# slow host: each keeps its arch's full width, and an identity phase holds
# that width card against the CPU.  qwen3-4b trains at its full config in
# phases 13 and 15.
SERVE_LAYERS = {"qwen3-4b": 18, "mamba2-780m": 12, "recurrentgemma-9b": 9,
                "mixtral-8x22b": 4, "musicgen-medium": 12}
MESH_SERVE_LAYERS = 9


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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


def device_events(fn, skip=frozenset(), tries: int = 3):
    """Device-side events (kernels, copies) of one profiled run of ``fn``
    (CUPTI through ``torch.profiler``), as (name, duration_us) pairs.  The
    profiler now and then returns a run with no device event at all; such
    a run is profiled again, up to ``tries`` runs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if evs:
            break
    return [(n, d) for n, d in evs if n not in skip]


def device_ms(fn, flush, iters: int = 20, how: str = "write") -> float:
    """Device time of one call of ``fn``: the summed durations of the
    kernels it launches, from the profiler, with the L2 cache flushed
    before each call (the main path finds these operands cold, other
    layers having run in between).  The flush's own kernel is excluded.
    ``how``: "write" zeroes the 64 MB buffer, which leaves the L2 full of
    dirty lines to write back; "read" reads it, which leaves them clean;
    "none" does not flush (the operands stay in L2 where they fit)."""
    op = {"write": flush.zero_, "read": flush.max, "none": None}[how]
    for _ in range(3):
        fn()
    skip = frozenset() if op is None else frozenset(
        n for n, _ in device_events(op))

    def run():
        for _ in range(iters):
            if op is not None:
                op()
            fn()

    evs = device_events(run, skip)
    if not evs:
        raise RuntimeError("the profiler recorded no device time")
    return sum(d for _, d in evs) / iters / 1e3


def kernel_breakdown(fn, flush, iters: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches (by kernel name,
    template arguments dropped), the L2 flushed before each call."""
    skip = frozenset(n for n, _ in device_events(flush.zero_))

    def run():
        for _ in range(iters):
            flush.zero_()
            fn()

    by = {}
    for name, us in device_events(run, skip):
        m = re.search(r"([A-Za-z_]\w*)(?:<[^(]*>)?\(", name)
        short = m.group(1) if m else name[:60]
        by[short] = by.get(short, 0.0) + us / iters / 1e3
    return by


def stream_ms(nbytes: int, dev, flush) -> float:
    """Device time of one PyTorch reduction that reads ``nbytes`` (bf16)
    under the same cold-L2 protocol: what streaming a kernel's bytes costs
    on this card as the measurement sees it, beside the bound's 3.35 TB/s."""
    import torch
    x = torch.ones(nbytes // 2, dtype=torch.bfloat16, device=dev)
    return device_ms(lambda: x.sum(dtype=torch.float32), flush)


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


def paged_layout(rng, lens, page, maxp, share=0, holes=0.0, stale=0.0,
                 empty=()):
    """Block tables (B, maxp) and a pool pos plane (P + 1, page), int32, for
    lanes of lengths ``lens``: each lane's pages are distinct rows of a
    shuffled pool, every row first holds a previous tenant's positions
    (so slots past a lane's length are stale, not empty), lanes 0 and 1
    share their first ``share`` pages, a share ``holes`` of table entries
    is then made absent (-1), a share ``stale`` of live pages keeps
    another slot's positions, and the lanes in ``empty`` have no page."""
    import numpy as np
    b = len(lens)
    npool = b * maxp
    perm = iter(rng.permutation(npool))
    tables = np.full((b, maxp), -1, np.int64)
    pos = np.full((npool + 1, page), -1, np.int64)
    pos[:npool] = (rng.integers(0, maxp, size=(npool, 1)) * page
                   + np.arange(page))
    for i, ln in enumerate(lens):
        if i in empty:
            continue
        for j in range(min(-(-int(ln) // page), maxp)):
            if i == 1 and j < share:
                tables[i, j] = tables[0, j]
                continue
            row = next(perm)
            tables[i, j] = row
            p = j * page + np.arange(page)
            pos[row] = np.where(p < ln, p, pos[row])
    live = np.argwhere(tables >= 0)
    for i, j in live[rng.random(len(live)) < stale]:
        pos[tables[i, j]] = ((j + 1) % maxp) * page + np.arange(page)
    tables[(rng.random(tables.shape) < holes) & (tables >= 0)] = -1
    return tables.astype(np.int32), pos.astype(np.int32)


def check_kernels(dev):
    """Phase 2: every kernel against its plain version on the card."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import rglru_scan as gk
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk

    rng = np.random.default_rng(SEED)
    hq, hkv, d = 32, 8, 128
    scale = d ** -0.5
    # Tolerances.  f32: kernel and plain version compute the same f32 math
    # in another order, so 2e-5 absolute (outputs are O(1)).  bf16: the
    # output is rounded once to bf16 (2^-8 relative) and the plain decode
    # path also rounds its probabilities to bf16 before P.V, so 2e-2
    # absolute; RMSNorm outputs reach several units, so there two bf16
    # roundings of the largest |reference| (2^-7 relative).
    # The scans (ssd, rglru) are held relative to their largest |reference|
    # (outputs reach several units): f32 2e-5 (the cumulative log-decay
    # |cum|, up to ~10^2 in a 128-token chunk, is summed in another order
    # and enters exp), bf16 two roundings (2^-7).
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    scan_tol = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
    results = {"decode_attention": [], "flash_attention": [], "rmsnorm": [],
               "paged_decode_attention": [], "ssd": [], "rglru": []}
    sweep = {}              # (kernel, dtype) -> (cases, max |err|)

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    def record(name, case, got, exp, dtype, lanes=None, quiet=False):
        """Hold ``got`` against ``exp`` within the tolerance; log the case
        (a quiet case only joins a summary: its kernel's sweep, or the dict
        ``quiet`` names)."""
        if lanes is not None:
            got, exp = got[lanes], exp[lanes]
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {case}: non-finite output")
        err = (got.float() - exp.float()).abs().max().item()
        lim = tol[dtype]
        if name == "rmsnorm" and dtype == torch.bfloat16:
            lim = 2.0 ** -7 * max(1.0, exp.float().abs().max().item())
        if name in ("ssd", "rglru"):
            lim = scan_tol[dtype] * max(1.0, exp.float().abs().max().item())
        if quiet is not False:
            into = sweep if quiet is True else quiet
            key = (name, str(dtype)[6:])
            n_, e_ = into.get(key, (0, 0.0))
            into[key] = (n_ + 1, max(e_, err))
        else:
            log(f"  {name:16s} {case:56s} {str(dtype)[6:]:8s} "
                f"max|err| {err:.3e}  tol {lim:.1e}")
        if not err <= lim:
            raise AssertionError(f"{name} {case} {dtype}: {err} > {lim}")
        results[name].append(err)
        return err

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

    # paged decode: B=8 over a shuffled pool of pages 8 and 16; every case
    # has absent entries, stale pos rows, two lanes sharing prefix pages, a
    # length-1 lane and a lane with no page (all lanes compared: a lane with
    # no visible slot must give what the oracle gives)
    for page in (8, 16):
        maxp = 2048 // page
        plens = np.concatenate([[700, 900, 1, 2048],
                                rng.integers(1, 2049, size=b - 4)])
        tables, ppos = paged_layout(rng, plens, page, maxp, share=600 // page,
                                    holes=0.05, stale=0.05, empty=(7,))
        tab = torch.from_numpy(tables).to(dev)
        pp = torch.from_numpy(ppos).to(dev)
        cl = torch.as_tensor(plens, dtype=torch.int32, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            q = t(rng.standard_normal((b, 1, hq, d)), dtype)
            kp = t(rng.standard_normal((b * maxp + 1, page, hkv, d)), dtype)
            vp = t(rng.standard_normal((b * maxp + 1, page, hkv, d)), dtype)
            for window in (0, 64):
                kw = dict(cache_len=cl, window=window, scale=scale)
                exp = pk.paged_decode_attention_plain(q, kp, vp, pp, tab, **kw)
                for splits in (None, 1):
                    record("paged_decode_attention",
                           f"B8 page{page} shuffled+holes+stale+shared w{window} "
                           f"splits={splits or 'auto'}",
                           pk.paged_decode_attention(q, kp, vp, pp, tab,
                                                     splits=splits, **kw),
                           exp, dtype)

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
            # the same keys as the ring (the serving path's two sources)
            # and as one concatenated source
            two = dict(k_cache=kc[:, :n].contiguous(),
                       v_cache=vc[:, :n].contiguous(), cache_pos=kp[:, :n])
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
                    kw2 = dict(kw, k_pos=qp, **two)
                    record("flash_attention",
                           f"chunk C32 ring2048 start{start} w{window} "
                           f"two sources splits={splits or 'auto'}",
                           fk.flash_attention(qc, kc[:, n:], vc[:, n:],
                                              splits=splits, **kw2),
                           exp, dtype)

    # rmsnorm: 8 x 2560 (d_model), the qk-norm pair at 8 x 32/8 x 128, the
    # residual add at d_model and mamba2's gated norm over d_inner; then
    # the four entry points over every width and row count (quiet)
    for dtype in (torch.bfloat16, torch.float32):
        x = t(rng.standard_normal((8, 2560)), dtype)
        sc = t(0.5 * rng.standard_normal(2560), torch.float32)
        record("rmsnorm", "x8x2560", rk.rmsnorm(x, sc, 1e-6),
               rk.rmsnorm_plain(x, sc, 1e-6), dtype)
        y = t(rng.standard_normal((8, 2560)), dtype)
        s_, h_ = rk.add_rmsnorm(x, y, sc, 1e-6)
        if not torch.equal(s_, x + y):
            raise AssertionError("add_rmsnorm: x + y not bit-equal")
        record("rmsnorm", "add x8x2560", h_,
               rk.add_rmsnorm_plain(x, y, sc, 1e-6)[1], dtype)
        q = t(rng.standard_normal((8, 1, 32, 128)), dtype)
        k = t(rng.standard_normal((8, 1, 8, 128)), dtype)
        qs = t(0.5 * rng.standard_normal(128), torch.float32)
        ks = t(0.5 * rng.standard_normal(128), torch.float32)
        got = rk.rmsnorm_pair(q, k, qs, ks, 1e-6)
        exp = rk.rmsnorm_pair_plain(q, k, qs, ks, 1e-6)
        record("rmsnorm", "pair q8x1x32x128 k8x1x8x128", got[0], exp[0],
               dtype)
        record("rmsnorm", "pair k", got[1], exp[1], dtype)
        proj = t(rng.standard_normal((8, 2 * 3072 + 2 * 128 + 48)), dtype)
        z = proj[:, :3072]
        y = t(rng.standard_normal((8, 3072)), dtype)
        sc = t(0.5 * rng.standard_normal(3072), torch.float32)
        record("rmsnorm", "gated x8x3072, z a slice of the projection",
               rk.gated_rmsnorm(y, z, sc, 1e-6),
               rk.gated_rmsnorm_plain(y, z, sc, 1e-6), dtype)
    check_norm_sweep(dev, rng, t, record)

    # ssd at mamba2's widths (48 heads of 64, state 128): the 32-token
    # serving chunk, a 1024-token prompt in chunks of 128, odd chunks (100
    # tokens in one chunk of 100, 130 in chunks of 2), and 8 rows
    for dtype in (torch.bfloat16, torch.float32):
        for (b_, s_, chunk), skip in (((1, 32, 32), True), ((1, 32, 32), False),
                                      ((1, 1024, 128), True),
                                      ((1, 100, 100), False),
                                      ((1, 130, 2), True), ((8, 64, 32), True)):
            args = ssd_inputs(rng, b_, s_, 48, 64, 128, dtype, dev, skip)
            record("ssd", f"B{b_} S{s_} chunk{chunk} H48 P64 N128 "
                   f"{'d_skip' if skip else 'no d_skip'}",
                   sk.ssd(*args, chunk=chunk), sk.ssd_plain(*args, chunk=chunk),
                   dtype)

    # rglru at recurrentgemma's width (4096): a serving chunk, a 1024-token
    # prompt and 8 rows of 33; then the sweep (quiet)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((1, 32, 4096), (1, 1024, 4096), (8, 33, 4096)):
            args = rglru_inputs(rng, shape, dtype, dev)
            record("rglru", "x".join(map(str, shape)), gk.rglru(*args),
                   gk.rglru_plain(*args), dtype)
    check_rglru_sweep(dev, rng, record)

    DETAILS["serve_shapes"] = check_attention_serve(dev, rng, t, record)
    DETAILS["gqa_cross"] = check_attention_gqa_cross(dev, rng, t, record)
    DETAILS["enc_attention"] = check_attention_enc(dev, rng, t, record)
    spacings = {"flash_attention": check_attention_sweep(dev, rng, t, record),
                "paged_decode_attention": check_paged_sweep(dev, rng, t,
                                                            record),
                "ssd": check_ssd_sweep(dev, rng, record)}
    for (name, dt), (cases, err) in sorted(sweep.items()):
        log(f"  {name:16s} sweep: {cases} cases {dt}, max|err| {err:.3e}")
    DETAILS["sweeps"] = {f"{k[0]} {k[1]}": v for k, v in sweep.items()}
    paged_sp, paged_plain_sp = spacings["paged_decode_attention"]
    spacings["paged_decode_attention"] = paged_sp
    for name, sp in spacings.items():
        lim = PAGED_SPACINGS if name == "paged_decode_attention" else P_SPACINGS
        log(f"  {name:16s} bf16 against the f32 oracle: max |err| {sp:.3f} "
            f"bf16 spacings (limit {lim})")
        DETAILS[f"{name}_bf16_max_spacings"] = sp
    log(f"  paged_decode_attention plain bf16 version against the f32 oracle: "
        f"{paged_plain_sp:.3f} bf16 spacings")
    DETAILS["paged_decode_attention_plain_bf16_max_spacings"] = paged_plain_sp
    return {k: max(v) for k, v in results.items()}


# The bf16 flash kernel against the f32 oracle, in bf16 spacings at the
# oracle's value (the spacing at 1/8 below 1/8): rounding the output once
# costs up to 0.5; with P split into hi + lo (about 16 bits) the rest is
# far below 0.25, even at 1/8.  P rounded once to bf16 (8 bits) errs by up
# to 2^-9 of each term and breaks the limit on rows with few visible keys.
P_SPACINGS = 0.75


# Paged decode rounds its probabilities P to bf16 once before P·V, as its
# oracle does (2^-9 of each term), which the f32 oracle does not: over the
# paged sweep the bf16 plain version itself lies more than 2 spacings from
# the f32 oracle.  The kernel rounds the running P, not the normalised one,
# so it is held at 3 spacings, and the run logs the plain version's reading
# beside its own.
PAGED_SPACINGS = 3.0


def bf16_spacings(got, exp32) -> float:
    """Largest |got - exp32| in units of the bf16 spacing at |exp32|."""
    import torch
    mag = exp32.abs().clamp_min(0.125)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - exp32).abs() / spacing).max().item()


def check_attention_sweep(dev, rng, t, record) -> float:
    """The redesigned attention kernels over GQA ratios and head dims, both
    dtypes, auto splits and a single pass (summarised per kernel):
    flash chunks of 1, 17 and 32 queries for 2 batch rows over an empty
    ring, a partly filled one and a wrapped one with holes, through the
    two-source arguments (500 slots: key tiles straddle ring and chunk),
    each with window and softcap variants; whole prompts of 512 and 2304;
    decode at ratios 1 to 16 over ragged lanes, with and without a wrapped
    pos plane with holes.  Every bf16 flash case is also held within
    ``P_SPACINGS`` of the f32 oracle; returns the largest reading."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    worst = 0.0

    def flash_case(case, args, kw, dtype, splits_list):
        nonlocal worst
        exp = fk.flash_attention_plain(*args, **kw)
        exp32 = None
        if dtype == torch.bfloat16:
            up = lambda x: x.float() if torch.is_tensor(x) and \
                x.dtype == dtype else x
            exp32 = fk.flash_attention_plain(
                *map(up, args), **{k: up(x) for k, x in kw.items()})
        for splits in splits_list:
            got = fk.flash_attention(*args, splits=splits, **kw)
            name = case + (f" splits={splits or 'auto'}"
                           if len(splits_list) > 1 else "")
            record("flash_attention", name, got, exp, dtype, quiet=True)
            if exp32 is not None:
                sp = bf16_spacings(got, exp32)
                worst = max(worst, sp)
                if not sp <= P_SPACINGS:
                    raise AssertionError(
                        f"flash_attention {name} bf16: {sp:.3f} bf16 "
                        f"spacings from the f32 oracle > {P_SPACINGS}")

    hkv, n, b = 2, 500, 2
    variants = ((0, 0.0), (64, 0.0), (0, 30.0))     # (window, softcap)
    rings = (("empty", 0, 0.0), ("partial", 300, 0.0),
             ("wrapped+holes", 1500, 0.1))
    for rep in (1, 4, 16):
        for d in (64, 128, 256):
            hq, scale = hkv * rep, d ** -0.5
            for dtype in (torch.bfloat16, torch.float32):
                kc = t(rng.standard_normal((b, n, hkv, d)), dtype)
                vc = t(rng.standard_normal((b, n, hkv, d)), dtype)
                for i, (c, (ring, start, holes)) in enumerate(
                        (c, r) for c in (1, 17, 32) for r in rings):
                    window, cap = variants[i % 3]
                    qc = t(rng.standard_normal((b, c, hq, d)), dtype)
                    kn = t(rng.standard_normal((b, c, hkv, d)), dtype)
                    vn = t(rng.standard_normal((b, c, hkv, d)), dtype)
                    cp = torch.from_numpy(ring_positions(
                        rng, b, n, [start] * b, holes)).to(dev)
                    qp = torch.arange(start, start + c, dtype=torch.int32,
                                      device=dev)
                    kw = dict(q_pos=qp, k_pos=qp, causal=True, window=window,
                              scale=scale, softcap=cap, k_cache=kc,
                              v_cache=vc, cache_pos=cp)
                    flash_case(f"rep{rep} D{d} C{c} {ring} w{window} "
                               f"cap{cap:g}", (qc, kn, vn), kw, dtype,
                               (None, 1))
    for rep, d in ((1, 64), (4, 128), (16, 256)):
        hq, scale = hkv * rep, d ** -0.5
        for s in (512, 2304):
            for dtype in (torch.bfloat16, torch.float32):
                qs = t(rng.standard_normal((1, s, hq, d)), dtype)
                ks = t(rng.standard_normal((1, s, hkv, d)), dtype)
                vs = t(rng.standard_normal((1, s, hkv, d)), dtype)
                ar = torch.arange(s, dtype=torch.int32, device=dev)
                for window, cap in variants:
                    kw = dict(q_pos=ar, k_pos=ar, causal=True, window=window,
                              scale=scale, softcap=cap)
                    flash_case(f"rep{rep} D{d} prompt S{s} w{window} "
                               f"cap{cap:g}", (qs, ks, vs), kw, dtype,
                               (None,))

    b, n = 4, 1024
    lens = np.array([1, 700, 1024, 2500])           # the last wraps
    for rep in (1, 2, 4, 8, 16):
        for d in (64, 128, 256):
            hq, scale = hkv * rep, d ** -0.5
            for dtype in (torch.bfloat16, torch.float32):
                q = t(rng.standard_normal((b, 1, hq, d)), dtype)
                kc = t(rng.standard_normal((b, n, hkv, d)), dtype)
                vc = t(rng.standard_normal((b, n, hkv, d)), dtype)
                cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
                for use_pos, window, cap in ((False, 0, 0.0),
                                             (True, 100, 0.0),
                                             (True, 0, 30.0)):
                    pos = (torch.from_numpy(ring_positions(rng, b, n, lens,
                                                           0.1)).to(dev)
                           if use_pos else None)
                    kw = dict(cache_len=cl if use_pos else cl.clamp_max(n),
                              pos=pos, window=window, scale=scale,
                              softcap=cap)
                    exp = dk.decode_attention_plain(q, kc, vc, **kw)
                    lanes = None
                    if pos is not None:
                        vis = (pos >= 0) & (pos < cl[:, None])
                        if window:
                            vis &= pos > cl[:, None] - 1 - window
                        lanes = vis.any(1)
                    for splits in (None, 1):
                        record("decode_attention",
                               f"rep{rep} D{d} {'pos' if use_pos else 'len'} "
                               f"w{window} cap{cap:g} "
                               f"splits={splits or 'auto'}",
                               dk.decode_attention(q, kc, vc, splits=splits,
                                                   **kw), exp, dtype, lanes,
                               quiet=True)
    return worst


def paged_visible(pp, tab, cl, page, window=0):
    """(B, maxp * page) bool: the slots the paged oracle lets a lane see."""
    import torch
    b, maxp = tab.shape
    safe = tab.clamp_min(0).long()
    expected = torch.arange(maxp * page, device=tab.device)[None]
    vis = ((pp[safe].reshape(b, -1) == expected) & (expected < cl[:, None])
           & (tab >= 0).repeat_interleave(page, 1))
    if window:
        vis &= expected > cl[:, None] - 1 - window
    return vis


def check_paged_sweep(dev, rng, t, record) -> float:
    """The redesigned paged decode kernel over GQA ratios 1-16 at D 64, 128
    and 256, pages of 8, 16 and 12 (a size that does not divide the 64-slot
    tile), both dtypes, auto splits and one pass (summarised): 4 lanes of
    ragged lengths over a shuffled pool, lanes 0 and 1 sharing prefix
    pages, absent (-1) entries inside the range, stale pos rows (recycled
    pages), a lane with no page at all, and window and softcap variants.
    Every bf16 case is also held within ``PAGED_SPACINGS`` of the f32
    oracle on the lanes with a visible slot (an empty lane's mean rounds
    1/(maxp * page) to bf16, as the bf16 oracle does); returns the largest
    reading of the kernel and of the bf16 plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_decode_attention as pk

    worst, plain_worst = 0.0, 0.0
    hkv = 2
    lens = np.array([700, 1000, 333, 1])
    variants = ((0, 0.0), (100, 0.0), (0, 30.0))    # (window, softcap)
    for page in (8, 16, 12):
        maxp = -(-1024 // page)
        for rep in (1, 2, 4, 8, 16):
            for d in (64, 128, 256):
                hq, scale = hkv * rep, d ** -0.5
                tables, ppos = paged_layout(
                    rng, np.concatenate([lens, [500]]), page, maxp,
                    share=600 // page, holes=0.05, stale=0.05, empty=(4,))
                tab = torch.from_numpy(tables).to(dev)
                pp = torch.from_numpy(ppos).to(dev)
                cl = torch.as_tensor(np.concatenate([lens, [500]]),
                                     dtype=torch.int32, device=dev)
                for dtype in (torch.bfloat16, torch.float32):
                    q = t(rng.standard_normal((5, 1, hq, d)), dtype)
                    kp = t(rng.standard_normal((5 * maxp + 1, page, hkv, d)),
                           dtype)
                    vp = t(rng.standard_normal((5 * maxp + 1, page, hkv, d)),
                           dtype)
                    for window, cap in variants:
                        kw = dict(cache_len=cl, window=window, scale=scale,
                                  softcap=cap)
                        exp = pk.paged_decode_attention_plain(q, kp, vp, pp,
                                                              tab, **kw)
                        exp32 = None
                        if dtype == torch.bfloat16:
                            exp32 = pk.paged_decode_attention_plain(
                                q.float(), kp.float(), vp.float(), pp, tab,
                                **kw)
                            lanes = paged_visible(pp, tab, cl, page,
                                                  window).any(1)
                            plain_worst = max(plain_worst, bf16_spacings(
                                exp[lanes], exp32[lanes]))
                        for splits in (None, 1):
                            case = (f"page{page} rep{rep} D{d} w{window} "
                                    f"cap{cap:g} splits={splits or 'auto'}")
                            got = pk.paged_decode_attention(
                                q, kp, vp, pp, tab, splits=splits, **kw)
                            record("paged_decode_attention", case, got, exp,
                                   dtype, quiet=True)
                            if exp32 is None:
                                continue
                            sp = bf16_spacings(got[lanes], exp32[lanes])
                            worst = max(worst, sp)
                            if not sp <= PAGED_SPACINGS:
                                raise AssertionError(
                                    f"paged_decode_attention {case} bf16: "
                                    f"{sp:.3f} bf16 spacings from the f32 "
                                    f"oracle > {PAGED_SPACINGS}")
    return worst, plain_worst


NORM_WIDTHS = (64, 128, 256, 999, 1000, 1536, 2304, 2560, 3072, 4096, 5376,
               6144, 7168, 8192)
NORM_ROWS = (1, 8, 32, 40, 320, 1280)


def check_norm_sweep(dev, rng, t, record):
    """The four norm entry points over the widths the archs run (head_dim
    64/128/256, d_model 1536-8192 with musicgen-medium's 1536, minicpm-2b's
    2304, mixtral's 6144, arctic's 7168 and llama-3.2-vision's 8192,
    mamba2's d_inner 3072), an odd one (999:
    element-wise loads) and 1000, at 1 to 1280 rows (8 decode lanes and a
    32-token chunk among them), both dtypes, nonzero gains: the norm; the qk pair (k with a quarter of q's rows); the
    residual add, whose sum must equal ``x + y`` bit for bit; the gated
    norm with z read through a row stride from a wider projection."""
    import torch
    from repro_torch.kernels import rmsnorm as rk

    for dtype in (torch.bfloat16, torch.float32):
        for d in NORM_WIDTHS:
            sc = t(0.5 * rng.standard_normal(d), torch.float32)
            sk = t(0.5 * rng.standard_normal(d), torch.float32)
            for rows in NORM_ROWS:
                case = f"D{d} rows{rows}"
                x = t(2.0 * rng.standard_normal((rows, d)), dtype)
                y = t(rng.standard_normal((rows, d)), dtype)
                record("rmsnorm", f"norm {case}", rk.rmsnorm(x, sc, 1e-6),
                       rk.rmsnorm_plain(x, sc, 1e-6), dtype, quiet=True)
                k = t(rng.standard_normal((-(-rows // 4), d)), dtype)
                got = rk.rmsnorm_pair(x, k, sc, sk, 1e-6)
                exp = rk.rmsnorm_pair_plain(x, k, sc, sk, 1e-6)
                for g_, e_ in zip(got, exp):
                    record("rmsnorm", f"pair {case}", g_, e_, dtype,
                           quiet=True)
                s_, h_ = rk.add_rmsnorm(x, y, sc, 1e-6)
                if not torch.equal(s_, x + y):
                    raise AssertionError(f"add_rmsnorm {case} {dtype}: the "
                                         f"sum is not x + y bit for bit")
                record("rmsnorm", f"add {case}", h_,
                       rk.add_rmsnorm_plain(x, y, sc, 1e-6)[1], dtype,
                       quiet=True)
                z = t(2.0 * rng.standard_normal((rows, 2 * d + 8)),
                      dtype)[:, 8:8 + d]
                record("rmsnorm", f"gated {case}",
                       rk.gated_rmsnorm(y, z, sc, 1e-6),
                       rk.gated_rmsnorm_plain(y, z, sc, 1e-6), dtype,
                       quiet=True)


RGLRU_S = (1, 2, 31, 32, 33, 128, 129, 1024, 2300)


def check_rglru_sweep(dev, rng, record):
    """``rglru`` over prompt lengths from one token to 2300 (one tile in
    registers up to 128 steps, then tiles of 256 through the staged
    pipeline, ragged last tiles included), 1 and 8 rows, width 4096 and a
    narrow odd one (77: element-wise staging, a ragged channel group), both
    dtypes; the staged path also forced on short prompts, and over 20 tiles
    of a 5000-step one."""
    import torch
    from repro_torch.kernels import rglru_scan as gk

    cases = [(b, s, d, None) for s in RGLRU_S for b in (1, 8)
             for d in (4096, 77)]
    cases += [(1, 32, 4096, True), (8, 33, 77, True), (1, 128, 4096, True),
              (2, 5000, 77, None)]
    for b, s, d, staged in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args = rglru_inputs(rng, (b, s, d), dtype, dev)
            record("rglru", f"B{b} S{s} D{d} plan {gk.plan(s, staged)}",
                   gk.rglru(*args, staged=staged), gk.rglru_plain(*args),
                   dtype, quiet=True)


def check_ssd_sweep(dev, rng, record) -> float:
    """The redesigned ``ssd`` over the chunk widths the mixer gives
    (``models.ssm._ssd_chunk``: 1, 2, 17, 32, 100, 128), each over one chunk
    and several, both dtypes, at mamba2's widths (48 heads of 64, state
    128) and at two narrow ones (5 heads of 32 over a state of 64: an odd
    head count; 3 heads of 16 over 16: the smoke config's widths).  Every
    bf16 case is also held within ``P_SPACINGS`` of the f32 oracle, which
    fails if the hi/lo splits are dropped; returns the largest reading."""
    import torch
    from repro_torch.kernels import ssd_scan as sk

    worst = 0.0
    shapes = [(1, s, chunk, 48, 64, 128) for chunk, several in
              ((1, 37), (2, 130), (17, 51), (32, 96), (100, 300),
               (128, 384)) for s in (chunk, several)]
    shapes += [(2, 68, 17, 5, 32, 64), (2, 64, 16, 3, 16, 16)]
    for b, s, chunk, h, p, n in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            args = ssd_inputs(rng, b, s, h, p, n, dtype, dev, skip=s % 2 == 0)
            case = f"B{b} S{s} chunk{chunk} H{h} P{p} N{n}"
            got = sk.ssd(*args, chunk=chunk)
            record("ssd", case, got, sk.ssd_plain(*args, chunk=chunk), dtype,
                   quiet=True)
            if dtype != torch.bfloat16:
                continue
            up = [a.float() if a is not None else None for a in args]
            sp = bf16_spacings(got, sk.ssd_plain(*up, chunk=chunk))
            worst = max(worst, sp)
            if not sp <= P_SPACINGS:
                raise AssertionError(f"ssd {case} bf16: {sp:.3f} bf16 "
                                     f"spacings from the f32 oracle > "
                                     f"{P_SPACINGS}")
    return worst


def ssd_inputs(rng, b, s, h, p, n, dtype, dev, skip=True):
    """SSD scan inputs as the mamba2 mixer makes them: silu'd x, B and C,
    dt the softplus of a normal around the reference's dt_bias init
    (log-uniform dt in [0.001, 0.1]), a_log = log U(1, 16), unit skip."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    def dev_t(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), h))
    bias = dt0 + np.log(-np.expm1(-dt0))
    x = F.silu(dev_t(rng.standard_normal((b, s, h, p)), torch.float32))
    bm = F.silu(dev_t(rng.standard_normal((b, s, n)), torch.float32))
    cm = F.silu(dev_t(rng.standard_normal((b, s, n)), torch.float32))
    dt = F.softplus(dev_t(0.5 * rng.standard_normal((b, s, h)) + bias,
                          torch.float32))
    a_log = dev_t(np.log(rng.uniform(1.0, 16.0, h)), torch.float32)
    d_skip = torch.ones(h, device=dev) if skip else None
    return (x.to(dtype), dt.to(dtype), a_log, bm.to(dtype), cm.to(dtype),
            d_skip)


def rglru_inputs(rng, shape, dtype, dev):
    """RG-LRU scan inputs as the Griffin block makes them: x normal,
    log_a = -8 softplus(Lambda) sigmoid(r) with the reference's Lambda
    (a^8 spanning 0.9 .. 0.999 over the channels), a sigmoid gate."""
    import numpy as np
    import torch
    w = shape[-1]
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, w)) / 8.0))
    r = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
    log_a = -8.0 * np.log1p(np.exp(lam)) * r
    gate = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
                 for a in (rng.standard_normal(shape), log_a, gate))


# The attention shapes of the served archs: arch -> (query heads, KV heads,
# head dim, ring slots, window, chunk widths, whole-prompt lengths, lengths
# of the first paged lanes or None where the arch is not checked paged).
# mixtral-8x22b (GQA 6) and arctic-480b (GQA 7) are the ratios where a
# 64-row flash tile ends part way through a token's heads and the f32
# decode bodies take a group in blocks of the ratio's largest divisor
# within their limit.  musicgen-medium is MHA at D 64 over rings of its
# serve phase; llama-3.2-vision-90b's self-attention layers decode over the
# 1024-slot rings of its generation phase after a whole-prompt prefill
# (its stack takes no chunked prefill: no chunk widths).
SERVE_SHAPES = {
    "minicpm-2b": (36, 36, 64, 2048, 0, (1, 8, 32), (64, 512, 1024), None),
    "recurrentgemma-9b": (16, 1, 256, 2048, 2048, (32,), (512, 2304),
                          (3000, 4096, 1, 2100)),
    "mixtral-8x22b": (48, 8, 128, 4096, 4096, (1, 17, 32), (64, 1024), None),
    "arctic-480b": (56, 8, 128, 2048, 0, (1, 17, 32), (64, 1024),
                    (700, 900, 1, 2048)),
    "musicgen-medium": (24, 24, 64, 2048, 0, (1, 8, 32), (64, 512, 1024),
                        (700, 900, 1, 2048)),
    "llama-3.2-vision-90b": (64, 8, 128, 1024, 0, (), (64, 512), None),
}

# llama-3.2-vision-90b's cross-attention layers: 64 query heads over 8 KV
# heads of 128, over its 1601 image tokens (25 key tiles of 64 and one key
# in a 26th).
ENC_SHAPE = (64, 8, 128, 1601)


def check_attention_enc(dev, rng, t, record) -> dict:
    """The two kernel forms of a cross-attention layer at
    llama-3.2-vision's shapes (``ENC_SHAPE``), 8 lanes with distinct keys:
    flash with ``causal=False`` (the prefill), S of 1, 17, 64 and 512
    queries over all 1601 keys at ``k_pos = arange(1601)``; and the
    contiguous decode kernel (``pos=None``, the decode step), one query per
    lane over n = 1601 slots with ``cache_len = 1601`` on every lane.  Both
    dtypes, auto splits and one pass.  Returns (cases, max |err|) by kernel
    and dtype."""
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk

    hq, hkv, d, n = ENC_SHAPE
    b, scale = 8, d ** -0.5
    summary = {}
    kp = torch.arange(n, dtype=torch.int32, device=dev)
    cl = torch.full((b,), n, dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        k = t(rng.standard_normal((b, n, hkv, d)), dtype)
        v = t(rng.standard_normal((b, n, hkv, d)), dtype)
        q = t(rng.standard_normal((b, 1, hq, d)), dtype)
        kw = dict(cache_len=cl, pos=None, scale=scale)
        exp = dk.decode_attention_plain(q, k, v, **kw)
        for splits in (None, 1):
            record("decode_attention",
                   f"enc B8 n{n} all visible splits={splits or 'auto'}",
                   dk.decode_attention(q, k, v, splits=splits, **kw), exp,
                   dtype, quiet=summary)
        for s_ in (1, 17, 64, 512):
            qs = t(rng.standard_normal((b, s_, hq, d)), dtype)
            qp = torch.zeros(s_, dtype=torch.int32, device=dev)
            kw = dict(q_pos=qp, k_pos=kp, causal=False, window=0, scale=scale)
            exp = fk.flash_attention_plain(qs, k, v, **kw)
            for splits in (None, 1):
                record("flash_attention",
                       f"enc B8 S{s_} over C{n} not causal "
                       f"splits={splits or 'auto'}",
                       fk.flash_attention(qs, k, v, splits=splits, **kw), exp,
                       dtype, quiet=summary)
            del exp
    return summarize("cross-attention (llama-3.2-vision)", summary)


def summarize(what: str, summary: dict) -> dict:
    """Log one line for each (kernel, dtype) of a quiet summary and return
    it keyed by ``"what kernel dtype"``."""
    out = {}
    for (name, dt), (cases, err) in sorted(summary.items()):
        log(f"  {what} {name} {dt}: {cases} cases, max|err| {err:.3e}")
        out[f"{what} {name} {dt}"] = (cases, err)
    return out


def check_attention_serve(dev, rng, t, record) -> dict:
    """The three attention kernels at each served arch's shapes
    (``SERVE_SHAPES``), 8 lanes: ring decode over ragged rings (one slot to
    full) and over wrapped rings with holes; paged decode, where the entry
    names lanes, over pages of 16 with shared, absent and stale pages and
    an empty lane; flash chunks over an empty, a partial, a full and a
    wrapped ring, through the two key sources as the chunked prefill passes
    them and as one concatenated source; whole prompts.  Both dtypes, auto
    splits and one pass.  One line is logged for each arch, kernel and
    dtype.  Returns (cases, max |err|) by arch, kernel and dtype."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk

    b, page = 8, 16
    both = (torch.bfloat16, torch.float32)
    seen = {}
    for arch, (hq, hkv, d, n, win, chunks, prompts,
               paged) in SERVE_SHAPES.items():
        scale = d ** -0.5
        tag = f"{arch} Hq{hq} Hkv{hkv} D{d}"
        summary = {}
        ragged = np.concatenate([[1, n], rng.integers(1, n + 1, b - 2)])
        wrapped = np.concatenate([[n + 1, 2 * n],
                                  rng.integers(n // 2, 3 * n, b - 2)])
        for dtype in both:
            q = t(rng.standard_normal((b, 1, hq, d)), dtype)
            kc = t(rng.standard_normal((b, n, hkv, d)), dtype)
            vc = t(rng.standard_normal((b, n, hkv, d)), dtype)
            for lens, holes, what in ((ragged, 0.0, "ragged"),
                                      (wrapped, 0.1, "wrapped+holes")):
                cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
                pos = torch.from_numpy(ring_positions(rng, b, n, lens,
                                                      holes)).to(dev)
                kw = dict(cache_len=cl, pos=pos, window=win, scale=scale)
                exp = dk.decode_attention_plain(q, kc, vc, **kw)
                vis = (pos >= 0) & (pos < cl[:, None])
                if win:
                    vis &= pos > cl[:, None] - 1 - win
                for splits in (None, 1):
                    record("decode_attention",
                           f"{tag} B8 n{n} w{win} {what} "
                           f"splits={splits or 'auto'}",
                           dk.decode_attention(q, kc, vc, splits=splits, **kw),
                           exp, dtype, vis.any(1), quiet=summary)

        if paged:
            reach = max(paged)
            maxp = reach // page
            plens = np.concatenate([paged, rng.integers(1, reach + 1,
                                                        b - len(paged))])
            tables, ppos = paged_layout(rng, plens, page, maxp,
                                        share=reach // 4 // page, holes=0.05,
                                        stale=0.05, empty=(7,))
            tab = torch.from_numpy(tables).to(dev)
            pp = torch.from_numpy(ppos).to(dev)
            cl = torch.as_tensor(plens, dtype=torch.int32, device=dev)
            for dtype in both:
                q = t(rng.standard_normal((b, 1, hq, d)), dtype)
                kp = t(rng.standard_normal((b * maxp + 1, page, hkv, d)),
                       dtype)
                vp = t(rng.standard_normal((b * maxp + 1, page, hkv, d)),
                       dtype)
                kw = dict(cache_len=cl, window=win, scale=scale)
                exp = pk.paged_decode_attention_plain(q, kp, vp, pp, tab, **kw)
                for splits in (None, 1):
                    record("paged_decode_attention",
                           f"{tag} B8 page16 maxp{maxp} w{win} "
                           f"shuffled+holes+stale+shared "
                           f"splits={splits or 'auto'}",
                           pk.paged_decode_attention(q, kp, vp, pp, tab,
                                                     splits=splits, **kw),
                           exp, dtype, quiet=summary)

        for dtype in both:
            for c in chunks:
                qc = t(rng.standard_normal((1, c, hq, d)), dtype)
                kc = t(rng.standard_normal((1, n + c, hkv, d)), dtype)
                vc = t(rng.standard_normal((1, n + c, hkv, d)), dtype)
                for start in (0, 700, n, n + 1500):
                    ring = ring_positions(rng, 1, n, [start])
                    qp = torch.arange(start, start + c, dtype=torch.int32,
                                      device=dev)
                    kp = torch.cat([torch.from_numpy(ring).to(dev), qp[None]],
                                   1)
                    kw = dict(q_pos=qp, k_pos=kp, causal=True, window=win,
                              scale=scale)
                    exp = fk.flash_attention_plain(qc, kc, vc, **kw)
                    two = dict(kw, k_pos=qp, k_cache=kc[:, :n].contiguous(),
                               v_cache=vc[:, :n].contiguous(),
                               cache_pos=kp[:, :n])
                    for splits in (None, 1):
                        case = (f"{tag} chunk C{c} ring{n} start{start} "
                                f"w{win} splits={splits or 'auto'}")
                        record("flash_attention", case,
                               fk.flash_attention(qc, kc, vc, splits=splits,
                                                  **kw),
                               exp, dtype, quiet=summary)
                        record("flash_attention", f"{case} two sources",
                               fk.flash_attention(qc, kc[:, n:], vc[:, n:],
                                                  splits=splits, **two),
                               exp, dtype, quiet=summary)
            for s in prompts:
                qs = t(rng.standard_normal((1, s, hq, d)), dtype)
                ks = t(rng.standard_normal((1, s, hkv, d)), dtype)
                vs = t(rng.standard_normal((1, s, hkv, d)), dtype)
                ar = torch.arange(s, dtype=torch.int32, device=dev)
                kw = dict(q_pos=ar, k_pos=ar, causal=True, window=win,
                          scale=scale)
                exp = fk.flash_attention_plain(qs, ks, vs, **kw)
                for splits in (None, 1):
                    record("flash_attention",
                           f"{tag} prompt S{s} w{win} "
                           f"splits={splits or 'auto'}",
                           fk.flash_attention(qs, ks, vs, splits=splits, **kw),
                           exp, dtype, quiet=summary)
        seen.update(summarize(arch, summary))
    return seen


def check_attention_gqa_cross(dev, rng, t, record) -> dict:
    """The three attention kernels over GQA ratios 3, 5, 6 and 7 at D 64,
    128 and 256, none of which divides a 64-row flash tile: 2 KV
    heads, 4 lanes; ring decode over a 512-slot ring (the last lane
    wrapped) with a window, paged decode over pages of 16 with softcap, a
    17-query chunk over a wrapped 300-slot ring (two sources) and a
    129-token prompt.  Both dtypes.  Returns (cases, max |err|) by kernel
    and dtype."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk

    summary = {}
    both = (torch.bfloat16, torch.float32)
    hkv, b, n = 2, 4, 512
    lens = np.array([1, 300, 512, 900])
    for rep in (3, 5, 6, 7):
        for d in (64, 128, 256):
            hq, scale = hkv * rep, d ** -0.5
            tables, ppos = paged_layout(rng, lens, 16, 64, share=10,
                                        holes=0.05, stale=0.05)
            tab = torch.from_numpy(tables).to(dev)
            pp = torch.from_numpy(ppos).to(dev)
            cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
            pos = torch.from_numpy(ring_positions(rng, b, n, lens,
                                                  0.1)).to(dev)
            for dtype in both:
                case = f"GQA{rep} D{d}"
                q = t(rng.standard_normal((b, 1, hq, d)), dtype)
                kc = t(rng.standard_normal((b, n, hkv, d)), dtype)
                vc = t(rng.standard_normal((b, n, hkv, d)), dtype)
                kw = dict(cache_len=cl, pos=pos, window=100, scale=scale)
                exp = dk.decode_attention_plain(q, kc, vc, **kw)
                vis = ((pos >= 0) & (pos < cl[:, None])
                       & (pos > cl[:, None] - 101))
                kp = t(rng.standard_normal((b * 64 + 1, 16, hkv, d)), dtype)
                vp = t(rng.standard_normal((b * 64 + 1, 16, hkv, d)), dtype)
                pkw = dict(cache_len=cl, window=0, scale=scale, softcap=30.0)
                pexp = pk.paged_decode_attention_plain(q, kp, vp, pp, tab,
                                                       **pkw)
                for splits in (None, 1):
                    record("decode_attention", f"cross {case} splits={splits}",
                           dk.decode_attention(q, kc, vc, splits=splits, **kw),
                           exp, dtype, vis.any(1), quiet=summary)
                    record("paged_decode_attention",
                           f"cross {case} splits={splits}",
                           pk.paged_decode_attention(q, kp, vp, pp, tab,
                                                     splits=splits, **pkw),
                           pexp, dtype, quiet=summary)
                c, start = 17, 800
                qc = t(rng.standard_normal((2, c, hq, d)), dtype)
                kn = t(rng.standard_normal((2, c, hkv, d)), dtype)
                vn = t(rng.standard_normal((2, c, hkv, d)), dtype)
                ring = torch.from_numpy(ring_positions(
                    rng, 2, 300, [start] * 2, 0.1)).to(dev)
                qp = torch.arange(start, start + c, dtype=torch.int32,
                                  device=dev)
                kw = dict(q_pos=qp, k_pos=qp, causal=True, window=0,
                          scale=scale, k_cache=kc[:2, :300].contiguous(),
                          v_cache=vc[:2, :300].contiguous(), cache_pos=ring)
                exp = fk.flash_attention_plain(qc, kn, vn, **kw)
                for splits in (None, 1):
                    record("flash_attention",
                           f"cross {case} chunk splits={splits}",
                           fk.flash_attention(qc, kn, vn, splits=splits, **kw),
                           exp, dtype, quiet=summary)
                s = 129
                qs = t(rng.standard_normal((1, s, hq, d)), dtype)
                ks = t(rng.standard_normal((1, s, hkv, d)), dtype)
                vs = t(rng.standard_normal((1, s, hkv, d)), dtype)
                ar = torch.arange(s, dtype=torch.int32, device=dev)
                kw = dict(q_pos=ar, k_pos=ar, causal=True, window=0,
                          scale=scale)
                record("flash_attention", f"cross {case} prompt S{s}",
                       fk.flash_attention(qs, ks, vs, **kw),
                       fk.flash_attention_plain(qs, ks, vs, **kw), dtype,
                       quiet=summary)
    return summarize("GQA cross", summary)


def check_moe(dev) -> None:
    """Phase 2: ``moe_ffn`` on the card against ``ref.moe_ffn_reference``
    (a plain loop over tokens and choices) on the card, on one layer's
    weights at full width drawn from the seed: mixtral-8x22b (8 experts
    of 6144 x 16384) in f32 with TF32 off and in bf16, arctic-480b (128
    experts of 7168 x 4864 and its dense FFN) in bf16.  Inputs: an 8-row
    decode batch and a 32-token chunk of normal rows, and the same two
    shapes of identical rows, which at the published capacity factor 1.25
    must drop choices (arctic's 8 rows: 8 choices on each of two experts
    over a capacity of 4; mixtral's 32 rows: 32 over 12).  Tolerance
    relative to max(1, max|ref|): f32 2e-5, bf16 2^-7; the rows that lose
    both choices (zero where there is no dense FFN) must be the same.
    Logs the kept (token, choice) pairs of each case."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.models import moe

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for arch, dtype in (("mixtral-8x22b", torch.float32),
                        ("mixtral-8x22b", torch.bfloat16),
                        ("arctic-480b", torch.bfloat16)):
        cfg = get_config(arch).replace(dtype=dtype)
        p = blocks.Experts(cfg, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        M.init_moe_(p, gen)
        d, k = cfg.d_model, cfg.num_experts_per_tok
        lim_rel = 2e-5 if dtype == torch.float32 else 2.0 ** -7
        for what, shape in (("decode B8", (8, 1, d)),
                            ("chunk C32", (1, 32, d))):
            for same in (False, True):
                if same:
                    one = rng.standard_normal((1, 1, d))
                    x = np.broadcast_to(one, shape)
                else:
                    x = rng.standard_normal(shape)
                x = torch.from_numpy(np.ascontiguousarray(x, np.float32)
                                     ).to(dev, dtype)
                y, aux = moe.moe_ffn(p, x, cfg)
                r, kept = ref.moe_ffn_reference(p, x, cfg)
                torch.cuda.synchronize()
                if not (torch.isfinite(y).all() and torch.isfinite(aux)):
                    raise AssertionError(f"moe {arch} {what}: non-finite")
                err = (y.float() - r.float()).abs().max().item()
                lim = lim_rel * max(1.0, r.float().abs().max().item())
                t = shape[0] * shape[1]
                case = (f"{arch} {str(dtype)[6:]} {what}"
                        f"{' identical rows' if same else ''}")
                log(f"  moe_ffn {case:48s} max|err| {err:.3e} tol "
                    f"{lim:.1e}; kept {len(kept)} of {t * k} choices "
                    f"(capacity {moe.expert_capacity(t, cfg)})")
                if not err <= lim:
                    raise AssertionError(f"moe_ffn {case}: {err} > {lim}")
                if not cfg.moe_dense_ff and not torch.equal(
                        y.abs().amax(-1) == 0, r.abs().amax(-1) == 0):
                    raise AssertionError(f"moe_ffn {case}: dropped rows "
                                         f"differ from the reference's")
                if same and len(kept) >= t * k:
                    raise AssertionError(f"moe_ffn {case}: no choice dropped")
                out[case] = dict(max_abs_err=err, tol=lim, kept=len(kept),
                                 choices=t * k,
                                 capacity=moe.expert_capacity(t, cfg))
        del p
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    DETAILS["moe"] = out


def time_kernels(dev):
    """Kernel, plain and library times at the shapes the serve phase runs
    most, in bf16, with each kernel's bound from these inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk

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
        read_flush_ms=device_ms(lambda: dk.decode_attention(q, kc, vc, **kw),
                                flush, how="read"),
        warm_ms=device_ms(lambda: dk.decode_attention(q, kc, vc, **kw),
                          flush, how="none"),
        empty_ms=device_ms(lambda: dk.decode_attention(
            q, kc, vc, **dict(kw, cache_len=torch.zeros_like(cl))), flush),
        stream_ms=stream_ms(nbytes, dev, flush),
        bound_ms=bms, bound_by=by)

    # paged decode at the ring row's shape: the same lanes' lengths over a
    # shuffled pool of 16-token pages.  No single PyTorch call computes
    # paged attention: the library row is SDPA with a boolean mask over K/V
    # gathered through the tables beforehand, the gather left out of the
    # time.
    page, maxp = 16, n // 16
    tables, ppos = paged_layout(rng, lens, page, maxp)
    tab = torch.from_numpy(tables).to(dev)
    pp = torch.from_numpy(ppos).to(dev)
    kp = rnd((b * maxp + 1, page, hkv, d))
    vp = rnd((b * maxp + 1, page, hkv, d))
    kw = dict(cache_len=cl, window=0, scale=scale)
    safe = tab.clamp_min(0).long()
    kg = kp[safe].reshape(b, maxp * page, hkv, d)
    vg = vp[safe].reshape(b, maxp * page, hkv, d)
    pvis = paged_visible(pp, tab, cl, page)
    live_pages = int(((tab >= 0) & (torch.arange(maxp, device=dev)[None] * page
                                    < cl[:, None])).sum())
    nbytes = (live_pages * page * (hkv * d * 2 * 2 + 4) + 2 * q.numel() * 2
              + tab.numel() * 4 + b * 4)
    bms, by = bound(nbytes, 4 * hq * d * int(pvis.sum()), PEAK_BF16_FLOPS)
    rows["paged_decode_attention"] = dict(
        shape=(f"B={b} pages of {page}, {maxp} per lane, Hq={hq} Hkv={hkv} "
               f"D={d} bf16 ragged, shuffled pool, "
               f"{pk.auto_splits(b, hkv, maxp, page, dev)} splits"),
        **timings(lambda: pk.paged_decode_attention(q, kp, vp, pp, tab, **kw),
                  lambda: pk.paged_decode_attention_plain(q, kp, vp, pp, tab,
                                                          **kw),
                  lambda: sdpa(q, kg, vg, attn_mask=pvis[:, None, None, :],
                               scale=scale)),
        library_note="SDPA over K/V gathered beforehand (gather not timed)",
        single_pass_ms=device_ms(
            lambda: pk.paged_decode_attention(q, kp, vp, pp, tab, splits=1,
                                              **kw), flush),
        read_flush_ms=device_ms(
            lambda: pk.paged_decode_attention(q, kp, vp, pp, tab, **kw),
            flush, how="read"),
        warm_ms=device_ms(
            lambda: pk.paged_decode_attention(q, kp, vp, pp, tab, **kw),
            flush, how="none"),
        **paged_fixed_ms(q, kp, vp, pp, tab, kw, flush),
        stream_ms=stream_ms(nbytes, dev, flush),
        bound_ms=bms, bound_by=by)

    # flash: the chunk the engine runs most, 32 queries over a full ring,
    # the ring passed beside the chunk as the serving path passes it (SDPA
    # gets the two concatenated beforehand, the concatenation not timed)
    c, start = 32, 2500
    qc, kc2, vc2 = rnd((1, c, hq, d)), rnd((1, n + c, hkv, d)), rnd((1, n + c, hkv, d))
    qp = torch.arange(start, start + c, dtype=torch.int32, device=dev)
    kp = torch.cat([torch.from_numpy(ring_positions(rng, 1, n, [start])).to(dev),
                    qp[None]], 1)
    kn, vn = kc2[:, n:].contiguous(), vc2[:, n:].contiguous()
    kw = dict(q_pos=qp, k_pos=qp, causal=True, window=0, scale=scale,
              k_cache=kc2[:, :n].contiguous(), v_cache=vc2[:, :n].contiguous(),
              cache_pos=kp[:, :n].contiguous())
    vis = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[None, :, None])
    pairs = int(vis.sum())
    keys_read = int(vis.any(1).sum())
    nbytes = keys_read * hkv * d * 2 * 2 + 2 * qc.numel() * 2 + 4 * (n + 2 * c)
    bms, by = bound(nbytes, 4 * hq * d * pairs, PEAK_BF16_FLOPS)
    rows["flash_attention"] = dict(
        shape=(f"chunk C={c} over a ring of n={n} Hq={hq} Hkv={hkv} D={d} "
               f"bf16, {fk.auto_splits(1, c, hq, hkv, n + c, dev)} splits"),
        **timings(lambda: fk.flash_attention(qc, kn, vn, **kw),
                  lambda: fk.flash_attention_plain(qc, kn, vn, **kw),
                  lambda: sdpa(qc, kc2, vc2, attn_mask=vis[:, None],
                               scale=scale)),
        single_pass_ms=device_ms(
            lambda: fk.flash_attention(qc, kn, vn, splits=1, **kw), flush),
        read_flush_ms=device_ms(lambda: fk.flash_attention(qc, kn, vn, **kw),
                                flush, how="read"),
        warm_ms=device_ms(lambda: fk.flash_attention(qc, kn, vn, **kw),
                          flush, how="none"),
        empty_ms=device_ms(lambda: fk.flash_attention(
            qc, kn, vn, **nothing_visible(kw)), flush),
        bound_ms=bms, bound_by=by)
    # whole-prompt prefill S=512, reported beside the chunk
    s = 512
    qs, ks, vs = rnd((1, s, hq, d)), rnd((1, s, hkv, d)), rnd((1, s, hkv, d))
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    kw = dict(q_pos=ar, k_pos=ar, causal=True, window=0, scale=scale)
    pairs = s * (s + 1) // 2
    bms, by = bound(2 * qs.numel() * 2 + 2 * ks.numel() * 2 + 2 * s * 4,
                    4 * hq * d * pairs, PEAK_BF16_FLOPS)
    rows["flash_attention"]["prompt512"] = dict(
        **timings(lambda: fk.flash_attention(qs, ks, vs, **kw),
                  lambda: fk.flash_attention_plain(qs, ks, vs, **kw),
                  lambda: sdpa(qs, ks, vs, is_causal=True, scale=scale)),
        # every block over every key tile: against the causal time, whether
        # the work or the longest block's walk sets it
        noncausal_ms=device_ms(lambda: fk.flash_attention(
            qs, ks, vs, **dict(kw, causal=False)), flush),
        bound_ms=bms, bound_by=by)

    # cross-attention at llama-3.2-vision's shapes (``ENC_SHAPE``), 8 lanes
    # with their own image tokens: the prefill's flash, 512 queries a lane
    # over all 1601 keys (not causal), and the decode step's contiguous
    # decode, one query a lane with every slot visible.  The library row is
    # SDPA over the same keys with no mask.
    ehq, ehkv, ed, en = ENC_SHAPE
    escale = ed ** -0.5
    ke, ve = rnd((b, en, ehkv, ed)), rnd((b, en, ehkv, ed))
    kv_bytes = 2 * ke.numel() * 2
    qe = rnd((b, s, ehq, ed))
    kw = dict(q_pos=torch.zeros(s, dtype=torch.int32, device=dev),
              k_pos=torch.arange(en, dtype=torch.int32, device=dev),
              causal=False, window=0, scale=escale)
    bms, by = bound(2 * qe.numel() * 2 + kv_bytes + (s + en) * 4,
                    4 * b * s * ehq * en * ed, PEAK_BF16_FLOPS)
    rows["flash_attention"]["cross1601"] = dict(
        shape=(f"B={b} S={s} over C={en} Hq={ehq} Hkv={ehkv} D={ed} bf16 not "
               f"causal, {fk.auto_splits(b, s, ehq, ehkv, en, dev)} splits"),
        **timings(lambda: fk.flash_attention(qe, ke, ve, **kw),
                  lambda: fk.flash_attention_plain(qe, ke, ve, **kw),
                  lambda: sdpa(qe, ke, ve, scale=escale)),
        bound_ms=bms, bound_by=by)
    q1 = rnd((b, 1, ehq, ed))
    kw = dict(cache_len=torch.full((b,), en, dtype=torch.int32, device=dev),
              pos=None, scale=escale)
    bms, by = bound(kv_bytes + 2 * q1.numel() * 2 + b * 4,
                    4 * b * ehq * en * ed, PEAK_BF16_FLOPS)
    rows["decode_attention"]["cross1601"] = dict(
        shape=(f"B={b} n={en} Hq={ehq} Hkv={ehkv} D={ed} bf16 contiguous, "
               f"every slot visible, {dk.auto_splits(b, ehkv, en, dev)} "
               f"splits"),
        **timings(lambda: dk.decode_attention(q1, ke, ve, **kw),
                  lambda: dk.decode_attention_plain(q1, ke, ve, **kw),
                  lambda: sdpa(q1, ke, ve, scale=escale)),
        single_pass_ms=device_ms(
            lambda: dk.decode_attention(q1, ke, ve, splits=1, **kw), flush),
        stream_ms=stream_ms(kv_bytes, dev, flush),
        bound_ms=bms, bound_by=by)

    # rmsnorm: the decode step's d_model rows (8 lanes x 2560), its fixed
    # cost (one row), and each fused form at its decode shape beside what
    # it replaces (the plain version: the unfused expression)
    rows["rmsnorm"] = time_norms(dev, rnd, flush, timings)

    # ssd: the 32-token chunk of mamba2's serving path (48 heads of 64,
    # state 128), with its fixed cost (the same widths at one token), and a
    # 1024-token prompt in chunks of 128, split by kernel.  No PyTorch call
    # computes the SSD scan: no library time.
    from repro_torch.kernels import ssd_scan as sk
    for (s_, chunk), key in (((32, 32), None), ((1024, 128), "prompt1024")):
        args = ssd_inputs(rng, 1, s_, 48, 64, 128, bf, dev)
        bms, by = bound(ssd_bytes(args), ssd_flops(args, chunk),
                        PEAK_BF16_FLOPS)
        row = dict(shape=f"B=1 S={s_} chunk={chunk} H=48 P=64 N=128 bf16",
                   **timings(lambda: sk.ssd(*args, chunk=chunk),
                             lambda: sk.ssd_plain(*args, chunk=chunk), None),
                   bound_ms=bms, bound_by=by)
        if key is None:
            one = ssd_inputs(rng, 1, 1, 48, 64, 128, bf, dev)
            row["one_token_ms"] = device_ms(lambda: sk.ssd(*one, chunk=1),
                                            flush)
            rows["ssd"] = row
        else:
            row["by_kernel_ms"] = kernel_breakdown(
                lambda: sk.ssd(*args, chunk=chunk), flush)
            rows["ssd"][key] = row

    # rglru: recurrentgemma's width, a 32-token chunk, its fixed cost (one
    # token) and the same chunk through the staged path, and the prompts.
    # No PyTorch call computes the scan: no library time.
    from repro_torch.kernels import rglru_scan as gk
    for shape, key in (((1, 32, 4096), None), ((1, 1024, 4096), "prompt1024"),
                       ((1, 2300, 4096), "prompt2300")):
        args = rglru_inputs(rng, shape, bf, dev)
        elems = args[0].numel()
        # per element: exp, exp(2l), 1 - e, sqrt, two products, one FMA
        bms, by = bound(4 * elems * 2, 8 * elems, PEAK_F32_FLOPS)
        row = dict(shape="x".join(map(str, shape)) + " bf16",
                   **timings(lambda: gk.rglru(*args),
                             lambda: gk.rglru_plain(*args), None),
                   bound_ms=bms, bound_by=by)
        if key is None:
            one = rglru_inputs(rng, (1, 1, 4096), bf, dev)
            row["fixed_ms"] = device_ms(lambda: gk.rglru(*one), flush)
            row["issue_us"] = issue_us(lambda: gk.rglru(*args))
            row["staged_ms"] = device_ms(
                lambda: gk.rglru(*args, staged=True), flush)
            rows["rglru"] = row
        else:
            row["warm_ms"] = device_ms(lambda: gk.rglru(*args), flush,
                                       how="none")
            rows["rglru"][key] = row

    for name, row in time_attention_d256(dev, rng, flush, timings,
                                         sdpa).items():
        rows[name]["d256"] = row
    for name in ("decode_attention", "flash_attention",
                 "paged_decode_attention", "ssd", "rmsnorm", "rglru"):
        row = rows[name]
        for key, at in (("ms", row), ("d256", row.get("d256")),
                        ("prompt512", row.get("prompt512")),
                        ("cross1601", row.get("cross1601")),
                        ("prompt1024", row.get("prompt1024")),
                        ("prompt2300", row.get("prompt2300")),
                        ("pair", row.get("pair")), ("add", row.get("add")),
                        ("gated", row.get("gated"))):
            if at is None:
                continue
            lib = at["library_ms"]
            log(f"  {name:16s} {key:10s} {at['ms']:.4f} ms; bound "
                f"{at['bound_ms']:.4f} ({at['bound_by']}), plain "
                f"{at['plain_ms']:.4f}, library "
                + ("none" if lib is None else f"{lib:.4f}")
                + "".join(f"; {label} {at[k]:.4f}" for k, label in (
                    ("single_pass_ms", "one split"),
                    ("read_flush_ms", "after a read flush"),
                    ("warm_ms", "no flush"),
                    ("empty_ms", "nothing visible"),
                    ("one_slot_ms", "one slot visible"),
                    ("one_token_ms", "one token"),
                    ("fixed_ms", "fixed cost"),
                    ("staged_ms", "through the staged path"),
                    ("issue_us", "host issue us"),
                    ("unfused_issue_us", "unfused host issue us"),
                    ("stream_ms", "streaming its bytes"),
                    ("noncausal_ms", "not causal")) if k in at))
    return rows


def issue_us(fn, n: int = 200) -> float:
    """Host issue cost of one call: the wall time of ``n`` back-to-back
    calls, with a device sync before and after, over ``n`` (microseconds).
    At these shapes the device keeps up, so this is the host's time."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def time_norms(dev, rnd, flush, timings) -> dict:
    """The norm kernel's rows, bf16: the plain norm at 8 x 2560 with its
    fixed cost (one row) and ``F.rms_norm``; the qk pair at decode (q 8 x
    32 x 128, k 8 x 8 x 128); the residual add at 8 x 2560; mamba2's gated
    norm at 8 x 3072 with z a slice of the projection.  Each fused form
    beside its plain version (the unfused expression: two norms, the add
    then the norm, the gate then the norm), with the host issue cost of
    both."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rk
    bf = torch.bfloat16

    def gain(d):
        return 0.1 * rnd((d,)).float()

    def nbytes(*ts):
        return sum(t_.numel() * t_.element_size() for t_ in ts)

    x, sc = rnd((8, 2560)), gain(2560)
    w = (1.0 + sc).to(bf)
    bms, by = bound(2 * nbytes(x) + nbytes(sc), 4 * x.numel(),
                    PEAK_F32_FLOPS)
    one = rnd((1, 2560))
    row = dict(shape="8 x 2560 bf16",
               **timings(lambda: rk.rmsnorm(x, sc, 1e-6),
                         lambda: rk.rmsnorm_plain(x, sc, 1e-6),
                         (lambda: F.rms_norm(x, (2560,), weight=w, eps=1e-6))
                         if hasattr(F, "rms_norm") else None),
               fixed_ms=device_ms(lambda: rk.rmsnorm(one, sc, 1e-6), flush),
               issue_us=issue_us(lambda: rk.rmsnorm(x, sc, 1e-6)),
               bound_ms=bms, bound_by=by)

    q, k = rnd((8, 1, 32, 128)), rnd((8, 1, 8, 128))
    qs, ks = gain(128), gain(128)
    bms, by = bound(2 * nbytes(q, k) + nbytes(qs, ks),
                    4 * (q.numel() + k.numel()), PEAK_F32_FLOPS)
    row["pair"] = dict(
        shape="q 8x1x32x128, k 8x1x8x128 bf16",
        **timings(lambda: rk.rmsnorm_pair(q, k, qs, ks, 1e-6),
                  lambda: rk.rmsnorm_pair_plain(q, k, qs, ks, 1e-6), None),
        unfused_ms=device_ms(lambda: (rk.rmsnorm(q, qs, 1e-6),
                                      rk.rmsnorm(k, ks, 1e-6)), flush),
        issue_us=issue_us(lambda: rk.rmsnorm_pair(q, k, qs, ks, 1e-6)),
        unfused_issue_us=issue_us(lambda: (rk.rmsnorm(q, qs, 1e-6),
                                           rk.rmsnorm(k, ks, 1e-6))),
        bound_ms=bms, bound_by=by)

    y = rnd((8, 2560))
    bms, by = bound(4 * nbytes(x) + nbytes(sc), 5 * x.numel(),
                    PEAK_F32_FLOPS)
    row["add"] = dict(
        shape="8 x 2560 bf16",
        **timings(lambda: rk.add_rmsnorm(x, y, sc, 1e-6),
                  lambda: rk.add_rmsnorm_plain(x, y, sc, 1e-6), None),
        unfused_ms=device_ms(lambda: rk.rmsnorm(x + y, sc, 1e-6), flush),
        issue_us=issue_us(lambda: rk.add_rmsnorm(x, y, sc, 1e-6)),
        unfused_issue_us=issue_us(lambda: rk.rmsnorm(x + y, sc, 1e-6)),
        bound_ms=bms, bound_by=by)

    proj = rnd((8, 2 * 3072 + 2 * 128 + 48))
    z, yg, sg = proj[:, :3072], rnd((8, 3072)), gain(3072)
    bms, by = bound(3 * nbytes(yg) + nbytes(sg), 10 * yg.numel(),
                    PEAK_F32_FLOPS)
    row["gated"] = dict(
        shape="8 x 3072 bf16, z a slice of the (8, 6448) projection",
        **timings(lambda: rk.gated_rmsnorm(yg, z, sg, 1e-6),
                  lambda: rk.gated_rmsnorm_plain(yg, z, sg, 1e-6), None),
        unfused_ms=device_ms(lambda: rk.rmsnorm(yg * F.silu(z), sg, 1e-6),
                             flush),
        issue_us=issue_us(lambda: rk.gated_rmsnorm(yg, z, sg, 1e-6)),
        unfused_issue_us=issue_us(
            lambda: rk.rmsnorm(yg * F.silu(z), sg, 1e-6)),
        bound_ms=bms, bound_by=by)
    return row


def ssd_bytes(args) -> int:
    """Bytes the SSD scan must move: each input read once, y written."""
    x = args[0]
    return (2 * x.numel() * x.element_size()
            + sum(a.numel() * a.element_size() for a in args[1:]
                  if a is not None))


def ssd_flops(args, chunk: int) -> int:
    """Operations of the chunked SSD scan on these inputs: per batch row
    and chunk the lower-triangle score C.B^T, once, since every head shares
    the one B/C group; per head and chunk its product with xb, and for
    every chunk but the first the carried-state term C.h and for every
    chunk but the last the state update, each 2 N P per position."""
    x, b_mat = args[0], args[3]
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    per_head = nc * pairs * 2 * p + 2 * (nc - 1) * 2 * chunk * n * p
    return b * nc * pairs * 2 * n + b * h * per_head


def time_attention_d256(dev, rng, flush, timings, sdpa):
    """The three attention kernels at recurrentgemma's local-attention
    shapes (D 256, Hq 16 over Hkv 1, window 2048), bf16: ring decode at 8
    lanes over a full 2048-slot ring, paged decode at 8 lanes of up to 4096
    positions in pages of 16, a 32-token chunk over a full ring."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import paged_decode_attention as pk

    bf = torch.bfloat16
    hq, hkv, d, n, win, b = 16, 1, 256, 2048, 2048, 8
    scale = d ** -0.5
    out = {}

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, bf)

    lens = rng.integers(n, 2 * n + 1, size=b)       # every ring full
    q, kc, vc = rnd((b, 1, hq, d)), rnd((b, n, hkv, d)), rnd((b, n, hkv, d))
    cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    pos = torch.from_numpy(ring_positions(rng, b, n, lens)).to(dev)
    kw = dict(cache_len=cl, pos=pos, window=win, scale=scale)
    valid = (pos >= 0) & (pos < cl[:, None]) & (pos > cl[:, None] - 1 - win)
    rows_read = int(valid.sum())
    nbytes = rows_read * hkv * d * 2 * 2 + b * n * 4 + 2 * q.numel() * 2 + b * 4
    bms, by = bound(nbytes, 4 * hq * d * rows_read, PEAK_BF16_FLOPS)
    out["decode_attention"] = dict(
        shape=f"B={b} n={n} Hq={hq} Hkv={hkv} D={d} w={win} bf16 full rings",
        **timings(lambda: dk.decode_attention(q, kc, vc, **kw),
                  lambda: dk.decode_attention_plain(q, kc, vc, **kw),
                  lambda: sdpa(q, kc, vc, attn_mask=valid[:, None, None, :],
                               scale=scale)),
        empty_ms=device_ms(lambda: dk.decode_attention(
            q, kc, vc, **dict(kw, cache_len=torch.zeros_like(cl))), flush),
        stream_ms=stream_ms(nbytes, dev, flush),
        bound_ms=bms, bound_by=by)

    page, maxp = 16, 4096 // 16
    plens = rng.integers(2048, 4097, size=b)
    tables, ppos = paged_layout(rng, plens, page, maxp)
    tab = torch.from_numpy(tables).to(dev)
    pp = torch.from_numpy(ppos).to(dev)
    kp = rnd((b * maxp + 1, page, hkv, d))
    vp = rnd((b * maxp + 1, page, hkv, d))
    cl = torch.as_tensor(plens, dtype=torch.int32, device=dev)
    kw = dict(cache_len=cl, window=win, scale=scale)
    safe = tab.clamp_min(0).long()
    kg = kp[safe].reshape(b, maxp * page, hkv, d)
    vg = vp[safe].reshape(b, maxp * page, hkv, d)
    pvis = paged_visible(pp, tab, cl, page, win)
    seen = int(pvis.sum())
    nbytes = (seen * (hkv * d * 2 * 2 + 4) + 2 * q.numel() * 2
              + tab.numel() * 4 + b * 4)
    bms, by = bound(nbytes, 4 * hq * d * seen, PEAK_BF16_FLOPS)
    out["paged_decode_attention"] = dict(
        shape=(f"B={b} pages of {page}, {maxp} per lane, Hq={hq} Hkv={hkv} "
               f"D={d} w={win} bf16, shuffled pool"),
        **timings(lambda: pk.paged_decode_attention(q, kp, vp, pp, tab, **kw),
                  lambda: pk.paged_decode_attention_plain(q, kp, vp, pp, tab,
                                                          **kw),
                  lambda: sdpa(q, kg, vg, attn_mask=pvis[:, None, None, :],
                               scale=scale)),
        library_note="SDPA over K/V gathered beforehand (gather not timed)",
        **paged_fixed_ms(q, kp, vp, pp, tab, kw, flush),
        stream_ms=stream_ms(nbytes, dev, flush),
        bound_ms=bms, bound_by=by)

    c, start = 32, 5000
    qc, kc2, vc2 = rnd((1, c, hq, d)), rnd((1, n + c, hkv, d)), rnd((1, n + c, hkv, d))
    qp = torch.arange(start, start + c, dtype=torch.int32, device=dev)
    kp2 = torch.cat([torch.from_numpy(ring_positions(rng, 1, n, [start])).to(dev),
                     qp[None]], 1)
    kn, vn = kc2[:, n:].contiguous(), vc2[:, n:].contiguous()
    kw = dict(q_pos=qp, k_pos=qp, causal=True, window=win, scale=scale,
              k_cache=kc2[:, :n].contiguous(), v_cache=vc2[:, :n].contiguous(),
              cache_pos=kp2[:, :n].contiguous())
    vis = ((kp2[:, None, :] >= 0) & (kp2[:, None, :] <= qp[None, :, None])
           & (kp2[:, None, :] > qp[None, :, None] - win))
    pairs = int(vis.sum())
    keys_read = int(vis.any(1).sum())
    nbytes = keys_read * hkv * d * 2 * 2 + 2 * qc.numel() * 2 + 4 * (n + 2 * c)
    bms, by = bound(nbytes, 4 * hq * d * pairs, PEAK_BF16_FLOPS)
    out["flash_attention"] = dict(
        shape=f"chunk C={c} over a ring of n={n} Hq={hq} Hkv={hkv} D={d} "
              f"w={win} bf16",
        **timings(lambda: fk.flash_attention(qc, kn, vn, **kw),
                  lambda: fk.flash_attention_plain(qc, kn, vn, **kw),
                  lambda: sdpa(qc, kc2, vc2, attn_mask=vis[:, None],
                               scale=scale)),
        empty_ms=device_ms(lambda: fk.flash_attention(
            qc, kn, vn, **nothing_visible(kw)), flush),
        bound_ms=bms, bound_by=by)
    return out


def paged_fixed_ms(q, kp, vp, pp, tab, kw, flush) -> dict:
    """Paged decode's fixed costs, the same launch, grid and splits:
    ``empty_ms`` with every table entry -1 (every tile is still walked,
    zero-filled, but no K/V byte is read, and each lane's mean of V reads
    pool row 0 only), ``one_slot_ms`` with a cache length of 1 (one tile in
    split 0 of each lane, no tile in the others)."""
    from repro_torch.kernels import paged_decode_attention as pk
    none = tab.new_full(tab.shape, -1)
    one = dict(kw, cache_len=kw["cache_len"].clamp_max(1))
    return {"empty_ms": device_ms(lambda: pk.paged_decode_attention(
                q, kp, vp, pp, none, **kw), flush),
            "one_slot_ms": device_ms(lambda: pk.paged_decode_attention(
                q, kp, vp, pp, tab, **one), flush)}


def nothing_visible(kw: dict) -> dict:
    """Flash arguments with every key position -1: the same launch, grid
    and splits, with no K/V tile requested (the kernel's fixed cost)."""
    import torch
    return dict(kw, k_pos=torch.full_like(kw["k_pos"], -1),
                cache_pos=torch.full_like(kw["cache_pos"], -1))


# ---------------------------------------------------------------- phase 3
def cpu_copy(model, cfg):
    """``model``'s copy on the CPU: ``M.Model(cfg, "cpu")`` with every
    parameter copied from the card.  Eight threads take slices of at most
    256 MB, zero each (which faults its fresh host pages in) and copy into
    it: about 3 GB/s on the card machine's host, where
    ``load_state_dict`` into fresh pages moves about 1.9."""
    import torch
    from repro_torch.models import model as M
    cpu = M.Model(cfg, "cpu")
    src, dst = model.state_dict(), cpu.state_dict()
    if list(src) != list(dst):
        raise AssertionError("the CPU model's parameters differ in name")
    parts = []
    for name, d in dst.items():
        g = src[name]
        rows = 1 if d.dim() == 0 else d.shape[0]
        row_bytes = d.numel() * d.element_size() // max(rows, 1)
        step = max(1, (256 << 20) // max(row_bytes, 1))
        if d.dim() == 0:
            parts.append((d, g))
        else:
            parts += [(d[i:i + step], g[i:i + step])
                      for i in range(0, rows, step)]

    def one(pair):
        d, g = pair
        with torch.no_grad():
            d.zero_()
            d.copy_(g)

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(one, parts))
    return cpu


def cpu_plain_stream(model, cfg, prompt, new_tokens, ceiling, capacity=1024):
    """The port's path on ``model``'s device without the engine: chunked
    prefill in the replica's bucket widths, then greedy decode steps.
    Returns (tokens, last logits)."""
    import torch
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, 1, capacity, model.device)
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


def identity_phase(dev, arch="qwen3-4b", layers=4, paged=True):
    """``arch`` at full width, depth cut to ``layers``, in f32 with TF32
    off: greedy fleet streams equal ``generate_sequential``, the port's
    plain path on the CPU and the same path on the card, and the last
    logits agree; with ``paged`` the paged replica's identity follows."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policies import make_policy
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Replica, Request, ServingFleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).replace(num_layers=layers, dtype=torch.float32)
    model = M.init_model(cfg, SEED, dev)
    cpu_model = cpu_copy(model, cfg)
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
            raise AssertionError(f"{arch} identity request {i}: {r.outcome} "
                                 f"{r.error}")
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
                f"{arch} identity prompt {len(p)}: fleet {fleet_toks} seq {seq} "
                f"cpu {cpu_toks} card {gpu_toks}")
        # f32 throughout with TF32 off: the two devices differ only in the
        # order of their sums; 1e-3 on O(1) logits leaves two orders of
        # magnitude while a masking or position fault moves them by O(1)
        if not err <= 1e-3:
            raise AssertionError(f"{arch} identity logits differ by {err}")
    key = "identity" if arch == "qwen3-4b" else f"identity_{arch}"
    DETAILS[key] = dict(layers=layers, prompts=[40, 200, 700], new_tokens=new,
                        last_logits_max_abs_diff=worst, tol=1e-3)
    if paged:
        paged_identity(cfg, model, cpu_model, rep)
    fleet.stop()
    del model, rep, fleet
    torch.cuda.empty_cache()


def drained(rep) -> dict:
    """A paged replica's pool after its lanes let go: the allocator's
    invariants hold and the prefix cache's own holds are the only ones
    left (no page held by a lane).  Raises otherwise."""
    rep._alloc.check()
    cached = rep._prefix.cached_pages() if rep._prefix is not None else []
    held = [p for p in range(rep.num_pages)
            if rep._alloc.refcount(p) > (1 if p in set(cached) else 0)]
    if held or (rep._tables != -1).any():
        raise AssertionError(f"{rep.name}: pages still held by lanes {held}")
    return dict(free=rep._alloc.free_count, cached=len(cached))


def serve_paged(rep, reqs, first_alone: bool):
    """Greedy streams of ``reqs`` on ``rep``: the first alone until its
    system prompt is registered in the prefix cache (it then emits its
    first token), the others from threads joining while it decodes."""
    import threading
    out = [None] * len(reqs)

    def go(i):
        out[i] = rep.generate(reqs[i]).tolist()
    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
    threads[0].start()
    if first_alone:
        t0 = time.perf_counter()
        while not len(rep._prefix) and time.perf_counter() - t0 < 300:
            time.sleep(0.005)
    for i, t in enumerate(threads[1:]):
        t.start()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{rep.name}: a request did not finish")
    return out


def paged_identity(cfg, model, cpu_model, ring):
    """Phase 3b: a paged replica with the prefix cache, on the card and on
    the CPU, against the card's ring replica, greedy: a request with a
    page-aligned 64-token system prompt, a request equal to the system
    prompt (a full hit: copy-on-write), a capacity-length prompt and
    another sharer joining mid-stream."""
    import numpy as np
    from repro_torch.serving.engine import Replica, Request

    cap, page = 256, 16
    rng = np.random.default_rng(SEED + 4)
    sysp = rng.integers(2, cfg.vocab_size, size=4 * page)
    prompts = [np.concatenate([sysp, rng.integers(2, cfg.vocab_size, 40)]),
               sysp.copy(), rng.integers(2, cfg.vocab_size, cap),
               np.concatenate([sysp, rng.integers(2, cfg.vocab_size, 20)])]
    prompts = [p.astype(np.int32) for p in prompts]
    new = [24, 8, 1, 8]        # a capacity-length lane has room for 1 token
    want = [ring.generate(Request(200 + i, p, n, 1e9)).tolist()
            for i, (p, n) in enumerate(zip(prompts, new))]
    got, stats = {}, {}
    for where, m in (("card", model), ("cpu", cpu_model)):
        rep = Replica(f"paged-{where}", cfg, m, slots=4, capacity=cap,
                      prefill_chunk_tokens=32, paged=True, page_size=page,
                      prefix_cache=True)
        got[where] = serve_paged(rep, [Request(300 + i, p, n, 1e9) for i, (p, n)
                                       in enumerate(zip(prompts, new))], True)
        rep.stop()
        stats[where] = dict(cow_copies=rep.cow_copies,
                            prefilled_tokens=rep.prefilled_tokens,
                            hit_rate=rep._prefix.hit_rate(), **drained(rep))
        if rep.cow_copies < 1:
            raise AssertionError(f"paged identity on the {where}: no COW")
    total = sum(len(p) for p in prompts)
    log(f"  paged+prefix: card == ring {got['card'] == want}, cpu == ring "
        f"{got['cpu'] == want}; {stats}; prompts {total} tokens")
    if not (got["card"] == want == got["cpu"]):
        raise AssertionError(f"paged identity: ring {want} card {got['card']} "
                             f"cpu {got['cpu']}")
    key = ("paged_identity" if cfg.name == "qwen3-4b"
           else f"paged_identity_{cfg.name}")
    DETAILS[key] = dict(prompts=[len(p) for p in prompts], new_tokens=new,
                        prompt_tokens=total, **stats)


def recurrent_identity(dev, arch: str, layers: int, capacity: int,
                       cpu_lens, card_lens):
    """Phase 3c: a recurrent arch at full width with its depth cut to
    ``layers``, in f32 with TF32 off.  Greedy streams through a
    ``ServingFleet`` (chunked prefill, 32-token ceiling) must equal the
    replica's ``generate_sequential`` (whole-prompt prefill) and, for the
    prompts of ``cpu_lens``, the port's plain path on the CPU; a paged
    replica (no prefix cache) must emit the ring replica's streams, a
    mid-stream join included; ``prefix_cache=True`` must be refused."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policies import make_policy
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Replica, Request, ServingFleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).replace(num_layers=layers, dtype=torch.float32)
    model = M.init_model(cfg, SEED, dev)
    cpu_model = cpu_copy(model, cfg)
    name = f"{arch}-ring"
    rep = Replica(name, cfg, model, slots=4, capacity=capacity,
                  prefill_chunk_tokens=32)
    fleet = ServingFleet(make_policy("DDS"), source=name, coordinator=name,
                         admission_margin=0.0)
    fleet.add_replica(rep)
    rng = np.random.default_rng(SEED + 6)
    lens = list(cpu_lens) + list(card_lens)
    prompts = [rng.integers(2, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]
    new = 16
    with ThreadPoolExecutor(len(prompts)) as ex:
        res = list(ex.map(fleet.submit, [Request(i, p, new, 1e9)
                                         for i, p in enumerate(prompts)]))
    worst, streams = 0.0, []
    for i, (p, r) in enumerate(zip(prompts, res)):
        if r.outcome != "ok":
            raise AssertionError(f"{arch} identity request {i}: {r.outcome} "
                                 f"{r.error}")
        got = r.tokens.tolist()
        streams.append(got)
        seq = rep.generate_sequential(Request(100 + i, p, new, 1e9)).tolist()
        line = f"  {arch} prompt {len(p):4d}: fleet == sequential {got == seq}"
        if got != seq:
            raise AssertionError(f"{arch} prompt {len(p)}: fleet {got} "
                                 f"sequential {seq}")
        if len(p) in cpu_lens:
            cpu_toks, cpu_last = cpu_plain_stream(cpu_model, cfg, p, new, 32,
                                                  capacity)
            gpu_toks, gpu_last = cpu_plain_stream(model, cfg, p, new, 32,
                                                  capacity)
            err = (gpu_last - cpu_last).abs().max().item()
            worst = max(worst, err)
            line += (f", fleet == cpu plain {got == cpu_toks}, card plain == "
                     f"cpu plain {gpu_toks == cpu_toks}, last logits "
                     f"max|diff| {err:.3e}")
            if not (got == cpu_toks == gpu_toks):
                raise AssertionError(f"{arch} prompt {len(p)}: fleet {got} "
                                     f"cpu {cpu_toks} card {gpu_toks}")
            # as for qwen3-4b: f32 with TF32 off, the devices differ only
            # in the order of their sums
            if not err <= 1e-3:
                raise AssertionError(f"{arch} identity logits differ by {err}")
        log(line)

    # paged replica (no prefix cache) against the ring replica: the first
    # request alone, the others joining it mid-stream; a prompt past
    # recurrentgemma's 2048-token window wraps its local rings in paged
    # mode too
    paged = Replica(f"{arch}-paged", cfg, model, slots=4, capacity=capacity,
                    prefill_chunk_tokens=32, paged=True, page_size=16)
    short = ([p for p in prompts if len(p) <= 700][:3]
             + [p for p in prompts if len(p) > 2048])
    want = [rep.generate(Request(200 + i, p, new, 1e9)).tolist()
            for i, p in enumerate(short)]
    got = serve_paged(paged, [Request(300 + i, p, new, 1e9)
                              for i, p in enumerate(short)], False)
    paged.stop()
    drained(paged)
    log(f"  {arch} paged == ring {got == want} "
        f"(prompts {[len(p) for p in short]}, joins mid-stream)")
    if got != want:
        raise AssertionError(f"{arch} paged {got} ring {want}")
    try:
        Replica(f"{arch}-prefix", cfg, model, slots=4, capacity=capacity,
                paged=True, page_size=16, prefix_cache=True)
    except ValueError as e:
        log(f"  {arch} prefix_cache refused: {e}")
    else:
        raise AssertionError(f"{arch}: prefix_cache was not refused")
    DETAILS[f"identity_{arch}"] = dict(
        layers=layers, capacity=capacity, prompts=lens, new_tokens=new,
        cpu_prompts=list(cpu_lens), last_logits_max_abs_diff=worst, tol=1e-3,
        paged_prompts=[len(p) for p in short])
    fleet.stop()
    rep.stop()
    del model, cpu_model, rep, paged, fleet
    gc.collect()
    torch.cuda.empty_cache()


def host_mem_gb(field: str = "MemAvailable") -> float:
    """``/proc/meminfo``'s ``field`` in GB (1e9 bytes)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError(f"/proc/meminfo has no {field}")


def moe_identity(dev, arch: str, layers: int, grads: bool = False):
    """Phases 3e and 3f: an MoE arch at full width with its depth cut to
    ``layers``, in f32 with TF32 off, on the card against the CPU.
    Greedy B=1 streams of 4 tokens after prompts of 40 and 200 (chunked
    prefill in the replica's buckets, then decode steps; each CPU pass
    reads every expert's f32 weights, 53.5 GB for arctic's layer) must be
    equal and their last logits within 1e-3.  Then a fixed batch
    composition: 8 lanes prefilled together with 8 prompts, lanes 0-5 with
    one prompt, so that a decode step's identical rows overflow their
    experts and drop choices, then 8 batched decode steps: the identical
    lanes' logits must part on the card (choices dropped), and both devices
    give the same tokens and every step's logits within 1e-3.  MoE does not
    promise that a fleet's stream equals ``generate_sequential`` (every
    lane's choices compete for the same expert capacity), so that equality
    is logged, not required.  With ``grads`` (3e) the same two models also
    give the loss, ce, aux and every parameter's gradient of one batch of 1
    x ``MOE_GRAD_TOKENS`` tokens (``make_loss_fn``, remat as the config
    has it), each within 1e-3 (per tensor, of its largest |gradient| on
    the CPU) and nonzero on the card, and the dropped (token, choice) pairs
    of that forward are counted (``moe.dropped_choices``).  The phase fails
    at once where the host cannot hold the CPU copy (MemAvailable below its
    size, twice that with ``grads``, plus 16 GB)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policies import make_policy
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Replica, Request, ServingFleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).replace(num_layers=layers, dtype=torch.float32)
    t0 = time.perf_counter()
    model = M.init_model(cfg, SEED, dev)
    need_gb = sum(p.numel() * 4 for p in model.parameters()) / 1e9
    host_gb = need_gb * (2 if grads else 1)        # weights (and gradients)
    avail_gb = host_mem_gb()
    log(f"  {arch}: {layers} layers, {need_gb:.1f} GB of f32 weights; host "
        f"MemAvailable {avail_gb:.1f} GB")
    if avail_gb < host_gb + 16.0:
        raise AssertionError(f"{arch}: the CPU copy needs {host_gb:.1f} GB "
                             f"and 16 GB beside it; the host has "
                             f"{avail_gb:.1f} GB available")
    rng = np.random.default_rng(SEED + 8)
    new = 4
    prompts = [rng.integers(2, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (40, 200)]
    base = rng.integers(2, cfg.vocab_size, size=24)
    batch = np.stack([base] * 6 + [rng.integers(2, cfg.vocab_size, size=24)
                                   for _ in range(2)]).astype(np.int64)
    stats = dict(layers=layers, weights_gb=need_gb,
                 host_mem_available_gb=avail_gb,
                 prompts=[len(p) for p in prompts], new_tokens=new,
                 batch_lanes=8, batch_prompt=24, batch_steps=8, tol=1e-3)

    def batched(m):
        """Tokens (steps, 8) and every step's last logits, from a whole
        prefill of the 8 lanes and 8 batched decode steps."""
        logits, cache = M.prefill(m, torch.as_tensor(batch, device=m.device),
                                  cfg, 64)
        toks, lgs = [], []
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        for i in range(8):
            toks.append(tok[:, 0].tolist())
            logits, cache = M.decode_step(m, cache, tok, batch.shape[1] + i,
                                          cfg)
            lgs.append(logits[:, -1].float().cpu())
            tok = torch.argmax(logits[:, -1], -1)[:, None]
        return toks, torch.stack(lgs)

    card_toks, card_lgs = batched(model)
    # lanes 0-5 carry one prompt: after the first step their logits part
    # only if the step dropped some of their choices, which this composition
    # is here to make certain
    parted = not torch.equal(card_lgs[0, 0], card_lgs[0, 5])
    stats["identical_lanes_parted"] = parted
    if not parted:
        raise AssertionError(f"{arch} batched: the 6 identical lanes kept "
                             f"equal logits, so no choice dropped")
    cpu_model = cpu_copy(model, cfg)
    worst = 0.0
    for p in prompts:
        cpu_t, cpu_last = cpu_plain_stream(cpu_model, cfg, p, new, 32)
        gpu_t, gpu_last = cpu_plain_stream(model, cfg, p, new, 32)
        err = (gpu_last - cpu_last).abs().max().item()
        worst = max(worst, err)
        log(f"  {arch} prompt {len(p):4d}: card plain == cpu plain "
            f"{gpu_t == cpu_t}, last logits max|diff| {err:.3e}")
        if gpu_t != cpu_t or not err <= 1e-3:
            raise AssertionError(f"{arch} identity prompt {len(p)}: card "
                                 f"{gpu_t} cpu {cpu_t}, logits {err}")
    cpu_toks, cpu_lgs = batched(cpu_model)
    berr = (card_lgs - cpu_lgs).abs().max().item()
    log(f"  {arch} batch of 8 (6 identical lanes), 8 steps: tokens "
        f"equal {card_toks == cpu_toks}, logits max|diff| {berr:.3e}; "
        f"identical lanes parted (choices dropped)")
    if card_toks != cpu_toks or not berr <= 1e-3:
        raise AssertionError(f"{arch} batched: card {card_toks} cpu "
                             f"{cpu_toks}, logits {berr}")
    stats.update(last_logits_max_abs_diff=worst,
                 batch_logits_max_abs_diff=berr)
    if grads:
        stats["gradients"] = moe_gradients(model, cpu_model, cfg)
    del cpu_model
    gc.collect()

    # observed, not required: the fleet against generate_sequential
    rep = Replica(f"{arch}-identity", cfg, model, slots=4, capacity=1024,
                  prefill_chunk_tokens=32)
    fleet = ServingFleet(make_policy("DDS"), source=rep.name,
                         coordinator=rep.name, admission_margin=0.0)
    fleet.add_replica(rep)
    with ThreadPoolExecutor(len(prompts)) as ex:
        res = list(ex.map(fleet.submit, [Request(i, p, new, 1e9)
                                         for i, p in enumerate(prompts)]))
    same = []
    for i, (p, r) in enumerate(zip(prompts, res)):
        if r.outcome != "ok":
            raise AssertionError(f"{arch} fleet request {i}: {r.outcome}")
        seq = rep.generate_sequential(Request(100 + i, p, new, 1e9)).tolist()
        same.append(r.tokens.tolist() == seq)
    log(f"  {arch} fleet == generate_sequential (observed, not required): "
        f"{same}")
    stats.update(fleet_equals_sequential=same,
                 seconds=time.perf_counter() - t0)
    fleet.stop()
    rep.stop()
    DETAILS[f"identity_{arch}"] = stats
    del model, rep, fleet
    gc.collect()
    torch.cuda.empty_cache()


MOE_GRAD_TOKENS = 136


def moe_identity_grads(dev) -> None:
    """Phase 3e: ``moe_identity`` of mixtral-8x22b at 1 layer (11.6 GB of
    f32 weights), serving and gradients."""
    moe_identity(dev, "mixtral-8x22b", 1, grads=True)


def moe_gradients(gpu, cpu, cfg) -> dict:
    """Phase 3e's gradients: the loss, ce, aux and every parameter's
    gradient of one batch of 1 x ``MOE_GRAD_TOKENS`` synthetic tokens on
    the card (flash and the norms through their backward kernels, the MoE
    FFN's batched products by autograd) against the CPU (plain versions),
    both f32 from the same weights: each within 1e-3, a gradient per
    tensor of its largest |gradient| on the CPU, and nonzero on the card.
    Counts the (token, choice) pairs the card's forward drops in each MoE
    call (``moe.dropped_choices``; remat's recompute calls it again).  The
    gradients are freed and the parameters set back to need none."""
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.training import steps as S

    t0 = time.perf_counter()
    tc = TrainConfig()
    batch = SyntheticDataset(cfg, DataConfig(global_batch=1,
                                             seq_len=MOE_GRAD_TOKENS,
                                             seed=SEED)).batch(0)
    loss_fn = S.make_loss_fn(cfg, tc)
    drops, ffn = {}, moe.moe_ffn

    def counted(p, x, cfg_, num_groups=1):
        if x.device.type == "cuda":
            drops.setdefault("calls", []).append(
                int(moe.dropped_choices(p, x, cfg_, num_groups)))
        return ffn(p, x, cfg_, num_groups)
    metrics = []
    moe.moe_ffn = counted
    try:
        ops.reset_kernel_launches()
        for m in (gpu, cpu):
            for p in m.parameters():
                p.requires_grad_(True)
            loss, aux = loss_fn(m, S.to_device(batch, m.device))
            loss.backward()
            metrics.append({k: float(v.detach()) for k, v in aux.items()})
    finally:
        moe.moe_ffn = ffn
    launches = ops.kernel_launches()
    if not launches["flash_attention_bwd"] or not launches["rmsnorm_bwd"]:
        raise AssertionError(f"{cfg.name} gradients: launches {launches}")
    for k in ("loss", "ce", "aux"):
        a, b = metrics[0][k], metrics[1][k]
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"{cfg.name} gradients: {k} card {a} CPU {b}")
    worst, worst_name = 0.0, ""
    for (name, g), c in zip(gpu.named_parameters(), cpu.parameters()):
        if g.grad is None or not (g.grad != 0).any():
            raise AssertionError(f"{cfg.name}: {name} has no gradient on the "
                                 "card")
        cg = c.grad.to(g.device)
        rel = ((g.grad - cg).abs().max() / cg.abs().max()).item()
        if rel > worst:
            worst, worst_name = rel, name
        if not rel <= 1e-3:
            raise AssertionError(f"{cfg.name}: {name} gradient off by "
                                 f"{rel:.2e} of its max")
        del cg
    for m in (gpu, cpu):
        for p in m.parameters():
            p.grad = None
            p.requires_grad_(False)
    out = dict(tokens=MOE_GRAD_TOKENS, card=metrics[0], cpu=metrics[1],
               grad_rel_err=worst, worst_leaf=worst_name,
               dropped_per_call=drops.get("calls", []),
               capacity=moe.expert_capacity(MOE_GRAD_TOKENS, cfg),
               launches=launches, seconds=time.perf_counter() - t0)
    log(f"  {cfg.name} gradients of 1 x {MOE_GRAD_TOKENS} tokens: loss "
        f"{metrics[0]['loss']:.6f}/{metrics[1]['loss']:.6f}, ce "
        f"{metrics[0]['ce']:.6f}/{metrics[1]['ce']:.6f}, aux "
        f"{metrics[0]['aux']:.6f}/{metrics[1]['aux']:.6f} (card/CPU); every "
        f"gradient nonzero, within {worst:.2e} of its max ({worst_name}); "
        f"dropped (token, choice) pairs per MoE call {out['dropped_per_call']}"
        f" of {2 * MOE_GRAD_TOKENS}, capacity {out['capacity']} an expert; "
        f"{out['seconds']:.1f} s")
    return out


VISION = "llama-3.2-vision-90b"


def vision_identity(dev, layers: int = 5):
    """Phase 3g: llama-3.2-vision-90b at full width, one period (4 self +
    1 cross layers), in f32 with TF32 off, through the model functions (no
    replica serves a cross stack): 4 lanes with their own seeded stub
    encoder states (1601 x 8192) and 64-token prompts, lanes 0 and 1 with
    one prompt (so only ``enc`` tells them apart), ``prefill(enc=...)`` then
    16 greedy ``decode_step``s on the card and on the CPU plain path.  The
    tokens must be equal and every step's last logits within 1e-3, and
    lanes 0 and 1 must differ.  The phase fails at once where the host
    cannot hold the CPU copy (MemAvailable below its size plus 16 GB)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(VISION).replace(num_layers=layers, dtype=torch.float32)
    t0 = time.perf_counter()
    model = M.init_model(cfg, SEED, dev)
    need_gb = sum(p.numel() * 4 for p in model.parameters()) / 1e9
    avail_gb = host_mem_gb()
    log(f"  {VISION}: {layers} layers ({cfg.layer_kinds().count('cross')} "
        f"cross), {need_gb:.1f} GB of f32 weights; host MemAvailable "
        f"{avail_gb:.1f} GB")
    if avail_gb < need_gb + 16.0:
        raise AssertionError(f"{VISION}: the CPU copy needs {need_gb:.1f} GB "
                             f"and 16 GB beside it; the host has "
                             f"{avail_gb:.1f} GB available")
    rng = np.random.default_rng(SEED + 9)
    b, plen, steps, cap = 4, 64, 16, 128
    toks = rng.integers(2, cfg.vocab_size, size=(b, plen))
    toks[1] = toks[0]
    enc = rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model),
                              dtype=np.float32)

    def run(m):
        """Tokens (steps, b) and every step's last logits."""
        logits, cache = M.prefill(
            m, torch.as_tensor(toks, device=m.device), cfg, cap,
            enc=torch.as_tensor(enc, device=m.device))
        out, lgs = [], [logits[:, -1].float().cpu()]
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        for i in range(steps):
            out.append(tok[:, 0].tolist())
            logits, cache = M.decode_step(m, cache, tok, plen + i, cfg)
            lgs.append(logits[:, -1].float().cpu())
            tok = torch.argmax(logits[:, -1], -1)[:, None]
        return out, torch.stack(lgs)

    card_toks, card_lgs = run(model)
    if not torch.isfinite(card_lgs).all():
        raise AssertionError(f"{VISION} identity: non-finite logits")
    apart = (card_lgs[0, 0] - card_lgs[0, 1]).abs().max().item()
    if not apart > 1e-3:
        raise AssertionError(f"{VISION} identity: lanes 0 and 1 share a "
                             f"prompt and differ in enc, but their logits "
                             f"differ by {apart}")
    cpu_model = cpu_copy(model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cpu_toks, cpu_lgs = run(cpu_model)
    err = (card_lgs - cpu_lgs).abs().max().item()
    log(f"  {VISION} 4 lanes, prompt {plen}, {steps} steps: tokens equal "
        f"{card_toks == cpu_toks}, logits max|diff| {err:.3e} (every step); "
        f"lanes 0/1 (one prompt, two enc) apart by {apart:.3e}")
    # f32 throughout with TF32 off, as the other identity phases
    if card_toks != cpu_toks or not err <= 1e-3:
        raise AssertionError(f"{VISION} identity: card {card_toks} cpu "
                             f"{cpu_toks}, logits {err}")
    DETAILS["identity_vision"] = dict(
        layers=layers, weights_gb=need_gb, host_mem_available_gb=avail_gb,
        lanes=b, prompt=plen, steps=steps, logits_max_abs_diff=err,
        enc_lanes_apart=apart, tol=1e-3, seconds=time.perf_counter() - t0)
    del cpu_model
    gc.collect()


def vision_phase(dev, layers: int = 20) -> dict:
    """Phase 12: llama-3.2-vision-90b generation at full width, depth cut
    to ``layers`` (4 periods: 16 self + 4 cross), bf16, through the model
    functions: 8 lanes with their own seeded stub encoder states and
    512-token prompts, one batched ``prefill(enc=...)``, then 32 greedy
    ``decode_step``s, each step's tokens read on the host.  The launches
    of that run must equal ``expected_launches`` (per step 20
    ``decode_attention``, 4 of them contiguous over the image tokens; per
    prefill 20 ``flash_attention``, 4 not causal; 41 ``rmsnorm`` for each).
    Then one decode step and the prefill are profiled.  Returns the
    launches."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(VISION).replace(num_layers=layers)
    t0 = time.perf_counter()
    model = M.init_model(cfg, SEED, dev)
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.numel() * 2 for p in model.parameters()) / 1e9
    b, plen, steps, cap = 8, 512, 32, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    enc = torch.randn((b, cfg.num_image_tokens, cfg.d_model), generator=gen,
                      device=dev).to(cfg.dtype)
    rng = np.random.default_rng(SEED + 10)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, size=(b, plen)),
                           device=dev)

    ops.reset_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(model, toks, cfg, cap, enc=enc)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    out = [tok[:, 0].cpu()]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    walls = []
    for i in range(steps):
        t1 = time.perf_counter()
        logits, cache = M.decode_step(model, cache, tok, plen + i, cfg)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out.append(tok[:, 0].cpu())
        walls.append((time.perf_counter() - t1) * 1e3)
    launches = ops.kernel_launches()
    expect = expected_launches(cfg, steps, 0, 1)
    log(f"  launches {launches}; expected {expect} from {steps} decode "
        f"steps and one whole prefill")
    if launches != expect:
        raise AssertionError(f"{VISION}: launches {launches}, expected "
                             f"{expect}")
    toks_out = torch.stack(out)
    if not torch.isfinite(logits).all() or toks_out.min() < 0 \
            or toks_out.max() >= cfg.vocab_size:
        raise AssertionError(f"{VISION}: bad logits or tokens {toks_out}")
    step_ms = sorted(walls)[len(walls) // 2]
    gen_s = (prefill_ms + sum(walls)) / 1e3
    stats = dict(layers=layers, weights_gb=weights_gb, init_s=init_s,
                 lanes=b, prompt=plen, steps=steps, prefill_ms=prefill_ms,
                 step_wall_ms_median=step_ms,
                 decode_tokens_per_s=b * steps / (sum(walls) / 1e3),
                 tokens_per_s=b * (steps + 1) / gen_s, launches=launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log(f"  {layers} layers ({weights_gb:.1f} GB): prefill {prefill_ms:.1f} "
        f"ms, decode step median {step_ms:.2f} ms, "
        f"{stats['decode_tokens_per_s']:.1f} decode tokens/s, "
        f"{stats['tokens_per_s']:.1f} tokens/s with the prefill, peak "
        f"{stats['peak_mem_gb']:.1f} GB")
    stats["decode_step"] = profile_call(
        f"decode step at position {plen + steps}",
        lambda: M.decode_step(model, cache, tok, plen + steps, cfg))
    stats["prefill"] = profile_call(
        f"prefill of {b} x {plen} tokens over {b} x {cfg.num_image_tokens} "
        f"image tokens", lambda: M.prefill(model, toks, cfg, cap, enc=enc))
    DETAILS["vision"] = stats
    del model, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------- backward kernels (phase 2t)
def bwd_spacings(got, exp32) -> float:
    """Largest |got - exp32| in bf16 spacings at |exp32|, floored at the
    spacing of max|exp32| / 256 (a gradient near zero beside large ones is
    held to the tensor's scale, not to its own)."""
    import torch
    mag = exp32.abs().clamp_min(exp32.abs().max().item() / 256 + 1e-30)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - exp32).abs() / spacing).max().item()


# A bf16 gradient is computed in f32 from the bf16 inputs and rounded once:
# 0.5 spacings of the f32 oracle on the same inputs, plus f32 sums in
# another order, far below.  f32: 2e-5 of max(1, max|ref|) (sums over up
# to 16 x 1024 products in another order).  A gain's gradient (f32 both
# ways): 1e-5 of the column's sum of |terms| (a sum over up to 65536 rows
# in another order; dropping one block's partial errs by about 1/264 of
# it).  lse: 2e-5 in f32; 1e-4 in bf16 (the forward's exp2.approx).
BWD_SPACINGS = 1.0


def flash_bwd_inputs(rng, b, s, t, hq, hkv, d, dtype, dev, holes=0.0,
                     qscale=1.0):
    """q, k, v, dout normal (q times ``qscale``), the queries the last s
    positions of t keys' ``arange``, a share ``holes`` of key slots empty."""
    import numpy as np
    import torch

    def rnd(shape, sc=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sc)
                                .astype(np.float32)).to(dev, dtype)
    q, k, v = (rnd((b, s, hq, d), qscale), rnd((b, t, hkv, d)),
               rnd((b, t, hkv, d)))
    dout = rnd((b, s, hq, d))
    kp = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    if holes:
        kp[rng.random((b, t)) < holes] = -1
    qp = torch.arange(t - s, t, dtype=torch.int32, device=dev)
    return q, k, v, dout, qp, torch.from_numpy(kp).to(dev)


def check_flash_bwd(dev, rng, label, b, s, t, hq, hkv, d, dtype, causal=True,
                    window=0, holes=0.0, softcap=0.0) -> float:
    """The forward kernel's lse against the plain version's, then the
    backward kernel against ``flash_attention_bwd_plain`` on the kernel's
    own out and lse (f32 oracle for bf16).  With a ``softcap``, q is drawn
    ``SOFTCAP_QSCALE`` times wider, so that the logits reach the cap's
    range and its derivative 1 - t^2 is far from 1.  Returns the max abs
    error, the bf16 spacings and the lse's error."""
    import torch
    from repro_torch.kernels import flash_attention as fk
    q, k, v, dout, qp, kp = flash_bwd_inputs(
        rng, b, s, t, hq, hkv, d, dtype, dev, holes,
        SOFTCAP_QSCALE if softcap else 1.0)
    kw = dict(q_pos=qp, k_pos=kp, causal=causal, window=window,
              scale=d ** -0.5, softcap=softcap)
    out, lse = fk.flash_attention(q, k, v, splits=1, return_lse=True, **kw)
    f = [x.float() for x in (q, k, v)]
    out_p, lse_p = fk.flash_attention_plain(*f, return_lse=True, **kw)
    lse_err = (lse - lse_p).abs().max().item()
    lse_tol = 2e-5 if dtype == torch.float32 else 1e-4
    got = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    exp = fk.flash_attention_bwd_plain(*f, out.float(), lse, dout.float(),
                                       **kw)
    torch.cuda.synchronize()
    worst, err = 0.0, 0.0
    for name, g, e in zip(("dq", "dk", "dv"), got, exp):
        if g.dtype != dtype or g.shape != e.shape or not torch.isfinite(g).all():
            raise AssertionError(f"flash bwd {label}: {name} {g.dtype} "
                                 f"{tuple(g.shape)} or not finite")
        err = max(err, (g.float() - e).abs().max().item())
        if dtype == torch.float32:
            lim = 2e-5 * max(1.0, e.abs().max().item())
            bad = (g - e).abs().max().item() > lim
        else:
            sp = bwd_spacings(g, e)
            worst = max(worst, sp)
            bad = sp > BWD_SPACINGS
        if bad:
            raise AssertionError(
                f"flash bwd {label}: {name} off by "
                f"{(g.float() - e).abs().max().item():.3e} (spacings "
                f"{bwd_spacings(g, e):.2f})")
    if lse_err > lse_tol:
        raise AssertionError(f"flash bwd {label}: lse off by {lse_err:.3e}")
    return err, worst, lse_err


def check_norm_bwd(dev, rng, form, rows, d, dtype, krows=0) -> float:
    """One norm form's backward kernel against its plain version (f32
    oracle on the same inputs).  Returns the max abs error of dx."""
    import numpy as np
    import torch
    from repro_torch.kernels import rmsnorm as rk

    def rnd(shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s)
                                .astype(np.float32)).to(dev, dtype)

    def gain():
        return torch.from_numpy((rng.standard_normal(d) * 0.1)
                                .astype(np.float32)).to(dev)
    x, dy, g0 = rnd((rows, d)), rnd((rows, d)), gain()
    f = lambda t: t.float()
    if form == "norm":
        got = rk.rmsnorm_bwd(x, g0, dy)
        exp = rk.rmsnorm_bwd_plain(f(x), g0, f(dy))
        terms = [(f(dy) * f(x) * torch.rsqrt(f(x).square().mean(-1, True)
                                              + 1e-6)).abs().sum(0)]
        pairs = [(got[0], exp[0]), (got[1], exp[1])]
    elif form == "gated":
        # the f32 oracle of gated_rmsnorm_bwd_plain's arithmetic on the
        # forward's input v = y * silu(z), rounded as the forward rounds it
        z = rnd((rows, d))
        got = rk.gated_rmsnorm_bwd(x, z, g0, dy)
        sz = torch.nn.functional.silu(z)
        v = f(x * sz)
        dv, dsc = rk._norm_bwd_f32(v, g0, f(dy), 1e-6)
        sig = torch.sigmoid(f(z))
        exp = (dv * f(sz), dv * f(x) * (sig * (1.0 + f(z) * (1.0 - sig))),
               dsc)
        terms = [(f(dy) * v * torch.rsqrt(v.square().mean(-1, True) + 1e-6))
                 .abs().sum(0)]
        # (dy, dscale), then dz held as another dx
        pairs = [(got[0], exp[0]), (got[2], exp[2]), (got[1], exp[1]),
                 (None, None)]
    elif form == "add":
        ds = rnd((rows, d), 0.5)
        got = rk.add_rmsnorm_bwd(x, g0, ds, dy)
        exp = rk.add_rmsnorm_bwd_plain(f(x), g0, f(ds), f(dy))
        terms = [(f(dy) * f(x) * torch.rsqrt(f(x).square().mean(-1, True)
                                              + 1e-6)).abs().sum(0)]
        pairs = [(got[0], exp[0]), (got[1], exp[1])]
    else:
        kx, dk, g1 = rnd((krows, d)), rnd((krows, d)), gain()
        got = rk.rmsnorm_pair_bwd(x, kx, g0, g1, dy, dk)
        exp = rk.rmsnorm_pair_bwd_plain(f(x), f(kx), g0, g1, f(dy), f(dk))
        terms = [(f(a) * f(b) * torch.rsqrt(f(b).square().mean(-1, True)
                                             + 1e-6)).abs().sum(0)
                 for a, b in ((dy, x), (dk, kx))]
        pairs = [(got[0], exp[0]), (got[2], exp[2]), (got[1], exp[1]),
                 (got[3], exp[3])]
    torch.cuda.synchronize()
    err, worst = 0.0, 0.0
    for i, (g, e) in enumerate(pairs):
        if g is None:
            continue
        if i % 2 == 0:                                   # dx
            if g.dtype != dtype or not torch.isfinite(g).all():
                raise AssertionError(f"norm bwd {form} D {d}: dx {g.dtype}")
            err = max(err, (g.float() - e).abs().max().item())
            if dtype == torch.float32:
                bad = (g - e).abs().max().item() > \
                    2e-5 * max(1.0, e.abs().max().item())
            else:
                worst = max(worst, bwd_spacings(g, e))
                bad = bwd_spacings(g, e) > BWD_SPACINGS
        else:                                            # the gain's
            bad = ((g - e).abs() > 1e-5 * terms[i // 2]).any().item()
        if bad:
            raise AssertionError(f"norm bwd {form} D {d} rows {rows} "
                                 f"{dtype}: output {i} off by "
                                 f"{(g.float() - e).abs().max().item():.3e}")
    return err, worst


def check_ssd_bwd(dev, rng, label, b, s, h, p, n, chunk, dtype) -> tuple:
    """``ssd_bwd`` against ``ssd_bwd_plain`` (f32 on the same inputs):
    dx, ddt, dB and dC within BWD_SPACINGS (bf16) or 2e-5 of max(1,
    max|ref|) (f32); d a_log and d d_skip, sums over every (b, s), within
    1e-5 of the sum of their terms' magnitudes.  Returns (max abs err,
    worst bf16 spacings)."""
    import torch
    from repro_torch.kernels import ssd_scan as sk
    x, dt, a_log, bm, cm, d_skip = ssd_inputs(rng, b, s, h, p, n, dtype, dev)
    dy = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype("float32")
                          ).to(dev, dtype)
    got = sk.ssd_bwd(x, dt, a_log, bm, cm, d_skip, dy, chunk=chunk)
    f = [t.float() for t in (x, dt, bm, cm, dy)]
    exp = sk.ssd_bwd_plain(f[0], f[1], a_log, f[2], f[3], d_skip, f[4],
                           chunk=chunk)
    sa, sd = sk.ssd_param_scales(x, dt, a_log, bm, cm, dy, chunk)
    torch.cuda.synchronize()
    err, worst = 0.0, 0.0
    for name, g, e in zip(("dx", "ddt", "da_log", "db", "dc", "dd"), got,
                          exp):
        if not torch.isfinite(g).all() or g.shape != e.shape:
            raise AssertionError(f"ssd bwd {label}: {name} {tuple(g.shape)} "
                                 "or not finite")
        diff = (g.float() - e).abs()
        err = max(err, diff.max().item())
        if name in ("da_log", "dd"):
            bad = (diff > 1e-5 * (sa if name == "da_log" else sd)
                   + 1e-6).any().item()
        elif dtype == torch.float32:
            bad = diff.max().item() > 2e-5 * max(1.0, e.abs().max().item())
        else:
            worst = max(worst, bwd_spacings(g, e))
            bad = bwd_spacings(g, e) > BWD_SPACINGS
        if bad:
            raise AssertionError(f"ssd bwd {label} {dtype}: {name} off by "
                                 f"{diff.max().item():.3e}")
    return err, worst


def rglru_bwd_diff(g, e, la) -> tuple:
    """(|g - e| finite part, its limit's conditioning term): d log_a
    carries 1 / (1 - a^2), so one rounding of exp(2 log_a) on either side
    moves it by 2^-23 / (1 - a^2) of itself; inf and NaN must sit where
    the plain version has them."""
    import torch
    fin = torch.isfinite(e)
    if not torch.equal(torch.isnan(g.float()), torch.isnan(e)) or \
            not torch.equal(g.float()[~fin & ~torch.isnan(e)],
                            e[~fin & ~torch.isnan(e)]):
        raise AssertionError("rglru bwd: inf or NaN where the plain "
                             "version has none, or the other way")
    u = 1.0 - torch.exp(2.0 * la.double())
    cond = (e.abs() * 2.0 ** -23 / u.clamp_min(1e-30)).float()
    diff = torch.where(fin, (g.float() - e).abs(), 0.0)
    return diff, torch.where(fin, cond, 0.0)


def check_rglru_bwd(dev, rng, label, b, s, d, dtype, staged=None,
                    zeros=False) -> tuple:
    """``rglru_bwd`` against ``rglru_bwd_plain`` (f32 on the same inputs),
    the inputs as the Griffin block makes them (``zeros``: a few log_a
    exactly 0, where d log_a is -inf, +inf or NaN): dx and dgate within
    BWD_SPACINGS (bf16) or 2e-5 of max(1, max|ref|) (f32), d log_a the
    same plus its conditioning (``rglru_bwd_diff``).  Returns (max abs
    err, worst bf16 spacings)."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    x, la, g = rglru_inputs(rng, (b, s, d), dtype, dev)
    if zeros:
        la[0, 0, :3] = 0.0
        la[-1, -1, -2:] = 0.0
    dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype("float32")
                          ).to(dev, dtype)
    got = rg.rglru_bwd(x, la, g, dy, staged=staged)
    exp = rg.rglru_bwd_plain(x.float(), la.float(), g.float(), dy.float())
    torch.cuda.synchronize()
    err, worst = 0.0, 0.0
    for name, gg, e in zip(("dx", "dlog_a", "dgate"), got, exp):
        if gg.dtype != dtype or gg.shape != e.shape:
            raise AssertionError(f"rglru bwd {label}: {name} {gg.dtype}")
        if name == "dlog_a":
            diff, cond = rglru_bwd_diff(gg, e, la)
        else:
            if not torch.isfinite(gg).all():
                raise AssertionError(f"rglru bwd {label}: {name} not finite")
            diff, cond = (gg.float() - e).abs(), torch.zeros_like(e)
        err = max(err, diff.max().item())
        ef = torch.where(torch.isfinite(e), e, 0.0)
        if dtype == torch.float32:
            bad = (diff > 2e-5 * max(1.0, ef.abs().max().item()) + cond
                   ).any().item()
        else:
            mag = ef.abs().clamp_min(ef.abs().max().item() / 256 + 1e-30)
            spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
            sp = ((diff - cond).clamp_min(0) / spacing).max().item()
            worst = max(worst, sp)
            bad = sp > BWD_SPACINGS
        if bad:
            raise AssertionError(f"rglru bwd {label} {dtype}: {name} off by "
                                 f"{diff.max().item():.3e}")
    return err, worst


# Phase 2t's softcap (gemma-style, the value gemma-2 sets) and the width of
# its q draws: |q.k| * scale then spreads ~16, past the cap at the tails,
# and 1 - t^2 falls to ~0.3, so a kernel without the cap's derivative fails
# by far more than a spacing.
SOFTCAP = 50.0
SOFTCAP_QSCALE = 16.0


def check_softcap_grad(dev) -> dict:
    """Flash under autograd with a softcap on the card: ``ops.flash_attention``
    at qwen3-4b's heads (32 over 8 of 128, B 1, S 256, bf16) launches the
    forward kernel once and the backward kernel once (the counters), its
    gradients within one bf16 spacing of ``flash_attention_bwd_plain``'s in
    f32 on the forward kernel's own out and lse; with a ring it still
    raises ``NotImplementedError``."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED + 28)
    q, k, v, dout, qp, kp = flash_bwd_inputs(rng, 1, 256, 256, 32, 8, 128,
                                             torch.bfloat16, dev,
                                             qscale=SOFTCAP_QSCALE)
    kw = dict(q_pos=qp, k_pos=kp, causal=True, window=0, scale=128 ** -0.5,
              softcap=SOFTCAP)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ops.reset_kernel_launches()
    out = ops.flash_attention(*leaves, **kw)
    out.backward(dout)
    torch.cuda.synchronize()
    n = ops.kernel_launches()
    counts = {key: n[key] for key in ("flash_attention", "flash_attention_bwd")}
    if counts != {"flash_attention": 1, "flash_attention_bwd": 1}:
        raise AssertionError(f"softcap under grad: launches {counts}")
    o, lse = fk.flash_attention(q, k, v, splits=1, return_lse=True, **kw)
    want = fk.flash_attention_bwd_plain(*(x.float() for x in (q, k, v)),
                                        o.float(), lse, dout.float(), **kw)
    worst = max(bwd_spacings(x.grad, w) for x, w in zip(leaves, want))
    if worst > BWD_SPACINGS:
        raise AssertionError(f"softcap under grad: {worst:.2f} spacings")
    ring = torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16, device=dev)
    try:
        ops.flash_attention(*leaves, k_cache=ring, v_cache=ring,
                            cache_pos=torch.zeros((1, 8), dtype=torch.int32,
                                                  device=dev), **kw)
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("flash with a ring under grad did not raise")
    log(f"  flash under grad with softcap {SOFTCAP}: launches {counts}, "
        f"gradients within {worst:.3f} spacings of the plain backward; with a "
        f"ring: NotImplementedError ({refused})")
    return dict(launches=counts, spacings=worst, ring_refused=refused)


def check_backward(dev) -> dict:
    """Phase 2t: the four backward kernels against their plain versions on
    the card (flash also with a softcap, and under autograd with one).
    Returns each one's max abs error."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 20)
    bf, f32 = torch.bfloat16, torch.float32
    names = ("flash_attention_bwd", "rmsnorm_bwd", "ssd_bwd", "rglru_bwd")
    errs, spac = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    lse_worst = 0.0
    cases = [("qwen3-4b train", 2, 1024, 1024, 32, 8, 128, bf, True, 0, 0.0),
             ("qwen3-4b train", 2, 1024, 1024, 32, 8, 128, f32, True, 0, 0.0),
             ("minicpm-2b D64 MHA", 1, 512, 512, 36, 36, 64, bf, True, 0, 0.0),
             ("minicpm-2b D64 MHA", 1, 512, 512, 36, 36, 64, f32, True, 0,
              0.0),
             ("S 1000", 1, 1000, 1000, 32, 8, 128, bf, True, 0, 0.0),
             ("S 77", 2, 77, 77, 8, 2, 64, f32, True, 0, 0.0),
             ("not causal, 100 over 333 keys with holes", 2, 100, 333, 16, 4,
              128, bf, False, 0, 0.1)]
    for rep in (1, 2, 3, 4, 5, 6, 7, 8, 16):
        for d in (64, 128):
            for dt in (bf, f32):
                cases.append((f"GQA {rep} D {d} window 100", 2, 300, 300,
                              2 * rep, 2, d, dt, True, 100, 0.05))
    # recurrentgemma-9b's local attention: D 256, 16 over 1, window 2048,
    # at its training shape in both dtypes, the rest in bf16 (the f32 body
    # is also held at S 77)
    cases += [("recurrentgemma-9b train D256", 2, 1024, 1024, 16, 1, 256,
               dt, True, 2048, 0.0) for dt in (bf, f32)]
    cases += [("D256 S 2300 past the window", 1, 2300, 2300, 16, 1, 256, bf,
               True, 2048, 0.0),
              ("D256 GQA 4 window 100 holes", 2, 300, 300, 8, 2, 256, bf,
               True, 100, 0.05),
              ("D256 S 77", 2, 77, 77, 4, 1, 256, f32, True, 0, 0.0),
              ("D256 not causal, 100 over 333 keys", 1, 100, 333, 4, 1, 256,
               bf, False, 0, 0.1)]
    for label, b, s, t, hq, hkv, d, dt, causal, window, holes in cases:
        e, sp, le = check_flash_bwd(dev, rng, label, b, s, t, hq, hkv, d, dt,
                                    causal, window, holes)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], e)
        spac["flash_attention_bwd"] = max(spac["flash_attention_bwd"], sp)
        lse_worst = max(lse_worst, le)
    # with a softcap of 50: D 64, 128 and 256, causal and windowed, GQA and
    # MQA, both dtypes (drawn apart, so the cases above keep their inputs)
    cap_rng = np.random.default_rng(SEED + 29)
    cap_cases = [(f"softcap qwen3-4b heads {dt}", 1, 512, 512, 32, 8, 128, dt,
                  True, 0, 0.0) for dt in (bf, f32)]
    cap_cases += [(f"softcap GQA 4 D {d} window 100 {dt}", 2, 300, 300, 8, 2,
                   d, dt, True, 100, 0.05) for d in (64, 128, 256)
                  for dt in (bf, f32)]
    cap_cases += [(f"softcap recurrentgemma-9b D256 MQA window 2048 {dt}", 1,
                   1024, 1024, 16, 1, 256, dt, True, 2048, 0.0)
                  for dt in (bf, f32)]
    cap_cases += [("softcap MQA D 64 window 64", 2, 200, 200, 8, 1, 64, bf,
                   True, 64, 0.0),
                  ("softcap not causal, 100 over 333 keys with holes", 2, 100,
                   333, 16, 4, 128, bf, False, 0, 0.1)]
    cap_err = cap_sp = cap_lse = 0.0
    for label, b, s, t, hq, hkv, d, dt, causal, window, holes in cap_cases:
        e, sp, le = check_flash_bwd(dev, cap_rng, label, b, s, t, hq, hkv, d,
                                    dt, causal, window, holes, SOFTCAP)
        cap_err, cap_sp, cap_lse = (max(cap_err, e), max(cap_sp, sp),
                                    max(cap_lse, le))
    errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], cap_err)
    spac["flash_attention_bwd"] = max(spac["flash_attention_bwd"], cap_sp)
    lse_worst = max(lse_worst, cap_lse)
    log(f"  flash bwd with softcap {SOFTCAP}: {len(cap_cases)} cases, max abs "
        f"err {cap_err:.3e}, bf16 {cap_sp:.3f} spacings (limit "
        f"{BWD_SPACINGS}), lse {cap_lse:.2e}")
    softcap_grad = check_softcap_grad(dev)
    norm_cases = [("norm", 2048, 2560, 0), ("add", 2048, 2560, 0),
                  ("pair", 2048 * 32, 128, 2048 * 8), ("norm", 2048, 2304, 0),
                  ("add", 2048, 2304, 0), ("norm", 300, 999, 0),
                  ("add", 300, 999, 0), ("pair", 300, 999, 77),
                  ("pair", 40, 64, 12), ("norm", 64, 8192, 0),
                  ("add", 7, 4096, 0), ("gated", 2048, 3072, 0),
                  ("gated", 300, 999, 0), ("gated", 3, 64, 0),
                  ("gated", 512, 1536, 0), ("gated", 512, 4096, 0)]
    for form, rows, d, krows in norm_cases:
        for dt in (bf, f32):
            e, sp = check_norm_bwd(dev, rng, form, rows, d, dt, krows)
            errs["rmsnorm_bwd"] = max(errs["rmsnorm_bwd"], e)
            spac["rmsnorm_bwd"] = max(spac["rmsnorm_bwd"], sp)
    # mamba2-780m's widths (48 heads of 64, state 128): its training
    # prompt, chunks of 100 and the narrow chunks of 2, one chunk and
    # several; then, in bf16, 47 heads at the training shape, whose last
    # head group is short (ssd_bwd_group_cases)
    ssd_cases = [(2, 1024, 48, 128, dt) for dt in (bf, f32)]
    ssd_cases += [(1, s, 48, chunk, dt) for s, chunk in (
        (100, 100), (300, 100), (2, 2), (130, 2)) for dt in (bf, f32)]
    group_cases = ssd_bwd_group_cases(dev)
    group_rng = np.random.default_rng(SEED + 26)    # the others' draws kept
    for ssd_rng, some in ((rng, ssd_cases), (group_rng, group_cases)):
        for b, s, h, chunk, dt in some:
            e, sp = check_ssd_bwd(dev, ssd_rng,
                                  f"B {b} S {s} H {h} chunk {chunk}", b, s,
                                  h, 64, 128, chunk, dt)
            errs["ssd_bwd"] = max(errs["ssd_bwd"], e)
            spac["ssd_bwd"] = max(spac["ssd_bwd"], sp)
    # recurrentgemma-9b's width 4096 and an odd one, 1 to 2300 steps, both
    # of plan's paths (staged forced on short ones too)
    rg_cases = [(2, 1024, 4096, None, True), (1, 1, 4096, None, False),
                (2, 33, 4096, None, False), (1, 128, 4096, None, False),
                (1, 33, 4096, True, False), (1, 2300, 4096, None, False),
                (8, 300, 999, None, True), (1, 5, 999, True, False)]
    for b, s, d, staged, zeros in rg_cases:
        for dt in (bf, f32):
            e, sp = check_rglru_bwd(dev, rng, f"B {b} S {s} D {d}", b, s, d,
                                    dt, staged, zeros)
            errs["rglru_bwd"] = max(errs["rglru_bwd"], e)
            spac["rglru_bwd"] = max(spac["rglru_bwd"], sp)
    ckpt_cases = check_rglru_checkpoint(dev, rng)
    log(f"  flash bwd: {len(cases)} cases, max abs err "
        f"{errs['flash_attention_bwd']:.3e}, bf16 {spac['flash_attention_bwd']:.3f} "
        f"spacings (limit {BWD_SPACINGS}), lse {lse_worst:.2e}; norm bwd: "
        f"{2 * len(norm_cases)} cases, max abs err {errs['rmsnorm_bwd']:.3e}, "
        f"bf16 {spac['rmsnorm_bwd']:.3f} spacings; ssd bwd: "
        f"{len(ssd_cases + group_cases)} cases, max abs err "
        f"{errs['ssd_bwd']:.3e}, "
        f"bf16 {spac['ssd_bwd']:.3f} spacings; rglru bwd: "
        f"{2 * len(rg_cases)} cases, max abs err {errs['rglru_bwd']:.3e}, "
        f"bf16 {spac['rglru_bwd']:.3f} spacings; the rglru forward's "
        f"checkpoint: {ckpt_cases} cases, y bit-identical with and without")
    repeated = check_bwd_repeat(dev, rng)
    DETAILS["backward_checks"] = dict(errs=errs, spacings=spac,
                                      lse_err=lse_worst,
                                      bit_identical=repeated,
                                      softcap=dict(cases=len(cap_cases),
                                                   max_abs_err=cap_err,
                                                   spacings=cap_sp,
                                                   lse_err=cap_lse,
                                                   under_grad=softcap_grad))
    return errs


def check_rglru_checkpoint(dev, rng) -> int:
    """``rglru(..., checkpoint=True)``: y bit-identical to the launch
    without the checkpoint, and the checkpoint (each tile's incoming f32
    state) against ``rglru_checkpoint_plain`` on the same inputs, 2e-5 of
    max(1, max|ref|) (f32 sums in another order); then the backward
    given that checkpoint bit-identical to the one that makes its own.
    Returns the number of cases."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    cases = [(2, 1024, 4096, torch.bfloat16), (8, 300, 999, torch.bfloat16),
             (1, 2300, 4096, torch.float32), (1, 100, 4096, torch.bfloat16)]
    for b, s, d, dt in cases:
        x, la, g = rglru_inputs(rng, (b, s, d), dt, dev)
        y0 = rg.rglru(x, la, g)
        y1, ckpt = rg.rglru(x, la, g, checkpoint=True)
        want = rg.rglru_checkpoint_plain(x.float(), la.float(), g.float())
        dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype(
            "float32")).to(dev, dt)
        b0 = rg.rglru_bwd(x, la, g, dy)
        b1 = rg.rglru_bwd(x, la, g, dy, ckpt=ckpt)
        torch.cuda.synchronize()
        label = f"rglru checkpoint B {b} S {s} D {d} {dt}"
        if not same_bits(y0, y1):
            raise AssertionError(f"{label}: y differs with the checkpoint")
        if ckpt.shape != want.shape or ckpt.shape[1] != rg.tiles(s) - 1:
            raise AssertionError(f"{label}: checkpoint {tuple(ckpt.shape)}")
        if ckpt.numel() and (ckpt - want).abs().max().item() > \
                2e-5 * max(1.0, want.abs().max().item()):
            raise AssertionError(f"{label}: checkpoint off by "
                                 f"{(ckpt - want).abs().max().item():.3e}")
        if not all(same_bits(u, v) for u, v in zip(b0, b1)):
            raise AssertionError(f"{label}: the backward differs given the "
                                 "checkpoint")
    return len(cases)


def ssd_bwd_group_cases(dev) -> list:
    """``check_ssd_bwd`` cases (b, s, h, chunk, dtype) whose planned head
    group leaves the last group short: bf16, B 2, S 1024, chunk 128, 47
    heads (groups of 6, the last of 5 on 132 SMs), so the kernels' path for
    heads past H runs on the card.  Raises if the card's plan divides the
    heads."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as sk
    b, s, h, chunk = 2, 1024, 47, 128
    group = sk.bwd_head_group(b, s, h, chunk, build.sm_count(dev.index or 0))
    if h % group == 0:
        raise AssertionError(f"ssd bwd: {group} heads a block divide {h}; "
                             "no short last group to check")
    return [(b, s, h, chunk, torch.bfloat16)]


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def check_bwd_repeat(dev, rng) -> list:
    """Two launches of each backward kernel at the training shapes give
    bit-identical outputs: no float atomics, sums in a fixed order (resume
    bit for bit rests on it).  bf16; qwen3-4b's: flash B 2, S 1024, 32
    over 8 heads of 128, causal; the norm and add forms over 2048 rows of
    2560, the pair over q 2048 x 32 and k 2048 x 8 rows of 128; the
    recurrent stacks': the gated norm over 2048 rows of 3072, ``ssd`` at
    mamba2-780m's (B 2, S 1024, 48 heads, chunk 128) and at 47 heads (a
    short last head group, ``ssd_bwd_group_cases``), ``rglru`` over
    2 x 1024 x 4096, flash at D 256, 16 over 1, window 2048."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk
    bf = torch.bfloat16
    q, k, v, dout, qp, kp = flash_bwd_inputs(rng, 2, 1024, 1024, 32, 8, 128,
                                             bf, dev)
    kw = dict(q_pos=qp, k_pos=kp, causal=True, window=0, scale=128 ** -0.5)
    out, lse = fk.flash_attention(q, k, v, splits=1, return_lse=True, **kw)

    def rnd(shape, sc=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sc)
                                .astype(np.float32)).to(dev, bf)

    def gain(d):
        return torch.from_numpy((rng.standard_normal(d) * 0.1)
                                .astype(np.float32)).to(dev)
    x, dy, ds, g = rnd((2048, 2560)), rnd((2048, 2560)), rnd((2048, 2560),
                                                             0.5), gain(2560)
    qx, kx, dq, dk = (rnd((2048 * 32, 128)), rnd((2048 * 8, 128)),
                      rnd((2048 * 32, 128)), rnd((2048 * 8, 128)))
    gq, gk = gain(128), gain(128)
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as sk
    gy, gz, gdo, g3 = (rnd((2048, 3072)), rnd((2048, 3072)),
                       rnd((2048, 3072)), gain(3072))
    sx, sdt, sal, sbm, scm, sds = ssd_inputs(rng, 2, 1024, 48, 64, 128, bf,
                                             dev)
    sdy = rnd((2, 1024, 48, 64))
    (sb, ss, sh, sq, _), = ssd_bwd_group_cases(dev)
    srng = np.random.default_rng(SEED + 27)    # the others' draws kept
    ssd_short = ssd_inputs(srng, sb, ss, sh, 64, 128, bf, dev)
    ssd_short_dy = torch.from_numpy(srng.standard_normal(
        (sb, ss, sh, 64)).astype(np.float32)).to(dev, bf)
    rx, rla, rgt = rglru_inputs(rng, (2, 1024, 4096), bf, dev)
    rdy = rnd((2, 1024, 4096))
    q2, k2, v2, do2, qp2, kp2 = flash_bwd_inputs(rng, 2, 1024, 1024, 16, 1,
                                                 256, bf, dev)
    kw2 = dict(q_pos=qp2, k_pos=kp2, causal=True, window=2048,
               scale=256 ** -0.5)
    out2, lse2 = fk.flash_attention(q2, k2, v2, splits=1, return_lse=True,
                                    **kw2)
    runs = {
        "flash_attention_bwd": lambda: fk.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw),
        "rmsnorm_bwd norm": lambda: rk.rmsnorm_bwd(x, g, dy),
        "rmsnorm_bwd add": lambda: rk.add_rmsnorm_bwd(x, g, ds, dy),
        "rmsnorm_bwd pair": lambda: rk.rmsnorm_pair_bwd(qx, kx, gq, gk, dq,
                                                        dk),
        "rmsnorm_bwd gated": lambda: rk.gated_rmsnorm_bwd(gy, gz, g3, gdo),
        "ssd_bwd": lambda: tuple(t for t in sk.ssd_bwd(
            sx, sdt, sal, sbm, scm, sds, sdy, chunk=128) if t is not None),
        f"ssd_bwd H {sh}": lambda: tuple(t for t in sk.ssd_bwd(
            *ssd_short, ssd_short_dy, chunk=sq) if t is not None),
        "rglru_bwd": lambda: rg.rglru_bwd(rx, rla, rgt, rdy),
        "flash_attention_bwd D256": lambda: fk.flash_attention_bwd(
            q2, k2, v2, out2, lse2, do2, **kw2),
    }
    for name, fn in runs.items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(first, second)):
            if not same_bits(a, b):
                raise AssertionError(f"{name}: output {i} differs between "
                                     "two launches")
    log(f"  two launches bit-identical: {', '.join(runs)}")
    return list(runs)


def softcap_rows(q, k, v, dout, kw, flush) -> dict:
    """The flash backward's time with a softcap of ``SOFTCAP`` at ``kw``'s
    shape (the forward's lse and out under the cap; q and the rest as the
    uncapped row has them), by launch, and the forward's with the cap."""
    from repro_torch.kernels import flash_attention as fk
    kc = dict(kw, softcap=SOFTCAP)
    out, lse = fk.flash_attention(q, k, v, splits=1, return_lse=True, **kc)

    def kern():
        return fk.flash_attention_bwd(q, k, v, out, lse, dout, **kc)
    return dict(softcap_ms=device_ms(kern, flush),
                softcap_split_ms=kernel_breakdown(kern, flush),
                softcap_fwd_ms=device_ms(lambda: fk.flash_attention(
                    q, k, v, splits=1, return_lse=True, **kc), flush))


def time_backward(dev) -> dict:
    """Phase 2c's rows for the backward kernels at qwen3-4b's training
    shapes (bf16; B 2, S 1024, 32 over 8 heads of 128; norms over 2048
    rows), beside their bounds, their plain versions and one PyTorch
    autograd backward as a yardstick (SDPA's over K/V expanded to the query
    heads; ``F.rms_norm``'s), which the port never calls; and the flash
    forward with and without its lse at the same shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rmsnorm as rk

    rng = np.random.default_rng(SEED + 21)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = {}
    b, s, hq, hkv, d = 2, 1024, 32, 8, 128
    for dt, peak, key in ((torch.bfloat16, PEAK_BF16_FLOPS, "ms"),
                          (torch.float32, PEAK_F32_FLOPS, "f32")):
        q, k, v, dout, qp, kp = flash_bwd_inputs(rng, b, s, s, hq, hkv, d, dt,
                                                 dev)
        kw = dict(q_pos=qp, k_pos=kp, causal=True, window=0, scale=d ** -0.5)
        out, lse = fk.flash_attention(q, k, v, splits=1, return_lse=True,
                                      **kw)
        rep = hq // hkv
        lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k.repeat_interleave(rep, 2),
                                v.repeat_interleave(rep, 2)))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
        ldo = dout.transpose(1, 2)
        el = q.element_size()
        # q, out, dout, k, v read; dq, dk, dv written; lse read
        nbytes = (4 * q.numel() + 4 * k.numel()) * el + lse.numel() * 4
        flops = 5 * 2 * b * hq * d * (s * (s + 1) // 2)
        bms, by = bound(nbytes, flops, peak)
        row = dict(
            shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal {dt}",
            ms=device_ms(lambda: fk.flash_attention_bwd(q, k, v, out, lse,
                                                        dout, **kw), flush),
            plain_ms=device_ms(lambda: fk.flash_attention_bwd_plain(
                q, k, v, out, lse, dout, **kw), flush),
            library_ms=device_ms(lambda: torch.autograd.grad(
                lo, (lq, lk, lv), ldo, retain_graph=True), flush),
            library_note="SDPA backward over K/V expanded to 32 heads",
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes)
        # the three launches apart: delta, dK/dV, dQ
        row["split_ms"] = kernel_breakdown(lambda: fk.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw), flush)
        if key == "ms":
            row.update(softcap_rows(q, k, v, dout, kw, flush))
            row["host_ms"] = host_ms(lambda: fk.flash_attention_bwd(
                q, k, v, out, lse, dout, **kw), flush=flush)
            rows["flash_attention_bwd"] = row
            fwd_bytes = (2 * q.numel() + 2 * k.numel()) * el
            fwd_flops = 2 * 2 * b * hq * d * (s * (s + 1) // 2)
            fb, fby = bound(fwd_bytes + lse.numel() * 4, fwd_flops, peak)
            rows["flash_attention_train"] = dict(
                ms=device_ms(lambda: fk.flash_attention(
                    q, k, v, splits=1, return_lse=True, **kw), flush),
                no_lse_ms=device_ms(lambda: fk.flash_attention(
                    q, k, v, splits=1, **kw), flush),
                plain_ms=device_ms(lambda: fk.flash_attention_plain(
                    q, k, v, **kw), flush),
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    lq.detach(), lk.detach(), lv.detach(), is_causal=True),
                    flush),
                bound_ms=fb, bound_by=fby,
                shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal bf16, "
                      "one split, with lse")
        else:
            rows["flash_attention_bwd"]["f32"] = row
        del lo, lq, lk, lv

    bf = torch.bfloat16

    def rnd(shape, sc=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sc)
                                .astype(np.float32)).to(dev, bf)

    def gain(dd):
        return torch.from_numpy((rng.standard_normal(dd) * 0.1)
                                .astype(np.float32)).to(dev)

    def lib_rms(xs, dys):
        """F.rms_norm's autograd backward over the same rows."""
        outs = []
        for x, dy in zip(xs, dys):
            lx = x.detach().requires_grad_(True)
            w = (1.0 + gain(x.shape[-1])).to(bf).requires_grad_(True)
            outs.append((F.rms_norm(lx, (x.shape[-1],), w, 1e-6), lx, w, dy))
        return lambda: [torch.autograd.grad(o, (lx, w), dy, retain_graph=True)
                        for o, lx, w, dy in outs]

    n, dm = 2048, 2560
    x, dy, g = rnd((n, dm)), rnd((n, dm)), gain(dm)
    ds = rnd((n, dm), 0.5)
    qx, kx = rnd((n * 32, 128)), rnd((n * 8, 128))
    dq, dk = rnd((n * 32, 128)), rnd((n * 8, 128))
    gq, gk = gain(128), gain(128)
    # (kernel, plain, library, elements, bytes: x and dy read and dx
    # written in bf16, the sum's gradient read too for the add, the gains
    # read and their gradients written in f32)
    forms = {
        "ms": (lambda: rk.rmsnorm_bwd(x, g, dy),
               lambda: rk.rmsnorm_bwd_plain(x, g, dy),
               lib_rms([x], [dy]), x.numel(), 3 * x.numel() * 2 + dm * 8,
               f"{n} x {dm} bf16"),
        # no single PyTorch call computes the add form: its yardstick is
        # the norm's backward alone, without the sum's gradient added
        "add": (lambda: rk.add_rmsnorm_bwd(x, g, ds, dy),
                lambda: rk.add_rmsnorm_bwd_plain(x, g, ds, dy),
                lib_rms([x], [dy]), x.numel(), 4 * x.numel() * 2 + dm * 8,
                f"{n} x {dm} bf16, the sum's gradient added"),
        "pair": (lambda: rk.rmsnorm_pair_bwd(qx, kx, gq, gk, dq, dk),
                 lambda: rk.rmsnorm_pair_bwd_plain(qx, kx, gq, gk, dq, dk),
                 lib_rms([qx, kx], [dq, dk]), qx.numel() + kx.numel(),
                 3 * (qx.numel() + kx.numel()) * 2 + 128 * 16,
                 f"q {n} x 32 x 128, k {n} x 8 x 128 bf16"),
    }
    norm_row = None
    for key, (kern, plain, lib, elems, nbytes, shape) in forms.items():
        # about ten f32 operations an element
        bms, by = bound(nbytes, 10 * elems, PEAK_F32_FLOPS)
        # beside the usual protocol (a write flush leaves the L2 full of
        # dirty lines, which these loads evict): a read flush that leaves it
        # clean, and a PyTorch reduction over as many bytes
        row = dict(ms=device_ms(kern, flush), plain_ms=device_ms(plain, flush),
                   library_ms=device_ms(lib, flush), bound_ms=bms,
                   bound_by=by, shape=shape, host_ms=host_ms(kern, flush=flush),
                   split_ms=kernel_breakdown(kern, flush),
                   read_flush_ms=device_ms(kern, flush, how="read"),
                   library_read_flush_ms=device_ms(lib, flush, how="read"),
                   stream_ms=stream_ms(nbytes, dev, flush))
        row["library_note"] = (
            "F.rms_norm autograd backward without the residual gradient's "
            "add: no single PyTorch call computes the add form"
            if key == "add" else "F.rms_norm autograd backward")
        if key == "ms":
            norm_row = row
        else:
            norm_row[key] = row
    rows["rmsnorm_bwd"] = norm_row
    t0 = time.perf_counter()
    rows.update(time_recurrent_backward(dev, rng, flush))
    log(f"  the recurrent stacks' backward rows: "
        f"{time.perf_counter() - t0:.1f} s")
    rows["rmsnorm_bwd"]["gated"] = rows.pop("rmsnorm_bwd_gated")
    rows["flash_attention_bwd"]["d256"] = rows.pop("flash_attention_bwd_d256")
    for name, row in rows.items():
        for key, at in (("ms", row), ("f32", row.get("f32")),
                        ("pair", row.get("pair")), ("add", row.get("add")),
                        ("gated", row.get("gated")),
                        ("d256", row.get("d256"))):
            if at is None:
                continue
            extra = (f"; without lse {at['no_lse_ms']:.4f}"
                     if "no_lse_ms" in at else "")
            if "read_flush_ms" in at:
                extra += (f"; clean L2 {at['read_flush_ms']:.4f} (library "
                          f"{at['library_read_flush_ms']:.4f}), a reduction "
                          f"over the bytes {at['stream_ms']:.4f}")
            if "split_ms" in at:
                extra += "; by launch " + ", ".join(
                    f"{k} {v:.4f}" for k, v in at["split_ms"].items())
            if "one_tile_ms" in at:
                extra += f"; 32 steps {at['one_tile_ms']:.4f}"
            if "fwd_ckpt_ms" in at:
                extra += (f"; forward with its checkpoint "
                          f"{at['fwd_ckpt_ms']:.4f}, without "
                          f"{at['fwd_ms']:.4f}")
            if "softcap_ms" in at:
                extra += (f"; softcap {SOFTCAP}: {at['softcap_ms']:.4f} "
                          f"({at['softcap_ms'] / at['ms']:.3f}x; by launch "
                          + ", ".join(f"{k} {v:.4f}" for k, v in
                                      at["softcap_split_ms"].items())
                          + f"; forward {at['softcap_fwd_ms']:.4f})")
            lib = at["library_ms"]
            log(f"  {name:22s} {key:5s} {at['ms']:.4f} ms; bound "
                f"{at['bound_ms']:.4f} ({at['bound_by']}), plain "
                f"{at['plain_ms']:.4f}, library "
                + ("none" if lib is None else f"{lib:.4f}")
                + extra + f" [{at['shape']}]")
    DETAILS["backward_timings"] = rows
    return rows


def ssd_bwd_flops(b: int, s: int, h: int, p: int, n: int, q: int) -> int:
    """Operations ``ssd``'s backward needs, two a multiply-add: per (b,
    chunk) C B^T once (the heads share B and C), per (b, chunk, head) the
    lower triangles (the decay mask L is causal) of dy xb^T (Q x Q x P),
    M1^T dy (P), M2 B and M2^T C (N, N), and the five state products (the
    chunk state, the carried state's local term, B G, dy H^T, xb G^T: Q x
    N x P each).  The bound of the ``ssd_bwd`` row."""
    tri = q * (q + 1) // 2
    return b * (s // q) * (2 * tri * n + h * (
        2 * tri * (2 * n + 2 * p) + 10 * q * n * p))


def ssd_bwd_f32_route_flops(b: int, s: int, h: int, p: int, n: int,
                            q: int) -> int:
    """Operations of ``ssd``'s backward as the f32 route's products count
    them, per (b, chunk, head): C B^T, dy xb^T, M1^T dy, M2 B, M2^T C as
    full Q x Q squares and the five state products; kept beside the
    bound to compare with the rows of the CUDA-core route, whose bound it
    was."""
    return b * (s // q) * h * (2 * q * q * (3 * n + 2 * p) + 10 * q * n * p)


def time_recurrent_backward(dev, rng, flush) -> dict:
    """Phase 2c's rows for the recurrent stacks' backward kernels at their
    training shapes (bf16, B 2, S 1024): ``ssd_bwd`` at mamba2-780m's (48
    heads of 64, state 128, chunk 128), ``rglru_bwd`` over width 4096, the
    gated norm over 2048 rows of 3072 (beside the autograd backward of
    ``F.rms_norm(y * F.silu(z))``) and flash at D 256, 16 over 1, window
    2048 (beside SDPA's backward over K/V expanded to 16 heads).  No
    single PyTorch call computes ``ssd``'s or ``rglru``'s backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    bf = torch.bfloat16
    rows = {}

    def rnd(shape, sc=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sc)
                                .astype("float32")).to(dev, bf)
    b, s, h, p, n, q = 2, 1024, 48, 64, 128, 128
    x, dt, a_log, bm, cm, dsk = ssd_inputs(rng, b, s, h, p, n, bf, dev)
    dy = rnd((b, s, h, p))
    kern = (lambda: sk.ssd_bwd(x, dt, a_log, bm, cm, dsk, dy, chunk=q))
    plain = (lambda: sk.ssd_bwd_plain(x, dt, a_log, bm, cm, dsk, dy,
                                      chunk=q))
    # x, dy read and dx written (B S H P); dt read, ddt written (B S H);
    # B, C read, dB, dC written (B S N); a_log, d_skip and theirs (f32)
    nbytes = 2 * (3 * x.numel() + 2 * dt.numel() + 4 * bm.numel()) + 16 * h
    flops = ssd_bwd_flops(b, s, h, p, n, q)
    f32_flops = ssd_bwd_f32_route_flops(b, s, h, p, n, q)
    # the inputs are bf16: the bound takes the products the function needs
    # at the tensor cores' rate, where the kernel runs them; the f32
    # route's count at the CUDA cores' 67 TFLOP/s, the rows' bound before
    # the redesign, is kept beside for comparison with them
    bms, by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    sms = build.sm_count(dev.index or 0)
    rows["ssd_bwd"] = dict(
        ms=device_ms(kern, flush), plain_ms=device_ms(plain, flush),
        library_ms=None, bound_ms=bms, bound_by=by,
        cuda_core_bound_ms=bound(nbytes, f32_flops, PEAK_F32_FLOPS)[0],
        flops=flops, f32_route_flops=f32_flops, bytes=nbytes, host_ms=host_ms(kern, flush=flush),
        split_ms=kernel_breakdown(kern, flush),
        shape=f"B={b} S={s} H={h} P={p} N={n} chunk {q} bf16, products on "
              f"the tensor cores (mma.sync, f32 operands split hi + lo), "
              f"{sk.bwd_head_group(b, s, h, q, sms)} heads a block")
    del x, dt, bm, cm, dy
    w = 4096
    x, la, g = rglru_inputs(rng, (b, s, w), bf, dev)
    dy = rnd((b, s, w))
    _, ckpt = rg.rglru(x, la, g, checkpoint=True)
    kern = (lambda: rg.rglru_bwd(x, la, g, dy, ckpt=ckpt))
    # x, log_a, gate, dy and the forward's checkpoint read; dx, dlog_a,
    # dgate written; about forty f32 operations an element (the forward
    # recomputed, the reverse scan)
    nbytes = 7 * x.numel() * 2 + ckpt.numel() * 4
    bms, by = bound(nbytes, 40 * x.numel(), PEAK_F32_FLOPS)
    rows["rglru_bwd"] = dict(
        ms=device_ms(kern, flush),
        plain_ms=device_ms(lambda: rg.rglru_bwd_plain(x, la, g, dy), flush),
        library_ms=None, bound_ms=bms, bound_by=by, bytes=nbytes,
        host_ms=host_ms(kern, flush=flush),
        one_tile_ms=device_ms(lambda: rg.rglru_bwd(
            x[:, :32].contiguous(), la[:, :32].contiguous(),
            g[:, :32].contiguous(), dy[:, :32].contiguous()), flush),
        # the forward at the training shape, as autograd runs it (with
        # the checkpoint) and as serving does (without)
        fwd_ckpt_ms=device_ms(lambda: rg.rglru(x, la, g, checkpoint=True),
                              flush),
        fwd_ms=device_ms(lambda: rg.rglru(x, la, g), flush),
        shape=f"B={b} S={s} D={w} bf16, given the forward's checkpoint "
              f"(one_tile_ms: the same over 32 steps; fwd_ckpt_ms, fwd_ms: "
              f"the forward with and without it)")
    del x, la, g, dy
    rows_n, d = 2048, 3072
    y, z, do = rnd((rows_n, d)), rnd((rows_n, d)), rnd((rows_n, d))
    gain = torch.from_numpy((rng.standard_normal(d) * 0.1).astype("float32")
                            ).to(dev)
    ly, lz = (t.detach().requires_grad_(True) for t in (y, z))
    lw = (1.0 + gain).to(bf).requires_grad_(True)
    lo = F.rms_norm(ly * F.silu(lz), (d,), lw, 1e-6)
    kern = (lambda: rk.gated_rmsnorm_bwd(y, z, gain, do))
    # y, z, dy read and dy, dz written (bf16); the gain and its gradient
    nbytes = 5 * y.numel() * 2 + d * 8
    bms, by = bound(nbytes, 30 * y.numel(), PEAK_F32_FLOPS)
    rows["rmsnorm_bwd_gated"] = dict(
        ms=device_ms(kern, flush),
        plain_ms=device_ms(lambda: rk.gated_rmsnorm_bwd_plain(y, z, gain, do),
                           flush),
        library_ms=device_ms(lambda: torch.autograd.grad(
            lo, (ly, lz, lw), do, retain_graph=True), flush),
        library_note="autograd backward of F.rms_norm(y * F.silu(z))",
        bound_ms=bms, bound_by=by, host_ms=host_ms(kern, flush=flush),
        split_ms=kernel_breakdown(kern, flush),
        shape=f"{rows_n} x {d} bf16 (mamba2-780m's d_inner)")
    del y, z, do, ly, lz, lo
    hq, hkv, dh, window = 16, 1, 256, 2048
    q_, k_, v_, do_, qp, kp = flash_bwd_inputs(rng, b, s, s, hq, hkv, dh, bf,
                                               dev)
    kw = dict(q_pos=qp, k_pos=kp, causal=True, window=window,
              scale=dh ** -0.5)
    out, lse = fk.flash_attention(q_, k_, v_, splits=1, return_lse=True, **kw)
    lq, lk, lv = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q_, k_.repeat_interleave(hq, 2),
                            v_.repeat_interleave(hq, 2)))
    # the window (2048) covers the 1024 keys: SDPA's causal mask is the same
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    kern = (lambda: fk.flash_attention_bwd(q_, k_, v_, out, lse, do_, **kw))
    nbytes = (4 * q_.numel() + 4 * k_.numel()) * 2 + lse.numel() * 4
    flops = 5 * 2 * b * hq * dh * (s * (s + 1) // 2)
    bms, by = bound(nbytes, flops, PEAK_BF16_FLOPS)
    rows["flash_attention_bwd_d256"] = dict(
        **softcap_rows(q_, k_, v_, do_, kw, flush),
        ms=device_ms(kern, flush),
        plain_ms=device_ms(lambda: fk.flash_attention_bwd_plain(
            q_, k_, v_, out, lse, do_, **kw), flush),
        library_ms=device_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do_.transpose(1, 2), retain_graph=True), flush),
        library_note="SDPA backward over K/V expanded to 16 heads",
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        host_ms=host_ms(kern, flush=flush),
        split_ms=kernel_breakdown(kern, flush),
        shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={dh} causal window "
              f"{window} bf16 (recurrentgemma-9b), dK/dV over "
              f"{fk.bwd_kv_groups(b, s, hq, hkv, sms)} head groups")
    return rows


# ------------------------------------------------ training (phases 3i, 13)
def train_identity(dev, layers: int = 2, batch: int = 2, seq: int = 256,
                   steps: int = 3, arch: str = "qwen3-4b",
                   resume: bool = True) -> dict:
    """Phase 3i: ``arch`` (qwen3-4b) at full width, ``layers`` deep, f32
    with TF32 off: step 1's gradients of every parameter card against CPU
    (and nonzero on the card), then ``steps`` ``make_train_step`` steps on
    both from the same weights and batches; then, with ``resume``, in bf16
    with f32 masters, 4 straight ``train_loop`` steps against 2, a
    checkpoint, a restore and 2 more, bit for bit on the card.  Phase 3r
    runs it for the recurrent stacks without the resume."""
    import gc
    import shutil
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as M
    from repro_torch.training import steps as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 8)
    cfg = get_config(arch).replace(num_layers=layers, dtype=torch.float32)
    lr = 1e-4
    tc = TrainConfig(learning_rate=lr, total_steps=10, warmup_steps=2)
    t0 = time.perf_counter()
    gpu = M.init_model(cfg, SEED, dev)
    cpu = cpu_copy(gpu, cfg)
    gs, cs = S.train_state(gpu, tc), S.train_state(cpu, tc)
    ds = SyntheticDataset(cfg, DataConfig(global_batch=batch, seq_len=seq,
                                          seed=SEED))
    loss_fn = S.make_loss_fn(cfg, tc)
    took = {"setup": time.perf_counter() - t0}
    losses = []
    for st in (gs, cs):
        loss, _ = loss_fn(st["model"], S.to_device(ds.batch(0),
                                                   st["model"].device))
        loss.backward()
        losses.append(float(loss.detach()))
    # per tensor, 1e-4 of its largest |gradient|: f32 sums over 512 tokens
    # and widths up to 9728 in another order on each side (cuBLAS, the
    # kernels' f32 bodies; the CPU's), through two layers and the 151936-
    # way softmax
    # compared on the card (the CPU's copy sent over): the same exact
    # differences, maxima and counts, without a pass over every parameter
    # on the host
    grad_err = 0.0
    for (name, g), c in zip(gpu.named_parameters(), cpu.parameters()):
        gg = g.grad
        if gg is None or not (gg != 0).any():
            raise AssertionError(f"train identity {arch}: {name} has no "
                                 "gradient on the card")
        cg = c.grad.to(dev)
        rel = ((gg - cg).abs().max() / cg.abs().max()).item()
        grad_err = max(grad_err, rel)
        if rel > 1e-4:
            raise AssertionError(f"train identity {arch}: {name} gradient "
                                 f"off by {rel:.2e} of its max")
        g.grad = c.grad = None
    took["gradients"] = time.perf_counter() - t0 - took["setup"]
    gstep, cstep = S.make_train_step(cfg, tc), S.make_train_step(cfg, tc)
    ops.reset_kernel_launches()
    metrics = []
    for i in range(steps):
        bt = ds.batch(i)
        gs, gm = gstep(gs, bt)
        cs, cm = cstep(cs, bt)
        m = {k: (float(gm[k]), float(cm[k])) for k in
             ("loss", "ce", "grad_norm", "lr")}
        metrics.append(m)
        # step 1 runs the same weights (f32 sums in another order); later
        # steps weights that may differ by 2 lr at noise elements (below)
        tol = 1e-5 if i == 0 else 1e-4
        for k, (a, b) in m.items():
            if abs(a - b) > tol * abs(b) + 1e-12:
                raise AssertionError(f"train identity {arch}: step {i + 1} "
                                     f"{k} card {a} CPU {b}")
    took["steps"] = time.perf_counter() - t0 - sum(took.values())
    launches = ops.kernel_launches()
    expect = expected_train_launches(cfg, cfg.remat, steps)
    if launches != expect:
        raise AssertionError(f"train identity {arch}: launches "
                             f"{launches}, expected {expect}")
    # AdamW's first updates are lr * sign(g) wherever |g| >> eps, so an
    # element whose gradient is summation noise near zero can move 2 lr the
    # other way at each step
    p_err, close = 0.0, 0
    total = 0
    for a, b in zip(gpu.parameters(), cpu.parameters()):
        dlt = (a.detach() - b.detach().to(dev)).abs()
        p_err = max(p_err, dlt.max().item())
        close += int((dlt <= 1e-6).sum())
        total += dlt.numel()
    if p_err > 2 * lr * steps:
        raise AssertionError(f"train identity {arch}: parameters off by "
                             f"{p_err}")
    log(f"  {arch} x {layers}: step-1 loss card {losses[0]:.6f} CPU "
        f"{losses[1]:.6f}; every "
        f"gradient nonzero, within {grad_err:.2e} of its max; {steps} steps "
        + "; ".join(f"loss {m['loss'][0]:.6f}/{m['loss'][1]:.6f} gnorm "
                    f"{m['grad_norm'][0]:.6f}/{m['grad_norm'][1]:.6f}"
                    for m in metrics)
        + f"; parameters within {p_err:.2e} ({close / total:.4%} within "
        f"1e-6); launches {launches}; seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in took.items()))
    out = dict(grad_rel_err=grad_err, param_err=p_err,
               params_within_1e6=close / total, metrics=metrics,
               launches=launches, layers=layers, batch=batch, seq=seq,
               seconds=took)
    del gs, cs, gpu, cpu, gstep, cstep
    gc.collect()
    torch.cuda.empty_cache()
    if not resume:
        DETAILS[f"train_identity_{arch}"] = out
        return out

    # resume, bit for bit, in bf16 with f32 masters
    cfgb = cfg.replace(dtype=torch.bfloat16)
    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(global_batch=batch, seq_len=seq, log_every=0, device=dev)
    t0 = time.perf_counter()
    straight = train_loop(cfgb, tc, steps=4, **kw)
    first = train_loop(cfgb, tc, steps=2, ckpt_dir=ckpt, **kw)
    del first
    resumed = train_loop(cfgb, tc, steps=2, ckpt_dir=ckpt, resume=True,
                         log_fn=log, **kw)
    la = [h["loss"] for h in straight["history"]]
    lb = [h["loss"] for h in resumed["history"]]
    if la[2:] != lb:
        raise AssertionError(f"resume: losses {la} against {lb}")
    sa, sb = straight["state"], resumed["state"]
    for (name, a), b in zip(sa["model"].named_parameters(),
                            sb["model"].parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"resume: {name} differs")
    for part in ("master", "mu", "nu"):
        for name, t in sa["opt"][part].items():
            if not torch.equal(t, sb["opt"][part][name]):
                raise AssertionError(f"resume: {part} {name} differs")
    resume_s = time.perf_counter() - t0
    log(f"  resume: 4 straight steps equal 2 + checkpoint + restore + 2, "
        f"bit for bit (losses {la}; {resume_s:.1f} s with the checkpoints)")
    out["resume_losses"], out["resume_s"] = la, resume_s
    shutil.rmtree(ckpt, ignore_errors=True)
    del straight, resumed, sa, sb
    gc.collect()
    torch.cuda.empty_cache()
    DETAILS["train_identity"] = out
    return out


def train_flops(model, cfg, batch: int, seq: int) -> float:
    """Model operations of one train step (forward and backward, remat's
    recompute not counted): 6 per weight per token over every projection
    (the leaves of two or more axes but the embedding, an untied head, the
    conv taps and an MoE's experts; the router counts) and the head, and
    6 S D per query head and attention layer per token for causal
    attention's two products (S at most the window).  An MoE layer's
    experts count for the slots they run, not the tokens: 6 per weight of
    one expert per capacity slot of every expert (``moe.expert_capacity``
    of the step's one group of ``batch * seq`` tokens), empty slots
    included, as ``moe_ffn`` computes them.  The recurrent scans are not
    counted."""
    from repro_torch.models import moe
    experts = ("moe.w_gate", "moe.w_up", "moe.w_down")
    mats = sum(p.numel() for n, p in model.named_parameters()
               if p.dim() >= 2 and n not in ("embed", "head")
               and "conv" not in n and not n.endswith(experts))
    per_expert = sum(p.numel() for n, p in model.named_parameters()
                     if n.endswith(experts)) // max(1, cfg.num_experts)
    slots = (min(moe.expert_capacity(batch * seq, cfg),
                 batch * seq * cfg.num_experts_per_tok) * cfg.num_experts
             if per_expert else 0)
    span = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    attn = (cfg.layer_kinds().count("attn") * cfg.num_heads * 6 * span
            * cfg.resolved_head_dim)
    return (batch * seq * (6 * (mats + cfg.d_model * cfg.vocab_size) + attn)
            + 6 * slots * per_expert)


def train_phase(dev, steps: int = 6, batch: int = 2, seq: int = 1024,
                layers: int = 0, arch: str = "qwen3-4b",
                key: str = "train") -> dict:
    """Phase 13 (and 17): ``arch`` at its full config, or ``layers`` deep
    (bf16 weights, f32 masters, remat, AdamW, cosine) through
    ``launch.train.train_loop``: ``steps`` steps of ``batch`` x ``seq``
    tokens, the launches of every kernel equal to
    ``expected_train_launches``, finite losses (and for an MoE stack a
    positive aux loss at every step); step wall ms (median
    after the first), tokens/s, one profiled step's device-busy ms and
    idle share, model operations over step time against 989 TFLOP/s, peak
    memory; kept under ``DETAILS[key]``."""
    import gc
    import numpy as np
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.tree import tree_bytes, tree_count
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    from repro_torch.training import steps as S

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 1e9
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    tc = TrainConfig(total_steps=steps, warmup_steps=1)
    ops.reset_kernel_launches()
    out = train_loop(cfg, tc, global_batch=batch, seq_len=seq, steps=steps,
                     log_every=1, device=dev, log_fn=lambda m: log("  " + m))
    launches = ops.kernel_launches()
    expect = expected_train_launches(cfg, cfg.remat, steps)
    log(f"  launches {launches}; expected {expect}")
    if launches != expect:
        raise AssertionError(f"train {arch}: launches {launches}, expected "
                             f"{expect}")
    hist = out["history"]
    if not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"train {arch}: losses "
                             f"{[h['loss'] for h in hist]}")
    if cfg.num_experts and not all(h["aux"] > 0 for h in hist):
        raise AssertionError(f"train {arch}: aux losses "
                             f"{[h['aux'] for h in hist]}")
    walls = sorted(h["ms"] for h in hist[1:])
    step_ms = walls[len(walls) // 2]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    state = out["state"]
    params, o = dict(state["model"].named_parameters()), state["opt"]
    state_gb = {k: tree_bytes(v) / 1e9 for k, v in (
        ("weights", params), ("masters", o["master"]),
        ("moments", {"mu": o["mu"], "nu": o["nu"]}))}
    fn = S.make_train_step(cfg, tc)
    bt = SyntheticDataset(cfg, DataConfig(global_batch=batch, seq_len=seq,
                                          seed=tc.seed)).batch(steps)
    prof = profile_call(f"{arch} train step", lambda: fn(state, bt))
    # the optimizer alone, on gradients of the step's shapes and dtypes
    from repro_torch.training import optimizer as opt
    grads = {k: torch.full_like(p, 1e-3) for k, p in params.items()}
    prof_opt = profile_call("AdamW update", lambda: opt.adamw_update(
        dict(grads), o, params, 0.0, tc, clip=tc.grad_clip))
    del grads
    flops = train_flops(state["model"], cfg, batch, seq)
    stats = dict(arch=arch, layers=cfg.num_layers, batch=batch, seq=seq,
                 losses=[h["loss"] for h in hist],
                 aux=[h["aux"] for h in hist],
                 step_ms=[h["ms"] for h in hist], step_ms_median=step_ms,
                 tokens_per_s=batch * seq / (step_ms / 1e3),
                 model_flops=flops,
                 flops_share=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
                 peak_mem_gb=peak, held_at_start_gb=held, profile=prof,
                 launches=launches, params=tree_count(params),
                 state_gb=state_gb, profile_adamw=prof_opt)
    log(f"  {arch}, {cfg.num_layers} layers, {batch} x {seq} tokens a step: "
        f"step {step_ms:.1f} ms (median after the first; first "
        f"{hist[0]['ms']:.0f}), {stats['tokens_per_s']:.0f} tokens/s, "
        f"{flops / 1e12:.1f} TFLOP a step = "
        f"{100 * stats['flops_share']:.1f}% of 989 TFLOP/s; profiled step "
        f"wall {prof['wall_ms']:.1f} ms, busy {prof['device_ms']:.1f} ms, "
        f"idle {100 * prof['idle_share']:.1f}%; peak {peak:.1f} GB "
        f"(held at start {held:.1f}; state "
        + ", ".join(f"{k} {v:.1f}" for k, v in state_gb.items())
        + f" GB over {stats['params'] / 1e9:.2f} B parameters)")
    DETAILS[key] = stats
    del out, state, fn, params, o
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_train_phase(dev) -> dict:
    """Phase 18: 4 steps of mixtral-8x22b at full width, 1 of its 56 layers
    (2.91 B parameters, ~47 GB of weights, masters and moments; 2 layers
    would hold 86.6 GB), through ``train_phase``.  Returns its launches by
    path."""
    return {"train_mixtral": train_phase(dev, steps=4, layers=1,
                                         arch="mixtral-8x22b",
                                         key="train_mixtral")}


def recurrent_train_phases(dev) -> dict:
    """Phase 17: 4 steps of mamba2-780m at its full config (48 layers)
    and of recurrentgemma-9b at 9 layers (three (rglru, rglru, attn)
    periods, which peak at 56.8 GB).  Returns the launches of each run by
    path."""
    return {key: train_phase(dev, steps=4, layers=layers, arch=arch, key=key)
            for arch, layers, key in (
                ("mamba2-780m", 0, "train_mamba2"),
                ("recurrentgemma-9b", 9, "train_recurrentgemma"))}


def recurrent_train_identity(dev) -> None:
    """Phase 3r: ``train_identity`` for the recurrent stacks (f32, TF32 off,
    full width), gradients card against CPU, then steps: mamba2-780m at 2
    layers, 3 steps over 2 x 256 tokens (two SSD chunks of 128);
    recurrentgemma-9b at 3 layers, one (rglru, rglru, attn) period so that
    the D 256 MQA flash backward runs inside the model, 1 step over 1 x 136
    tokens (past the RG-LRU's one-tile 128 steps); each arch's seconds
    logged.  A recurrentgemma-9b step costs ~16 s on the CPU side (the
    256000-way head and AdamW over 1.2 B f32 parameters), so its steps are
    the ones cut to keep the script within its time."""
    for arch, layers, batch, seq, steps in (
            ("mamba2-780m", 2, 2, 256, 3),
            ("recurrentgemma-9b", 3, 1, 136, 1)):
        t0 = time.perf_counter()
        train_identity(dev, layers=layers, batch=batch, seq=seq, steps=steps,
                       arch=arch, resume=False)
        took = time.perf_counter() - t0
        DETAILS[f"train_identity_{arch}"]["total_s"] = took
        log(f"  {arch}: {took:.1f} s")


# ------------------------------------------------ the distributed trainer
# One card holds one rank: the trainer's process group is a world of one
# NCCL rank, joined in-process over a FileStore under build/ and destroyed
# when its phase ends (NCCL refuses two ranks on one card; worlds of 2-8
# gloo ranks run in tests/test_torch_distributed.py).  Its gathers and
# reductions are real NCCL collectives over groups of one.
@contextmanager
def one_rank_world(dev):
    """A world of one NCCL rank on ``dev`` for the ``with`` body."""
    import torch.distributed as dist
    from repro_torch.launch import multihost

    path = os.path.join(ROOT, "build", "nccl_store")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    env = multihost.ClusterEnv("", 1, 0, local_rank=dev.index or 0)
    multihost.initialize(env, device=dev, store=dist.FileStore(path, 1),
                         timeout_s=300.0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        yield
    finally:
        dist.destroy_process_group()
        if os.path.exists(path):
            os.remove(path)


def expected_pipeline_launches(cfg, micro: int) -> dict:
    """A GPipe forward of a dense attention stack in ``micro``
    microbatches: every layer once a microbatch, the final norm once."""
    one = expected_train_launches(cfg, False, 1)
    return dict(one, flash_attention=one["flash_attention"] * micro,
                rmsnorm=(one["rmsnorm"] - 1) * micro + 1,
                flash_attention_bwd=0, rmsnorm_bwd=0, ssd_bwd=0, rglru_bwd=0)


def train_dist_identity(dev, layers: int = 4, batch: int = 2, seq: int = 256,
                        steps: int = 3) -> dict:
    """Phase 3p: the distributed trainer on a world of one NCCL rank,
    qwen3-4b at full width, ``layers`` deep (one a pipeline stage), f32
    with TF32 off: ``steps`` sharded steps on a (1, 1) ``DeviceMesh``
    against ``make_train_step`` on the card (loss, ce, grad norm, lr and
    every parameter within 1e-6 relative; bit-equality reported), launches
    as ``expected_train_launches``; the int8 all-reduce over the world
    equal to ``dequantize(quantize(x))``; ``pipeline_forward`` over 4
    stages on the card against ``forward`` within 1e-5 of max(1,
    max|ref|); then, in bf16 with f32 masters at 1 layer, 4 straight
    ``train_loop`` steps on the mesh against 2, a checkpoint, a restore
    through ``reshard_leaf`` and 2 more, bit for bit."""
    import gc
    import shutil
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as M
    from repro_torch.sharding import placement
    from repro_torch.sharding.mesh import make_mesh as make_stage_mesh
    from repro_torch.sharding.placement import local
    from repro_torch.training import optimizer as opt
    from repro_torch.training import steps as S
    from repro_torch.training.compression import make_compressed_allreduce
    from repro_torch.training.pipeline import pipeline_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3-4b").replace(num_layers=layers,
                                         dtype=torch.float32)
    tc = TrainConfig(learning_rate=1e-4, total_steps=10, warmup_steps=2)
    ds = SyntheticDataset(cfg, DataConfig(global_batch=batch, seq_len=seq,
                                          seed=SEED))
    out = {}
    with one_rank_world(dev):
        mesh = make_mesh(1, 1, device=dev)
        plain = S.init_train_state(cfg, SEED, dev, tc)
        sharded, _ = placement.place_by_specs(
            S.init_train_state(cfg, SEED, dev, tc), mesh)
        pstep = S.make_train_step(cfg, tc)
        sstep = S.make_train_step(cfg, tc, num_groups=1, mesh=mesh)
        pm = []
        for i in range(steps):
            plain, m = pstep(plain, ds.batch(i))
            pm.append({k: float(v) for k, v in m.items()})
        ops.reset_kernel_launches()
        sm = []
        for i in range(steps):
            sharded, m = sstep(sharded, ds.batch(i))
            sm.append({k: float(v) for k, v in m.items()})
        launches = ops.kernel_launches()
        expect = expected_train_launches(cfg, cfg.remat, steps)
        if launches != expect:
            raise AssertionError(f"sharded train: launches {launches}, "
                                 f"expected {expect}")
        metric_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                         for a, b in zip(sm, pm) for k in
                         ("loss", "ce", "grad_norm", "lr"))
        if metric_err > 1e-6:
            raise AssertionError(f"sharded train: metrics {sm} against {pm}")
        p_err, p_equal = 0.0, True
        for (name, a), b in zip(sharded["model"].named_parameters(),
                                plain["model"].parameters()):
            a, b = local(a), b.detach()
            rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            p_err, p_equal = max(p_err, rel), p_equal and torch.equal(a, b)
            if rel > 1e-6:
                raise AssertionError(f"sharded train: {name} off by {rel:.2e} "
                                     "of its max")
        metrics_equal = all(a[k] == b[k] for a, b in zip(sm, pm) for k in b)
        log(f"  {steps} sharded steps on (1, 1) against make_train_step: "
            f"metrics within {metric_err:.2e} relative (bit-equal: "
            f"{metrics_equal}), parameters within {p_err:.2e} (bit-equal: "
            f"{p_equal}); losses {[m['loss'] for m in sm]}; launches as "
            "expected")
        out.update(metric_rel_err=metric_err, metrics_bit_equal=metrics_equal,
                   param_rel_err=p_err, params_bit_equal=p_equal,
                   losses=[m["loss"] for m in sm], launches=launches)
        del sharded, sstep
        gc.collect()

        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        x = torch.randn(1 << 20, generator=gen, device=dev) * 0.02
        got = make_compressed_allreduce(mesh, "data")({"g": x})["g"]
        if not torch.equal(got, opt.dequantize_int8(*opt.quantize_int8(x))):
            raise AssertionError("int8 all-reduce over one rank: not "
                                 "dequantize(quantize(x))")
        log("  int8 all-reduce over the world of one equals "
            "dequantize(quantize(x)) (2^20 elements)")

        model = plain["model"]
        tokens = torch.randint(0, cfg.vocab_size, (8, seq), generator=gen,
                               device=dev)
        stage_mesh = make_stage_mesh((4,), ("stage",), [dev] * 4)
        ops.reset_kernel_launches()
        got = pipeline_forward(stage_mesh, "stage", model, tokens, cfg, 4)
        pipe = ops.kernel_launches()
        if pipe != expected_pipeline_launches(cfg, 4):
            raise AssertionError(f"pipeline: launches {pipe}")
        with torch.no_grad():
            want, _ = M.forward(model, tokens, cfg)
        err = ((got - want).abs().max() / want.abs().max().clamp_min(1.0)
               ).item()
        if err > 1e-5:
            raise AssertionError(f"pipeline: logits off by {err:.2e}")
        log(f"  pipeline_forward over 4 stages on the card (4 microbatches "
            f"of 2 x {seq}) within {err:.2e} of max(1, max|forward|); "
            f"launches {pipe}")
        out.update(pipeline_rel_err=err, pipeline_launches=pipe)
        del plain, pstep, model, got, want
        gc.collect()
        torch.cuda.empty_cache()

        # resume through reshard_leaf, bit for bit, bf16 with f32 masters
        cfgb = cfg.replace(dtype=torch.bfloat16, num_layers=1)
        host = make_host_mesh(dev)
        ckpt = os.path.join(ROOT, "build", "train_dist_ckpt")
        shutil.rmtree(ckpt, ignore_errors=True)
        kw = dict(global_batch=batch, seq_len=seq, log_every=0, mesh=host)
        straight = train_loop(cfgb, tc, steps=4, **kw)
        train_loop(cfgb, tc, steps=2, ckpt_dir=ckpt, **kw)
        resumed = train_loop(cfgb, tc, steps=2, ckpt_dir=ckpt, resume=True,
                             log_fn=log, **kw)
        la = [h["loss"] for h in straight["history"]]
        lb = [h["loss"] for h in resumed["history"]]
        if la[2:] != lb:
            raise AssertionError(f"sharded resume: losses {la} against {lb}")
        sa, sb = straight["state"], resumed["state"]
        for (name, a), b in zip(sa["model"].named_parameters(),
                                sb["model"].parameters()):
            if not torch.equal(local(a), local(b)):
                raise AssertionError(f"sharded resume: {name} differs")
        for part in ("master", "mu", "nu"):
            for name, t in sa["opt"][part].items():
                if not torch.equal(local(t), local(sb["opt"][part][name])):
                    raise AssertionError(f"sharded resume: {part} {name}")
        log(f"  sharded resume: 4 straight steps equal 2 + checkpoint + "
            f"restore + reshard_leaf + 2, bit for bit (losses {la})")
        out["resume_losses"] = la
        shutil.rmtree(ckpt, ignore_errors=True)
        del straight, resumed, sa, sb
    gc.collect()
    torch.cuda.empty_cache()
    DETAILS["train_dist_identity"] = out
    return out


def train_sharded_phase(dev, steps: int = 6, batch: int = 2,
                        seq: int = 1024) -> dict:
    """Phase 15: the sharded trainer at qwen3-4b's full config (bf16
    weights, f32 masters, remat, AdamW, cosine) through
    ``launch.train.train_loop(mesh=make_host_mesh())`` on a world of one
    NCCL rank: ``steps`` steps of ``batch`` x ``seq`` tokens, finite
    losses within 1e-3 relative of phase 13's, launches as
    ``expected_train_launches``, peak memory within phase 13's plus 2 GB;
    step wall ms, tokens/s, one profiled step's device-busy ms and idle
    share, the device ms of gathering every parameter once and of reducing
    every gradient once, peak memory.  Then ``pipeline_forward`` of the 36
    layers in bf16 over 4 stages on the card, 4 microbatches of ``batch`` x
    ``seq``, against one ``forward`` of all of them: ms of each, the
    largest logit difference against max(1, max|ref|) and the argmax
    agreement (tolerances: PERF.md); whether each microbatch's logits are
    bit-equal to a ``forward`` of its rows alone is logged.  Returns the
    launches of both paths."""
    import gc
    import numpy as np
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as M
    from repro_torch.sharding import placement
    from repro_torch.sharding.mesh import make_mesh as make_stage_mesh
    from repro_torch.training import steps as S
    from repro_torch.training.pipeline import pipeline_forward

    gc.collect()
    torch.cuda.synchronize(dev)           # the context, when run first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config("qwen3-4b")
    tc = TrainConfig(total_steps=steps, warmup_steps=1)
    base = DETAILS.get("train")           # phase 13, when it ran
    stats = {}
    with one_rank_world(dev):
        mesh = make_host_mesh(dev)
        ops.reset_kernel_launches()
        res = train_loop(cfg, tc, global_batch=batch, seq_len=seq,
                         steps=steps, log_every=1, mesh=mesh,
                         log_fn=lambda m: log("  " + m))
        launches = ops.kernel_launches()
        expect = expected_train_launches(cfg, cfg.remat, steps)
        if launches != expect:
            raise AssertionError(f"sharded train: launches {launches}, "
                                 f"expected {expect}")
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"sharded train: losses {losses}")
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        if base is not None:
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(losses, base["losses"]))
            if rel > 1e-3:
                raise AssertionError(f"sharded train: losses {losses} "
                                     f"against phase 13's {base['losses']}")
            stats.update(loss_rel_to_phase13=rel,
                         losses_equal_phase13=losses == base["losses"])
            if peak > base["peak_mem_gb"] + 2.0:
                raise AssertionError(f"sharded train: peak {peak:.1f} GB "
                                     f"against phase 13's "
                                     f"{base['peak_mem_gb']:.1f}")
        walls = sorted(h["ms"] for h in hist[1:])
        step_ms = walls[len(walls) // 2]
        state = res["state"]
        fn = S.make_train_step(cfg, tc, num_groups=1, mesh=mesh)
        bt = SyntheticDataset(cfg, DataConfig(global_batch=batch, seq_len=seq,
                                              seed=tc.seed)).batch(steps)
        prof = profile_call("sharded train step", lambda: fn(state, bt))
        prof["host"] = host_ops("sharded train step", lambda: fn(state, bt))
        params = dict(state["model"].named_parameters())
        shards = {n: placement.local(p) for n, p in params.items()}
        pls = {n: p.placements for n, p in params.items()}
        def gather_all():                  # one leaf held at a time
            for n in shards:
                placement.gather_full(shards[n], mesh, pls[n])

        grads = {n: torch.full_like(t, 1e-3) for n, t in shards.items()}

        def reduce_all():
            for n in grads:
                placement.to_placement(grads[n], mesh, pls[n])

        prof_gather = profile_call("gather every parameter once", gather_all)
        prof_gather["host"] = host_ops("gather every parameter once",
                                       gather_all)
        prof_reduce = profile_call("reduce every gradient once", reduce_all)
        del grads, res, state, fn, params, shards
    gc.collect()
    torch.cuda.empty_cache()
    stats.update(layers=cfg.num_layers, batch=batch, seq=seq, losses=losses,
                 step_ms=[h["ms"] for h in hist], step_ms_median=step_ms,
                 tokens_per_s=batch * seq / (step_ms / 1e3),
                 peak_mem_gb=peak, profile=prof, launches=launches,
                 gather_all_params=prof_gather,
                 reduce_all_grads=prof_reduce)
    log(f"  {cfg.num_layers} layers, {batch} x {seq} tokens a step on a "
        f"(1, 1) mesh: step {step_ms:.1f} ms (median after the first), "
        f"{stats['tokens_per_s']:.0f} tokens/s; profiled step wall "
        f"{prof['wall_ms']:.1f} ms, busy {prof['device_ms']:.1f} ms, idle "
        f"{100 * prof['idle_share']:.1f}%"
        + (f" (phase 13: {base['step_ms_median']:.1f} ms, busy "
           f"{base['profile']['device_ms']:.1f}, idle "
           f"{100 * base['profile']['idle_share']:.1f}%, peak "
           f"{base['peak_mem_gb']:.1f} GB; losses within "
           f"{stats['loss_rel_to_phase13']:.2e}, equal: "
           f"{stats['losses_equal_phase13']})" if base else "")
        + f"; every parameter gathered once {prof_gather['device_ms']:.2f} "
        f"ms, every gradient reduced once {prof_reduce['device_ms']:.2f} ms "
        f"of device time; peak {peak:.1f} GB")

    # GPipe: 4 stages on the card against one forward of the whole batch
    model = M.init_model(cfg, SEED, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    micro = 4
    tokens = torch.randint(0, cfg.vocab_size, (micro * batch, seq),
                           generator=gen, device=dev)
    stage_mesh = make_stage_mesh((4,), ("stage",), [dev] * 4)
    ops.reset_kernel_launches()
    got = pipeline_forward(stage_mesh, "stage", model, tokens, cfg, micro)
    pipe = ops.kernel_launches()
    if pipe != expected_pipeline_launches(cfg, micro):
        raise AssertionError(f"pipeline: launches {pipe}")

    def forward(t):
        with torch.no_grad():
            return M.forward(model, t, cfg)[0]

    max_diff, ref_max, agree, bit_equal = 0.0, 0.0, 0, True
    want = forward(tokens)
    for i in range(micro):
        rows = slice(i * batch, (i + 1) * batch)
        a, b = got[rows].float(), want[rows].float()
        max_diff = max(max_diff, (a - b).abs().max().item())
        ref_max = max(ref_max, b.abs().max().item())
        agree += (a.argmax(-1) == b.argmax(-1)).sum().item()
        bit_equal = bit_equal and torch.equal(got[rows],
                                              forward(tokens[rows]))
        del a, b
    del want, got
    agree /= micro * batch * seq
    rel = max_diff / max(1.0, ref_max)
    limit = PIPE_BF16_SPACINGS * bf16_spacing(ref_max)
    if not bit_equal or max_diff > limit:
        raise AssertionError(
            f"pipeline bf16: each microbatch bit-equal to a forward of its "
            f"rows: {bit_equal}; whole batch off by {max_diff:.4f} (limit "
            f"{limit:.4f}, {PIPE_BF16_SPACINGS} bf16 spacings of max|ref| "
            f"{ref_max:.2f}), argmax agreement {agree:.4f}")
    pipe_ms = host_ms(lambda: pipeline_forward(stage_mesh, "stage", model,
                                               tokens, cfg, micro), iters=5)
    fwd_ms = host_ms(lambda: forward(tokens), iters=5)
    log(f"  pipeline_forward of {cfg.num_layers} layers over 4 stages on the "
        f"card, {micro} microbatches of {batch} x {seq}: {pipe_ms:.1f} ms "
        f"against one forward of {micro * batch} x {seq} {fwd_ms:.1f} ms; "
        f"each microbatch bit-equal to a forward of its own rows (the "
        f"head's GEMM over {batch * seq} rows, not {micro * batch * seq}): "
        f"{bit_equal}; largest logit difference against the whole batch "
        f"{max_diff:.4f} (limit {limit:.4f}) = {rel:.3e} of max(1, max|ref| "
        f"{ref_max:.2f}), argmax agreement {agree:.4%}; launches {pipe}")
    stats.update(pipeline_ms=pipe_ms, forward_ms=fwd_ms,
                 pipeline_bit_equal_per_microbatch=bit_equal,
                 pipeline_max_logit_diff=max_diff, pipeline_rel_err=rel,
                 pipeline_max_logit_diff_limit=limit,
                 pipeline_argmax_agree=agree, pipeline_launches=pipe)
    DETAILS["train_sharded"] = stats
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return {"train_sharded": launches, "pipeline": pipe}


# bf16 GPipe: each microbatch must equal a forward of its own rows bit for
# bit.  Against one forward of the whole batch the GEMMs see 8192 rows
# instead of 2048 and may take other cuBLAS kernels, whose rounding
# differs: the logits may differ by this many bf16 spacings of max|ref|
# (the card read 0 and 100% argmax agreement in every run so far)
PIPE_BF16_SPACINGS = 4


def bf16_spacing(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


# ---------------------------------------------------------------- phase 4
# ------------------------------------------------ the serving mesh (PR 22)
# The one-card mesh: four sequence shards on cuda:0, so the partials and
# combine launches run for real (shards on distinct cards take the same
# code with cross-device copies; no run here has tested that).
MESH_SHAPE = (1, 4)
MESH_SHAPES = {
    # qwen3-4b's decode: 8 lanes ragged up to 8192 slots (2048 a shard; the
    # longest lanes' slots span three and four shards)
    "qwen3-4b": dict(hq=32, hkv=8, d=128, n=8192, window=0,
                     lens=(1, 300, 2047, 2048, 4097, 6000, 7999, 8191)),
    # recurrentgemma-9b's local layer: window 2048 over a 4096 ring that
    # wraps, so window edges fall inside every shard
    "recurrentgemma-9b local": dict(hq=16, hkv=1, d=256, n=4096, window=2048,
                                    lens=(5, 1000, 2049, 4095, 4096, 5000,
                                          7000, 9000)),
}


def card_mesh(dev):
    from repro_torch.sharding.mesh import make_mesh
    return make_mesh(MESH_SHAPE, ("data", "model"),
                     [dev] * (MESH_SHAPE[0] * MESH_SHAPE[1]))


def mesh_tol(dtype, ref) -> float:
    """f32 2e-5, bf16 2^-7, of max(1, max|ref|)."""
    import torch
    base = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    return base * max(1.0, float(ref.float().abs().max()))


def check_mesh_kernels(dev, timing: bool = True) -> dict:
    """Phase 2m: ``spmd_decode_attention`` and
    ``spmd_paged_decode_attention`` on a (1, 4) mesh of one card against
    the plain decode over ``gather_cache`` (f32 2e-5, bf16 2^-7 of max(1,
    max|ref|)), the written K/V and pos equal to the unsharded write; the
    partials and combine launches against their plain versions, and one
    shard's partials, combined, bit for bit the ordinary launch at the
    same splits; then (``timing``) the sharded call's device time beside
    the unsharded kernel's and its bound."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import paged_decode_attention as pk
    from repro_torch.kernels import ref
    from repro_torch.serving import spmd_decode as spmd

    rng = np.random.default_rng(SEED + 22)
    mesh = card_mesh(dev)
    n_seq = MESH_SHAPE[1]
    out = {"errs": {}, "bit_equal": [], "rows": {}}

    def rnd(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, dtype)

    def hold(name, got, exp, dtype):
        err = float((got.float() - exp.float()).abs().max())
        tol = mesh_tol(dtype, exp)
        out["errs"][f"{name} {str(dtype)[6:]}"] = err
        if not err <= tol:
            raise AssertionError(f"mesh {name}: max|diff| {err} > {tol}")
        return err

    def same(name, a, b):
        if not torch.equal(a, b):
            raise AssertionError(f"mesh {name}: not bit-equal")
        out["bit_equal"].append(name)

    def ring_case(label, sh, dtype):
        b, hq, hkv, d, n, window = (8, sh["hq"], sh["hkv"], sh["d"], sh["n"],
                                    sh["window"])
        lens = np.asarray(sh["lens"])
        q = rnd((b, 1, hq, d), dtype)
        kc, vc = rnd((b, n, hkv, d), dtype), rnd((b, n, hkv, d), dtype)
        nk, nv = rnd((b, 1, hkv, d), dtype), rnd((b, 1, hkv, d), dtype)
        pos = torch.from_numpy(ring_positions(rng, b, n, lens)).to(dev)
        idx = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        scale = d ** -0.5
        # the unsharded write
        lanes, slots = torch.arange(b, device=dev), (idx % n).long()
        kw_, vw_, pw_ = kc.clone(), vc.clone(), pos.clone()
        kw_[lanes, slots], vw_[lanes, slots] = nk[:, 0], nv[:, 0]
        pw_[lanes, slots] = idx
        got, ks, vs, ps = spmd.spmd_decode_attention(
            mesh, q, kc, vc, nk, nv, pos, idx, window=window, scale=scale)
        for name_, a, b_ in (("k", ks, kw_), ("v", vs, vw_), ("pos", ps, pw_)):
            same(f"{label} written {name_}", a.gather(), b_)
        kw = dict(cache_len=idx + 1, window=window, scale=scale)
        exp = dk.decode_attention_plain(q, ks.gather(), vs.gather(),
                                        pos=ps.gather(), **kw)
        err = hold(f"{label} spmd", got, exp, dtype)
        unsh = dk.decode_attention(q, kw_, vw_, pos=pw_, **kw)
        # one shard (rank 1): partials and combine against their plain
        # versions, and bit for bit the ordinary launch
        k1, v1, p1 = ks.parts[0][1], vs.parts[0][1], ps.parts[0][1]
        auto = dk.auto_splits(b, hkv, n // n_seq, dev)
        for splits in sorted({1, auto}):
            ml, part = dk.decode_attention_partials(q, k1, v1, pos=p1,
                                                    splits=splits, **kw)
            pml, ppart = dk.decode_attention_partials_plain(
                q, k1, v1, pos=p1, splits=splits, **kw)
            m, pm = ml[..., 0], pml[..., 0]
            if not torch.allclose(m, pm, atol=1e-4, rtol=1e-5) or \
                    not torch.allclose(ml[..., 1], pml[..., 1], rtol=1e-3,
                                       atol=1e-6):
                raise AssertionError(f"mesh {label}: partial (m, l) differ "
                                     f"by {float((m - pm).abs().max())}")
            comb = dk.attention_combine(ml, part, dtype)
            hold(f"{label} partials s{splits}", comb,
                 dk.attention_combine_plain(pml, ppart, dtype), dtype)
            hold(f"{label} combine s{splits}", comb,
                 dk.attention_combine_plain(ml, part, dtype), dtype)
            same(f"{label} combined s{splits} == ordinary launch",
                 comb.reshape(q.shape),
                 dk.decode_attention(q, k1, v1, pos=p1, splits=splits, **kw))
        log(f"  {label} {str(dtype)[6:]}: spmd max|diff| {err:.3e} (tol "
            f"{mesh_tol(dtype, exp):.1e}), vs the unsharded kernel "
            f"{float((got.float() - unsh.float()).abs().max()):.3e}; writes "
            f"exact; partials/combine held at splits {sorted({1, auto})}, "
            f"bit-equal to the ordinary launch")
        return q, ks, vs, ps, nk, nv, idx, kw, (kw_, vw_, pw_)

    def paged_case(dtype):
        sh = MESH_SHAPES["qwen3-4b"]
        b, hq, hkv, d, n = 8, sh["hq"], sh["hkv"], sh["d"], sh["n"]
        page, maxp = 16, n // 16
        lens = np.asarray(sh["lens"])
        tables, ppos = paged_layout(rng, lens[:-1].tolist() + [0], page, maxp,
                                    share=4, holes=0.02, stale=0.02,
                                    empty=(b - 1,))
        lens[-1] = 0                # lane 7: no page, nothing visible
        # 4 * maxp rows: the layout's b * maxp pages, 3 spare rows and the
        # dump row last, so the pool splits into 4 shards
        rows_all = b * maxp + 4
        pp = np.full((rows_all, page), -1, np.int32)
        pp[:b * maxp] = ppos[:-1]
        tab = torch.from_numpy(tables).to(dev)
        ppt = torch.from_numpy(pp).to(dev)
        kp, vp = (rnd((rows_all, page, hkv, d), dtype) for _ in range(2))
        q = rnd((b, 1, hq, d), dtype)
        nk, nv = rnd((b, 1, hkv, d), dtype), rnd((b, 1, hkv, d), dtype)
        idx = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        entry = tab[torch.arange(b, device=dev),
                    (idx // page).clamp_max(maxp - 1).long()]
        rows = torch.where(entry >= 0, entry, rows_all - 1).long()
        within = (idx % page).long()
        kw_, vw_, pw_ = kp.clone(), vp.clone(), ppt.clone()
        kw_[rows, within], vw_[rows, within] = nk[:, 0], nv[:, 0]
        pw_[rows, within] = idx
        scale = d ** -0.5
        got, ks, vs, ps = spmd.spmd_paged_decode_attention(
            mesh, q, kp, vp, ppt, tab, nk, nv, rows, within, idx,
            scale=scale)
        # the dump row takes several lanes' writes in no fixed order
        for name_, a, b_ in (("k", ks, kw_), ("v", vs, vw_), ("pos", ps, pw_)):
            same(f"paged written {name_}", a.gather()[:-1], b_[:-1])
        kw = dict(cache_len=idx + 1, window=0, scale=scale)
        exp = ref.combine_partials(*pk.paged_decode_attention_partials_plain(
            q, ks.gather(), vs.gather(), ps.gather(), tab, **kw), dtype
            ).reshape(q.shape)
        err = hold("paged spmd", got, exp, dtype)
        if got[b - 1].abs().max() != 0:
            raise AssertionError("mesh paged: the empty lane is not zeros")
        # shard 2's partials against the plain version, and bit for bit the
        # ordinary launch on the lanes that see something there
        p_loc = rows_all // n_seq
        e_off = tab - 2 * p_loc
        tbl = torch.where((tab >= 0) & (e_off >= 0) & (e_off < p_loc), e_off,
                          -1).to(torch.int32).contiguous()
        k2, v2, p2 = ks.parts[0][2], vs.parts[0][2], ps.parts[0][2]
        auto = pk.auto_splits(b, hkv, maxp, page, dev)
        for splits in sorted({1, auto}):
            ml, part = pk.paged_decode_attention_partials(
                q, k2, v2, p2, tbl, splits=splits, **kw)
            pml, ppart = pk.paged_decode_attention_partials_plain(
                q, k2, v2, p2, tbl, splits=splits, **kw)
            comb = dk.attention_combine(ml, part, dtype)
            hold(f"paged partials s{splits}", comb,
                 dk.attention_combine_plain(pml, ppart, dtype), dtype)
            seen = (pml[..., 0].amax(1) > -1e29).reshape(b, hq).all(1)
            ordinary = pk.paged_decode_attention(q, k2, v2, p2, tbl,
                                                 splits=splits, **kw)
            same(f"paged combined s{splits} == ordinary launch",
                 comb.reshape(q.shape)[seen], ordinary[seen])
        log(f"  paged {str(dtype)[6:]}: spmd max|diff| {err:.3e}; writes "
            f"exact; the empty lane zeros; partials held at splits "
            f"{sorted({1, auto})}, bit-equal to the ordinary launch on the "
            f"{int(seen.sum())} lanes shard 2 sees")
        return q, ks, vs, ps, tab, nk, nv, rows, within, idx, kw, \
            (kw_, vw_, pw_)

    kept = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, sh in MESH_SHAPES.items():
            kept[(label, dtype)] = ring_case(label, sh, dtype)
        kept[("paged", dtype)] = paged_case(dtype)
    DETAILS["mesh_kernels"] = dict(errs=out["errs"],
                                   bit_equal=out["bit_equal"])
    if not timing:
        return out

    # timing, bf16, qwen3-4b's shapes: the sharded call (the writes, four
    # partials launches and the combine) and its attention alone (the
    # partials and the combine), beside the unsharded kernel and its bound
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bf = torch.bfloat16
    q, ks, vs, ps, nk, nv, idx, kw, (kw_, vw_, pw_) = kept[("qwen3-4b", bf)]
    sh = MESH_SHAPES["qwen3-4b"]
    hkv, d = sh["hkv"], sh["d"]

    def ring_attn():
        parts = [[dk.decode_attention_partials(q, ks.parts[0][r],
                                               vs.parts[0][r],
                                               pos=ps.parts[0][r], **kw)
                  for r in range(n_seq)]]
        return spmd._combine(parts, q)

    def ring_call():
        return spmd.spmd_decode_attention(
            mesh, q, ks, vs, nk, nv, ps, idx, window=0,
            scale=kw["scale"])[0]

    vis = (pw_ >= 0) & (pw_ < (idx + 1)[:, None])
    nbytes = (int(vis.sum()) * hkv * d * 2 * 2
              + int(np.minimum(np.asarray(sh["lens"]) + 1, sh["n"]).sum()) * 4
              + 2 * q.numel() * 2 + q.shape[0] * 4)
    bms, by = bound(nbytes, 4 * sh["hq"] * d * int(vis.sum()),
                    PEAK_BF16_FLOPS)
    out["rows"]["decode_attention"] = dict(
        shape=(f"B=8 n=8192 Hq=32 Hkv=8 D=128 bf16 ragged to 8192, mesh "
               f"{MESH_SHAPE} on one card, "
               f"{dk.auto_splits(8, hkv, sh['n'] // n_seq, dev)} splits a "
               "shard"),
        mesh_ms=device_ms(ring_call, flush),
        mesh_host_ms=host_ms(ring_call, flush=flush),
        mesh_attn_ms=device_ms(ring_attn, flush),
        unsharded_ms=device_ms(lambda: dk.decode_attention(
            q, kw_, vw_, pos=pw_, **kw), flush),
        bound_ms=bms, bound_by=by)

    q, ks, vs, ps, tab, nk, nv, rows, within, idx, kw, (kw_, vw_, pw_) = \
        kept[("paged", bf)]

    def paged_call():
        return spmd.spmd_paged_decode_attention(
            mesh, q, ks, vs, ps, tab, nk, nv, rows, within, idx,
            scale=kw["scale"])[0]

    p_loc = ks.chunk
    local = [torch.where((tab >= r * p_loc) & (tab < (r + 1) * p_loc),
                         tab - r * p_loc, -1).to(torch.int32).contiguous()
             for r in range(n_seq)]

    def paged_attn():
        parts = [[pk.paged_decode_attention_partials(
            q, ks.parts[0][r], vs.parts[0][r], ps.parts[0][r], local[r], **kw)
            for r in range(n_seq)]]
        return spmd._combine(parts, q)

    page = 16
    pvis = paged_visible(pw_, tab, idx + 1, page)
    live = int(((tab >= 0) & (torch.arange(tab.shape[1], device=dev)[None]
                              * page < (idx + 1)[:, None])).sum())
    nbytes = (live * page * (hkv * d * 2 * 2 + 4) + 2 * q.numel() * 2
              + tab.numel() * 4 + q.shape[0] * 4)
    bms, by = bound(nbytes, 4 * sh["hq"] * d * int(pvis.sum()),
                    PEAK_BF16_FLOPS)
    out["rows"]["paged_decode_attention"] = dict(
        shape=("B=8 pages of 16, 512 per lane, Hq=32 Hkv=8 D=128 bf16, "
               f"pool of 4100 rows over mesh {MESH_SHAPE} on one card"),
        mesh_ms=device_ms(paged_call, flush),
        mesh_host_ms=host_ms(paged_call, flush=flush),
        mesh_attn_ms=device_ms(paged_attn, flush),
        unsharded_ms=device_ms(lambda: pk.paged_decode_attention(
            q, kw_, vw_, pw_, tab, **kw), flush),
        bound_ms=bms, bound_by=by)
    for name, r in out["rows"].items():
        log(f"  {name} mesh: sharded call {r['mesh_ms']:.4f} ms (host "
            f"{r['mesh_host_ms']:.3f}), its attention {r['mesh_attn_ms']:.4f}"
            f"; unsharded kernel {r['unsharded_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    DETAILS["mesh_kernels"]["rows"] = out["rows"]
    return out


def mesh_identity(dev) -> dict:
    """Phase 3m: qwen3-4b at full width, 4 layers, f32, TF32 off.  A
    replica on a (1, 4) mesh of the card, ring, then paged with the prefix
    cache: greedy streams (a lane joining mid-stream, a 700-token prompt
    whose ring spans three of the four 256-slot shards) equal to the
    unsharded replica's on the card and to the plain path on the CPU; the
    plain path's decode steps under the mesh on the card give the CPU's
    tokens and last logits within identity_phase's 1e-3; launches as
    ``expected_launches`` states for the mesh.  Returns the paged
    replica's launches (the ``mesh_paged`` path)."""
    import threading
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Replica, Request
    from repro_torch.sharding import context as shctx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen3-4b").replace(num_layers=4, dtype=torch.float32)
    model = M.init_model(cfg, SEED, dev)
    cpu_model = cpu_copy(model, cfg)
    mesh = card_mesh(dev)
    n_seq = MESH_SHAPE[1]
    cap, new = 1024, 16
    rng = np.random.default_rng(SEED + 23)
    prompts = [rng.integers(2, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (40, 200, 700)]

    def staggered(rep, reqs):
        """Streams of ``reqs``, the last joining once the others decode."""
        res = [None] * len(reqs)

        def go(i):
            res[i] = rep.generate(reqs[i]).tolist()
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(reqs))]
        for t in threads[:-1]:
            t.start()
        wait_until(lambda: rep.decode_steps > 0, "a decode step")
        threads[-1].start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"{rep.name}: a request did not finish")
        return res

    def counted(rep, drive, paged):
        before = (rep.decode_steps, rep.prefill_chunks, rep.whole_prefills)
        ops.reset_kernel_launches()
        res = drive()
        launches = ops.kernel_launches()
        steps, chunks, wholes = (getattr(rep, k) - b for k, b in zip(
            ("decode_steps", "prefill_chunks", "whole_prefills"), before))
        expect = expected_launches(cfg, steps, chunks, wholes, paged=paged,
                                   n_seq=n_seq)
        if launches != expect or not steps:
            raise AssertionError(f"mesh identity (paged {paged}): launches "
                                 f"{launches}, expected {expect}")
        return res, launches

    plain = Replica("plain0", cfg, model, slots=4, capacity=cap,
                    prefill_chunk_tokens=32)
    want = [plain.generate(Request(i, p, new, 1e9)).tolist()
            for i, p in enumerate(prompts)]
    ring = Replica("mesh0", cfg, model, slots=4, capacity=cap,
                   prefill_chunk_tokens=32, serving_mesh=mesh)
    got, ring_launches = counted(ring, lambda: staggered(
        ring, [Request(10 + i, p, new, 1e9) for i, p in enumerate(prompts)]),
        False)
    seq = ring.generate_sequential(Request(20, prompts[2], new, 1e9)).tolist()
    ring.stop()
    worst = 0.0
    for p, g, w in zip(prompts, got, want):
        cpu_toks, cpu_last = cpu_plain_stream(cpu_model, cfg, p, new, 32, cap)
        with shctx.serving_mesh(mesh):
            card_toks, card_last = cpu_plain_stream(model, cfg, p, new, 32,
                                                    cap)
        err = float((card_last - cpu_last).abs().max())
        worst = max(worst, err)
        log(f"  ring prompt {len(p):4d}: mesh == unsharded {g == w}, mesh == "
            f"cpu plain {g == cpu_toks}, card mesh plain == cpu "
            f"{card_toks == cpu_toks}, last logits max|diff| {err:.3e}")
        if not (g == w == cpu_toks == card_toks) or not err <= 1e-3:
            raise AssertionError(f"mesh identity prompt {len(p)}: mesh {g} "
                                 f"unsharded {w} cpu {cpu_toks} card "
                                 f"{card_toks} logits {err}")
    if seq != want[2]:
        raise AssertionError(f"mesh generate_sequential {seq} != {want[2]}")

    # paged with the prefix cache: a page-aligned system prompt, a full hit
    # (copy-on-write), the 700-token prompt and a sharer joining mid-stream,
    # against the unsharded ring replica
    page = 16
    sysp = rng.integers(2, cfg.vocab_size, size=4 * page)
    pp = [np.concatenate([sysp, rng.integers(2, cfg.vocab_size, 40)]),
          sysp.copy(), prompts[2],
          np.concatenate([sysp, rng.integers(2, cfg.vocab_size, 20)])]
    pp = [p.astype(np.int32) for p in pp]
    pwant = [plain.generate(Request(30 + i, p, new, 1e9)).tolist()
             for i, p in enumerate(pp)]
    plain.stop()
    paged = Replica("mesh-paged0", cfg, model, slots=4, capacity=cap,
                    prefill_chunk_tokens=32, paged=True, page_size=page,
                    num_pages=255, prefix_cache=True, serving_mesh=mesh)
    pgot, paged_launches = counted(paged, lambda: serve_paged(
        paged, [Request(40 + i, p, new, 1e9) for i, p in enumerate(pp)],
        True), True)
    paged.stop()
    pstats = dict(cow_copies=paged.cow_copies,
                  hit_rate=paged._prefix.hit_rate(), **drained(paged))
    log(f"  paged+prefix on the mesh == unsharded ring {pgot == pwant}; "
        f"{pstats}; launches {paged_launches}")
    if pgot != pwant or paged.cow_copies < 1:
        raise AssertionError(f"mesh paged identity: {pgot} != {pwant} or no "
                             "COW")
    DETAILS["mesh_identity"] = dict(
        layers=4, capacity=cap, prompts=[len(p) for p in prompts],
        paged_prompts=[len(p) for p in pp], new_tokens=new,
        last_logits_max_abs_diff=worst, tol=1e-3, ring_launches=ring_launches,
        paged_launches=paged_launches, paged=pstats)
    del model, ring, paged
    torch.cuda.empty_cache()
    return paged_launches


def mesh_serve_phase(dev, layers: int = MESH_SERVE_LAYERS) -> dict:
    """Phase 14: qwen3-4b at full width, ``layers`` deep (bf16), in a DDS
    fleet of two
    replicas sharing weights: ``replica0`` sharded on a (1, 4) mesh of the
    card, ``replica1`` unsharded, both 8 lanes at capacity 8192 (2048 slots
    a shard); 12 requests of 64-6000 prompt tokens (the longest spans three
    shards), 32 new tokens each, one sampled.  All ``ok``, every lane free
    after, launches as ``expected_launches`` states for each replica (per
    decode step of replica0, 4 partials launches and a combine per
    attention layer).  Reports tokens/s, TTFT, each replica's step curve,
    the sharded and unsharded step's device-busy ms and idle share
    (``step_profile``) and peak memory."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Replica, Request, ServingFleet

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config("qwen3-4b").replace(num_layers=layers)
    cap = 8192
    t0 = time.perf_counter()
    model = M.init_model(cfg, SEED, dev)
    fleet = ServingFleet(make_policy("DDS"), source="replica0",
                         coordinator="replica1")
    reps = [Replica("replica0", cfg, model, slots=8, capacity=cap,
                    prefill_chunk_tokens=32, serving_mesh=card_mesh(dev)),
            Replica("replica1", cfg, model, slots=8, capacity=cap,
                    prefill_chunk_tokens=32)]
    for r in reps:
        fleet.add_replica(r)
    build_s = time.perf_counter() - t0
    curves = {r.name: dict(zip((int(x) for x in r.profile.step_curve.xs),
                               r.profile.step_curve.ys)) for r in reps}
    for r in reps:
        log(f"  {r.name}{' (mesh)' if r.serving_mesh else ''}: warmup "
            f"{r.warmup_s:.2f} s; step ms by occupancy "
            + ", ".join(f"{x}:{y:.2f}" for x, y in curves[r.name].items()))

    rng = np.random.default_rng(SEED + 24)
    lens = rng.integers(64, 1025, size=12)
    lens[-2:] = (4600, 6000)
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
    expect, counts = {}, {}
    for r in reps:
        c = [getattr(r, k) - b for k, b in zip(
            ("decode_steps", "prefill_chunks", "whole_prefills"),
            before[r.name])]
        counts[r.name] = c
        for k, v in expected_launches(cfg, *c, n_seq=(
                MESH_SHAPE[1] if r.serving_mesh is not None else 0)).items():
            expect[k] = expect.get(k, 0) + v
    for i, r in enumerate(res):
        if r.outcome != "ok":
            raise AssertionError(f"mesh serve request {i}: {r.outcome} "
                                 f"{r.error}")
        toks = np.asarray(r.tokens)
        if len(toks) != 32 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"mesh serve request {i}: bad tokens {toks}")
    log(f"  launches {launches}; expected {expect} from (steps, chunks, "
        f"wholes) {counts}")
    if launches != expect or not counts["replica0"][0]:
        raise AssertionError(f"mesh serve: launches {launches}, expected "
                             f"{expect}")
    wait_until(lambda: all(j is None for r in reps for j in r._lanes),
               "every lane free")
    profiles = {"replica0_at_1024": step_profile(reps[0], cfg, dev),
                "replica0_at_6000": step_profile(reps[0], cfg, dev, at=6000,
                                                 chunks=False),
                "replica1_at_6000": step_profile(reps[1], cfg, dev, at=6000,
                                                 chunks=False)}
    gen = sum(len(r.tokens) for r in res)
    ttft = sorted(r.ttft_ms for r in res)
    stats = dict(requests=len(res), ok=sum(r.ok for r in res),
                 placements=dict(fleet.stats), wall_s=wall,
                 tokens_per_s=gen / wall, generated_tokens=gen,
                 prompt_tokens=int(lens.sum()),
                 ttft_p50_ms=ttft[len(ttft) // 2],
                 ttft_p99_ms=ttft[min(int(len(ttft) * 0.99), len(ttft) - 1)],
                 engine_counts=counts, launches=launches, build_s=build_s,
                 step_curve_ms=curves,
                 warmup_s={r.name: r.warmup_s for r in reps},
                 step_profiles=profiles,
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log(f"  {stats['ok']}/{len(res)} ok, placements {stats['placements']}, "
        f"{gen} tokens in {wall:.2f} s = {stats['tokens_per_s']:.1f} tok/s, "
        f"TTFT p50 {stats['ttft_p50_ms']:.0f} ms p99 "
        f"{stats['ttft_p99_ms']:.0f} ms, peak {stats['peak_mem_gb']:.1f} GB")
    fleet.stop()
    DETAILS["mesh_serve"] = stats
    del model, reps, fleet
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _kernel_class(name: str) -> str:
    for key, cls in (("flash_bwd_", "flash_attention_bwd"),
                     ("ncclDevKernel", "nccl"), ("ncclKernel", "nccl"),
                     ("norm_bwd_kernel", "rmsnorm_bwd"),
                     ("dscale_kernel", "rmsnorm_bwd"),
                     ("paged_decode_tc_kernel", "paged_decode_attention"),
                     ("paged_decode_f32_kernel", "paged_decode_attention"),
                     ("decode_tc_kernel", "decode_attention"),
                     ("decode_f32_kernel", "decode_attention"),
                     ("flash_tc_kernel", "flash_attention"),
                     ("flash_f32_kernel", "flash_attention"),
                     ("combine_splits", "combine"),
                     ("norm_group_kernel", "rmsnorm"),
                     ("norm_block_kernel", "rmsnorm"), ("ssd_kernel", "ssd"),
                     ("ssd_chunk_out_kernel", "ssd"),
                     ("ssd_chunk_state_kernel", "ssd"),
                     ("ssd_state_pass_kernel", "ssd"),
                     ("rglru_one_tile_kernel", "rglru"),
                     ("rglru_staged_kernel", "rglru"),
                     ("ssd_bwd_", "ssd_bwd"),
                     ("rglru_bwd_kernel", "rglru_bwd")):
        if key in name:
            return cls
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def profile_call(what: str, fn) -> dict:
    """Host wall time (median of 5, synced) and device-busy time of one
    call of ``fn``, with device time by kernel class and the top kernels;
    logged as ``what``."""
    import torch
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
    log(f"  {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms (idle "
        f"{100 * (1 - busy / wall):.0f}%), {len(evs)} device events; by "
        f"class " + ", ".join(f"{k} {v:.2f}" for k, v in
                              sorted(by_class.items())))
    return dict(wall_ms=wall, device_ms=busy, idle_share=1.0 - busy / wall,
                device_events=len(evs), device_ms_by_class=by_class,
                top_kernels_ms=top)


def host_ops(what: str, fn, top: int = 10) -> dict:
    """Host time of one profiled call of ``fn`` by operator (self CPU ms
    and calls, the ``top`` first), with the CUDA runtime's allocation and
    synchronisation calls among them; logged as ``what``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    runtime = [r for r in rows if r[0].startswith("cuda") and any(
        w in r[0] for w in ("Malloc", "Free", "Synchronize"))]
    total = sum(r[1] for r in rows)
    log(f"  {what}: host {total:.1f} ms of self CPU time; top "
        + ", ".join(f"{k[:40]} {ms:.1f} ({n})" for k, ms, n in rows[:top])
        + "; runtime " + (", ".join(f"{k} {ms:.1f} ({n})"
                                    for k, ms, n in runtime) or "none"))
    return dict(host_ms=total, top=rows[:top], runtime=runtime)


def step_profile(rep, cfg, dev, at: int = 1024, chunks: bool = True):
    """Host wall time and device-busy time of one batched decode step (all
    lanes at position ``at``) and, for a ring replica (with ``chunks``),
    one widest-bucket prefill chunk, on scratch caches, with device time by
    kernel class.  A paged replica's scratch tables (``scratch_tables``)
    map each lane to its own run of pages, holding positions 0 .. at-1.  A
    sharded replica's scratch cache is laid out over its mesh, and its
    step runs under it."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving import spmd_decode as spmd
    from repro_torch.serving.engine import scratch_tables

    def laid_out(cache):
        if rep.serving_mesh is None:
            return cache
        return spmd.shard_cache(cache, rep.serving_mesh, paged=rep.paged,
                                batch_axis=rep._mesh_axes[0],
                                seq_axis=rep._mesh_axes[1])

    tok = np.zeros((rep.slots, 1), np.int64)
    idx = np.full((rep.slots,), at, np.int32)
    if rep.paged:
        cache = M.init_paged_cache(cfg, rep.slots, rep.capacity,
                                   rep.num_pages, rep.page_size, dev)
        tables = scratch_tables(rep)
        page = rep.page_size
        full = -(-at // page)
        rows = tables[:, :full].reshape(-1).long()
        p = (torch.arange(full, device=dev)[:, None] * page
             + torch.arange(page, device=dev)).repeat(rep.slots, 1)
        for layer in cache:
            if "pos" in layer:
                layer["pos"][rows] = torch.where(p < at, p, -1).to(torch.int32)
        cache = laid_out(cache)
        fns = (("decode_step", lambda: rep._step(rep.params, cache, tok, idx,
                                                 tables)),)
    else:
        cache = M.init_cache(cfg, rep.slots, rep.capacity, dev)
        lane = M.init_cache(cfg, 1, rep.capacity, dev)
        for layer in cache + lane:      # rings holding positions 0 .. at-1
            if "pos" not in layer:
                continue                # a recurrent layer: its state
            n = layer["pos"].shape[1]
            p = torch.arange(max(0, at - n), at, dtype=torch.int32, device=dev)
            layer["pos"][:, (p % n).long()] = p
        cache = laid_out(cache)
        buf = rep._zeros_tokens(rep.prefill_chunk_tokens)
        fns = (("decode_step", lambda: rep._step(rep.params, cache, tok, idx)),
               ("prefill_chunk", lambda: rep._prefill_chunk(rep.params, lane,
                                                            buf, at)))
        fns = fns if chunks else fns[:1]
    with rep._mesh_scope():
        out = {name: profile_call(f"{rep.name} {name} at position {at}", fn)
               for name, fn in fns}
    if not rep.paged and chunks:
        # wall time of one chunk at each bucket width: the fixed and
        # per-token parts the profile's chunk-cost fit separates
        by_width = {}
        for w in rep._chunk_buckets:
            toks = rep._zeros_tokens(w)
            walls = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rep._prefill_chunk(rep.params, lane, toks, at)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            by_width[w] = sorted(walls)[len(walls) // 2]
        out["prefill_chunk_wall_ms_by_width"] = by_width
        log("  prefill_chunk wall ms by width "
            + ", ".join(f"{w}:{v:.2f}" for w, v in by_width.items()))
    return out


def expected_launches(cfg, steps: int, chunks: int, wholes: int,
                      paged: bool = False, n_seq: int = 0) -> dict:
    """Launches of every kernel that a run of ``steps`` decode steps,
    ``chunks`` prefill chunks and ``wholes`` whole-prompt prefills must
    make, from the layer kinds: an attention layer launches the (paged)
    decode kernel once per step (on a replica sharded over ``n_seq``
    sequence shards: the partials launch once a shard and the combine
    once, instead) and flash once per prefill, a
    cross-attention layer the contiguous decode kernel once per step (its
    cache is the encoder's, never paged) and flash once per whole prefill,
    an SSD layer ``ssd`` and an RG-LRU layer ``rglru`` once per prefill,
    and each call of a norm entry point is one ``rmsnorm`` launch: every
    layer's pre-norm, every MLP's residual add with its norm
    (``add_rmsnorm``), every qk-norm (``rmsnorm_pair``, q and k in one
    launch; a cross layer's decode step norms q alone), every Mamba2 gated
    norm (``gated_rmsnorm``) and the final norm."""
    kinds = cfg.layer_kinds()
    attn, cross = kinds.count("attn"), kinds.count("cross")
    prefills = chunks + wholes
    norms = 1 + len(kinds) * (1 + (cfg.d_ff > 0))
    norms += (attn + cross) * cfg.use_qk_norm + kinds.count("ssm")
    mesh = attn * steps if n_seq else 0
    plain = 0 if n_seq else attn * steps
    return {"decode_attention": (0 if paged else plain) + cross * steps,
            "paged_decode_attention": plain if paged else 0,
            "flash_attention": attn * prefills + cross * wholes,
            "ssd": kinds.count("ssm") * prefills,
            "rglru": kinds.count("rglru") * prefills,
            "rmsnorm": norms * (steps + prefills),
            "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssd_bwd": 0,
            "rglru_bwd": 0,
            "decode_attention_partials": 0 if paged else n_seq * mesh,
            "paged_decode_attention_partials": n_seq * mesh if paged else 0,
            "attention_combine": mesh}


def expected_train_launches(cfg, remat: bool, steps: int = 1) -> dict:
    """Launches of every kernel that ``steps`` train steps of a stack of
    attention, SSD and RG-LRU layers must make (one microbatch).  The
    forward runs each layer once, twice with remat (the checkpointed
    forward and its recompute in the backward); the final norm sits
    outside the checkpoint and runs once.  Per layer and forward: the
    mixer's kernel once (flash, ``ssd`` or ``rglru``), and the pre-norm,
    the qk pair (attention with qk-norm), Mamba2's gated norm and the
    residual add with the MLP's norm once each (each a ``rmsnorm``
    launch); the backward launches each one's backward kernel once.  An
    MoE layer is an attention layer whose channel mixer, ``moe_ffn``,
    launches no kernel of its own (batched products, gathers and an
    ``index_add_``), so its norms count as a dense layer's."""
    kinds = cfg.layer_kinds()
    if not set(kinds) <= {"attn", "ssm", "rglru"}:
        raise ValueError(f"{cfg.name}: a train step is counted for stacks "
                         "of attention, SSD and RG-LRU layers only")
    layers = len(kinds)
    attn, ssm, rec = (kinds.count(k) for k in ("attn", "ssm", "rglru"))
    norms = layers * (1 + (cfg.d_ff > 0)) + attn * cfg.use_qk_norm + ssm
    fwd = 2 if remat else 1
    return {"decode_attention": 0, "paged_decode_attention": 0,
            "ssd": ssm * fwd * steps, "rglru": rec * fwd * steps,
            "flash_attention": attn * fwd * steps,
            "rmsnorm": (norms * fwd + 1) * steps,
            "flash_attention_bwd": attn * steps,
            "rmsnorm_bwd": (norms + 1) * steps,
            "ssd_bwd": ssm * steps, "rglru_bwd": rec * steps,
            "decode_attention_partials": 0,
            "paged_decode_attention_partials": 0, "attention_combine": 0}


def serve_phase(dev, arch="qwen3-4b", capacity=2048, long_prompts=(),
                key="serve", layers=0):
    """Phase 4: ``arch`` at its full config in bf16 (its depth cut to
    ``layers`` where that is set) through a DDS fleet of 2 replicas sharing
    weights, 8 slots, a 32-token chunk ceiling; 12 requests of 64-1024
    prompt tokens (the last ones replaced by ``long_prompts``), 32 new
    tokens each, one sampled."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_fleet
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9    # left by earlier phases
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    fleet = build_fleet(cfg, "DDS", replicas=2, slots=8, capacity=capacity,
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
    DETAILS[f"{key}_build_s"] = build_s
    DETAILS[f"{key}_step_curve_ms"] = {r.name: list(r.profile.step_curve.ys)
                                       for r in reps}

    rng = np.random.default_rng(SEED + 3)
    lens = rng.integers(64, 1025, size=12)
    if long_prompts:
        lens[-len(long_prompts):] = long_prompts
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
    expect = expected_launches(cfg, steps, chunks, wholes)
    log(f"  launches {launches}; expected {expect} from {steps} decode "
        f"steps, {chunks} chunks, {wholes} whole prefills")
    if launches != expect or steps == 0 or chunks == 0:
        raise AssertionError(f"{arch}: launches {launches}, expected {expect}")

    # finite logits of the served model on a served prompt
    cache = M.init_cache(cfg, 1, capacity, dev)
    lg, _ = M.prefill_chunk(reps[0].params, cache,
                            torch.as_tensor(reqs[0].prompt[:32], device=dev,
                                            dtype=torch.int64)[None], 0, cfg)
    if not torch.isfinite(lg).all():
        raise AssertionError("non-finite logits")

    DETAILS[f"{key}_step_profile"] = step_profile(reps[0], cfg, dev)

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
                 held_at_start_gb=held_gb,
                 # the Update-Profile chunk cost (its fit at the full
                 # chunk width) after the phase; the warmup line shows its
                 # start
                 profile_prefill_chunk_ms={r.name: r.profile.prefill_chunk_ms
                                           for r in reps},
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log(f"  {stats['ok']}/{len(res)} ok, placements {stats['placements']}, "
        f"{gen} tokens in {wall:.2f} s = {stats['tokens_per_s']:.1f} tok/s, "
        f"TTFT p50 {stats['ttft_p50_ms']:.0f} ms p99 "
        f"{stats['ttft_p99_ms']:.0f} ms")
    fleet.stop()
    DETAILS[key] = stats
    return launches


def paged_serve_phase(dev, arch="qwen3-4b", key="paged", layers=0):
    """Phase 5: the paged path with the prefix cache at ``arch``'s full
    config (its depth cut to ``layers`` where that is set): 2 replicas
    sharing weights, 8 lanes, capacity 2048, pages of 16, 512 pages each
    (half of what 8 full lanes need), DDS; 12 requests opening with one
    512-token system prompt, the first alone until its first token, one
    equal to the system prompt (a full hit)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_fleet
    from repro_torch.serving.engine import Request

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    fleet = build_fleet(cfg, "DDS", replicas=2, slots=8, capacity=2048,
                        prefill_chunk_tokens=32, paged=True, page_size=16,
                        num_pages=512, prefix_cache=True, seed=SEED,
                        device=dev, verbose=False)
    build_s = time.perf_counter() - t0
    reps = list(fleet.replicas.values())
    for r in reps:
        log(f"  {r.name}: warmup {r.warmup_s:.2f} s; paged step ms by "
            "occupancy " + ", ".join(
                f"{int(x)}:{y:.2f}" for x, y in
                zip(r.profile.step_curve.xs, r.profile.step_curve.ys))
            + f"; chunk({r.prefill_chunk_tokens}) "
              f"{r.profile.prefill_chunk_ms:.2f} ms")
    DETAILS[f"{key}_serve_build_s"] = build_s
    DETAILS[f"{key}_step_curve_ms"] = {r.name: list(r.profile.step_curve.ys)
                                       for r in reps}

    rng = np.random.default_rng(SEED + 5)
    sysp = rng.integers(2, cfg.vocab_size, size=512)
    sufs = rng.integers(16, 513, size=11)
    prompts = [np.concatenate([sysp, rng.integers(2, cfg.vocab_size, int(n))])
               .astype(np.int32) for n in sufs] + [sysp.astype(np.int32)]
    reqs = [Request(i, p, 32, 600_000.0) for i, p in enumerate(prompts)]
    reqs[5].temperature, reqs[5].top_p, reqs[5].seed = 0.8, 0.95, 1234
    total = sum(len(p) for p in prompts)

    before = {r.name: (r.decode_steps, r.prefill_chunks, r.whole_prefills,
                       r.prefilled_tokens, r.cow_copies) for r in reps}
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(reqs)) as ex:
        first = ex.submit(fleet.submit, reqs[0])
        # the others follow once the first has registered the system
        # prompt, which it does just before emitting its first token
        while (not first.done() and time.perf_counter() - t0 < 300
               and not any(len(r._prefix) for r in reps)):
            time.sleep(0.005)
        rest = [ex.submit(fleet.submit, r) for r in reqs[1:]]
        res = [first.result()] + [f.result() for f in rest]
    wall = time.perf_counter() - t0
    launches = ops.kernel_launches()
    delta = {k: sum(getattr(r, k) - before[r.name][i] for r in reps)
             for i, k in enumerate(("decode_steps", "prefill_chunks",
                                    "whole_prefills", "prefilled_tokens",
                                    "cow_copies"))}
    for i, r in enumerate(res):
        if r.outcome != "ok":
            raise AssertionError(f"paged request {i}: {r.outcome} {r.error}")
        toks = np.asarray(r.tokens)
        if len(toks) != 32 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"paged request {i}: bad tokens {toks}")
    steps, chunks = delta["decode_steps"], delta["prefill_chunks"]
    expect = expected_launches(cfg, steps, chunks, delta["whole_prefills"],
                               paged=True)
    log(f"  launches {launches}; expected {expect} from {steps} decode "
        f"steps, {chunks} chunks")
    if launches != expect or steps == 0 or chunks == 0:
        raise AssertionError(f"{arch} paged: launches {launches}, expected "
                             f"{expect}")
    hit = {r.name: r._prefix.hit_rate() for r in reps}
    # LRU evictions: distinct full prompt blocks a replica served, less the
    # blocks its prefix cache still holds
    blocks = {r.name: set() for r in reps}
    for q, r in zip(reqs, res):
        n = len(q.prompt) - len(q.prompt) % 16
        blocks[r.replica].update(tuple(q.prompt[:e]) for e in range(16, n + 1,
                                                                     16))
    evicted = {r.name: len(blocks[r.name]) - len(r._prefix) for r in reps}
    log(f"  prefix hit rate {hit}; prefilled {delta['prefilled_tokens']} of "
        f"{total} prompt tokens; {delta['cow_copies']} COW copies; LRU "
        f"evictions {evicted}")
    if not (max(hit.values()) > 0 and delta["prefilled_tokens"] < total
            and delta["cow_copies"] >= 1):
        raise AssertionError("the prefix cache was not exercised")

    DETAILS[f"{key}_step_profile"] = step_profile(reps[0], cfg, dev)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    gen = sum(len(r.tokens) for r in res)
    ttft = sorted(r.ttft_ms for r in res)
    stats = dict(requests=len(res), ok=sum(r.ok for r in res),
                 placements=dict(fleet.stats), wall_s=wall,
                 tokens_per_s=gen / wall, generated_tokens=gen,
                 prompt_tokens=total, prefix_hit_rate=hit,
                 lru_evictions=evicted,
                 ttft_p50_ms=ttft[len(ttft) // 2],
                 ttft_p99_ms=ttft[min(int(len(ttft) * 0.99), len(ttft) - 1)],
                 launches=launches, warmup_s={r.name: r.warmup_s for r in reps},
                 peak_mem_gb=peak, **delta)
    log(f"  {stats['ok']}/{len(res)} ok, placements {stats['placements']}, "
        f"{gen} tokens in {wall:.2f} s = {stats['tokens_per_s']:.1f} tok/s, "
        f"TTFT p50 {stats['ttft_p50_ms']:.0f} ms p99 "
        f"{stats['ttft_p99_ms']:.0f} ms, peak memory {peak:.1f} GB")
    fleet.stop()
    stats["pools_after_stop"] = {r.name: drained(r) for r in reps}
    DETAILS[f"{key}_serve"] = stats
    return launches


# ---------------------------------------------------------------- phase 8
# the fleet's fault timings in phase 8 (as the port's fault tests use them):
# a 20 ms heartbeat, staleness after 5 of them, and a progress watchdog
# well above a step or a chunk (tens of ms; 4x that under slow(4))
CHAOS_HEARTBEAT_MS = 20.0
CHAOS_STALENESS = 5.0
CHAOS_PROGRESS_MS = 1000.0
# the partition scenario's staleness alarm spans at least this many of the
# victim's one-lane steps, so that the window in which its loop must be seen
# to run on holds several steps whatever the host's speed
CHAOS_PARTITION_STEPS = 8.0
# minicpm-2b's depth in phase 8: a quarter of its 40 layers.  The phase
# checks failover, eviction and lost requests, which do not depend on the
# depth; phase 3d holds minicpm-2b's full width card against CPU.
CHAOS_LAYERS = 10


def wait_until(cond, what: str, timeout_s: float = 120.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def decoding(rep) -> bool:
    return any(j is not None for j in rep._lanes)


def chaos_phase(dev):
    """Phase 8: fault injection on the card.  minicpm-2b at full width,
    ``CHAOS_LAYERS`` deep, in bf16 (head_dim 64, 36 heads over 36 KV
    heads), fleets of two DDS
    replicas over one set of weights, 8 lanes, capacity 2048, a 32-token
    chunk ceiling, built afresh for each scenario (a crash is permanent):
    crash, hang, slow(4x) and partition-then-heal against ``replica0``,
    each applied once the victim decodes.  Returns the kernels' launches
    summed over the scenarios' traffic, which must equal
    ``expected_launches`` from the engine counters of every replica, the
    crashed and the hung ones included."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.latency import NodeState, Task, predict_total_ms
    from repro_torch.core.policies import make_policy
    from repro_torch.ft import faults
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.serving.engine import (Replica, Request, ServingFleet,
                                            profile_replica)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    cfg = get_config("minicpm-2b").replace(num_layers=CHAOS_LAYERS)
    params = M.init_model(cfg, SEED, dev)
    log(f"  fleet timings: heartbeat {CHAOS_HEARTBEAT_MS:.0f} ms, staleness "
        f"alarm {CHAOS_HEARTBEAT_MS * CHAOS_STALENESS:.0f} ms, progress "
        f"timeout {CHAOS_PROGRESS_MS:.0f} ms")
    rng = np.random.default_rng(SEED + 8)

    def prompt(n):
        return rng.integers(2, cfg.vocab_size, size=(int(n),)).astype(np.int32)

    def replica(name):
        return Replica(name, cfg, params, slots=8, capacity=2048,
                       prefill_chunk_tokens=32)

    def fleet_of(reps, staleness):
        """A DDS fleet (source replica0, coordinator replica1) that records
        each eviction: its reason, when, and the victim's decode steps."""
        fleet = ServingFleet(make_policy("DDS"), source="replica0",
                             coordinator="replica1",
                             heartbeat_ms=CHAOS_HEARTBEAT_MS,
                             staleness_factor=staleness,
                             progress_timeout_ms=CHAOS_PROGRESS_MS,
                             admission_margin=0.0)
        deaths = []
        declare = fleet.monitor.on_dead

        def on_dead(name, reason):
            rep = fleet.replicas.get(name)
            deaths.append(dict(name=name, reason=reason,
                               at=time.perf_counter(),
                               decode_steps=(rep.decode_steps
                                             if rep is not None else -1)))
            declare(name, reason)

        fleet.monitor.on_dead = on_dead
        for r in reps:
            fleet.add_replica(r)
        return fleet, deaths

    launches_sum, engine_sum = {}, dict(steps=0, chunks=0, wholes=0)
    stats = {}

    def counted(key, reps, drive):
        """Run ``drive`` (which leaves every decode thread stopped) with the
        launch counts set to 0 just before, and hold them against the
        engine counters of all of ``reps`` just after."""
        before = [(r.decode_steps, r.prefill_chunks, r.whole_prefills)
                  for r in reps]
        ops.reset_kernel_launches()
        out = drive()
        if any(r._thread.is_alive() for r in reps):
            raise AssertionError(f"chaos {key}: a decode thread outlived "
                                 "the scenario")
        launches = ops.kernel_launches()
        steps, chunks, wholes = (sum(getattr(r, k) - b[i]
                                     for r, b in zip(reps, before))
                                 for i, k in enumerate(("decode_steps",
                                                        "prefill_chunks",
                                                        "whole_prefills")))
        expect = expected_launches(cfg, steps, chunks, wholes)
        log(f"  {key}: launches {launches}; expected {expect} from {steps} "
            f"decode steps, {chunks} chunks, {wholes} whole prefills over "
            + ", ".join(r.name for r in reps))
        if launches != expect or steps == 0 or chunks == 0:
            raise AssertionError(f"chaos {key}: launches {launches}, "
                                 f"expected {expect}")
        for k, v in launches.items():
            launches_sum[k] = launches_sum.get(k, 0) + v
        for k, v in zip(("steps", "chunks", "wholes"), (steps, chunks, wholes)):
            engine_sum[k] += v
        return out

    def evicted(fleet, deaths, t_fault, cause):
        if fleet.dead != ["replica0"] or not deaths or cause not in \
                deaths[0]["reason"]:
            raise AssertionError(f"expected replica0 evicted by {cause}: "
                                 f"dead {fleet.dead}, {deaths}")
        return (deaths[0]["at"] - t_fault) * 1e3

    def pair(staleness=CHAOS_STALENESS):
        gc.collect()            # the last scenario's replicas and caches
        t0 = time.perf_counter()
        reps = [replica("replica0"), replica("replica1")]
        fleet, deaths = fleet_of(reps, staleness)
        return reps, fleet, deaths, time.perf_counter() - t0

    # ---- crash: phase 4's prompt mix, one request sampled
    reps, fleet, deaths, build_s = pair()
    lens = np.random.default_rng(SEED + 3).integers(64, 1025, size=12)
    reqs = [Request(i, prompt(n), 32, 600_000.0) for i, n in enumerate(lens)]
    reqs[5].temperature, reqs[5].top_p, reqs[5].seed = 0.8, 0.95, 1234
    # the sampled request served with no fault, on the survivor-to-be
    calm = reps[1].generate(dataclasses.replace(reqs[5], request_id=105))
    inj = faults.inject(fleet, "replica0")

    def drive_crash():
        with ThreadPoolExecutor(len(reqs)) as ex:
            futs = [ex.submit(fleet.submit, r) for r in reqs]
            wait_until(lambda: decoding(reps[0]), "replica0 to decode")
            t_fault = time.perf_counter()
            inj.apply("crash")
            res = [f.result() for f in futs]
        t_end = time.perf_counter()
        inj.stop()
        fleet.stop()
        reps[0].stop()          # its decode thread died at the gate
        return res, t_fault, t_end

    res, t_fault, t_end = counted("crash", reps, drive_crash)
    bad = [(i, r.outcome, r.error) for i, r in enumerate(res) if not r.ok]
    moved = sum(1 for r in res if r.failed_over or r.attempts > 1)
    if bad or fleet.lost != 0 or moved == 0:
        raise AssertionError(f"crash: not ok {bad}, lost {fleet.lost}, "
                             f"failed over {moved}")
    evict_ms = evicted(fleet, deaths, t_fault, "staleness")
    for i, (q, r) in enumerate(zip(reqs, res)):
        want = (calm if i == 5 else reps[1].generate_sequential(q)).tolist()
        if r.tokens.tolist() != want:
            raise AssertionError(
                f"crash request {i} ({len(q.prompt)} tokens, on "
                f"{r.replica}): {r.tokens.tolist()} != "
                f"{'undisturbed' if i == 5 else 'generate_sequential'} "
                f"{want}")
    DETAILS["chaos_step_profile"] = step_profile(reps[1], cfg, dev)
    gen = sum(len(r.tokens) for r in res if r.replica == "replica1")
    stats["crash"] = dict(
        requests=len(res), ok=sum(r.ok for r in res), lost=fleet.lost,
        failed_over=moved, fleet_failovers=fleet.failovers, dead=fleet.dead,
        reason=deaths[0]["reason"], fault_to_eviction_ms=evict_ms,
        placements=dict(fleet.stats), survivor_tokens=gen,
        survivor_tokens_per_s=gen / (t_end - t_fault),
        wall_s=t_end - t_fault, build_s=build_s)
    log(f"  crash: {stats['crash']['ok']}/{len(res)} ok, lost 0, "
        f"{moved} failed over, placements {stats['crash']['placements']}; "
        f"fault to eviction {evict_ms:.0f} ms ({deaths[0]['reason']}); the "
        f"survivor served {gen} tokens in {t_end - t_fault:.2f} s = "
        f"{gen / (t_end - t_fault):.1f} tok/s; greedy streams equal "
        f"generate_sequential, the sampled one its undisturbed stream")
    del reps, fleet, inj

    # ---- hang: the progress watchdog, with the heartbeats going on
    reps, fleet, deaths, build_s = pair()
    reqs = [Request(20 + i, prompt(n), 32, 600_000.0)
            for i, n in enumerate((96, 160, 224))]
    inj = faults.inject(fleet, "replica0")

    def drive_hang():
        with ThreadPoolExecutor(len(reqs)) as ex:
            futs = [ex.submit(fleet.submit, r) for r in reqs]
            wait_until(lambda: decoding(reps[0]), "replica0 to decode")
            t_fault = time.perf_counter()
            inj.apply("hang")
            res = [f.result() for f in futs]
        inj.apply("heal")
        inj.stop()
        clean = reps[0].stop()  # raises ReplicaLeak if still hung
        fleet.stop()
        return res, t_fault, clean

    res, t_fault, clean = counted("hang", reps, drive_hang)
    evict_ms = evicted(fleet, deaths, t_fault, "progress stalled")
    failed = sum(1 for r in res if not r.ok)
    if fleet.lost != failed or not clean or any(
            r.ok and r.replica != "replica1" for r in res):
        raise AssertionError(f"hang: lost {fleet.lost}, failed {failed}, "
                             f"clean stop {clean}, "
                             f"{[(r.replica, r.outcome) for r in res]}")
    stats["hang"] = dict(requests=len(res), ok=len(res) - failed,
                         lost=fleet.lost, dead=fleet.dead,
                         reason=deaths[0]["reason"],
                         fault_to_eviction_ms=evict_ms,
                         failed_over=sum(1 for r in res if r.attempts > 1),
                         placements=dict(fleet.stats), build_s=build_s)
    log(f"  hang: evicted by the watchdog {evict_ms:.0f} ms after the fault "
        f"({deaths[0]['reason']}); {len(res) - failed}/{len(res)} ok on "
        f"replica1, {fleet.lost} lost; healed, stopped without a leak")
    del reps, fleet, inj

    # ---- slow(4x): the Update-Profile loop moves placements off the victim
    reps, fleet, deaths, build_s = pair()
    inj = faults.inject(fleet, "replica0")
    prof = reps[0].profile
    probe = prompt(64)
    # a deadline twice what the idle, healthy victim is predicted to take:
    # DDS keeps such a request on its source until the step estimate grows
    task = Task(task_id=0, app_id="serve", size_kb=64.0, created_ms=0.0,
                constraint_ms=1e9, source="replica0")
    deadline = 2.0 * predict_total_ms(fleet.profiles["replica0"], task,
                                      NodeState(), remote=False)

    def short(i):
        return Request(i, probe, 16, deadline)

    def drive_slow():
        before = fleet.submit(short(30))
        est0 = prof.step_curve(1.0)
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(fleet.submit, Request(31, prompt(64), 32,
                                                  600_000.0))
            wait_until(lambda: decoding(reps[0]), "replica0 to decode")
            steps0 = reps[0].decode_steps
            inj.apply("slow", factor=4.0)
            slowed = fut.result()
        est1 = prof.step_curve(1.0)
        after = [fleet.submit(short(32 + i)) for i in range(2)]
        inj.apply("heal")
        inj.stop()
        fleet.stop()
        return [before, slowed] + after, est0, est1, \
            reps[0].decode_steps - steps0

    res, est0, est1, n_slow = counted("slow", reps, drive_slow)
    places = [r.replica for r in res]
    if (not all(r.ok for r in res) or est1 < 2.5 * est0 or n_slow < 8
            or places != ["replica0", "replica0", "replica1", "replica1"]):
        raise AssertionError(f"slow: step estimate {est0:.2f} -> {est1:.2f} "
                             f"ms over {n_slow} steps, placements {places}, "
                             f"{[r.outcome for r in res]}")
    stats["slow"] = dict(step_estimate_ms=[est0, est1], ratio=est1 / est0,
                         slowed_steps=n_slow, deadline_ms=deadline,
                         placements=places, dead=fleet.dead,
                         build_s=build_s)
    log(f"  slow(4x): replica0's step estimate at one lane {est0:.2f} -> "
        f"{est1:.2f} ms ({est1 / est0:.2f}x) over {n_slow} slowed steps; "
        f"with a {deadline:.0f} ms deadline the request before the fault "
        f"went to {places[0]}, the two after it to {places[2]} and "
        f"{places[3]}")
    del reps, fleet, inj, prof

    # ---- partition, then heal: staleness evicts, the healed node rejoins
    # the healed node comes back as a fresh process (the fleet stopped the
    # evicted one), built and profiled before the counted traffic
    gc.collect()
    rejoin = replica("replica0")
    rejoin_prof = profile_replica(rejoin)
    # the victim's loop must be seen to run on between the fault and its
    # eviction.  A one-lane step takes 30-45 ms on an idle host and more on
    # a loaded one, so the phase's 100 ms alarm held one or two steps, or
    # none: here the alarm spans CHAOS_PARTITION_STEPS of the steps that
    # the rejoining replica's profile measured on this card
    step_ms = rejoin_prof.step_curve(1.0)
    staleness = max(CHAOS_STALENESS,
                    CHAOS_PARTITION_STEPS * step_ms / CHAOS_HEARTBEAT_MS)
    reps, fleet, deaths, build_s = pair(staleness)
    log(f"  partition: one-lane step {step_ms:.2f} ms, staleness alarm "
        f"{staleness * CHAOS_HEARTBEAT_MS:.0f} ms")
    inj = faults.inject(fleet, "replica0")
    req = Request(40, prompt(128), 48, 600_000.0)

    def drive_partition():
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(fleet.submit, req)
            wait_until(lambda: decoding(reps[0]), "replica0 to decode")
            # partition just after a step ends: the eviction (one
            # staleness alarm after the last heartbeat) then leaves the
            # loop the most time to show that it runs on
            steps0 = reps[0].decode_steps
            wait_until(lambda: reps[0].decode_steps > steps0, "a step")
            steps0 = reps[0].decode_steps
            t_fault = time.perf_counter()
            inj.apply("partition")
            wait_until(lambda: "replica0" in fleet.dead, "the eviction", 10)
            first = fut.result()
        inj.apply("heal")
        inj.stop()
        reps[0].stop()
        fleet.add_replica(rejoin, profile=rejoin_prof)
        again = fleet.submit(Request(41, prompt(64), 16, 600_000.0))
        fleet.stop()
        return first, again, steps0, t_fault

    first, again, steps0, t_fault = counted(
        "partition", reps + [rejoin], drive_partition)
    evict_ms = evicted(fleet, deaths, t_fault, "staleness")
    ran = deaths[0]["decode_steps"] - steps0
    if not (first.ok and first.replica == "replica1" and first.attempts > 1
            and again.ok and again.replica == "replica0" and ran > 0):
        raise AssertionError(
            f"partition: first {first.replica} {first.outcome}, rejoined "
            f"{again.replica} {again.outcome}, {ran} steps while partitioned")
    stats["partition"] = dict(fault_to_eviction_ms=evict_ms,
                              staleness_alarm_ms=staleness
                              * CHAOS_HEARTBEAT_MS,
                              step_ms=step_ms,
                              reason=deaths[0]["reason"],
                              steps_while_partitioned=ran,
                              failed_over=first.replica,
                              after_rejoin=again.replica, build_s=build_s)
    log(f"  partition: evicted by staleness {evict_ms:.0f} ms after the "
        f"fault, {ran} decode steps while partitioned; the request failed "
        f"over to {first.replica}; healed and rejoined, the next request "
        f"ran on {again.replica}")
    del reps, fleet, inj, rejoin

    stats.update(launches=launches_sum, engine=engine_sum,
                 wall_s=time.perf_counter() - t_phase,
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    log(f"  phase 8 wall {stats['wall_s']:.1f} s, peak memory "
        f"{stats['peak_mem_gb']:.1f} GB; launches {launches_sum}")
    DETAILS["chaos"] = stats
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches_sum


# ------------------------------------------------------------- the dry run
DRYRUN_BUDGET_S = 60.0


def dryrun_phase(dev, batch: int = 2, seq: int = 1024) -> dict:
    """Phase 16: ``launch.dryrun`` on this machine's torch, then the dry
    run held against a real sharded step on the card (module docstring).
    Returns the records and the comparison; raises if a cell is not as
    the reference has it, if the counts disagree or if the phase takes
    longer than ``DRYRUN_BUDGET_S``."""
    import gc
    import torch
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.common.tree import tree_paths
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import placement
    from repro_torch.training import steps as S

    t0 = time.perf_counter()
    records = {}
    for shape_name, status in (("train_4k", "OK"), ("decode_32k", "OK"),
                               ("long_500k", "SKIP")):
        rec = dryrun.run_cell("qwen3-4b", shape_name, False, save=False)
        log(f"  {json.dumps(rec)}")
        if rec["status"] != status:
            raise AssertionError(f"dry run qwen3-4b {shape_name}: "
                                 f"{rec['status']}, not {status}: "
                                 f"{rec.get('traceback', rec)}")
        records[shape_name] = rec

    cfg = get_config("qwen3-4b")
    shape = ShapeConfig("phase16", "train", seq, batch)
    with dryrun.fake_world(1):
        dry = dryrun.trace_cell(cfg, shape, make_host_mesh("cpu"))
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    data = {}
    for k, t in dryrun.input_specs(cfg, shape).items():
        if t.dtype == torch.int32:
            data[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                    device=dev, dtype=torch.int32)
        else:
            data[k] = torch.ones(t.shape, dtype=t.dtype, device=dev)
    tc = TrainConfig(total_steps=1000)
    with one_rank_world(dev):
        mesh = make_host_mesh(dev)
        state, _ = placement.place_by_specs(
            S.init_train_state(cfg, SEED, dev, tc), mesh)
        held = sum(placement.local(t).nbytes for _, t in
                   tree_paths(placement.state_tree(state)))
        held += sum(t.nbytes for t in data.values())   # one rank: every row
        fn = S.make_train_step(cfg, tc, num_groups=1, mesh=mesh)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with dryrun.Trace() as tr:
            _, metrics = fn(state, data)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        loss = float(metrics["loss"])
        real = dryrun.collective_bytes(tr.calls)
        del state, fn, metrics, tr
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    cmp = {"batch": batch, "seq": seq, "dry": dry,
           "real_collective_bytes": real, "real_argument_bytes": held,
           "real_peak_bytes": peak, "real_loss": loss,
           "peak_ratio_dry_over_real": dry["memory"]["peak_bytes"] / peak,
           "seconds": seconds}
    log(f"  dry vs real, qwen3-4b {batch} x {seq} on (1, 1): collective "
        f"bytes dry {json.dumps(dry['collective_bytes'])} real "
        f"{json.dumps(real)}; argument bytes dry "
        f"{dry['memory']['argument_bytes']} real {held}; peak bytes dry "
        f"{dry['memory']['peak_bytes']} (plain route) real {peak} "
        f"(max_memory_allocated), ratio "
        f"{cmp['peak_ratio_dry_over_real']:.3f}; real loss {loss:.4f}; "
        f"phase {seconds:.1f} s")
    DETAILS["dryrun"] = {"records": records, "dry_vs_real": cmp}
    if dry["collective_bytes"] != real:
        raise AssertionError(f"dry run: collective bytes "
                             f"{dry['collective_bytes']} against a real "
                             f"step's {real}")
    if dry["memory"]["argument_bytes"] != held:
        raise AssertionError(f"dry run: argument bytes "
                             f"{dry['memory']['argument_bytes']} against the "
                             f"real state and batch's {held}")
    if not math.isfinite(loss):
        raise AssertionError(f"dry run: the real step's loss {loss}")
    if seconds > DRYRUN_BUDGET_S:
        raise AssertionError(f"phase 16 took {seconds:.1f} s, over "
                             f"{DRYRUN_BUDGET_S:.0f}")
    return cmp


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", default="",
                    help="also write every measurement to this JSON file")
    ap.add_argument("--only", default="",
                    help="build, run only these phases (comma-separated: "
                         "2t, 2c, 3i, 13 of the training slice; 2m, 3m, 14 "
                         "of the serving mesh; 3p, 15 of the distributed "
                         "trainer, 15 held against 13 when 13 runs first; "
                         "16, the dry run; 3r, 17 of the recurrent stacks' "
                         "training; 3e, 18 of MoE training) "
                         "and stop, with no summary: a quick check of a "
                         "change, not the smoke test")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = card_line()
    phase_s, started = {}, [None, time.perf_counter()]

    def phase(msg: str) -> None:
        """Log a phase's first line; time the one before it."""
        now = time.perf_counter()
        if started[0] is not None:
            phase_s[started[0]] = round(now - started[1], 1)
        started[:] = [msg.split(":")[0], now]
        log(msg)

    phase(f"phase 1: card {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {torch.cuda.device_count()} device(s); host "
        f"MemTotal {host_mem_gb('MemTotal'):.1f} GB")
    DETAILS["host_mem_total_gb"] = host_mem_gb("MemTotal")
    # every nvcc starts now; phase 2 runs the forward kernels only, so it
    # starts once they are built while the backward ones go on building
    # until phase 2t waits for them
    t0 = time.perf_counter()
    bwd = [n for n in build.SOURCES if n.endswith("_bwd")]
    builder = ThreadPoolExecutor(1)
    bwd_built = builder.submit(build.build_all, bwd)
    took = build.build_all([n for n in build.SOURCES if n not in bwd])

    def built(what: str) -> None:
        log(f"  {what} built in {time.perf_counter() - t0:.1f} s "
            f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")

    built("forward kernels")
    if args.only:
        took = bwd_built.result()
        builder.shutdown()
        built("backward kernels")
        DETAILS["build_logs"] = {k: build.build_log(k) for k in build.SOURCES}
        # the card's context and allocator before any phase: one that resets
        # the peak memory first (13, 17) fails on a card nothing has used
        torch.zeros(1, device=dev)
        only = {"2t": check_backward, "2c": time_backward,
                "3i": train_identity, "13": train_phase,
                "3p": train_dist_identity, "15": train_sharded_phase,
                "2m": check_mesh_kernels, "3m": mesh_identity,
                "14": mesh_serve_phase, "16": dryrun_phase,
                "3r": recurrent_train_identity, "17": recurrent_train_phases,
                "3e": moe_identity_grads, "18": moe_train_phase}
        for key in args.only.split(","):
            phase(f"phase {key} (--only)")
            only[key](dev)
        phase("selected phases passed")
        DETAILS["phase_s"] = phase_s
        if args.details:
            os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                        exist_ok=True)
            with open(args.details, "w") as f:
                json.dump(DETAILS, f, indent=1, default=str)
        return 0

    phase("phase 2: kernels against their plain versions")
    errs = check_kernels(dev)
    took = bwd_built.result()
    builder.shutdown()
    built("backward kernels")
    DETAILS["build_logs"] = {k: build.build_log(k) for k in build.SOURCES}
    phase("phase 2t: the backward kernels against their plain versions "
          "(flash at qwen3-4b's training shape, D 64 MHA, GQA 1-16 with a "
          "window, ragged S, D 256 MQA; the norm forms at 128, 2304, 2560, "
          "999, 8192, the gated one at 3072; ssd at mamba2-780m's widths, "
          "chunks 128, 100, 2, and at 47 heads; rglru 1-2300 steps at 4096 "
          "and 999)")
    errs.update(check_backward(dev))
    phase("phase 2b: moe_ffn against the reference loop (one layer at full "
        "width: mixtral-8x22b f32 and bf16, arctic-480b bf16)")
    check_moe(dev)
    phase("phase 2c: kernel timings beside their bounds (bf16)")
    rows = time_kernels(dev)
    train_rows = time_backward(dev)
    rows["flash_attention"]["train_lse"] = train_rows.pop(
        "flash_attention_train")
    rows.update(train_rows)
    phase("phase 2m: the decode kernels over a serving mesh (1 x 4 shards on "
          "one card): spmd ring and paged against the plain decode, "
          "partials and combine against their plain versions, timings")
    mesh_rows = check_mesh_kernels(dev)["rows"]
    for name, r in mesh_rows.items():
        rows[name]["mesh"] = r

    phase("phase 3: identity (qwen3-4b width, 4 layers, f32, TF32 off)")
    identity_phase(dev)
    phase("phase 3c: identity of the recurrent stacks (full width, f32, TF32 "
        "off): mamba2-780m at 4 layers, recurrentgemma-9b at 5")
    recurrent_identity(dev, "mamba2-780m", 4, 1024, (40, 200, 700), ())
    recurrent_identity(dev, "recurrentgemma-9b", 5, 4096, (40, 200),
                       (700, 2300))
    phase("phase 3d: identity of minicpm-2b (full width: head_dim 64, 36 "
        "heads over 36 KV heads, vocab 122753; 4 layers, f32, TF32 off)")
    identity_phase(dev, "minicpm-2b", 4, paged=False)
    phase("phase 3e: identity of mixtral-8x22b (full width: 8 experts of "
        "6144 x 16384, GQA 48/8, window 4096; 1 layer, f32, TF32 off), "
        "serving and gradients")
    moe_identity_grads(dev)
    phase("phase 3f: identity of arctic-480b (full width: 128 experts of "
        "7168 x 4864 and a dense FFN, GQA 56/8; 1 layer, f32, TF32 off)")
    moe_identity(dev, "arctic-480b", 1)

    phase("phase 3g: identity of llama-3.2-vision-90b (full width, one "
        "period: 4 self + 1 cross layers over 1601 image tokens; f32, TF32 "
        "off; model functions)")
    vision_identity(dev)
    phase("phase 3h: identity of musicgen-medium (full width: head_dim 64, "
        "24 heads over 24 KV heads, gelu MLP; 4 layers, f32, TF32 off)")
    identity_phase(dev, "musicgen-medium", 4, paged=True)
    phase("phase 3i: train identity (qwen3-4b width, 2 layers, f32, TF32 "
          "off): gradients and 3 train steps card against CPU; resume bit "
          "for bit (bf16, f32 masters)")
    train_identity(dev)
    phase("phase 3r: train identity of the recurrent stacks (full width, "
          "f32, TF32 off): gradients and steps card against CPU, "
          "mamba2-780m at 2 layers 3 steps, recurrentgemma-9b at 3 layers "
          "(rglru, rglru, attn) 1 step")
    recurrent_train_identity(dev)
    phase("phase 3m: identity of a sharded replica (qwen3-4b width, 4 "
          "layers, f32, TF32 off; 1 x 4 mesh on one card): ring, then paged "
          "with the prefix cache, against the unsharded replica and the CPU")
    mesh_paged = mesh_identity(dev)
    phase("phase 3p: identity of the distributed trainer (qwen3-4b width, 4 "
          "layers, f32, TF32 off; a world of one NCCL rank): sharded steps "
          "against make_train_step, int8 all-reduce, GPipe over 4 stages, "
          "resume through reshard_leaf")
    train_dist_identity(dev)

    phase("phase 4: serve (qwen3-4b full width, 18 of 36 layers, bf16, 2 "
          "replicas, DDS)")
    launches = {"ring": serve_phase(dev, layers=SERVE_LAYERS["qwen3-4b"])}

    phase("phase 5: paged serve with prefix cache (qwen3-4b full width, 18 "
        "of 36 layers, bf16, 2 replicas, DDS)")
    launches["paged"] = paged_serve_phase(dev,
                                          layers=SERVE_LAYERS["qwen3-4b"])

    phase("phase 6: serve mamba2-780m (full width, 12 of 48 layers, bf16, 2 "
        "replicas, DDS, capacity 2048)")
    launches["mamba2"] = serve_phase(
        dev, "mamba2-780m", 2048, key="serve_mamba2",
        layers=SERVE_LAYERS["mamba2-780m"])
    phase("phase 7: serve recurrentgemma-9b (full width, 9 of 38 layers, "
        "bf16, 2 replicas, DDS, capacity 4096, one prompt past the 2048 "
        "window)")
    launches["recurrentgemma"] = serve_phase(
        dev, "recurrentgemma-9b", 4096, long_prompts=(2300,),
        key="serve_recurrentgemma", layers=SERVE_LAYERS["recurrentgemma-9b"])
    phase("phase 8: chaos (minicpm-2b full width, 10 of 40 layers, head_dim "
          "64, MHA, bf16; 2 replicas, DDS): crash, hang, slow(4x), partition")
    launches["chaos"] = chaos_phase(dev)
    for name in ("decode_attention", "flash_attention", "rmsnorm"):
        if not launches["chaos"][name]:
            raise AssertionError(f"{name}: no launch on the chaos path")
    phase("phase 9: serve mixtral-8x22b (full width, 4 of 56 layers, bf16, "
        "2 replicas, DDS, capacity 8192, one prompt of 4600 tokens past "
        "the 4096 window)")
    launches["mixtral"] = serve_phase(
        dev, "mixtral-8x22b", 8192, long_prompts=(4600,),
        key="serve_mixtral", layers=SERVE_LAYERS["mixtral-8x22b"])
    phase("phase 10: paged serve with prefix cache, arctic-480b (full width, "
        "2 layers, bf16, 2 replicas, DDS)")
    launches["arctic"] = paged_serve_phase(dev, "arctic-480b",
                                           key="arctic_paged", layers=2)
    phase("phase 11: serve musicgen-medium (full width, 12 of 48 layers, "
        "bf16, 2 replicas, DDS, capacity 2048)")
    launches["musicgen"] = serve_phase(
        dev, "musicgen-medium", 2048, key="serve_musicgen",
        layers=SERVE_LAYERS["musicgen-medium"])
    phase("phase 12: llama-3.2-vision-90b generation (full width, 20 layers: "
        "16 self + 4 cross; bf16; 8 lanes, prefill with enc, 32 steps)")
    launches["vision"] = vision_phase(dev)
    phase("phase 13: train qwen3-4b (full config: 36 layers, bf16, f32 "
          "masters, remat, AdamW, cosine; 6 steps of 2 x 1024 tokens)")
    launches["train"] = train_phase(dev)
    phase("phase 14: serve qwen3-4b (full width, 9 of 36 layers, bf16) "
          "from a sharded "
          "replica (1 x 4 mesh on one card) and an unsharded one, DDS, "
          "capacity 8192, prompts to 6000 tokens")
    launches["mesh"] = mesh_serve_phase(dev)
    launches["mesh_paged"] = mesh_paged
    phase("phase 15: the sharded trainer, qwen3-4b full config (bf16, f32 "
          "masters, remat, AdamW, cosine; 6 steps of 2 x 1024 tokens) on a "
          "(1, 1) mesh of one NCCL rank; GPipe of the 36 layers over 4 "
          "stages")
    launches.update(train_sharded_phase(dev))
    phase("phase 16: the multi-pod dry run (qwen3-4b train_4k and "
          "decode_32k on a fake 16x16 world, long_500k skipped), held "
          "against a real sharded step on a world of one NCCL rank")
    dryrun_phase(dev)
    phase("phase 17: train the recurrent stacks (bf16, f32 masters, remat, "
          "AdamW, cosine; 4 steps of 2 x 1024 tokens): mamba2-780m at full "
          "config (48 layers), recurrentgemma-9b at 9 layers")
    launches.update(recurrent_train_phases(dev))
    phase("phase 18: train mixtral-8x22b (full width, 1 of 56 layers, bf16, "
          "f32 masters, remat, AdamW, cosine; 4 steps of 2 x 1024 tokens)")
    launches.update(moe_train_phase(dev))

    phase("all phases passed")
    DETAILS["phase_s"] = phase_s
    meta = {
        "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:85"),
        "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:75"),
        "rmsnorm": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:31"),
        "paged_decode_attention": (
            "cuda", "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention.py:193"),
        "ssd": ("cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                "src/repro/kernels/ssd_scan.py:73"),
        "rglru": ("cuda", "src/repro_torch/kernels/csrc/rglru_scan.cu",
                  "src/repro/kernels/rglru_scan.py:53"),
        # the backward of the TPU kernel's function (the JAX package
        # differentiates its jnp path; there is no TPU backward kernel)
        "flash_attention_bwd": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention.py:75"),
        "rmsnorm_bwd": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                        "src/repro/kernels/rmsnorm.py:31"),
        "ssd_bwd": ("cuda", "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                    "src/repro/kernels/ssd_scan.py:73"),
        "rglru_bwd": ("cuda",
                      "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
                      "src/repro/kernels/rglru_scan.py:53"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        r = rows[name]
        # a serving mesh runs the decode kernels' partials entry point (the
        # same kernel, unmerged) and the combine: counted apart, listed
        # beside
        by_path = {path: n.get(name, 0) + n.get(f"{name}_partials", 0)
                   for path, n in launches.items()}
        if not sum(by_path.values()):
            raise AssertionError(f"{name}: no launch on the main paths")
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[name], "ms": r["ms"], "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
        for extra in ("single_pass_ms", "empty_ms", "stream_ms",
                      "library_note", "d256", "prompt512", "cross1601",
                      "prompt1024",
                      "prompt2300", "one_token_ms", "one_slot_ms",
                      "read_flush_ms", "warm_ms", "fixed_ms", "issue_us",
                      "staged_ms", "pair", "add", "gated", "train_lse",
                      "f32", "flops", "bytes", "split_ms", "one_tile_ms",
                      "fwd_ckpt_ms", "fwd_ms", "softcap_ms",
                      "softcap_split_ms", "softcap_fwd_ms",
                      "cuda_core_bound_ms", "f32_route_flops"):
            if extra in r:
                kernels[-1][extra] = r[extra]
        if "mesh" in r:
            partials = {path: n[f"{name}_partials"]
                        for path, n in launches.items()
                        if n.get(f"{name}_partials")}
            if not partials:
                raise AssertionError(f"{name}: no partials launch on a mesh "
                                     "path")
            combine = {path: n["attention_combine"] for path in partials
                       for n in (launches[path],)}
            kernels[-1]["mesh"] = dict(r["mesh"], partials_launches=partials,
                                       combine_launches=combine)
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
