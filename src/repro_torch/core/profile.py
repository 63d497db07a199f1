"""Device / application profiling — the substrate of the paper's DDS.

The paper's key departure from prior schedulers is that placement decisions
are driven by *measured* profiles rather than analytic models:

  * Table II   — runtime vs input size (image KB)         -> size scaling
  * Table III/IV — cold-container start vs concurrency     -> cold-start cost
  * Table V/VI — warm-container runtime vs concurrency     -> contention curve
  * Fig 7      — runtime vs background CPU load            -> load factor

``AppProfile`` composes those measured curves into a single
``process_time(size, concurrency, cpu_load)`` predictor, with EWMA updates
from live observations (the paper's Update-Profile loop).

All of the paper's published measurements ship as calibration constants so
the simulator reproduces the paper's environment exactly; ``measure_profile``
builds the same tables empirically for *this* host by timing real JAX model
steps under true process-level concurrency (the TPU-fleet adaptation's
"warm executable" analogue).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------- interpolation
def _interp(xs: Sequence[float], ys: Sequence[float], x: float) -> float:
    """Piecewise-linear with linear extrapolation beyond the measured range."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if x <= xs[0]:
        if len(xs) == 1:
            return float(ys[0])
        slope = (ys[1] - ys[0]) / (xs[1] - xs[0])
        return float(ys[0] + slope * (x - xs[0]))
    if x >= xs[-1]:
        if len(xs) == 1:
            return float(ys[0])
        slope = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
        return float(ys[-1] + slope * (x - xs[-1]))
    return float(np.interp(x, xs, ys))


@dataclass
class Curve:
    """A measured 1-D curve with EWMA-updatable points.

    ``xs`` are the measured sample positions (concurrency levels, input
    sizes, lane occupancies); ``ys`` the measured values (ms).  Reads
    interpolate piecewise-linearly between points and extrapolate
    linearly beyond them; ``observe`` folds a live sample into the
    nearest measured point with weight ``ewma`` (0.25: a new sample
    moves the point a quarter of the way — the paper's Update-Profile
    smoothing).

    ``observe`` (UP-loop writers) and ``__call__``/``copy`` (predictor and
    heartbeat readers) run on different threads, so every access takes the
    curve's lock — EWMA updates can never tear an interpolation read or a
    snapshot copy.
    """

    xs: List[float]
    ys: List[float]
    ewma: float = 0.25
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def __call__(self, x: float) -> float:
        with self._lock:
            return _interp(self.xs, self.ys, x)

    def observe(self, x: float, y: float) -> None:
        """EWMA-update the nearest measured point (Update-Profile step)."""
        with self._lock:
            i = int(np.argmin(np.abs(np.asarray(self.xs) - x)))
            self.ys[i] = (1 - self.ewma) * self.ys[i] + self.ewma * y

    def copy(self) -> "Curve":
        with self._lock:
            return Curve(list(self.xs), list(self.ys), self.ewma)


# ------------------------------------------------------------------- profiles
@dataclass
class AppProfile:
    """Processing-time model for one application on one device.

    Two prediction modes share this dataclass:

    * **process-per-slot** (the paper's containers): ``contention`` maps
      concurrency -> measured average runtime (Tables V/VI), with
      ``size_curve``/``load_curve`` multiplicative corrections relative
      to ``base_ms`` at ``reference_size``.
    * **lane mode** (batched serving replicas, ``lane_mode`` True):
      ``step_curve`` maps lane occupancy -> measured batched
      ``decode_step`` wall-clock, ``tokens_per_task`` is the reference
      decode length the size curve was built with, and
      ``prefill_chunk_ms``/``prefill_chunk_tokens`` carry the measured
      chunked-prefill interleave cost.  A joining task is then priced as
      its prefill plus ``tokens_per_task`` steps at the post-join
      occupancy's cadence — strongly sub-linear, because lanes share
      each step's weight streaming.

    All curves are EWMA-updated from live observations
    (``observe_runtime`` / ``observe_step`` / ``observe_prefill_chunk``
    — the paper's Update-Profile loop) and snapshotted per heartbeat via
    ``copy``.
    """

    app_id: str
    base_ms: float                       # 1 warm slot, idle, reference size
    contention: Curve                    # concurrency -> avg runtime (ms)
    size_curve: Optional[Curve] = None   # input size -> runtime (ms) @ n=1
    load_curve: Optional[Curve] = None   # cpu load [0,1] -> runtime (ms) @ n=1
    cold_start: Optional[Curve] = None   # concurrency -> cold container start (ms)
    reference_size: float = 29.0         # size units of base_ms
    # --- lane-occupancy mode (batched serving replicas) -----------------
    # Batched decode lanes share each step's weight streaming, so joining a
    # batch at occupancy n costs the *measured* step cadence at n — strongly
    # sub-linear — not a full process-per-slot contended runtime.
    step_curve: Optional[Curve] = None   # lane occupancy -> decode-step wall (ms)
    tokens_per_task: float = 0.0         # reference decode length (steps/task)
    prefill_chunk_ms: float = 0.0        # chunked-prefill interleave cost (ms)
    prefill_chunk_tokens: float = 0.0    # tokens per interleaved chunk (0 = whole-prompt)
    # --- paged-KV telemetry (published per heartbeat by paged replicas) --
    # prefix_hit_rate discounts the interleave charge for joins whose
    # prompt prefix is already resident (prefilled once, shared via the
    # replica's prefix cache); free_pages is admission headroom (free +
    # immediately reclaimable KV pages; -1.0 = replica is not paged).
    prefix_hit_rate: float = 0.0         # fraction of lookups hitting >= 1 block
    free_pages: float = -1.0             # free + reclaimable KV pages (-1 = unpaged)
    # guards the prefill_chunk_ms fit's read-modify-write (same UP-writer
    # vs heartbeat-copier pattern the Curve lock covers); bare reads of the
    # float stay lock-free
    _pc_lock: threading.Lock = field(default_factory=threading.Lock,
                                     repr=False, compare=False)
    # exponentially weighted sums (weight, Σw, Σw², Σms, Σw·ms) over the
    # chunk samples (width w, time ms) that ``observe_prefill_chunk`` fits
    _pc_sums: List[float] = field(default_factory=lambda: [0.0] * 5,
                                  repr=False, compare=False)

    @property
    def lane_mode(self) -> bool:
        """True when this profile models a batched-lane replica: predictions
        use the measured per-occupancy step curve instead of the
        process-per-slot contention curve."""
        return self.step_curve is not None and self.tokens_per_task > 0

    def prefill_ms(self, size: float | None) -> float:
        """Lane mode: the prompt-length-dependent prefill component, i.e.
        the measured end-to-end runtime minus the decode steps it includes."""
        if self.size_curve is None:
            return 0.0
        s = self.reference_size if size is None else size
        decode = self.tokens_per_task * (self.step_curve(1.0)
                                         if self.step_curve else 0.0)
        return max(self.size_curve(s) - decode, 0.0)

    def process_time(self, size: float | None = None, concurrency: int = 1,
                     cpu_load: float = 0.0) -> float:
        """Predicted runtime (ms) of one task.

        Composition: contention supplies the concurrency scaling, size and
        load curves supply multiplicative corrections relative to base.  In
        lane mode the task instead pays its prefill plus ``tokens_per_task``
        decode steps at the measured step cadence for that occupancy.
        """
        conc = max(concurrency, 1)
        if self.lane_mode:
            t = self.prefill_ms(size) + self.tokens_per_task * self.step_curve(conc)
        else:
            t = self.contention(conc)
            if size is not None and self.size_curve is not None:
                t *= self.size_curve(size) / self.size_curve(self.reference_size)
        if cpu_load > 0.0 and self.load_curve is not None:
            t *= self.load_curve(cpu_load) / self.load_curve(0.0)
        return t

    def cold_start_time(self, concurrency: int = 1) -> float:
        if self.cold_start is None:
            return 0.0
        return self.cold_start(max(concurrency, 1))

    def observe_runtime(self, runtime_ms: float, concurrency: int,
                        size: float | None = None, cpu_load: float = 0.0) -> None:
        """Feed a live observation back into the contention curve (UP loop).
        Corrections for size/load are divided out so the curve stays in
        reference units."""
        t = runtime_ms
        if size is not None and self.size_curve is not None:
            t /= self.size_curve(size) / self.size_curve(self.reference_size)
        if cpu_load > 0.0 and self.load_curve is not None:
            t /= self.load_curve(cpu_load) / self.load_curve(0.0)
        self.contention.observe(concurrency, t)

    def observe_step(self, occupancy: int, step_ms: float) -> None:
        """Lane-mode UP loop: feed one measured (occupancy, decode-step
        wall-clock) sample back into the step curve."""
        if self.step_curve is not None:
            self.step_curve.observe(float(max(occupancy, 1)), step_ms)

    # shrinks the fitted per-token slope toward 0 (a chunk cost that does
    # not grow with the width) while the samples' widths barely vary (token²)
    PREFILL_FIT_RIDGE = 1.0

    def observe_prefill_chunk(self, ms: float, ewma: float = 0.25,
                              tokens: Optional[int] = None) -> None:
        """Lane-mode UP loop: fold one chunk's time into the chunk cost.

        A chunk of ``tokens`` prompt tokens costs a fixed part (launches,
        streaming the weights) plus a part per token; on the card the
        fixed part dominates, on the CPU the per-token one.  So every
        sample, whatever its width, feeds a least-squares fit of
        ``ms = fixed + per_token * tokens`` in which each sample weighs
        ``ewma`` against the earlier ones' ``1 - ewma``.
        ``prefill_chunk_ms`` becomes the fit at the reference width
        (``prefill_chunk_tokens``): it stays "ms per reference chunk", and
        a narrow chunk is never scaled up to that width.  While the widths
        seen barely vary, the ridge holds the slope near 0, so the fit
        does not extrapolate from one width: a cost it underestimates so
        widens the SLO budget's chunks until their widths tell the two
        parts apart.  The cost measured before the first sample (the
        warmup's) stands until that sample."""
        ref = self.prefill_chunk_tokens
        w = float(tokens) if tokens and ref > 0 else ref
        with self._pc_lock:
            sums = self._pc_sums
            k = ewma if sums[0] > 0.0 else 1.0
            sums[:] = [(1 - k) * v for v in sums]
            for i, v in enumerate((1.0, w, w * w, ms, w * ms)):
                sums[i] += k * v
            n, sw, sww, sy, swy = sums
            mw, my = sw / n, sy / n
            var = max(sww / n - mw * mw, 0.0)
            slope = max((swy / n - mw * my) / (var + self.PREFILL_FIT_RIDGE),
                        0.0)
            fixed = my - slope * mw
            if fixed < 0.0:
                # a cost through the origin: all per-token
                fixed, slope = 0.0, swy / sww
            self.prefill_chunk_ms = fixed + slope * ref

    def prefill_ms_per_token(self) -> float:
        """Measured chunked-prefill cost per prompt token (0.0 when the
        replica has no chunk measurement, e.g. whole-prompt fallback).
        This is the rate the serving engine's SLO budget divides into its
        per-step slack, and the rate ``interleave_ms`` charges with."""
        if self.prefill_chunk_ms <= 0.0 or self.prefill_chunk_tokens <= 0.0:
            return 0.0
        return self.prefill_chunk_ms / self.prefill_chunk_tokens

    def interleave_ms(self, prompt_tokens: float) -> float:
        """Chunked-prefill interleave charge for one L-token prompt,
        derived from the same measured per-token rate the SLO budget
        uses: L x (chunk_ms / chunk_tokens).  Chunks are exact (never
        padded), so the charge is linear in L — no ceil-to-chunk
        rounding.  Whole-prompt-fallback profiles
        (``prefill_chunk_tokens == 0``) charge one monolithic stall."""
        if self.prefill_chunk_ms <= 0.0:
            return 0.0
        if self.prefill_chunk_tokens <= 0.0:
            return self.prefill_chunk_ms
        return max(prompt_tokens, 1.0) * self.prefill_ms_per_token()

    def copy(self) -> "AppProfile":
        return AppProfile(
            self.app_id, self.base_ms, self.contention.copy(),
            self.size_curve.copy() if self.size_curve else None,
            self.load_curve.copy() if self.load_curve else None,
            self.cold_start.copy() if self.cold_start else None,
            self.reference_size,
            self.step_curve.copy() if self.step_curve else None,
            self.tokens_per_task, self.prefill_chunk_ms,
            self.prefill_chunk_tokens, self.prefix_hit_rate,
            self.free_pages)


@dataclass
class LinkProfile:
    """Network link to a peer: bandwidth + latency + loss (paper: WiFi/UDP)."""

    bandwidth_kbps: float = 6_000.0      # ~6 MB/s WiFi
    rtt_ms: float = 4.0
    loss_prob: float = 0.0

    def transfer_time(self, size_kb: float) -> float:
        return self.rtt_ms / 2.0 + size_kb / self.bandwidth_kbps * 1_000.0


@dataclass
class DeviceProfile:
    """Everything the coordinator's Maintain-Profile table stores per device."""

    device_id: str
    slots: int                           # warm containers / execution lanes
    apps: Dict[str, AppProfile]
    link: LinkProfile = field(default_factory=LinkProfile)
    cpu_load: float = 0.0                # background load [0, 1]

    def app(self, app_id: str) -> AppProfile:
        return self.apps[app_id]

    def copy(self) -> "DeviceProfile":
        return DeviceProfile(
            self.device_id, self.slots,
            {k: v.copy() for k, v in self.apps.items()},
            dataclasses.replace(self.link), self.cpu_load)


# ==================================================================== PAPER
# Calibration constants: the paper's own measurements, verbatim.
FACE = "face_detection"

# Table II — edge server, runtime vs image size (KB)
PAPER_SIZE_KB = [29.0, 87.0, 133.0, 172.0, 259.0]
PAPER_SIZE_MS = [223.0, 417.0, 615.0, 798.0, 1163.0]

# Table V — warm containers on the edge server (avg ms per image)
PAPER_EDGE_WARM_N = [1, 2, 3, 4, 5, 6, 7, 8]
PAPER_EDGE_WARM_MS = [223.0, 273.0, 366.0, 464.0, 540.0, 644.0, 837.0, 947.0]

# Table VI — warm containers on the Raspberry Pi
PAPER_RPI_WARM_N = [1, 2, 3, 4, 5, 6]
PAPER_RPI_WARM_MS = [597.0, 613.0, 651.0, 860.0, 1071.0, 1290.0]

# Table III — cold containers on the edge server (new-container start, ms)
PAPER_EDGE_COLD_N = [1, 3, 5, 8, 11]
PAPER_EDGE_COLD_MS = [52554.0, 71788.0, 106596.0, 165717.0, 437846.0]

# Table IV — cold containers on the Raspberry Pi
PAPER_RPI_COLD_N = [1, 2, 3, 4, 5, 6]
PAPER_RPI_COLD_MS = [168279.0, 179280.0, 188633.0, 211136.0, 241222.0, 249413.0]

# Fig 7 — edge-server runtime vs CPU load (fractions 0..1)
PAPER_LOAD_FRAC = [0.0, 0.25, 0.50, 0.75, 1.0]
PAPER_LOAD_MS = [223.0, 284.0, 312.0, 350.0, 374.0]


def paper_edge_server(slots: int = 8) -> DeviceProfile:
    prof = AppProfile(
        app_id=FACE,
        base_ms=PAPER_EDGE_WARM_MS[0],
        contention=Curve(list(map(float, PAPER_EDGE_WARM_N)),
                         list(PAPER_EDGE_WARM_MS)),
        size_curve=Curve(list(PAPER_SIZE_KB), list(PAPER_SIZE_MS)),
        load_curve=Curve(list(PAPER_LOAD_FRAC), list(PAPER_LOAD_MS)),
        cold_start=Curve(list(map(float, PAPER_EDGE_COLD_N)),
                         list(PAPER_EDGE_COLD_MS)),
    )
    return DeviceProfile("edge_server", slots, {FACE: prof},
                         LinkProfile(bandwidth_kbps=6000.0, rtt_ms=4.0))


def paper_raspberry_pi(name: str = "rasp1", slots: int = 4) -> DeviceProfile:
    # RPi size/load scaling assumed proportional to the edge server's
    # (the paper only measured those curves on the edge server).
    prof = AppProfile(
        app_id=FACE,
        base_ms=PAPER_RPI_WARM_MS[0],
        contention=Curve(list(map(float, PAPER_RPI_WARM_N)),
                         list(PAPER_RPI_WARM_MS)),
        size_curve=Curve(list(PAPER_SIZE_KB), list(PAPER_SIZE_MS)),
        load_curve=Curve(list(PAPER_LOAD_FRAC), list(PAPER_LOAD_MS)),
        cold_start=Curve(list(map(float, PAPER_RPI_COLD_N)),
                         list(PAPER_RPI_COLD_MS)),
    )
    return DeviceProfile(name, slots, {FACE: prof},
                         LinkProfile(bandwidth_kbps=6000.0, rtt_ms=4.0))


# ============================================================ live measurement
def measure_profile(app_id: str, step_fn, sizes: Sequence[int],
                    concurrencies: Sequence[int] = (1, 2, 3, 4),
                    reps: int = 3) -> AppProfile:
    """Build an AppProfile by timing a real callable on this host.

    ``step_fn(size) -> None`` runs one task (e.g. a jitted model step on
    ``size`` tokens).  Concurrency contention is measured with threads —
    on this 1-core container that reproduces exactly the paper's
    many-containers-per-core regime.
    """
    import concurrent.futures as cf

    def time_one(size: int) -> float:
        t0 = time.perf_counter()
        step_fn(size)
        return (time.perf_counter() - t0) * 1e3

    ref_size = sizes[len(sizes) // 2]
    step_fn(ref_size)  # warm (compile) — cold-start analogue, excluded

    size_ms = [min(time_one(s) for _ in range(reps)) for s in sizes]

    # Contention (Table V/VI semantics): *average per-task* runtime at
    # concurrency n — each task times its own start->finish inside the pool
    # (batch wall-clock over-counts whenever tasks serialize unevenly).
    # Best-of-reps like the size curve, then clamp out timer jitter: true
    # contention cannot make concurrent execution faster than less-loaded.
    concurrencies = sorted(concurrencies)
    conc_ms = []
    for n in concurrencies:
        per_rep = []
        for _ in range(reps):
            with cf.ThreadPoolExecutor(max_workers=n) as ex:
                per_task = list(ex.map(lambda _: time_one(ref_size), range(n)))
            per_rep.append(sum(per_task) / n)
        conc_ms.append(min(per_rep))
    raw = list(conc_ms)
    conc_ms = [float(v) for v in np.maximum.accumulate(conc_ms)]
    # the raw measurements must be monotone up to timer jitter — a point
    # the clamp had to lift by more than 2x means the workload itself is
    # not contention-shaped (e.g. step_fn caches across calls), and the
    # curve would be fiction, not measurement
    assert all(r >= 0.5 * c for r, c in zip(raw, conc_ms)), \
        f"measured contention grossly non-monotone in n: raw={raw}"

    base = conc_ms[0]
    return AppProfile(
        app_id=app_id,
        base_ms=base,
        contention=Curve([float(n) for n in concurrencies], conc_ms),
        size_curve=Curve([float(s) for s in sizes], size_ms),
        reference_size=float(ref_size),
    )
