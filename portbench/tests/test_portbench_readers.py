"""Per-metric readers on runs made by hand: the chat cell's delivered
tokens count a request in flight at the close at its own cadence, its
medians count a failed request past its limit, a slice that recorded no device work
gives no device metric, and the training readers take the wall time a
step from the steps the profiler did not slow."""
import pytest

from portbench import harness, roofline
from portbench.trace import Spans

S = 1_000_000_000


class _Res:
    def __init__(self, ttft, tokens, latency):
        self.ttft_ms, self.tokens, self._lat = ttft, [1] * tokens, latency

    def latency_ms(self):
        return self._lat


class _Out:
    def __init__(self, res, ok=True, start=0.0):
        self.result, self.ok, self.start_ms = res, ok, start


def _serve_run(outs):
    w = harness.load("workloads", "mixtral-8x22b.chat")
    return harness.Run("mixtral-8x22b.chat", w, {}, "serve", outcomes=outs)


def test_median_readers_count_a_failure_past_the_limit():
    outs = [_Out(_Res(100.0, 11, 100.0 + 10 * 30.0)),
            _Out(_Res(200.0, 11, 200.0 + 10 * 40.0)),
            _Out(_Res(300.0, 11, 300.0 + 10 * 50.0)),
            _Out(_Res(0.0, 0, 0.0), ok=False, start=500.0),
            _Out(_Res(0.0, 0, 0.0), ok=False, start=900.0)]
    run = _serve_run(outs)
    run.drain_end_ms = 10_000.0
    # failures: TTFT from the due time to the drain's end; TPOT 2x the limit
    assert harness.reader("ttft_median_ms")(run) == 300.0
    assert harness.reader("tpot_median_ms")(run) == 50.0
    run.outcomes = outs[:3]
    assert harness.reader("ttft_median_ms")(run) == 200.0
    assert harness.reader("tpot_median_ms")(run) == 40.0
    assert harness.reader("ttft_median_ms")(_serve_run([])) is None


class _Done:
    def __init__(self, created, ttft, tokens, finished):
        self.created_ms, self.ttft_ms = created, ttft
        self.tokens, self.finished_ms = [1] * tokens, finished


def test_delivered_tokens_count_the_ones_before_the_close():
    outs = [_Out(_Done(0.0, 100.0, 10, 900.0)),
            # first token at 600 ms, 11 tokens by 1600: 1 + 10 * 0.4 by 1000
            _Out(_Done(500.0, 100.0, 11, 1600.0)),
            _Out(_Done(950.0, 100.0, 5, 1300.0)),
            _Out(_Done(0.0, 100.0, 7, 500.0), ok=False)]
    run = _serve_run(outs)
    run.close_ms, run.window_s = 1000.0, 2.0
    assert harness.reader("serve_tokens_per_s")(run) == \
        pytest.approx((10 + 5.0) / 2.0)


class _Slice:
    """A profiled slice as ``trace.Profile`` hands it to the readers."""

    def __init__(self, recorded, t0=10 * S, t1=13 * S, busy=1.2):
        self.recorded, self.t0, self.t1, self._busy = recorded, t0, t1, busy

    def busy_s(self):
        return self._busy

    def window_s(self):
        return (self.t1 - self.t0) / S

    def charge(self, spans, names):
        return {n: 0.1 for n in names}


@pytest.mark.parametrize("name,kind", [
    ("idle_share.serve", "serve"), ("decode_step_device_ms", "serve"),
    ("attn_roofline.serve", "serve"), ("idle_share.train", "train"),
    ("optimizer_ms", "train"), ("kernel_roofline.train", "train")])
def test_a_slice_without_device_work_gives_no_device_metric(name, kind):
    run = harness.Run("c", {}, {}, kind, spans=Spans(),
                      profile=_Slice(recorded=False))
    assert harness.reader(name)(run) is None


def _train_run():
    w = harness.load("workloads", "qwen3-4b.train")
    c = harness.load("configs", "qwen3-4b")
    spans = Spans()
    # four steps of 0.8 s before the slice, three of 1.0 s inside it
    for i in range(4):
        spans.add("train_step", i * S, i * S + 8 * S // 10)
    for i in range(3):
        spans.add("train_step", 10 * S + i * S, 11 * S + i * S)
    run = harness.Run("qwen3-4b.train", w, c, "train", spans=spans,
                      profile=_Slice(recorded=True), window_s=20.0,
                      steps=[{"loss": 1.0}] * 7)
    return run, w["traffic"], c


def test_train_readers_take_a_step_from_outside_the_slice():
    run, t, c = _train_run()
    idle = harness.reader("idle_share.train")(run)
    assert idle == pytest.approx(1.0 - 0.4 / 0.8)
    mfu = harness.reader("mfu.train")(run)
    flops = roofline.train_flops(c, t["batch"], t["seq"])
    assert mfu == pytest.approx(
        100.0 * 4 * flops / (3.2 * roofline.PEAK_BF16_FLOPS))
    run.profile = None
    assert harness.reader("mfu.train")(run) == pytest.approx(
        100.0 * 7 * flops / (20.0 * roofline.PEAK_BF16_FLOPS))
