"""The traffic generators: one seed repeats, another draws other tokens
for the same sizes at the same times; and the sweep's knee."""
import numpy as np

from portbench.tests import _tiny
from portbench.traffic import batches, requests


def _open(seed, name="mixtral-8x22b.chat", seconds=30.0):
    w = _tiny.workload(name)
    return requests.make(w["traffic"], 256, seed, seconds)


def test_open_loop_repeats_for_a_seed_and_moves_for_another():
    a, b, c = _open(2 ** 31 + 5), _open(2 ** 31 + 5), _open(2 ** 31 + 6)
    assert [x.due_s for x in a.asks] == [x.due_s for x in b.asks]
    assert all(np.array_equal(x.prompt, y.prompt)
               for x, y in zip(a.asks, b.asks))
    assert any(not np.array_equal(x.prompt, y.prompt)
               for x, y in zip(a.asks, c.asks))
    # another seed: the same work at the same times, other tokens
    assert [x.due_s for x in a.asks] == [x.due_s for x in c.asks]
    assert [len(x.prompt) for x in a.asks] == [len(x.prompt) for x in c.asks]
    assert [x.max_new_tokens for x in a.asks] == \
        [x.max_new_tokens for x in c.asks]
    assert len(a.asks) == round(4.0 * 30)
    assert a.asks[0].due_s == 0.0 and a.asks[-1].due_s < 30.0
    assert all(x.deadline_ms == 2000 + 100 * x.max_new_tokens
               for x in a.asks)


def test_lengths_are_quantiles_within_bounds():
    spec = {"dist": "lognormal", "median": 1024, "sigma": 0.7, "min": 64,
            "max": 3584}
    n = requests.lengths(spec, 101)
    assert n[50] == 1024 and n.min() >= 64 and n.max() <= 3584
    assert list(n) == sorted(n)
    u = requests.lengths({"dist": "uniform", "min": 32, "max": 256}, 4)
    assert list(u) == [60, 116, 172, 228]


def _row(rate, attain, backlog):
    return {"rate_per_s": rate, "attain": attain, "backlog": backlog}


def test_knee_needs_every_window_of_a_rate():
    from portbench import sweep
    rows = [_row(1.5, 1.0, False), _row(2.0, 0.98, False),
            _row(2.5, 0.6, True), _row(1.5, 0.97, False),
            _row(2.0, 0.85, False), _row(2.5, 0.95, False)]
    assert sweep.knee_of(rows, 0.9) == 1.5
    rows[4] = _row(2.0, 0.95, False)
    assert sweep.knee_of(rows, 0.9) == 2.0
    assert sweep.knee_of([_row(3.0, 0.2, True)], 0.9) is None


class _Res:
    def __init__(self, ttft, tokens=4, latency=None):
        self.ttft_ms, self.tokens = ttft, [1] * tokens
        self._lat = latency if latency is not None else ttft + 30 * tokens

    def latency_ms(self):
        return self._lat


class _Out:
    def __init__(self, res, start=0.0, ok=True):
        self.result, self.start_ms, self.ok = res, start, ok


class _Run:
    def __init__(self, outs):
        self.outcomes, self.drain_end_ms = outs, 10_000.0


def test_backlog_is_growth_past_half_the_ttft_limit():
    """The thirds' medians differ by the mix of prompt lengths alone at a
    low rate (236 -> 776 ms, 1.0/s); a growing queue adds seconds."""
    from portbench import sweep
    limits = {"ttft_ms": 2000, "tpot_ms": 100}
    mix = [_Out(_Res(t)) for t in [236] * 10 + [500] * 10 + [776] * 10]
    got = sweep.attainment(_Run(mix), limits)
    assert got["met"] == 30 and not got["backlog"]
    grow = [_Out(_Res(t)) for t in [1040] * 10 + [2000] * 10 + [2931] * 10]
    got = sweep.attainment(_Run(grow), limits)
    assert got["backlog"] and got["met"] == 20


def test_training_batches_repeat_and_differ():
    t = {"batch": 2, "seq": 16}
    x = batches.batch(t, 256, 2 ** 31 + 9, 0, "cpu")
    assert x.equal(batches.batch(t, 256, 2 ** 31 + 9, 0, "cpu"))
    assert not x.equal(batches.batch(t, 256, 2 ** 31 + 9, 1, "cpu"))
    assert not x[0].equal(x[1])
