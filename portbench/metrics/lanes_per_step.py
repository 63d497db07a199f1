"""lanes_per_step: tokens the decode steps generated over the decode steps,
in the window (the benchmark's span around ``Replica._decode_step`` counts
each step's active lanes)."""


def read(run):
    if run.spans is None:
        return None
    lo, hi = run.window_ns
    steps = run.spans.named("decode_step", lo, hi)
    if not steps:
        return None
    return sum(len(s[4]["positions"]) for s in steps) / len(steps)
