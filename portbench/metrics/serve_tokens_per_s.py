"""serve_tokens_per_s: output tokens the window delivered, over its
seconds: every token of the requests that finished ``ok`` within it, and
of the ``ok`` requests still running at its close the tokens delivered
before the close, at each one's own cadence between its first token and
its last (a request still waiting for its first token delivered none)."""


def delivered(o, close_ms: float) -> float:
    res = o.result
    if not o.ok:
        return 0.0
    n = len(res.tokens)
    if res.finished_ms <= close_ms:
        return float(n)
    first = res.created_ms + res.ttft_ms
    if first >= close_ms or res.ttft_ms <= 0:
        return 0.0
    return 1.0 + (n - 1) * (close_ms - first) / (res.finished_ms - first)


def read(run):
    if run.kind != "serve":
        return None
    return sum(delivered(o, run.close_ms) for o in run.outcomes) \
        / run.window_s
