"""mfu.serve: model operations of the window over (window seconds x 989
TFLOP/s).  Counted from the benchmark's spans: every decoded token of
every decode step at its position, and every prompt token a prefill chunk
computed (tokens the prefix cache restored are not computed and not
counted), each at 2 operations a weight it multiplies (an MoE layer's
active experts and router only) plus attention's 4 d a query head and
visible key, and the head for each decoded token and each chunk's last."""
from portbench import roofline as R


def read(run):
    if run.spans is None or run.kind != "serve":
        return None
    c = run.config
    lo, hi = run.window_ns
    flops = 0.0
    for s in run.spans.named("decode_step", lo, hi):
        flops += sum(R.token_flops(c, p, True) for p in s[4]["positions"])
    for s in run.spans.named("prefill_chunk", lo, hi):
        flops += R.span_flops(c, s[4]["start"], s[4]["stop"], 1)
    if flops <= 0:
        return None
    return 100.0 * flops / (run.window_s * R.PEAK_BF16_FLOPS)
