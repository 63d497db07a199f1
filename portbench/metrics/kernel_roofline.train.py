"""kernel_roofline.train: the training step's attention and norm kernels
(flash forward and backward, the norm forms forward and backward) against
their roofline over the profiled slice: the sum of each launch's bound
over those kernels' device seconds.

Forward launches are counted from the benchmark's records of each call
(remat's recompute included: it launches again); a backward launch per
the program's backward counters, flash's at the training shape of the
forward calls (10 d operations a causal pair and query head), a norm
backward at the mean size of the forward norm calls,
reading x and the incoming gradient and writing the input's gradient."""
from portbench import roofline as R

CLASSES = {"flash_attention", "flash_attention_bwd", "rmsnorm",
           "rmsnorm_bwd"}
NORMS = ("rmsnorm", "rmsnorm_pair", "add_rmsnorm")


def _flash(rec, bwd=False):
    b, s, hq, d = rec["q"]
    pairs = b * R.causal_pairs(s, rec["window"])
    fn = R.attention_bwd_work if bwd else R.attention_work
    work = fn(pairs, b * s, b * s, hq, rec["hkv"], d)
    return R.bound_s(work["bytes"], work["flops"])


def _norm(rec, bwd=False):
    add = rec["op"] == "add_rmsnorm"
    work = R.norm_work(rec["rows"], rec["width"],
                       reads=2 if (add or bwd) else 1,
                       writes=1 if bwd else (2 if add else 1),
                       elt=rec["elt"])
    return R.bound_s(work["bytes"], work["flops"], R.PEAK_F32_FLOPS)


def read(run):
    p = run.profile
    if p is None or not p.recorded or run.kind != "train":
        return None
    recs = run.hooks.launches
    flash = [r for r in recs if r["op"] == "flash_attention"]
    norms = [r for r in recs if r["op"] in NORMS]
    spent = p.class_s(CLASSES)
    if not flash or spent <= 0:
        return None
    total = sum(_flash(r) for r in flash) + sum(_norm(r) for r in norms)
    delta = run.hooks.launches_delta
    total += delta.get("flash_attention_bwd", 0) * _flash(flash[0], True)
    if norms:
        elems = sum(r["rows"] * r["width"] for r in norms) / len(norms)
        mean = dict(op="rmsnorm", rows=elems, width=1, elt=norms[0]["elt"])
        total += delta.get("rmsnorm_bwd", 0) * _norm(mean, True)
    return 100.0 * total / spent
