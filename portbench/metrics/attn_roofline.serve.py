"""attn_roofline.serve: the serving attention kernels' share of their
roofline over the profiled slice: the sum over the slice's launches of
flash (chunked prefill), ring decode and paged decode of each launch's
bound (``roofline.bound_s`` of the keys its inputs make visible), over
the device seconds of those kernels (their split-combine kernel too)."""
import torch

from portbench import roofline as R

CLASSES = {"flash_attention", "decode_attention", "paged_decode_attention",
           "combine"}


def _visible_flash(rec):
    """(pairs, key rows read) of one flash launch."""
    b, s, hq, d = rec["q"]
    w = rec["window"]
    qp = rec["q_pos"].reshape(-1, s)[0].long()
    kp = rec["k_pos"].reshape(-1, rec["k"][1])[0].long()

    def vis(keys):
        m = (keys[None, :] >= 0) & (keys[None, :] <= qp[:, None])
        if w:
            m &= keys[None, :] > qp[:, None] - w
        return m

    m = vis(kp)
    pairs, rows = float(m.sum()) * b, float(m.any(0).sum()) * b
    if rec["cache_pos"] is not None:
        for cp in rec["cache_pos"].reshape(-1, rec["cache_pos"].shape[-1]):
            mr = vis(cp.long())
            pairs += float(mr.sum())
            rows += float(mr.any(0).sum())
    return pairs, rows


def _visible_decode(rec):
    cl = rec["cache_len"].long().reshape(-1, 1)
    w = rec["window"]
    if rec.get("pos") is not None:
        pos = rec["pos"].long()
        m = (pos >= 0) & (pos < cl)
        if w:
            m &= pos > cl - 1 - w
        return float(m.sum())
    tab, page = rec["tables"].long(), rec["page"]
    j = torch.arange(tab.shape[1] * page, device=cl.device)
    m = (j[None, :] < cl) & (tab[:, j // page] >= 0)
    if w:
        m &= j[None, :] > cl - 1 - w
    return float(m.sum())


def bound_s(rec) -> float:
    b, s, hq, d = rec["q"]
    if rec["op"] == "flash_attention":
        pairs, rows = _visible_flash(rec)
        work = R.attention_work(pairs, b * s, rows, hq, rec["hkv"], d)
    else:
        vis = _visible_decode(rec)
        work = R.attention_work(vis, b, vis, hq, rec["hkv"], d)
    return R.bound_s(work["bytes"], work["flops"])


def read(run):
    p = run.profile
    if p is None or not p.recorded or run.kind != "serve":
        return None
    recs = [r for r in run.hooks.launches if r["op"] in (
        "flash_attention", "decode_attention", "paged_decode_attention")]
    spent = p.class_s(CLASSES)
    if not recs or spent <= 0:
        return None
    return 100.0 * sum(bound_s(r) for r in recs) / spent
