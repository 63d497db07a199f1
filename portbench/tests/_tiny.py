"""Cells cut to a size a CPU test can run in seconds: the configuration's
widths and the traffic's lengths shrunk, every structure kept."""
import copy
import json

from portbench import harness

WIDTHS = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=256)
# limits at these widths, set as the cells' are: above the program's
# readings on the CPU (bf16 at width 64 rounds more than at full width)
# and below its fp8 control's
LIMITS = {"mean_logit_gap_limit": 0.05,
          "loss_gap_limit": 1.2e-4, "grad_norm_gap_limit": 0.012,
          "change_gap_limit": 0.006}


def config(name: str) -> dict:
    c = dict(harness.load("configs", name), **WIDTHS)
    if c.get("num_experts"):
        c["num_experts"] = 4
    if "serve" in c:
        c["serve"] = dict(c["serve"], slots=4, capacity=256,
                          prefill_chunk_tokens=32)
    return c


def workload(name: str) -> dict:
    w = copy.deepcopy(harness.load("workloads", name))
    w["check"] = dict(w["check"], **{k: LIMITS[k] for k in w["check"]
                                     if k.endswith("_limit")})
    t = w["traffic"]
    if w["kind"] == "train":
        t.update(batch=2, seq=32)
    else:
        t.update(rate_per_s=4.0, warm=dict(requests=2, prompt=120, output=4))
        t["prompt"] = dict(t["prompt"], median=40, min=8, max=120)
        t["output"] = dict(t["output"], median=8, min=4, max=16)
    return json.loads(json.dumps(w))
