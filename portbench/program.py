"""The system under test, reached through its entry points: the model
configuration, a ``Model`` whose tensors the benchmark fills from the seed,
the serving fleet, the train step, and the program's counters.

Only this module, the runners and the trace hooks import ``repro_torch``;
the reference imports none of it.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench import weights as W

# configuration keys that are sizes of the model (the rest of a config file
# is the deployment, the serving and training settings and their notes)
MODEL_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size", "num_experts",
              "num_experts_per_tok", "moe_capacity_factor", "use_qk_norm",
              "rope_theta", "sliding_window", "tie_embeddings", "norm_eps",
              "max_seq_len")


def model_config(c: dict):
    """The program's ``ModelConfig``: its registered arch with every size
    the file states, so the run is of the file's configuration."""
    from repro_torch.configs import get_config
    sizes = {k: c[k] for k in MODEL_KEYS if k in c}
    return get_config(c["arch"]).replace(**sizes)


def _targets(model, group: str) -> Dict[str, torch.Tensor]:
    """The program's tensors for one weight group, by the benchmark's leaf
    names (the program's layouts hold the same elements in the same
    order: (d, H, hd) for an (d, H*hd) projection, (H, hd, d) for wo)."""
    if group == "embed":
        out = {"embed": model.embed, "final_norm": model.final_norm}
        if model.head is not None:
            out["head"] = model.head
        return {k: v.data for k, v in out.items()}
    blk = model.layers[int(group[len("layer"):])]
    out = {"norm1": blk.norm1, "norm2": blk.norm2}
    out.update((k, blk.attn[k]) for k in ("wq", "wk", "wv", "wo", "q_norm",
                                          "k_norm") if k in blk.attn)
    src = blk.moe if blk.moe is not None else blk.mlp
    for k in ("router", "w_gate", "w_up", "w_down"):
        if blk.moe is not None or k != "router":
            out[k] = src[k]
    return {k: v.data for k, v in out.items()}


@torch.no_grad()
def build_model(c: dict, cfg, seed: int, device):
    """A ``Model`` of ``cfg`` on ``device`` holding the benchmark's weights
    for ``seed`` (drawn into its own tensors, group by group)."""
    from repro_torch.models.model import Model
    model = Model(cfg, device)
    for name, leaves in W.groups(c):
        W.fill_group(seed, name, leaves, _targets(model, name))
    return model


def build_kernels(names) -> None:
    """Build (or find built, in the checkout's ``build/kernels``) the CUDA
    sources a cell launches, all at once."""
    from repro_torch.kernels import build
    build.build_all(names)


def build_fleet(c: dict, cfg, model):
    """A DDS-routed ``ServingFleet`` of the config's replicas sharing
    ``model``, as ``repro_torch.launch.serve.build_fleet`` builds one, with
    the benchmark's weights in place of the ones that function draws."""
    from repro_torch.core.policies import make_policy
    from repro_torch.serving.engine import Replica, ServingFleet
    s = c["serve"]
    n = s["replicas"]
    fleet = ServingFleet(make_policy(s["policy"]), source="replica0",
                         coordinator="replica1" if n > 1 else "replica0",
                         admission_margin=0.0)
    for i in range(n):
        rep = Replica(f"replica{i}", cfg, model, slots=s["slots"],
                      capacity=s["capacity"],
                      prefill_chunk_tokens=s["prefill_chunk_tokens"],
                      paged=s.get("paged", False),
                      page_size=s.get("page_size", 16),
                      num_pages=s.get("num_pages"),
                      prefix_cache=s.get("prefix_cache", False))
        fleet.add_replica(rep)
    return fleet


def request(i: int, prompt, max_new_tokens: int, deadline_ms: float,
            created_ms: float):
    from repro_torch.serving.engine import Request
    return Request(i, prompt, int(max_new_tokens), float(deadline_ms),
                   created_ms=float(created_ms))


def counters(fleet) -> Dict[str, int]:
    """The replicas' counters, summed, and the fleet's outcome counts."""
    keys = ("decode_steps", "prefill_chunks", "whole_prefills",
            "prefilled_tokens", "cow_copies")
    out = {k: sum(getattr(r, k) for r in fleet.replicas.values())
           for k in keys}
    out.update(lost=fleet.lost, shed=fleet.shed, rejected=fleet.rejected)
    return out


def leaf_names(c: dict, model) -> Dict[str, str]:
    """``<group>.<leaf>`` (the benchmark's names) -> the program's
    parameter name holding it."""
    by_ptr = {p.data_ptr(): n for n, p in model.named_parameters()}
    return {f"{g}.{k}": by_ptr[t.data_ptr()]
            for g, _ in W.groups(c) for k, t in _targets(model, g).items()}


def train_config(c: dict, **over):
    """The program's ``TrainConfig`` from the config file's ``train``."""
    from repro_torch.common.config import TrainConfig
    t = c["train"]
    return TrainConfig(learning_rate=t["learning_rate"],
                       weight_decay=t["weight_decay"],
                       grad_clip=t["grad_clip"],
                       warmup_steps=t["warmup_steps"],
                       total_steps=10 ** 9, schedule=t["schedule"], **over)


def train_step(cfg, tc):
    """``(state, batch) -> (state, metrics)``: the program's train step."""
    from repro_torch.training.steps import make_train_step
    return make_train_step(cfg, tc)


def train_state(model, tc):
    """The program's train state (AdamW with f32 masters) around
    ``model``, as ``init_train_state`` builds it around its own draw."""
    from repro_torch.training.steps import train_state as make
    return make(model, tc)
