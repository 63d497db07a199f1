"""The autograd wiring the card runs, exercised on the CPU.

On the card a kernel writes its output through ctypes, so the output has
no autograd graph; ``kernels/ops.py`` routes a call whose inputs need a
gradient through the kernel's ``torch.autograd.Function`` (forward
kernel, then backward kernel).  Here ``ops._route`` is made to take the
card's route for CPU tensors and each Function's launchers are replaced by
the plain forward (run inside the Function, so graph-less, as the
kernel's output is) and the plain backward (``*_bwd_plain``).  Then:

  * each Function's gradients (q, k, v, also at head_dim 256 and with a
    softcap; x, y and
    the gains, both outputs of the pair and the add; the gated norm's y, z
    and gain; ``ssd``'s x, dt, a_log, B, C and d_skip; ``rglru``'s x,
    log_a and gate) equal autograd through the plain forward, to 1e-5
    (f32: the plain backward is another order of the same sums);
  * the detach fault: with the launch taken directly whatever the grad
    mode (the routing before the Functions), the attention branch and the
    residual stream are cut and ``wq`` gets no gradient; with the Functions
    every parameter gets a nonzero one;
  * the kernels with no backward (the decode kernels; flash with a ring)
    raise ``NotImplementedError`` under grad instead of returning a
    detached output, and ``ssd``, ``rglru``, the gated norm and flash with
    a softcap no longer do;
  * a smoke-config train step of qwen3-4b, mamba2-780m,
    recurrentgemma-9b and mixtral-8x22b (MoE: no kernel of its own, its
    attention and norms through theirs) launches each kernel as often as
    ``chip_smoke.expected_train_launches`` holds the card to, with and
    without remat.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rmsnorm as rk
from repro_torch.kernels import ssd_scan as sk
from repro_torch.training import steps as tsteps

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

# launcher name in its module -> its plain twin
FLASH = {"flash_attention": lambda *a, splits=None, **k:
         fk.flash_attention_plain(*a, **k),
         "flash_attention_bwd": fk.flash_attention_bwd_plain}
NORM = {"rmsnorm": rk.rmsnorm_plain, "rmsnorm_pair": rk.rmsnorm_pair_plain,
        "add_rmsnorm": rk.add_rmsnorm_plain,
        "rmsnorm_bwd": rk.rmsnorm_bwd_plain,
        "rmsnorm_pair_bwd": rk.rmsnorm_pair_bwd_plain,
        "add_rmsnorm_bwd": rk.add_rmsnorm_bwd_plain,
        "gated_rmsnorm": rk.gated_rmsnorm_plain,
        "gated_rmsnorm_bwd": rk.gated_rmsnorm_bwd_plain}
SSD = {"ssd": lambda *a, **k: sk.ssd_plain(*a, **k),
       "ssd_bwd": sk.ssd_bwd_plain}
RGLRU = {"rglru": lambda *a, staged=None, checkpoint=False: (
    (rg.rglru_plain(*a), rg.rglru_checkpoint_plain(*a, staged))
    if checkpoint else rg.rglru_plain(*a)),
         "rglru_bwd": lambda *a, staged=None, ckpt=None:
         rg.rglru_bwd_plain(*a)}


def _fake_card(monkeypatch, calls=None):
    """CPU tensors take the card's route; the launchers are their plain
    twins, run without a graph as the ctypes launches are, and counted in
    ``calls`` by launcher name."""
    monkeypatch.setattr(ops, "_route", lambda t: True)
    for mod, table in ((fk, FLASH), (rk, NORM), (sk, SSD), (rg, RGLRU)):
        for name, plain in table.items():
            def launcher(*a, _plain=plain, _name=name, **k):
                if calls is not None:
                    calls[_name] = calls.get(_name, 0) + 1
                with torch.no_grad():
                    return _plain(*a, **k)
            monkeypatch.setattr(mod, name, launcher)


def _leaf(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).requires_grad_(True)


def _grads_of(fn, inputs, weights):
    """Gradients of sum(out_i * w_i) with respect to ``inputs``."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * w).sum() for o, w in zip(outs, weights))
    return torch.autograd.grad(loss, inputs)


CASES = ["flash", "flash_gqa_window", "norm", "pair", "add", "flash_d256",
         "gated", "ssd", "ssd_no_skip", "rglru", "flash_softcap"]


def _case(name, rng):
    """(fn through ops, the same through the plain forward, inputs,
    output weights)."""
    if name.startswith("flash"):
        rep, window = (4, 5) if name == "flash_gqa_window" else (1, 0)
        b, s, hkv, d = 2, 9, 2, 64
        if name == "flash_d256":          # recurrentgemma-9b: MQA at D 256
            rep, window, hkv, d = 4, 5, 1, 256
        # a cap that bites at these logits (|q.k| * scale up to ~3)
        cap = 1.5 if name == "flash_softcap" else 0.0
        if cap:
            rep, window = 2, 4
        pos = torch.arange(s, dtype=torch.int32)
        kw = dict(q_pos=pos, k_pos=pos, causal=True, window=window,
                  scale=d ** -0.5, softcap=cap)
        inputs = [_leaf(rng, (b, s, hkv * rep, d)), _leaf(rng, (b, s, hkv, d)),
                  _leaf(rng, (b, s, hkv, d))]
        weights = [torch.from_numpy(rng.standard_normal((b, s, hkv * rep, d))
                                    .astype(np.float32))]
        return (lambda q, k, v: ops.flash_attention(q, k, v, **kw),
                lambda q, k, v: fk.flash_attention_plain(q, k, v, **kw),
                inputs, weights)
    if name.startswith("ssd"):
        b, s, h, p, n = 2, 12, 3, 4, 8
        x, bm, cm = (_leaf(rng, (b, s, h, p)), _leaf(rng, (b, s, n)),
                     _leaf(rng, (b, s, n)))
        dt = torch.from_numpy((rng.random((b, s, h)) * 0.4 + 0.05)
                              .astype(np.float32)).requires_grad_(True)
        a_log = _leaf(rng, (h,), 0.5)
        ins = [x, dt, a_log, bm, cm]
        if name == "ssd":
            ins.append(_leaf(rng, (h,)))
        w = [torch.from_numpy(rng.standard_normal((b, s, h, p))
                              .astype(np.float32))]
        skip = (lambda a: a[5] if len(a) > 5 else None)
        return ((lambda *a: ops.ssd(*a[:5], skip(a), chunk=4)),
                (lambda *a: sk.ssd_plain(*a[:5], skip(a), chunk=4)), ins, w)
    if name == "rglru":
        shape = (2, 20, 6)
        la = torch.from_numpy((-np.abs(rng.standard_normal(shape)) * 0.3)
                              .astype(np.float32)).requires_grad_(True)
        g = torch.from_numpy(rng.random(shape).astype(np.float32)
                             ).requires_grad_(True)
        w = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))]
        return (ops.rglru, rg.rglru_plain, [_leaf(rng, shape), la, g], w)
    shape, d = (3, 4, 64), 64
    x, y = _leaf(rng, shape), _leaf(rng, shape, 0.5)
    g0, g1 = _leaf(rng, (d,), 0.1), _leaf(rng, (d,), 0.1)
    w = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         for _ in range(2)]
    if name == "norm":
        return ((lambda x, g: ops.rmsnorm(x, g)),
                (lambda x, g: rk.rmsnorm_plain(x, g)), [x, g0], w[:1])
    if name == "gated":
        return ((lambda a, b, s0: ops.gated_rmsnorm(a, b, s0)),
                (lambda a, b, s0: rk.gated_rmsnorm_plain(a, b, s0)),
                [x, y, g0], w[:1])
    if name == "pair":
        y2 = _leaf(rng, (3, 2, 64))
        w[1] = torch.from_numpy(rng.standard_normal((3, 2, 64))
                                .astype(np.float32))
        return ((lambda a, b, s0, s1: ops.rmsnorm_pair(a, b, s0, s1)),
                (lambda a, b, s0, s1: rk.rmsnorm_pair_plain(a, b, s0, s1)),
                [x, y2, g0, g1], w)
    return ((lambda a, b, s0: ops.add_rmsnorm(a, b, s0)),
            (lambda a, b, s0: rk.add_rmsnorm_plain(a, b, s0)),
            [x, y, g0], w)


@pytest.mark.parametrize("name", CASES)
def test_functions_match_autograd_of_the_plain_forward(monkeypatch, name):
    rng = np.random.default_rng(CASES.index(name))
    routed, plain, inputs, weights = _case(name, rng)
    want = _grads_of(plain, inputs, weights)
    calls = {}
    _fake_card(monkeypatch, calls)
    got = _grads_of(routed, inputs, weights)
    assert any(k.endswith("_bwd") for k in calls), calls
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def _cfg():
    """qwen3-4b's smoke config at a head_dim the backward kernel takes."""
    return get_smoke_config("qwen3-4b").replace(dtype=torch.float32,
                                                head_dim=64)


def _batch(cfg, b=2, s=16):
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(b, s))
    return {"tokens": toks, "labels": toks, "mask": np.ones((b, s),
                                                            np.float32)}


def _loss_grads(cfg):
    model = tsteps.init_train_state(cfg, 0, "cpu")["model"]
    loss, _ = tsteps.make_loss_fn(cfg, TrainConfig())(
        model, tsteps.to_device(_batch(cfg), "cpu"))
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


def test_detach_fault_regression(monkeypatch):
    """Graph-less kernel outputs: launched directly under grad (as before
    the Functions), ``wq`` of every layer and the norms before the last
    MLP lose their gradients, and ``backward`` says nothing; through the
    Functions every parameter gets a nonzero gradient."""
    torch.set_num_threads(2)
    cfg = _cfg()
    _fake_card(monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(ops, "_grad", lambda *ts: False)      # the old routing
        old = _loss_grads(cfg)
    assert old["layers.0.attn.wq"] is None
    assert old["layers.1.attn.wq"] is None
    assert old["layers.0.norm1"] is None
    new = _loss_grads(cfg)
    for name, g in new.items():
        assert g is not None, name
        assert g.abs().max() > 0, name


def test_kernels_without_backward_raise_under_grad(monkeypatch):
    """The decode kernels, and flash with a ring, raise under grad on the
    card's route; ``ssd``, ``rglru``, the gated norm, flash at head_dim 256
    and flash with a softcap go through their Functions and return outputs
    that carry a gradient (the softcap reaching both of flash's
    launchers)."""
    calls = {}
    _fake_card(monkeypatch, calls)
    rng = np.random.default_rng(3)
    y, z = _leaf(rng, (2, 3, 64)), _leaf(rng, (2, 3, 64))
    g = torch.zeros(64)
    assert ops.gated_rmsnorm(y, z, g).grad_fn is not None
    x = _leaf(rng, (1, 8, 2, 4))
    dt = torch.ones(1, 8, 2)
    bm = torch.zeros(1, 8, 16)
    assert ops.ssd(x, dt, torch.zeros(2), bm, bm).grad_fn is not None
    assert ops.rglru(_leaf(rng, (1, 8, 4)), torch.zeros(1, 8, 4),
                     torch.ones(1, 8, 4)).grad_fn is not None
    assert calls == {"gated_rmsnorm": 1, "ssd": 1, "rglru": 1}
    q = _leaf(rng, (2, 1, 4, 64))
    kc = torch.zeros(2, 8, 2, 64)
    cl = torch.tensor([3, 8], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        ops.decode_attention(q, kc, kc, cache_len=cl, scale=0.125)
    with pytest.raises(NotImplementedError, match="paged_decode_attention"):
        ops.paged_decode_attention(q, kc, kc, torch.zeros(2, 8), cl[:, None],
                                   cache_len=cl, scale=0.125)
    pos = torch.arange(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="backward.*ring"):
        ops.flash_attention(q, q, q, q_pos=pos, k_pos=pos, scale=0.125,
                            k_cache=kc, v_cache=kc,
                            cache_pos=torch.zeros(2, 8))
    seen = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        def spy(*a, _name=name, _f=getattr(fk, name), **k):
            seen[_name] = k.get("softcap")
            return _f(*a, **k)
        monkeypatch.setattr(fk, name, spy)
    capped = ops.flash_attention(q, q, q, q_pos=pos, k_pos=pos, scale=0.125,
                                 softcap=30.0)
    assert capped.grad_fn is not None
    capped.sum().backward()
    assert seen == {"flash_attention": 30.0, "flash_attention_bwd": 30.0}
    assert q.grad is not None and torch.isfinite(q.grad).all()
    q256 = _leaf(rng, (2, 1, 4, 256))
    assert ops.flash_attention(q256, q256, q256, q_pos=pos, k_pos=pos,
                               scale=0.0625).grad_fn is not None
    # without grad the kernel's own wrapper is called (and refuses CPU
    # tensors), so the serving path is what it was
    monkeypatch.undo()
    monkeypatch.setattr(ops, "_route", lambda t: True)
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA"):
        ops.gated_rmsnorm(y, z, g)
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA"):
        ops.rmsnorm(y, g)


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_launches_match_expected(monkeypatch, remat):
    """One train step on the card's route: each launcher is called as
    often as ``chip_smoke.expected_train_launches`` says (a forward
    launcher per forward, twice with remat; a backward launcher once)."""
    torch.set_num_threads(2)
    cfg = _cfg().replace(remat=remat)
    calls = {}
    _fake_card(monkeypatch, calls)
    state = tsteps.init_train_state(cfg, 0, "cpu")
    tsteps.make_train_step(cfg, TrainConfig())(state, _batch(cfg))
    want = chip_smoke.expected_train_launches(cfg, remat)
    norm_fwd = sum(calls.get(k, 0) for k in ("rmsnorm", "rmsnorm_pair",
                                             "add_rmsnorm"))
    norm_bwd = sum(calls.get(k, 0) for k in ("rmsnorm_bwd",
                                             "rmsnorm_pair_bwd",
                                             "add_rmsnorm_bwd"))
    assert calls["flash_attention"] == want["flash_attention"]
    assert calls["flash_attention_bwd"] == want["flash_attention_bwd"]
    assert norm_fwd == want["rmsnorm"] and norm_bwd == want["rmsnorm_bwd"]
    assert want["flash_attention"] == cfg.num_layers * (2 if remat else 1)


@pytest.mark.parametrize("remat", [True, False])
def test_moe_train_step_launches_match_expected(monkeypatch, remat):
    """mixtral-8x22b's smoke train step on the card's route (head_dim 64,
    which the backward kernel takes): flash, the norm forms and their
    backwards as often as ``chip_smoke.expected_train_launches`` says for a
    stack of attention layers, the MoE FFN (batched products) launching
    none of its own; the step's loss finite and its aux loss positive."""
    torch.set_num_threads(2)
    cfg = get_smoke_config("mixtral-8x22b").replace(
        dtype=torch.float32, remat=remat, head_dim=64)
    calls = {}
    _fake_card(monkeypatch, calls)
    state = tsteps.init_train_state(cfg, 0, "cpu")
    _, metrics = tsteps.make_train_step(cfg, TrainConfig())(state,
                                                            _batch(cfg))
    want = chip_smoke.expected_train_launches(cfg, remat)
    fwd = ("rmsnorm", "rmsnorm_pair", "add_rmsnorm")
    got = {k: calls.get(k, 0) for k in ("flash_attention",
                                        "flash_attention_bwd")}
    got["rmsnorm"] = sum(calls.get(k, 0) for k in fwd)
    got["rmsnorm_bwd"] = sum(calls.get(f"{k}_bwd", 0) for k in fwd)
    assert got == {k: want[k] for k in got}
    assert set(calls) <= {*fwd, *(f"{k}_bwd" for k in fwd),
                          "flash_attention", "flash_attention_bwd"}
    assert want["flash_attention"] == cfg.num_layers * (2 if remat else 1)
    assert float(metrics["aux"]) > 0 and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_recurrent_train_step_launches_match_expected(monkeypatch, arch,
                                                      remat):
    """The recurrent stacks' smoke train step on the card's route: ``ssd``,
    ``rglru``, flash and every norm form (the gated one among them) and
    their backwards as often as ``chip_smoke.expected_train_launches``
    says (recurrentgemma-9b's head_dim at 64, which the fake card's plain
    launchers take like 256)."""
    torch.set_num_threads(2)
    cfg = get_smoke_config(arch).replace(dtype=torch.float32, remat=remat)
    if arch == "recurrentgemma-9b":
        cfg = cfg.replace(head_dim=64)
    calls = {}
    _fake_card(monkeypatch, calls)
    state = tsteps.init_train_state(cfg, 0, "cpu")
    tsteps.make_train_step(cfg, TrainConfig())(state, _batch(cfg))
    want = chip_smoke.expected_train_launches(cfg, remat)
    fwd = ("rmsnorm", "rmsnorm_pair", "add_rmsnorm", "gated_rmsnorm")
    got = {k: calls.get(k, 0) for k in ("ssd", "rglru", "flash_attention",
                                        "ssd_bwd", "rglru_bwd",
                                        "flash_attention_bwd")}
    got["rmsnorm"] = sum(calls.get(k, 0) for k in fwd)
    got["rmsnorm_bwd"] = sum(calls.get(f"{k}_bwd", 0) for k in fwd)
    assert got == {k: want[k] for k in got}
    kinds = cfg.layer_kinds()
    mixer = "ssd" if "ssm" in kinds else "rglru"
    assert want[mixer] == kinds.count("ssm" if mixer == "ssd" else "rglru") \
        * (2 if remat else 1)
    assert calls.get("gated_rmsnorm", 0) == kinds.count("ssm") * (
        2 if remat else 1)
