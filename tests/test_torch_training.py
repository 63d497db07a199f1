"""The port's training path held against the JAX package's functions on
the CPU: schedules, AdamW (f32 parameters, and bf16 parameters with f32
masters), clipping, int8 error feedback, the loss, the plain backward of
flash attention and of the norm forms (against ``jax.vjp`` of the
reference functions), the loss gradients and ``make_train_step`` (against
``jax.jit(repro.training.steps.make_train_step)``) at the qwen3-4b and
granite-8b smoke configs in f32 (the loss gradients also at minicpm-2b's
and musicgen-medium's, D 64 stacks that train on one card;
``test_torch_train_recurrent.py`` runs both at the recurrent stacks'),
mixtral-8x22b's (MoE: the aux loss in the loss, the router's top-k and
the capacity drops under grad; also at a capacity factor that drops
choices) and qwen3-4b's with an attention softcap, remat against no
remat, and the synthetic batches.  The reference's ``train_loop`` builds a host mesh that fails on
its own tests, so the reference functions, not the loop, are the oracle.

Inputs are made with numpy from a seed and the weights bridged with
``bridge.params_from_numpy``.  Tolerances:
  * schedules, optimizer steps and compression: the same f32 operations,
    1e-6 relative (rounding of fused multiply-adds), compression exact;
  * the loss 1e-5 relative, gradients 1e-5 + 1e-4 relative (f32 sums in
    another order), parameters after 3 steps 5e-5 (the reference's own
    accumulation test's bound): Adam divides by sqrt(nu), so an element
    whose gradient is summation noise moves by up to lr either way;
  * with ``int8_ef``, parameters within 2 lr a step: an element whose
    ``g + e`` lies at a rounding edge of the int8 grid, which an f32 sum
    in another order moves across, gets another quantum, and Adam turns
    that into an update up to lr the other way;
  * plain backward: f32 1e-5 + 1e-5 relative; bf16 one rounding of the
    largest |gradient| (2^-7 relative, as the forward norm is held); flash
    with a softcap against the reference's softcapped attention: f32
    2e-5 of max(1, max|ref|), bf16 within one bf16 spacing of the f32
    oracle (``_bf16_spacings``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as JTC
from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import DataConfig as JDC
from repro.data.pipeline import SyntheticDataset as JDS
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.training import optimizer as jopt
from repro.training import schedules as jsched
from repro.training import steps as jsteps
from repro_torch import bridge
from repro_torch.common.config import TrainConfig as TTC
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.data.pipeline import DataConfig as TDC
from repro_torch.data.pipeline import SyntheticDataset as TDS
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import rmsnorm as rk
from repro_torch.models import model as TM
from repro_torch.training import optimizer as topt
from repro_torch.training import schedules as tsched
from repro_torch.training import steps as tsteps

KEY = jax.random.PRNGKey(0)
EPS = 1e-6


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else
                      jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------------ schedules
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "linear", "constant"])
def test_schedules_match_reference(schedule):
    kw = dict(learning_rate=1e-3, schedule=schedule, warmup_steps=10,
              total_steps=100, wsd_decay_frac=0.2)
    jf, tf = jsched.make_schedule(JTC(**kw)), tsched.make_schedule(TTC(**kw))
    steps = np.arange(0, 106)
    want = np.asarray([float(jf(jnp.int32(s))) for s in steps])
    got = np.asarray([float(tf(torch.tensor(s, dtype=torch.int32)))
                      for s in steps])
    # f32 cos and pow of two libraries: within an ulp of the base rate
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 1e-3)


# ------------------------------------------------------------------ optimizer
def _tree(rng):
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(np.float32) * 0.02}


def test_adamw_f32_matches_reference():
    """Three AdamW steps with clipping on f32 parameters: parameters,
    moments and step as the reference's."""
    rng = np.random.default_rng(0)
    tc = dict(learning_rate=1e-2, weight_decay=0.1)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    assert ts["master"] == {}
    for i in range(3):
        g = {k: v * (3.0 if i == 1 else 0.5) for k, v in _tree(rng).items()}
        jg, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        jp, js = jopt.adamw_update(jg, js, jp, 1e-2, JTC(**tc))
        _, _, tn = topt.adamw_update({k: torch.from_numpy(v)
                                      for k, v in g.items()},
                                     ts, tp, 1e-2, TTC(**tc), clip=1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in p0:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(_np(ts["mu"][k]), _np(js["mu"][k]),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(_np(ts["nu"][k]), _np(js["nu"][k]),
                                   rtol=1e-6, atol=1e-12)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_adamw_bf16_params_keep_f32_masters():
    """A bf16 parameter is updated through its f32 master: the master
    follows the reference's f32 parameter, the bf16 copy is the master
    rounded.  Without the master, an update of lr on a weight near 0.02
    is below half a bf16 spacing there and rounds away."""
    rng = np.random.default_rng(1)
    p0 = _tree(rng)
    p0["b"] = rng.uniform(0.017, 0.03, size=16).astype(np.float32)
    tc = dict(learning_rate=1e-5, weight_decay=0.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    js = jopt.adamw_init(jp)
    ts = topt.adamw_init(tp)
    assert set(ts["master"]) == set(p0)
    # the reference trains the bf16-rounded weights as its f32 masters
    jp = {k: jnp.asarray(_np(tp[k])) for k in p0}
    for _ in range(3):
        g = _tree(rng)
        jp, js = jopt.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                   js, jp, 1e-5, JTC(**tc))
        topt.adamw_update({k: torch.from_numpy(v).to(torch.bfloat16)
                           for k, v in g.items()}, ts, tp, 1e-5, TTC(**tc))
    for k in p0:
        # the gradients were bf16 on the port's side, f32 on JAX's: the
        # first moments agree to a bf16 rounding of g, and the update to
        # lr (sign-like at the first steps) either way
        np.testing.assert_allclose(_np(ts["master"][k]), _np(jp[k]),
                                   atol=3 * 2e-5, rtol=0)
        assert torch.equal(tp[k], ts["master"][k].to(torch.bfloat16))
    # the master moved where the bf16 weight alone could not have: three
    # updates of at most about lr each stay below half a bf16 spacing
    b0 = torch.from_numpy(p0["b"]).to(torch.bfloat16)
    assert (ts["master"]["b"] - b0.float()).abs().max() > 1e-5
    assert torch.equal((b0.float() + 3e-5).to(torch.bfloat16), b0)
    assert torch.equal((b0.float() - 3e-5).to(torch.bfloat16), b0)


def test_adamw_updates_in_place_and_frees_gradients():
    tp = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = topt.adamw_init(tp)
    w, master = tp["w"], st["master"]["w"]
    grads = {"w": torch.full((4,), 0.5, dtype=torch.bfloat16)}
    topt.adamw_update(grads, st, tp, 0.1, TTC(weight_decay=0.0))
    assert grads == {}
    assert tp["w"] is w and st["master"]["w"] is master
    assert torch.allclose(master, torch.full((4,), 0.9))


def test_weight_decay_is_decoupled():
    tp = {"w": torch.tensor([10.0])}
    st = topt.adamw_init(tp)
    topt.adamw_update({"w": torch.tensor([0.0])}, st, tp, 0.1,
                      TTC(learning_rate=0.1, weight_decay=0.1))
    np.testing.assert_allclose(tp["w"].numpy(), [10.0 - 0.1 * 0.1 * 10.0],
                               rtol=1e-6)


def test_global_norm_clip_matches_reference():
    g = {"a": np.asarray([3.0], np.float32), "b": np.asarray([4.0],
                                                              np.float32)}
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v)
                                       for k, v in g.items()}, 1.0)
    tc, tn = topt.clip_by_global_norm({k: torch.from_numpy(v)
                                       for k, v in g.items()}, 1.0)
    assert float(tn) == pytest.approx(5.0) == float(jn)
    for k in g:
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=1e-7)


def test_int8_compression_matches_reference():
    """``quantize_int8`` and ``compress_grads_ef`` on the same f32 inputs:
    the same int8 grid and scale, the same residuals, exactly."""
    rng = np.random.default_rng(2)
    g = (rng.standard_normal((64, 48)) * 0.01).astype(np.float32)
    e = (rng.standard_normal((64, 48)) * 1e-4).astype(np.float32)
    jq, js = jopt.quantize_int8(jnp.asarray(g))
    tq, ts = topt.quantize_int8(torch.from_numpy(g))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert float(js) == float(ts)
    jd, je = jopt.compress_grads_ef({"g": jnp.asarray(g)},
                                    {"g": jnp.asarray(e)})
    td, te = topt.compress_grads_ef({"g": torch.from_numpy(g)},
                                    {"g": torch.from_numpy(e)})
    assert np.array_equal(np.asarray(jd["g"]), td["g"].numpy())
    assert np.array_equal(np.asarray(je["g"]), te["g"].numpy())
    back = topt.dequantize_int8(tq, ts)
    assert (back - torch.from_numpy(g)).abs().max() <= ts * 0.5 + 1e-9


# ----------------------------------------------------------------------- loss
@pytest.mark.parametrize("masked,z_loss", [(False, 0.0), (True, 0.0),
                                           (True, 1e-4)])
def test_cross_entropy_matches_reference(masked, z_loss):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.7).astype(np.float32) if masked else None
    want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask),
                                z_loss)
    got = tsteps.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if mask is None else
                               torch.from_numpy(mask), z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------- plain backward kernels
@pytest.mark.parametrize("rep,d,causal,window", [(1, 16, True, 0),
                                                 (4, 16, True, 5),
                                                 (1, 64, False, 0),
                                                 (4, 64, True, 0),
                                                 (4, 64, False, 7)])
def test_flash_bwd_plain_matches_jax_vjp(rep, d, causal, window):
    """``flash_attention_bwd_plain`` from the plain forward's output and
    log-sum-exp against ``jax.vjp`` of ``ref.mha_cache_masked`` under the
    same position mask (every query sees a key: the backward gives a row
    with none no gradient, the oracle's uniform softmax would)."""
    rng = np.random.default_rng(rep * 100 + d)
    b, s, hkv = 2, 13, 2
    hq = hkv * rep
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    kpos = np.tile(pos, (b, 1))
    kpos[1, 3] = -1                               # an empty key slot
    scale = d ** -0.5
    m = np.broadcast_to(kpos[:, None, :] >= 0, (b, s, s)).copy()
    if causal:
        m &= kpos[:, None, :] <= pos[None, :, None]
    if window:
        m &= kpos[:, None, :] > pos[None, :, None] - window
    assert m.any(-1).all()
    f = lambda q_, k_, v_: jref.mha_cache_masked(
        q_, k_, v_, mask=jnp.asarray(m), scale=scale)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    T = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(q_pos=torch.from_numpy(pos), k_pos=torch.from_numpy(kpos),
              causal=causal, window=window, scale=scale)
    out, lse = fk.flash_attention_plain(*T, return_lse=True, **kw)
    assert lse.shape == (b, hq, s)
    got = fk.flash_attention_bwd_plain(*T, out, lse, torch.from_numpy(do),
                                       **kw)
    for g_, w_ in zip(got, want):
        assert g_.shape == tuple(w_.shape)
        np.testing.assert_allclose(_np(g_), _np(w_), atol=1e-5, rtol=1e-5)


def _bf16_spacings(got, want) -> float:
    """Largest |got - want| in bf16 spacings at |want| (f32), floored at
    the spacing of max|want| / 256: a gradient near zero beside large ones
    is held to the tensor's scale (``chip_smoke.bwd_spacings``)."""
    want = np.abs(want).astype(np.float64), want.astype(np.float64)
    mag = np.maximum(want[0], want[0].max() / 256 + 1e-30)
    spacing = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.abs(got.astype(np.float64) - want[1]) / spacing).max())


SOFTCAP = 50.0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6),
                                           (False, 0)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_plain_softcap_matches_jax_vjp(d, causal, window, dt):
    """``flash_attention_bwd_plain`` with a softcap of 50, from the plain
    forward's output and log-sum-exp (the capped logits'), against
    ``jax.vjp`` of ``ref.mha_reference(softcap=50)`` (GQA 3 over 2 KV
    heads).  q is drawn 16 times wider, so that the logits reach the cap's
    range (|q.k| * scale to ~60, 1 - t^2 down to ~0.3) and a missing
    ``1 - t^2`` shows; the f32 oracle runs on the bf16 inputs' values.
    ``out`` is the f32 forward's on those values in both dtypes: rounded
    to bf16 it moves ``delta`` by its rounding, which ``dS = P (dP -
    delta)`` turns into up to ~130 spacings of dq where the capped softmax
    is peaked (|dP - delta| << |delta|) -- the forward's rounding, not the
    backward's arithmetic held here (phase 2t of ``chip_smoke.py`` holds
    the kernel on its own bf16 out against this function on the same)."""
    rng = np.random.default_rng(d + window + 7 * causal)
    b, s, hkv, rep_ = 2, 19, 2, 3
    hq = hkv * rep_
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32) * 16
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    T = [torch.from_numpy(a).to(tdt) for a in (q, k, v, do)]
    q, k, v, do = (_np(t) for t in T)            # the values the port sees
    scale = d ** -0.5
    f = lambda q_, k_, v_: jref.mha_reference(
        q_, k_, v_, causal=causal, window=window, scale=scale,
        softcap=SOFTCAP)
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [_np(w) for w in vjp(jnp.asarray(do))]
    pos = torch.arange(s, dtype=torch.int32)
    kw = dict(q_pos=pos, k_pos=pos, causal=causal, window=window,
              scale=scale, softcap=SOFTCAP)
    out, lse = fk.flash_attention_plain(*(t.float() for t in T[:3]),
                                        return_lse=True, **kw)
    u = np.einsum("bshd,bthd->bhst", q, np.repeat(k, rep_, 2)) * scale
    assert np.abs(u).max() > SOFTCAP          # the cap bites
    got = fk.flash_attention_bwd_plain(*T[:3], out, lse, T[3], **kw)
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == tdt and g_.shape == w_.shape, name
        if dt == "f32":
            np.testing.assert_allclose(_np(g_), w_, rtol=0, err_msg=name,
                                       atol=2e-5 * max(1.0, np.abs(w_).max()))
        else:
            assert _bf16_spacings(_np(g_), w_) <= 1.0, name


def _jax_norm(scale, x):
    return jlayers.rmsnorm({"scale": scale}, x, EPS)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["norm", "pair", "add"])
def test_norm_bwd_plains_match_jax_vjp(form, dt):
    """Each norm form's ``*_bwd_plain`` against ``jax.vjp`` of the
    reference's norm (the pair: two norms, each with its gain; the add: the
    sum and its norm, with the gradients of both outputs)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(4)
    shape, d = (3, 5, 96), 96
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    arrs[1] = arrs[1] * 0.5
    sc = [(rng.standard_normal(d) * 0.1).astype(np.float32) for _ in range(2)]
    J = [jnp.asarray(a).astype(jdt) for a in arrs]
    T = [torch.from_numpy(a).to(tdt) for a in arrs]
    JS = [jnp.asarray(a) for a in sc]
    TS = [torch.from_numpy(a) for a in sc]
    if form == "norm":
        _, vjp = jax.vjp(_jax_norm, JS[0], J[0])
        want = vjp(J[2])[::-1]
        got = rk.rmsnorm_bwd_plain(T[0], TS[0], T[2], EPS)
    elif form == "pair":
        f = lambda a, b, s0, s1: (_jax_norm(s0, a), _jax_norm(s1, b))
        _, vjp = jax.vjp(f, J[0], J[1], JS[0], JS[1])
        want = vjp((J[2], J[3]))
        got = rk.rmsnorm_pair_bwd_plain(T[0], T[1], TS[0], TS[1], T[2], T[3],
                                        EPS)
    else:
        f = lambda a, b, s0: (a + b, _jax_norm(s0, a + b))
        _, vjp = jax.vjp(f, J[0], J[1], JS[0])
        want = vjp((J[2], J[3]))
        ssum = T[0] + T[1]
        dx, dsc = rk.add_rmsnorm_bwd_plain(ssum, TS[0], T[2], T[3], EPS)
        np.testing.assert_array_equal(_np(want[0]), _np(want[1]))
        got, want = (dx, dsc), (want[0], want[2])
    for g_, w_ in zip(got, want):
        w_ = _np(w_)
        if g_.dtype == torch.float32 and dt == "bf16":   # a gain's gradient
            tol = dict(atol=1e-4, rtol=1e-4)
        elif dt == "bf16":
            tol = dict(atol=2.0 ** -7 * max(1.0, np.abs(w_).max()), rtol=0)
        else:
            tol = dict(atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(g_), w_, **tol)


# -------------------------------------------- the train step against JAX
def _states(arch: str, tc_kw: dict, seed: int = 0, **over):
    """The reference's f32 train state and the port's on the same
    weights (``over``: config fields set on both)."""
    jc = jsmoke(arch).replace(dtype=jnp.float32, param_dtype=jnp.float32,
                              **over)
    tcfg = tsmoke(arch).replace(dtype=torch.float32, **over)
    js = jsteps.init_train_state(jax.random.PRNGKey(seed), jc)
    if tc_kw.get("grad_compression") == "int8_ef":
        js["ef"] = jopt.ef_init(js["params"])
    model = bridge.params_from_numpy(jax.tree.map(np.asarray, js["params"]),
                                     tcfg, "cpu")
    return jc, tcfg, js, tsteps.train_state(model, TTC(**tc_kw))


def _batch(rng, vocab, b=4, s=32, audio=False):
    """Tokens as labels, or for an audio stack (``audio``) labels drawn
    apart, as the JAX package's smoke train step draws them."""
    toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = (rng.integers(0, vocab, size=(b, s)).astype(np.int32) if audio
              else toks)
    mask = np.ones((b, s), np.float32)
    mask[0, -5:] = 0.0
    return {"tokens": toks, "labels": labels, "mask": mask}


def _as_port(tree, tcfg):
    """A reference params-shaped tree (params or their gradients) as named
    port tensors."""
    m = bridge.params_from_numpy(jax.tree.map(np.asarray, tree), tcfg, "cpu")
    return dict(m.named_parameters())


def _loss_gradients(arch: str, **over) -> dict:
    """The loss, ce and aux and every parameter's gradient of one batch,
    against ``jax.value_and_grad`` of the reference's loss; every gradient
    is nonzero.  Returns the port's metrics."""
    torch.set_num_threads(2)
    tc_kw = dict(total_steps=10)
    jc, tcfg, js, ts = _states(arch, tc_kw, **over)
    batch = _batch(np.random.default_rng(5), jc.vocab_size,
                   audio=jc.family == "audio")
    jl = jsteps.make_loss_fn(jc, JTC(**tc_kw))
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        js["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    model = ts["model"]
    loss, tm = tsteps.make_loss_fn(tcfg, TTC(**tc_kw))(
        model, tsteps.to_device(batch, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = _as_port(jg, tcfg)
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
        np.testing.assert_allclose(_np(p.grad), _np(want[name]), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    return tm


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-8b", "minicpm-2b",
                                  "musicgen-medium", "mixtral-8x22b"])
def test_loss_gradients_match_reference(arch):
    """The loss and every parameter's gradient of one batch, against
    ``jax.value_and_grad`` of the reference's loss; every gradient is
    nonzero (mixtral-8x22b: the router's through the top-k weights and
    the aux loss)."""
    tm = _loss_gradients(arch)
    if arch == "mixtral-8x22b":
        assert float(tm["aux"].detach()) > 0


@pytest.mark.parametrize("cap", [SOFTCAP, 0.5])
def test_softcap_loss_gradients_match_reference(cap):
    """qwen3-4b's smoke stack with an attention softcap (``logit_softcap``;
    0.5 bites at the smoke widths' small logits, 50 barely does): the loss
    and every gradient against the reference's, whose attention caps its
    logits in jnp."""
    _loss_gradients("qwen3-4b", logit_softcap=cap)


def test_moe_drops_under_grad_match_reference(monkeypatch):
    """mixtral-8x22b's smoke stack at capacity factor 0.5, where each
    layer's experts hold half of the (token, choice) pairs
    (``dropped_choices`` > 0 in every layer's call): the loss, ce, aux and
    every gradient against the reference's, which drops the same pairs."""
    from repro_torch.models import moe as tmoe
    drops, ffn = [], tmoe.moe_ffn

    def counted(p, x, cfg, num_groups=1):
        drops.append(int(tmoe.dropped_choices(p, x, cfg, num_groups)))
        return ffn(p, x, cfg, num_groups)
    monkeypatch.setattr(tmoe, "moe_ffn", counted)
    _loss_gradients("mixtral-8x22b", moe_capacity_factor=0.5)
    assert drops and min(drops) > 0, drops


def test_eval_step_matches_reference():
    """``make_eval_step``: the loss, ce and aux of one batch without a
    gradient, against the reference's eval step."""
    tc_kw = dict(total_steps=10)
    jc, tcfg, js, ts = _states("granite-8b", tc_kw)
    batch = _batch(np.random.default_rng(8), jc.vocab_size)
    want = jsteps.make_eval_step(jc, JTC(**tc_kw))(
        js["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    got = tsteps.make_eval_step(tcfg, TTC(**tc_kw))(ts["model"], batch)
    assert set(got) == set(want)
    for k in want:
        assert not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-7)


STEP_CASES = [("qwen3-4b", 1, "none"), ("qwen3-4b", 2, "none"),
              ("granite-8b", 1, "none"), ("granite-8b", 2, "none"),
              ("qwen3-4b", 1, "int8_ef"), ("granite-8b", 2, "int8_ef"),
              ("mixtral-8x22b", 1, "none"), ("mixtral-8x22b", 2, "none")]


@pytest.mark.parametrize("arch,micro,comp", STEP_CASES)
def test_train_step_matches_reference(arch, micro, comp):
    """Three train steps (clipping, the cosine schedule from warmup, AdamW;
    ``microbatches``, ``int8_ef``) against ``jax.jit`` of the reference's
    ``make_train_step``: loss, ce, grad norm and lr at every step, and the
    parameters after the first and the third."""
    torch.set_num_threads(2)
    lr = 1e-3
    tc_kw = dict(learning_rate=lr, total_steps=10, warmup_steps=2,
                 microbatches=micro, grad_compression=comp)
    jc, tcfg, js, ts = _states(arch, tc_kw)
    jstep = jax.jit(jsteps.make_train_step(jc, JTC(**tc_kw)))
    tstep = tsteps.make_train_step(tcfg, TTC(**tc_kw))
    rng = np.random.default_rng(6)
    ef = comp == "int8_ef"
    for i in range(3):
        batch = _batch(rng, jc.vocab_size)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, batch)
        for k in ("loss", "ce", "grad_norm", "lr"):
            tol = 1e-4 if ef and k in ("loss", "ce", "grad_norm") else 1e-5
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       err_msg=f"step {i + 1} {k}")
        if i in (0, 2):
            want = _as_port(js["params"], tcfg)
            bound = 2 * lr * (i + 1) if ef else 5e-5
            for name, p in ts["model"].named_parameters():
                np.testing.assert_allclose(_np(p), _np(want[name]),
                                           atol=bound, rtol=0,
                                           err_msg=f"step {i + 1} {name}")
    assert int(ts["opt"]["step"]) == 3


def test_remat_is_bit_equal():
    """Checkpointed layers recompute the same forward: the loss and every
    gradient are bit-equal with and without remat, on the CPU."""
    torch.set_num_threads(2)
    tcfg = tsmoke("qwen3-4b").replace(dtype=torch.float32)
    batch = tsteps.to_device(_batch(np.random.default_rng(7), 256), "cpu")
    out = {}
    for remat in (True, False):
        cfg = tcfg.replace(remat=remat)
        model = tsteps.init_train_state(cfg, 3, "cpu")["model"]
        loss, _ = tsteps.make_loss_fn(cfg, TTC())(model, batch)
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in
                                      model.named_parameters()})
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[True][1].items():
        assert torch.equal(g, out[False][1][name]), name


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen3-4b", "musicgen-medium",
                                  "llama-3.2-vision-90b"])
def test_synthetic_batches_byte_equal(arch):
    """The lm, audio and vlm families' batches are the reference's, byte
    for byte, at several steps."""
    kw = dict(global_batch=2, seq_len=48, seed=3)
    jd, td = JDS(jsmoke(arch), JDC(**kw)), TDS(tsmoke(arch), TDC(**kw))
    for step in (0, 1, 17):
        a, b = jd.batch(step), td.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), (arch, step, k)
