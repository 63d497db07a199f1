"""The port's model stack against the JAX package's on the CPU: identical
weights through ``bridge.params_from_numpy``, f32 smoke configs, inputs
from numpy seeds.

Tolerances: logits are O(1-10) and both sides compute the same f32 math
in another summation order, so 1e-4 absolute; greedy tokens must be
identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as TM

ARCHS = ["qwen3-4b", "granite-8b", "gemma3-27b", "mamba2-780m",
         "recurrentgemma-9b", "minicpm-2b", "mixtral-8x22b", "arctic-480b",
         "musicgen-medium"]
TOL = 1e-4


@pytest.fixture(scope="module")
def stacks():
    """arch -> (jax cfg, jax params, port cfg, port model), f32."""
    torch.set_num_threads(2)
    out = {}
    for arch in ARCHS:
        jc = jget_smoke(arch).replace(dtype=jnp.float32,
                                      param_dtype=jnp.float32)
        tc = get_smoke_config(arch).replace(dtype=torch.float32)
        jp = JM.init_model(jax.random.PRNGKey(0), jc)
        tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
        out[arch] = (jc, jp, tc, tp)
    return out


def _prompt(n, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        2, vocab, size=(n,)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(stacks, arch):
    jc, jp, tc, tp = stacks[arch]
    toks = np.stack([_prompt(24, tc.vocab_size, s) for s in (1, 2)])
    jl, jaux = JM.forward(jp, jnp.asarray(toks), jc)
    tl, aux = TM.forward(tp, _t(toks), tc)
    assert tl.shape == (2, 24, tc.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    # the MoE balance loss summed over layers; 0.0 for a dense stack
    assert abs(float(aux) - float(jaux)) <= 1e-6 * len(tp.layers)
    if not tc.num_experts:
        assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_token_identical_to_jax(stacks, arch):
    """Whole-prompt prefill plus 8 decode steps: the same greedy tokens and
    logits as the JAX package (gemma3's 16-wide local rings wrap)."""
    jc, jp, tc, tp = stacks[arch]
    prompt = _prompt(21, tc.vocab_size, 3)
    cap = 48
    jdecode = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, t, i, jc))
    jl, jcache = jax.jit(lambda p, t: JM.prefill(p, t, jc, cap))(
        jp, jnp.asarray(prompt)[None])
    tl, tcache = TM.prefill(tp, _t(prompt)[None], tc, cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl[:, -1], -1)[:, None]
    jtoks, ttoks = [], []
    for i in range(8):
        jl, jcache = jdecode(jp, jcache, jt, len(prompt) + i)
        tl, tcache = TM.decode_step(tp, tcache, tt, len(prompt) + i, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1], -1)[:, None]
        jtoks.append(int(jt[0, 0]))
        ttoks.append(int(tt[0, 0]))
    assert ttoks == jtoks


@pytest.mark.parametrize("arch,plen,capacity,chunk", [
    ("qwen3-4b", 19, 64, 5),
    ("granite-8b", 30, 32, 8),
    ("gemma3-27b", 28, 32, 5),      # local rings of 16 wrap inside chunks
    ("mamba2-780m", 37, 64, 8),     # SSD state threaded across chunks
    ("recurrentgemma-9b", 28, 32, 5),   # RG-LRU state and a 16-slot ring
    ("mixtral-8x22b", 40, 64, 8),   # MoE; local rings of 16 wrap
    ("arctic-480b", 30, 32, 8),     # MoE beside a dense FFN
    ("musicgen-medium", 33, 64, 8),  # gelu MLP, untied head
])
def test_chunked_prefill_matches_whole_and_jax(stacks, arch, plen, capacity,
                                               chunk):
    """``prefill_chunk`` over pieces equals whole-prompt ``prefill`` (last
    logits and one decode continuation) and JAX's ``prefill_chunk``.  The
    MoE archs run at capacity factor E, where no choice drops: at the
    published 1.25 a chunk's tokens compete for expert capacity with each
    other only, a whole prompt's with all of it, so the two prefills may
    drop different choices (JAX's own prefill test strips the experts for
    this reason)."""
    jc, jp, tc, tp = stacks[arch]
    if tc.num_experts:
        jc, tc = (c.replace(moe_capacity_factor=float(tc.num_experts))
                  for c in (jc, tc))
    prompt = _prompt(plen, tc.vocab_size, 4)
    lw, cache_w = TM.prefill(tp, _t(prompt)[None], tc, capacity)
    cache = TM.init_cache(tc, 1, capacity, "cpu")
    jcache = JM.init_cache(jc, 1, capacity)
    jchunk = jax.jit(lambda p, c, t, s: JM.prefill_chunk(p, c, t, s, jc))
    for c0 in range(0, plen, chunk):
        piece = prompt[c0:c0 + chunk]
        lg, cache = TM.prefill_chunk(tp, cache, _t(piece)[None], c0, tc)
        jlg, jcache = jchunk(jp, jcache, jnp.asarray(piece)[None], c0)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL,
                                   rtol=TOL)
    assert float((lg - lw).abs().max()) < TOL
    tok = torch.argmax(lg[:, -1], -1)[:, None]
    l2, _ = TM.decode_step(tp, cache, tok, plen, tc)
    l2w, _ = TM.decode_step(tp, cache_w, tok, plen, tc)
    assert float((l2 - l2w).abs().max()) < TOL


def test_chunked_prefill_caps_match_jax():
    for arch in ARCHS:
        for cap in (8, 64):
            assert TM.chunked_prefill_caps(get_smoke_config(arch), cap) == \
                JM.chunked_prefill_caps(jget_smoke(arch), cap)


def test_configs_match_jax_and_count_params():
    """Same fields (dtypes aside) for config() and smoke_config(), and the
    same parameter counts, full widths included (qwen3-4b: ~4.02 B; the
    recurrent archs count their SSM and RG-LRU leaves)."""
    for arch in ARCHS:
        for tget, jget in ((get_config, jget_config),
                           (get_smoke_config, jget_smoke)):
            t = dataclasses.asdict(tget(arch))
            j = dataclasses.asdict(jget(arch))
            for k in ("dtype", "param_dtype"):
                t.pop(k), j.pop(k)
            assert t == j, arch
        assert TM.count_params(get_config(arch)) == \
            JM.count_params(jget_config(arch))
    assert 4.0e9 < TM.count_params(get_config("qwen3-4b")) < 4.1e9


def test_every_jax_arch_resolves_in_the_port():
    """Every public id of the JAX registry resolves in the port, to the
    same config (dtypes aside) and parameter count, full widths included;
    an unknown id still raises."""
    from repro import configs as jconfigs
    for arch in jconfigs._ALIASES:
        for tget, jget in ((get_config, jget_config),
                           (get_smoke_config, jget_smoke)):
            t = dataclasses.asdict(tget(arch))
            j = dataclasses.asdict(jget(arch))
            for k in ("dtype", "param_dtype"):
                t.pop(k), j.pop(k)
            assert t == j, arch
    for arch in ("llama-3.2-vision-90b", "musicgen-medium"):
        assert TM.count_params(get_config(arch)) == \
            JM.count_params(jget_config(arch))
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-arch")
    with pytest.raises(KeyError, match="unknown"):
        get_smoke_config("llama-3.2-vision")


def test_default_device_entry_points_need_a_card():
    """Entry points default to the card; without one they raise instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = get_smoke_config("qwen3-4b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_model(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(cfg, 1, 16)


def test_init_model_is_seeded_and_scaled():
    """Same seed, same weights; fan-in std and zero norm gains as the
    reference initializers."""
    cfg = get_smoke_config("qwen3-4b").replace(d_model=256, d_ff=512)
    a = TM.init_model(cfg, 7, "cpu")
    b = TM.init_model(cfg, 7, "cpu")
    c = TM.init_model(cfg, 8, "cpu")
    assert torch.equal(a.layers[0].attn["wq"], b.layers[0].attn["wq"])
    assert not torch.equal(a.layers[0].attn["wq"], c.layers[0].attn["wq"])
    w = a.layers[0].mlp["w_up"].float()
    # truncated at 2 std: sample std ~0.88 / sqrt(fan_in)
    assert abs(float(w.std()) * 256 ** 0.5 - 0.88) < 0.05
    assert float(w.abs().max()) <= 2.0 / 256 ** 0.5 + 1e-6
    assert a.layers[0].attn["wq"].dtype == cfg.dtype
    assert float(a.layers[0].norm1.abs().max()) == 0.0
    assert a.final_norm.dtype == torch.float32


def test_gelu_mlp_bf16_matches_jax():
    """musicgen's gelu MLP in bf16 on the same weights and inputs: within
    2^-7 x max(1, |ref|) of the reference (``F.gelu`` with the tanh
    approximation rounds once; XLA may round each operation)."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(9)
    d, f = 256, 1024
    w = {"w_up": rng.standard_normal((d, f)) / d ** 0.5,
         "w_down": rng.standard_normal((f, d)) / f ** 0.5}
    x = 2.0 * rng.standard_normal((32, d))
    jw = {k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()}
    tw = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
          for k, v in w.items()}
    exp = np.asarray(jlayers.mlp(jw, jnp.asarray(x, jnp.bfloat16), "gelu")
                     .astype(jnp.float32))
    got = tlayers.mlp(tw, torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16), "gelu").float().numpy()
    assert np.abs(got - exp).max() <= 2.0 ** -7 * max(1.0, np.abs(exp).max())
