"""The port's paged KV cache and prefix reuse against the JAX package's on
the CPU: the allocator and prefix cache driven through the same random
operation sequences as the originals; the paged decode oracle against
``ref.paged_decode_mha_reference`` and the Pallas kernel in interpret mode;
the model's paged functions against the JAX ones on bridged weights; and
the paged engine's greedy and sampled streams against the port's ring
``Replica`` and the JAX paged ``Replica`` (granite-8b smoke, f32).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version tested here.

Tolerances: as ``test_torch_kernels.py`` for the kernel (f32 2e-5, bf16
2e-2 absolute) and ``test_torch_model.py`` for logits (1e-4 in f32).
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ref as jref
from repro.kernels.decode_attention import \
    paged_decode_attention as pallas_paged
from repro.models import model as JM
from repro.serving import engine as jeng
from repro.serving import paging as jpaging
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pk
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serving import engine as teng
from repro_torch.serving import paging as tpaging

TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOGIT_TOL = 1e-4
CAP, PS, CHUNK = 48, 8, 8


# ------------------------------------------------------- allocator / cache
def _state(alloc, cache=None):
    """Everything observable of an allocator (and its prefix cache)."""
    st = (list(alloc._free), list(alloc._ref))
    if cache is not None:
        st += (sorted((k, e.page, e.tick) for k, e in cache._entries.items()),
               cache.hits, cache.lookups, cache._tick)
    return st


def _alloc_ops(mod, ops_seq, num_pages):
    """The random machine of ``test_paging.py``'s allocator property over
    ``mod``'s ``PageAllocator``: alloc / share / release / COW.  Returns
    the state after every op and the outcome of each."""
    alloc = mod.PageAllocator(num_pages)
    held, trace = [], []
    for op in ops_seq:
        kind, arg = op % 4, op // 4
        out = None
        if kind == 0:
            out = alloc.alloc(arg % (num_pages + 2))
            if out is not None:
                held.extend(out)
        elif kind == 1 and held:
            p = held[arg % len(held)]
            alloc.incref(p)
            held.append(p)
        elif kind == 2 and held:
            out = alloc.decref(held.pop(arg % len(held)))
        elif kind == 3 and held:
            i = arg % len(held)
            try:
                out = alloc.ensure_writable(held[i])
                held[i] = out[0]
            except mod.PagingError:
                out = "full"
        alloc.check()
        for p in set(held):
            assert alloc.refcount(p) == held.count(p)
        trace.append((out, _state(alloc)))
    for p in held:
        alloc.decref(p)
    alloc.check()
    assert alloc.free_count == num_pages
    return trace


@pytest.mark.parametrize("seed,num_pages", [(0, 1), (1, 4), (2, 7), (3, 12)])
def test_allocator_random_ops_match_jax(seed, num_pages):
    """The same random op sequence through both copies of the allocator:
    identical outcomes and free-list/refcount states after every op, the
    invariants held throughout, and the pool fully free at the end."""
    ops_seq = np.random.default_rng(seed).integers(0, 10_000, size=200)
    assert _alloc_ops(tpaging, ops_seq, num_pages) == \
        _alloc_ops(jpaging, ops_seq, num_pages)


def _prefix_workload(mod, prompts, page_size, num_pages):
    """``test_paging.py``'s engine-shaped prefix workload: match -> alloc
    the uncached suffix (reclaiming on shortage) -> register -> retire an
    old lane every other request."""
    alloc = mod.PageAllocator(num_pages)
    cache = mod.PrefixCache(alloc, page_size)
    lanes, trace = [], []
    for i, prompt in enumerate(prompts):
        matched, pages = cache.match(prompt)
        need = len(prompt) // page_size - len(pages)
        fresh = alloc.alloc(need)
        if fresh is None:
            cache.reclaim(need - alloc.free_count)
            fresh = alloc.alloc(need)
        if fresh is None:
            for p in pages:
                alloc.decref(p)
            trace.append(("backed out", _state(alloc, cache)))
            continue
        pages = pages + fresh
        added = cache.register(prompt, pages) if len(prompt) >= page_size \
            else 0
        lanes.append(pages)
        if i % 2 == 1:
            for p in lanes.pop(0):
                alloc.decref(p)
        alloc.check()
        for p in cache.cached_pages():
            assert alloc.refcount(p) >= 1
        trace.append((matched, added, cache.reclaimable(),
                      _state(alloc, cache)))
    for pages in lanes:
        for p in pages:
            alloc.decref(p)
    cache.drop()
    alloc.check()
    assert alloc.free_count == num_pages
    return trace


@pytest.mark.parametrize("seed,page_size,num_pages",
                         [(0, 1, 8), (1, 2, 12), (2, 4, 24), (3, 2, 9)])
def test_prefix_cache_random_workload_matches_jax(seed, page_size,
                                                  num_pages):
    """Random prompts over a small alphabet (so prefixes collide): both
    prefix caches match, register, reclaim and hit alike, never leak, and
    keep the cache's own hold on every cached page."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 3, size=int(rng.integers(0, 20))).tolist()
               for _ in range(12)]
    assert _prefix_workload(tpaging, prompts, page_size, num_pages) == \
        _prefix_workload(jpaging, prompts, page_size, num_pages)


def test_paging_edge_rules():
    """Double free and bad incref raise ``PagingError``; alloc is
    all-or-nothing; COW copies only shared pages; keys chain from position
    0; re-registration adopts nothing; reclaim is LRU and spares referenced
    blocks — the port's copy, case by case."""
    alloc = tpaging.PageAllocator(4)
    (p,) = alloc.alloc(1)
    assert alloc.ensure_writable(p) == (p, False)
    alloc.incref(p)
    w, copied = alloc.ensure_writable(p)
    assert copied and w != p and alloc.refcount(p) == 1
    assert alloc.alloc(3) is None and alloc.free_count == 2
    for q in (p, w):
        alloc.decref(q)
    with pytest.raises(tpaging.PagingError):
        alloc.decref(p)
    with pytest.raises(tpaging.PagingError):
        alloc.incref(p)
    alloc.check()

    alloc = tpaging.PageAllocator(8)
    cache = tpaging.PrefixCache(alloc, page_size=2)
    a = alloc.alloc(2)
    assert cache.register([1, 2, 3, 4], a) == 2
    assert cache.match([9, 9, 3, 4]) == (0, [])
    assert cache.register([1, 2, 3, 4], alloc.alloc(2)) == 0
    matched, shared = cache.match([1, 2, 3, 4])
    assert matched == 4 and shared == a
    for q in a:
        alloc.decref(q)
    assert cache.reclaimable() == 0 and cache.reclaim(2) == 0
    for q in shared:
        alloc.decref(q)
    b = alloc.alloc(1)
    cache.register([7, 7], b)
    alloc.decref(b[0])
    _, got = cache.match([1, 2])            # touch block [1, 2]: [3, 4] ages
    alloc.decref(got[0])
    assert cache.reclaim(1) == 1
    assert a[1] not in cache.cached_pages() and a[0] in cache.cached_pages()
    assert cache.hit_rate() == pytest.approx(2 / 3)


# ------------------------------------------------------------- the kernel
def _paged_inputs(rng, dt, b=4, page=8, maxp=6, hq=8, hkv=2, d=16):
    """A shuffled pool with lanes 0 and 1 sharing their first two pages,
    absent entries, a page holding another slot's positions, every page's
    tail past its lane's length stale, and lane 3 with no page at all."""
    lens = np.array([21, 30, 1, 44], np.int32)
    npool = b * maxp
    perm = list(rng.permutation(npool))
    tables = np.full((b, maxp), -1, np.int32)
    pos = (rng.integers(0, maxp, size=(npool + 1, 1)) * page
           + np.arange(page)).astype(np.int32)
    pos[-1] = -1
    for i, ln in enumerate(lens[:3]):
        for j in range(-(-int(ln) // page)):
            if i == 1 and j < 2:
                tables[i, j] = tables[0, j]
                continue
            row = perm.pop()
            tables[i, j] = row
            p = j * page + np.arange(page)
            pos[row] = np.where(p < ln, p, pos[row])
    tables[1, 3] = -1                       # absent inside lane 1's range
    pos[tables[0, 2]] = 5 * page + np.arange(page)   # another slot's page
    qj, qt = _pair(rng.standard_normal((b, 1, hq, d)), dt)
    kj, kt = _pair(rng.standard_normal((npool + 1, page, hkv, d)), dt)
    vj, vt = _pair(rng.standard_normal((npool + 1, page, hkv, d)), dt)
    return lens, tables, pos, (qj, kj, vj), (qt, kt, vt)


def _pair(a, dt):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(JDT[dt]), torch.from_numpy(a).to(TDT[dt])


def _close(got_t, exp_j, dt, lanes=None):
    got = got_t.float().numpy()
    exp = np.asarray(exp_j.astype(jnp.float32))
    if lanes is not None:
        got, exp = got[lanes], exp[lanes]
    np.testing.assert_allclose(got, exp, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("window,softcap,dt", [(0, 0.0, "f32"),
                                               (16, 0.0, "f32"),
                                               (0, 30.0, "f32"),
                                               (16, 0.0, "bf16"),
                                               (0, 0.0, "bf16")])
def test_paged_plain_matches_reference_and_pallas(window, softcap, dt):
    """``paged_decode_attention_plain`` against the JAX oracle on every
    lane (the lane with no page included), and against the Pallas kernel
    in interpret mode on the lanes with a visible slot (the Pallas kernel
    writes zeros where the oracle averages equal masked logits)."""
    rng = np.random.default_rng(6)
    lens, tables, pos, (qj, kj, vj), (qt, kt, vt) = _paged_inputs(rng, dt)
    d = qt.shape[-1]
    kw = dict(window=window, scale=d ** -0.5, softcap=softcap)
    got = pk.paged_decode_attention_plain(
        qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(tables),
        cache_len=torch.from_numpy(lens), **kw)
    jargs = (qj, kj, vj, jnp.asarray(pos), jnp.asarray(tables))
    _close(got, jref.paged_decode_mha_reference(
        *jargs, cache_len=jnp.asarray(lens), **kw), dt)
    _close(got, pallas_paged(*jargs, cache_len=jnp.asarray(lens),
                             interpret=True, **kw), dt,
           lanes=np.array([True, True, True, False]))


def test_paged_wrapper_refuses_cpu_and_plain_calls_are_not_counted():
    rng = np.random.default_rng(8)
    lens, tables, pos, _, (qt, kt, vt) = _paged_inputs(rng, "f32")
    args = (qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(tables))
    kw = dict(cache_len=torch.from_numpy(lens), scale=0.25)
    with pytest.raises(RuntimeError, match="CUDA"):
        pk.paged_decode_attention(*args, **kw)
    ops.reset_kernel_launches()
    assert torch.equal(ops.paged_decode_attention(*args, **kw),
                       pk.paged_decode_attention_plain(*args, **kw))
    assert ops.kernel_launches()["paged_decode_attention"] == 0


# -------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def stacks():
    """granite-8b smoke weights (f32) on both sides of the bridge."""
    torch.set_num_threads(2)
    jc = jget_smoke("granite-8b").replace(dtype=jnp.float32,
                                          param_dtype=jnp.float32)
    tc = get_smoke_config("granite-8b").replace(dtype=torch.float32)
    jp = JM.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, jp, tc, tp


def _jax_layers(cache, cfg):
    """The JAX cache pytree as the port's per-layer list of numpy dicts."""
    out = []
    for i in range(cfg.num_layers):
        if i < cfg.num_periods * cfg.pattern_period:
            r, slot = divmod(i, cfg.pattern_period)
            leaves = {k: np.asarray(v)[r]
                      for k, v in cache["periods"][slot].items()}
        else:
            leaves = {k: np.asarray(v) for k, v in
                      cache["tail"][i - cfg.num_periods
                                    * cfg.pattern_period].items()}
        out.append(leaves)
    return out


def _assert_caches_equal(tcache, jcache, jc, atol=LOGIT_TOL):
    for tl, jl in zip(tcache, _jax_layers(jcache, jc)):
        np.testing.assert_array_equal(tl["pos"].numpy(), jl["pos"])
        for name in ("k", "v"):
            np.testing.assert_allclose(tl[name].numpy(), jl[name],
                                       atol=atol, rtol=atol)


def _prefill_ring(jc, jp, tc, tp, prompt, cap, chunk=8):
    """The same prompt chunk-prefilled into a B=1 ring on both sides."""
    jring, tring = JM.init_cache(jc, 1, cap), TM.init_cache(tc, 1, cap, "cpu")
    for c0 in range(0, len(prompt), chunk):
        piece = prompt[c0:c0 + chunk]
        jl, jring = JM.prefill_chunk(jp, jring, jnp.asarray(piece)[None], c0,
                                     jc)
        tl, tring = TM.prefill_chunk(tp, tring,
                                     torch.from_numpy(piece).long()[None], c0,
                                     tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    return jring, tring, tl


def test_paged_model_functions_match_jax(stacks):
    """``init_paged_cache``, ``paged_commit`` (with a shared prefix routed
    to the dump row), ``paged_copy_page``, ``paged_restore`` and
    ``decode_step(block_tables=...)`` over two lanes, one of them free,
    against the JAX functions: pools, rings and logits agree."""
    jc, jp, tc, tp = stacks
    cap, page, npages = 32, 8, 10
    rng = np.random.default_rng(9)
    prompt = rng.integers(2, tc.vocab_size, size=21).astype(np.int32)
    jring, tring, tl = _prefill_ring(jc, jp, tc, tp, prompt, cap)
    jpool = JM.init_paged_cache(jc, 2, cap, npages, page)
    tpool = TM.init_paged_cache(tc, 2, cap, npages, page, "cpu")
    _assert_caches_equal(tpool, jpool, jc)
    row = np.array([7, 2, 9, -1], np.int32)
    # first commit everything, then re-commit from position 8: the first
    # page is "shared" and must not be written again
    for from_pos in (0, 8):
        jpool = JM.paged_commit(jpool, jring, 0, jnp.asarray(row), from_pos,
                                jc, page)
        TM.paged_commit(tpool, tring, 0, torch.from_numpy(row), from_pos, tc,
                        page)
        _assert_caches_equal(tpool, jpool, jc)
    jpool = JM.paged_copy_page(jpool, 9, 4, jc)
    TM.paged_copy_page(tpool, 9, 4, tc)
    _assert_caches_equal(tpool, jpool, jc)
    for matched in (16, 21):
        jr = JM.paged_restore(jpool, JM.init_cache(jc, 1, cap),
                              jnp.asarray(row), matched, jc, page)
        tr = TM.paged_restore(tpool, TM.init_cache(tc, 1, cap, "cpu"),
                              torch.from_numpy(row), matched, tc, page)
        _assert_caches_equal(tr, jr, jc)
    # decode: lane 0 continues the prompt through its table, lane 1 is free
    tables = np.array([[7, 2, 9, 3], [-1, -1, -1, -1]], np.int32)
    jt = jnp.argmax(tl[:, -1].numpy(), -1)
    tok = np.array([[int(jt[0])], [5]], np.int32)
    idx = np.array([21, 11], np.int32)
    for _ in range(4):
        jl, jpool = JM.decode_step(jp, jpool, jnp.asarray(tok),
                                   jnp.asarray(idx), jc,
                                   block_tables=jnp.asarray(tables))
        tl2, _ = TM.decode_step(tp, tpool, torch.from_numpy(tok).long(),
                                torch.from_numpy(idx), tc,
                                block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(tl2[0].numpy(), np.asarray(jl)[0],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        tok[0, 0] = int(torch.argmax(tl2[0, -1]))
        assert tok[0, 0] == int(jnp.argmax(jl[0, -1]))
        idx += 1
    _assert_caches_equal(tpool, jpool, jc)


# ------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def engines(stacks):
    """Port ring / paged / paged+prefix replicas on the bridged weights,
    and the JAX paged+prefix replica on the originals: 2 lanes, capacity
    48, pages of 8, 8-token chunks."""
    jc, jp, tc, tp = stacks
    kw = dict(slots=2, capacity=CAP, prefill_chunk_tokens=CHUNK)
    ring = teng.Replica("ring", tc, tp, **kw)
    paged = teng.Replica("paged", tc, tp, paged=True, page_size=PS, **kw)
    prefix = teng.Replica("prefix", tc, tp, paged=True, page_size=PS,
                          prefix_cache=True, **kw)
    jprefix = jeng.Replica("jprefix", jc, jp, paged=True, page_size=PS,
                           prefix_cache=True, **kw)
    yield tc, tp, ring, paged, prefix, jprefix
    for r in (ring, paged, prefix, jprefix):
        r.stop()


def _prompts(vocab, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=s).astype(np.int32) for s in sizes]


def _req(mod, i, prompt, new=5, **kw):
    return mod.Request(i, np.asarray(prompt, np.int32), max_new_tokens=new,
                       deadline_ms=1e9, **kw)


def _concurrent(gen, reqs, gap_s=0.05):
    """Submit ``reqs`` from threads ``gap_s`` apart (later ones join while
    earlier ones decode); their token lists in order."""
    out = [None] * len(reqs)

    def go(i):
        time.sleep(i * gap_s)
        out[i] = gen(reqs[i]).tolist()
    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return out


def _drained(rep):
    """Only the prefix cache's own holds remain: free + cached partitions
    the pool, each cached page at refcount 1."""
    rep._alloc.check()
    cached = rep._prefix.cached_pages() if rep._prefix is not None else []
    assert all(rep._alloc.refcount(p) == 1 for p in cached)
    assert rep._alloc.free_count + len(cached) == rep.num_pages
    assert (rep._tables == -1).all()


def test_paged_streams_match_ring_capacity_prompt_included(engines):
    """Paged and paged+prefix greedy streams equal the ring replica's,
    a capacity-length prompt (every page of the lane's table) included,
    and the pools drain."""
    tc, tp, ring, paged, prefix, _ = engines
    for i, p in enumerate(_prompts(tc.vocab_size, [3, 17, 31, CAP], 7)):
        n = 1 if len(p) == CAP else 6
        want = ring.generate(_req(teng, 100 + i, p, n)).tolist()
        assert paged.generate(_req(teng, 200 + i, p, n)).tolist() == want
        assert prefix.generate(_req(teng, 300 + i, p, n)).tolist() == want
    _drained(paged)
    _drained(prefix)


def test_paged_mid_stream_join_and_sampled_lanes_match_ring(engines):
    """A greedy lane and a seeded sampled lane joining while another
    decodes: every stream equals the ring replica's (the ghost-write rule:
    a mid-prefill lane's table row is not visible to the batched step)."""
    tc, tp, ring, paged, prefix, _ = engines
    pa, pb, pc = _prompts(tc.vocab_size, [21, 13, 9], 11)
    kws = [dict(), dict(), dict(temperature=0.9, top_k=8, seed=42)]
    news = [10, 6, 6]
    want = [ring.generate(_req(teng, 110 + i, p, n, **kw)).tolist()
            for i, (p, n, kw) in enumerate(zip((pa, pb, pc), news, kws))]
    for rep in (paged, prefix):
        reqs = [_req(teng, 210 + i, p, n, **kw)
                for i, (p, n, kw) in enumerate(zip((pa, pb, pc), news, kws))]
        assert _concurrent(rep.generate, reqs) == want
        _drained(rep)


def test_prefix_sharers_prefill_system_prompt_once_as_jax_does(engines):
    """A seed request, then two concurrent sharers of its two-page system
    prompt: the port computes the system prompt once, each sharer only its
    suffix, and the streams and the counts equal the JAX replica's."""
    tc, tp, ring, _, prefix, jprefix = engines
    rng = np.random.default_rng(17)
    sysp = rng.integers(1, tc.vocab_size, size=2 * PS).astype(np.int32)
    sufs = _prompts(tc.vocab_size, [5, 3, 7], 18)
    prompts = [np.concatenate([sysp, s]) for s in sufs]
    wants = [ring.generate(_req(teng, 130 + i, p)).tolist()
             for i, p in enumerate(prompts)]
    counts = []
    for mod, rep in ((teng, prefix), (jeng, jprefix)):
        seen = (rep._prefix.hits, rep._prefix.lookups)
        base = rep.prefilled_tokens
        assert rep.generate(_req(mod, 230, prompts[0])).tolist() == wants[0]
        assert rep.prefilled_tokens - base == len(prompts[0])
        base = rep.prefilled_tokens
        got = _concurrent(rep.generate, [_req(mod, 231 + i, prompts[1 + i])
                                         for i in range(2)], gap_s=0.0)
        assert got == wants[1:]
        assert rep.prefilled_tokens - base == sum(len(s) for s in sufs[1:])
        rep._alloc.check()
        counts.append((rep._prefix.hits - seen[0],
                       rep._prefix.lookups - seen[1]))
    assert counts[0] == counts[1] == (2, 3)


def test_prefix_full_hit_copies_on_write_and_keeps_shared_pages_clean(
        engines):
    """The same prompt three times: the second and third are full hits
    that copy the last page and recompute one token; the cached pages'
    K/V/pos never change, though lanes decode past them."""
    tc, tp, ring, _, prefix, _ = engines
    (p,) = _prompts(tc.vocab_size, [2 * PS], 19)
    want = ring.generate(_req(teng, 140, p, 4)).tolist()
    assert prefix.generate(_req(teng, 240, p, 4)).tolist() == want
    key, cached = b"", []
    for blk in (p[:PS], p[PS:]):
        key = tpaging._block_hash(key, blk)
        cached.append(prefix._prefix._entries[key].page)
    snap = [{k: v[cached].clone() for k, v in layer.items()}
            for layer in prefix._cache]
    base_cow, base_tok = prefix.cow_copies, prefix.prefilled_tokens
    got = _concurrent(prefix.generate, [_req(teng, 241, p, 4),
                                        _req(teng, 242, p, 4)])
    assert got == [want, want]
    assert prefix.cow_copies - base_cow == 2
    assert prefix.prefilled_tokens - base_tok == 2      # the recomputes
    key = b""
    for blk, page in zip((p[:PS], p[PS:]), cached):
        key = tpaging._block_hash(key, blk)
        assert prefix._prefix._entries[key].page == page
    for layer, old in zip(prefix._cache, snap):
        for k, v in old.items():
            assert torch.equal(layer[k][cached], v)
    _drained(prefix)


def test_mid_prefill_lane_never_writes_shared_prefix_pages(stacks):
    """The ghost-write rule.  Lane 1 is left at a stale index inside the
    system prompt's first page; a sharer then prefills there in several
    chunks while lane 0 keeps decoding.  The batched step writes every
    lane slot, so had the sharer's table row been published at admission
    the step would write through it into the shared page.  The cached
    pages stay bit-identical and every stream equals the ring path's."""
    jc, jp, tc, tp = stacks
    kw = dict(slots=2, capacity=256, prefill_chunk_tokens=CHUNK)
    ring = teng.Replica("ring-ghost", tc, tp, **kw)
    rep = teng.Replica("ghost", tc, tp, paged=True, page_size=PS,
                       prefix_cache=True, **kw)
    try:
        rng = np.random.default_rng(37)
        sysp = rng.integers(1, tc.vocab_size, size=2 * PS).astype(np.int32)
        seed_p, short, long_, c_p, d_p = (
            np.concatenate([sysp, rng.integers(1, tc.vocab_size, 3)]),
            rng.integers(1, tc.vocab_size, 5), rng.integers(1, tc.vocab_size, 4),
            np.concatenate([sysp, rng.integers(1, tc.vocab_size, 20)]),
            np.concatenate([sysp, rng.integers(1, tc.vocab_size, 6)]))
        reqs = [(seed_p, 3), (short, 3), (long_, 250), (c_p, 4), (d_p, 4)]
        want = [ring.generate(_req(teng, 160 + i, p, n)).tolist()
                for i, (p, n) in enumerate(reqs)]
        got = [rep.generate(_req(teng, 260, seed_p, 3)).tolist()]
        key, pages = b"", []
        for blk in (sysp[:PS], sysp[PS:]):
            key = tpaging._block_hash(key, blk)
            pages.append(rep._prefix._entries[key].page)
        snap = [{k: v[pages].clone() for k, v in layer.items()}
                for layer in rep._cache]
        # the long request decodes on lane 0; the short one takes lane 1 and
        # leaves it at index 7, where the sharer then prefills
        out = {}

        def go(i):
            out[i] = rep.generate(_req(teng, 260 + i, *reqs[i])).tolist()

        def wait_for(cond):
            t0 = time.monotonic()
            while not cond():
                assert time.monotonic() - t0 < 60
                time.sleep(0.001)
        long_thread = threading.Thread(target=go, args=(2,))
        long_thread.start()
        wait_for(lambda: rep._lanes[0] is not None)
        go(1)
        assert rep._idx[1] == len(short) + 2
        go(3)
        assert rep._lanes[0] is not None        # lane 0 decoded throughout
        long_thread.join(timeout=120)
        assert not long_thread.is_alive()
        go(4)
        got += [out[i] for i in (1, 2, 3, 4)]
        assert got == want
        for layer, old in zip(rep._cache, snap):
            for k, v in old.items():
                assert torch.equal(layer[k][pages], v)
        _drained(rep)
    finally:
        ring.stop()
        rep.stop()


def test_eviction_under_pressure_never_frees_live_pages(stacks):
    """A pool of barely two lanes: distinct prompts force LRU reclaim of
    cached blocks at admission, concurrent sharers of the newest prompt
    keep theirs, and every stream equals the ring path's."""
    jc, jp, tc, tp = stacks
    kw = dict(slots=2, capacity=32, prefill_chunk_tokens=CHUNK)
    ring = teng.Replica("ring32", tc, tp, **kw)
    small = teng.Replica("small", tc, tp, paged=True, page_size=PS,
                         num_pages=8, prefix_cache=True, **kw)
    try:
        prompts = _prompts(tc.vocab_size, [16, 16, 16, 16], 23)
        wants = [ring.generate(_req(teng, 150 + i, p, 3)).tolist()
                 for i, p in enumerate(prompts)]
        for i, (p, w) in enumerate(zip(prompts, wants)):
            assert small.generate(_req(teng, 250 + i, p, 3)).tolist() == w
            small._alloc.check()
        assert len(small._prefix) < 2 * len(prompts)       # reclaimed
        got = _concurrent(small.generate, [_req(teng, 260 + i, prompts[-1], 3)
                                           for i in range(2)], gap_s=0.0)
        assert got == [wants[-1]] * 2
        _drained(small)
    finally:
        ring.stop()
        small.stop()


def test_paged_admission_refuses_unservable_and_validates_config(stacks):
    """A prompt past the paged capacity is refused in the caller's thread;
    a request needing more pages than the pool holds is refused; a pool
    below one lane and a zero page size are configuration errors."""
    jc, jp, tc, tp = stacks
    tight = teng.Replica("tight", tc, tp, slots=2, capacity=32,
                         prefill_chunk_tokens=CHUNK, paged=True,
                         page_size=PS, num_pages=4)
    try:
        p16, p33 = _prompts(tc.vocab_size, [16, 33], 29)
        assert len(tight.generate(_req(teng, 270, p16, 3))) == 3
        with pytest.raises(teng.ReplicaRefused, match="capacity"):
            tight.generate(_req(teng, 271, p33, 1))
        _drained(tight)
    finally:
        tight.stop()
    with pytest.raises(ValueError, match="num_pages"):
        teng.Replica("bad", tc, tp, slots=1, capacity=32, paged=True,
                     page_size=PS, num_pages=1)
    with pytest.raises(ValueError, match="page_size"):
        teng.Replica("bad", tc, tp, slots=1, capacity=32, paged=True,
                     page_size=0)


def test_paged_telemetry_feeds_update_profile(engines):
    """A paged replica's measured profile gets the step curve from paged
    steps, and serving publishes ``free_pages`` (free + reclaimable) and
    ``prefix_hit_rate`` into it; ring replicas leave them unset."""
    tc, tp, ring, _, prefix, _ = engines
    prof = teng.profile_replica(prefix, prompt_lens=(8,), new_tokens=2,
                                steps_per_point=1)
    assert prof.step_curve is not None and len(prof.step_curve.xs) == 2
    prefix.profile = prof
    try:
        rng = np.random.default_rng(31)
        sysp = rng.integers(1, tc.vocab_size, size=PS).astype(np.int32)
        for i in range(2):
            prefix.generate(_req(teng, 280 + i, np.concatenate(
                [sysp, rng.integers(1, tc.vocab_size, size=3)]), 2))
        assert prof.free_pages == prefix._alloc.free_count \
            + prefix._prefix.reclaimable()
        assert 0.0 < prof.prefix_hit_rate == prefix._prefix.hit_rate()
    finally:
        prefix.profile = None
    assert ring.profile is None or ring.profile.free_pages == -1.0


def test_serve_cli_paged_prefix_runs_on_cpu(capsys):
    tserve.main(["--device", "cpu", "--prefix-cache", "--requests", "3",
                 "--interval-ms", "1", "--new-tokens", "4",
                 "--prompt-len", "20"])
    out = capsys.readouterr().out
    assert "paged KV" in out and "prefix cache" in out
    assert "outcomes: ok=3 rejected=0 shed=0 lost=0" in out


# ------------------------------------------------------- recurrent stacks
def _recurrent_engines(arch, seed, capacity):
    """Port ring and paged replicas of ``arch``'s smoke config (f32) on
    one set of seeded weights: 2 lanes, 8-token chunks, pages of 8."""
    torch.set_num_threads(2)
    cfg = get_smoke_config(arch).replace(dtype=torch.float32)
    params = TM.init_model(cfg, seed, "cpu")
    kw = dict(slots=2, capacity=capacity, prefill_chunk_tokens=CHUNK)
    ring = teng.Replica("ring", cfg, params, **kw)
    paged = teng.Replica("paged", cfg, params, paged=True, page_size=PS, **kw)
    return cfg, params, ring, paged


@pytest.fixture(scope="module")
def ssm_engines():
    cfg, params, ring, paged = _recurrent_engines("mamba2-780m", 1, 64)
    yield cfg, params, ring, paged
    ring.stop()
    paged.stop()


def test_paged_token_identity_ssm(ssm_engines):
    """Pure-SSM stack (no attention layer, so no page pool at all): the
    paged engine's recurrent-state plumbing is still token-identical,
    concurrent joins included."""
    cfg, params, ring, paged = ssm_engines
    pa, pb = _prompts(cfg.vocab_size, [19, 9], 37)
    want = [ring.generate(_req(teng, 300, pa, 6)).tolist(),
            ring.generate(_req(teng, 301, pb, 4)).tolist()]
    got = _concurrent(paged.generate, [_req(teng, 310, pa, 6),
                                       _req(teng, 311, pb, 4)])
    assert got == want
    _drained(paged)


def test_prefix_cache_refused_on_recurrent_stack(ssm_engines):
    """Prefix reuse needs positions portable across lanes, which only
    global-attention KV is: a recurrent stack refuses the knob loudly."""
    cfg, params, *_ = ssm_engines
    with pytest.raises(ValueError):
        teng.Replica("bad", cfg, params, slots=1, capacity=32, paged=True,
                     page_size=PS, prefix_cache=True)


@pytest.fixture(scope="module")
def rglru_engines():
    cfg, params, ring, paged = _recurrent_engines("recurrentgemma-9b", 2, 32)
    yield cfg, params, ring, paged
    ring.stop()
    paged.stop()


def test_paged_token_identity_rglru(rglru_engines):
    """Griffin stack (RG-LRU + local attention, window 16 < capacity): a
    28-token prompt spans the local ring's wrap, the hybrid stack's
    hardest alignment case; paged must match ring exactly, and prefix
    reuse is refused."""
    cfg, params, ring, paged = rglru_engines
    pa, pb = _prompts(cfg.vocab_size, [28, 7], 41)
    for i, (p, n) in enumerate([(pa, 4), (pb, 5)]):
        want = ring.generate(_req(teng, 400 + i, p, n)).tolist()
        got = paged.generate(_req(teng, 410 + i, p, n)).tolist()
        assert got == want, f"prompt len {len(p)}"
    with pytest.raises(ValueError):      # local window < capacity: no reuse
        teng.Replica("bad", cfg, params, slots=1, capacity=32, paged=True,
                     page_size=PS, prefix_cache=True)


def test_paged_moves_leave_recurrent_leaves_alone(rglru_engines):
    """On a hybrid stack ``paged_copy_page`` and ``paged_restore`` touch
    only the attention pools and rings, never a recurrent layer's
    per-lane state, while ``paged_commit`` splices the lane's recurrent
    state into its batch row and leaves the other lane's row alone."""
    cfg, params, *_ = rglru_engines
    cap, npages = 32, 10
    gen = torch.Generator().manual_seed(5)
    pool = TM.init_paged_cache(cfg, 2, cap, npages, PS, "cpu")
    lane = TM.init_cache(cfg, 1, cap, "cpu")
    kinds = cfg.layer_kinds()
    for layers in (pool, lane):
        for kind, layer in zip(kinds, layers):
            for name, t in layer.items():
                if name != "pos":
                    t.copy_(torch.randn(t.shape, generator=gen))
            if kind == "attn":
                layer["pos"].copy_(torch.arange(layer["pos"].numel(),
                                                dtype=torch.int32)
                                   .reshape(layer["pos"].shape) % cap)

    def recurrent(layers):
        return [{k: v.clone() for k, v in layer.items()}
                for kind, layer in zip(kinds, layers) if kind != "attn"]

    before = recurrent(pool)
    TM.paged_copy_page(pool, 3, 4, cfg)
    for kind, layer in zip(kinds, pool):
        if kind == "attn":
            for t in layer.values():
                assert torch.equal(t[4], t[3])
    for a, b in zip(recurrent(pool), before):
        assert all(torch.equal(a[k], b[k]) for k in a)

    row = torch.tensor([7, 2, 9, -1], dtype=torch.int32)
    lane_before = recurrent(lane)
    TM.paged_restore(pool, lane, row, 20, cfg, PS)
    for a, b in zip(recurrent(lane), lane_before):
        assert all(torch.equal(a[k], b[k]) for k in a)
    attn = [layer for kind, layer in zip(kinds, lane) if kind == "attn"]
    assert all(int(layer["pos"].max()) == 19 for layer in attn)

    TM.paged_commit(pool, lane, 1, row, 0, cfg, PS)
    for a, b, ring in zip(recurrent(pool), before,
                          [layer for kind, layer in zip(kinds, lane)
                           if kind != "attn"]):
        for k in a:
            assert torch.equal(a[k][1], ring[k][0].to(a[k].dtype))
            assert torch.equal(a[k][0], b[k][0])
