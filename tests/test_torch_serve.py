"""Serving over a paged KV cache, port against the JAX package
(tests/test_serve.py's pins): the paged primitives, GPT-2's and Llama's
paged decode, the block tables and prefix cache, the engine, the request
file and the CLI.

Tolerances: scatter, copy and gather bytes equal JAX's
(``np.array_equal``; the port's pool carries one scratch page past JAX's,
left out of the comparison), paged attention within ``1e-5``. At float32
compute the paged decode logits and page contents are held to JAX's within
``1e-5`` (the bound of the port's other float32 model comparisons), and the
port's paged decode is ``torch.equal`` to its dense decode at the same
attended length. A right-padded prefill writes no byte outside the real
tokens' cells (exact); its real positions are within ``1e-5`` of the
unpadded prefill's and its next greedy token equal. The block tables and
prefix cache take one seeded op sequence in both packages: tables,
refcounts, free lists and every return value identical. The engines serve
the same weights and staggered requests: tokens and reasons equal up to the
first token where JAX's top-2 logit margin is below ``MARGIN`` (ten times
the logit tolerance, tests/test_torch_generate.py's rule). Inside the port:
staggered ≡ solo (greedy and sampled), prefix sharing ≡ unshared, EOS and
overflow evictions free every page, the fairness cap changes when and not
what, and NF4 serves from a smaller tree.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2Config
from distributed_lion_tpu.models.gpt2 import gpt2_decode as j_gpt2_decode
from distributed_lion_tpu.models.gpt2 import gpt2_decode_paged as j_gpt2_decode_paged
from distributed_lion_tpu.models.gpt2 import gpt2_init as j_gpt2_init
from distributed_lion_tpu.models.gpt2 import gpt2_init_cache as j_gpt2_init_cache
from distributed_lion_tpu.models.llama import LlamaConfig as JLlamaConfig
from distributed_lion_tpu.models.llama import llama_decode as j_llama_decode
from distributed_lion_tpu.models.llama import llama_decode_paged as j_llama_decode_paged
from distributed_lion_tpu.models.llama import llama_init as j_llama_init
from distributed_lion_tpu.models.llama import llama_init_cache as j_llama_init_cache
from distributed_lion_tpu.ops import attention as jatt
from distributed_lion_tpu.serve import api as japi
from distributed_lion_tpu.serve import engine as jeng
from distributed_lion_tpu.serve import kv_cache as jkv
from distributed_lion_tpu_torch.cli import run_serve
from distributed_lion_tpu_torch.models.gpt2 import (
    GPT2Config,
    gpt2_decode,
    gpt2_decode_paged,
    gpt2_init_cache,
)
from distributed_lion_tpu_torch.models.llama import (
    LlamaConfig,
    llama_decode,
    llama_decode_paged,
    llama_init_cache,
)
from distributed_lion_tpu_torch.ops import attention as tatt
from distributed_lion_tpu_torch.serve import api
from distributed_lion_tpu_torch.serve import kv_cache
from distributed_lion_tpu_torch.serve.engine import (
    Request,
    ServeConfig,
    ServeModel,
    ServingEngine,
    weight_bytes,
)
from distributed_lion_tpu_torch.utils.serialization import llama_params_from_jax

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-4
# the engines' geometry: prompts of up to 16 tokens take two prefill buckets
GEOM = dict(max_seqs=4, block_size=8, max_blocks_per_seq=8)
LENS = (3, 9, 5, 14, 7)
ARRIVALS = {"r0": 0, "r1": 1, "r2": 1, "r3": 3, "r4": 5}
NEW = 6


def _requests(vocab, lens=LENS, seed=3, new=NEW, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(f"r{i}", list(map(int, rng.integers(1, vocab, n))), new, i)
            for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def fams() -> dict:
    """name → JAX config and params, port config and params, and JAX's
    engine with its staggered run and stats, at float32 compute; the JAX
    engine is built once (two prefill buckets and the decode tick)."""
    out = {}
    for name, jcfg, tcfg, init, for_model in (
            ("gpt2", JGPT2Config.tiny(compute_dtype=jnp.float32),
             GPT2Config.tiny(compute_dtype=torch.float32), j_gpt2_init,
             jeng.ServeModel.for_gpt2),
            ("llama", JLlamaConfig.tiny(compute_dtype=jnp.float32),
             LlamaConfig.tiny(compute_dtype=torch.float32), j_llama_init,
             jeng.ServeModel.for_llama)):
        jparams = init(jax.random.key(5), jcfg)
        tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams))
        engine = jeng.ServingEngine(for_model(jparams, jcfg), jeng.ServeConfig(**GEOM))
        done = engine.run(_requests(jcfg.vocab_size, cls=jeng.Request), arrivals=ARRIVALS)
        out[name] = dict(jcfg=jcfg, jparams=jparams, tcfg=tcfg, tparams=tparams,
                         engine=engine, done=done, stats=dict(engine.stats))
    return out


def _port_model(name, tcfg, tparams):
    return (ServeModel.for_gpt2 if name == "gpt2" else ServeModel.for_llama)(tparams, tcfg)


def _port_engine(fams, name="gpt2", **kw):
    f = fams[name]
    return ServingEngine(_port_model(name, f["tcfg"], f["tparams"]),
                         ServeConfig(**(GEOM | kw)))


def _pool(rng, nb, bs=4, kv=2, hd=8):
    """A JAX pool of ``nb`` pages and the port's copy with its scratch page."""
    j = rng.standard_normal((nb, bs, kv, hd)).astype(np.float32)
    t = torch.from_numpy(np.concatenate([j, rng.standard_normal((1, bs, kv, hd))
                                         .astype(np.float32)]))
    return jnp.asarray(j), t


# ---------------------------------------------------------------- (a) primitives
def test_paged_scatter_matches_jax():
    """Shuffled pages, a window straddling a page, a sentinel row (an idle
    slot), a valid mask (a padded tail) and positions past the table
    (``mode="clip"``): the same bytes as JAX's scatter."""
    rng = np.random.default_rng(0)
    NB, B, S = 6, 4, 5
    jpool, tpool = _pool(rng, NB)
    tables = np.array([[3, 1, 5], [0, 2, NB], [NB, NB, NB], [4, NB, NB]], np.int32)
    pos = np.array([2, 3, 0, 9], np.int32)
    valid = np.ones((B, S), bool)
    valid[1, 3:] = False
    new = rng.standard_normal((B, S, 2, 8)).astype(np.float32)
    want = jatt.paged_scatter_kv(jpool, jnp.asarray(tables), jnp.asarray(pos),
                                 jnp.asarray(new), jnp.asarray(valid))
    got = tatt.paged_scatter_kv(tpool, torch.from_numpy(tables), torch.from_numpy(pos),
                                torch.from_numpy(new), torch.from_numpy(valid))
    assert got is tpool   # in place
    np.testing.assert_array_equal(got[:NB].numpy(), np.asarray(want))


def test_paged_copy_pages_matches_jax():
    """Copy pairs padded with the sentinel, a source that is also a
    destination: every source read before any write, as JAX's."""
    rng = np.random.default_rng(1)
    NB = 6
    jk, tk = _pool(rng, NB)
    jv, tv = _pool(rng, NB)
    src = np.array([1, 4, NB, NB], np.int32)
    dst = np.array([4, 0, NB, NB], np.int32)
    want = jatt.paged_copy_pages([{"k": jk, "v": jv}], jnp.asarray(src), jnp.asarray(dst))
    got = tatt.paged_copy_pages([{"k": tk, "v": tv}], torch.from_numpy(src),
                                torch.from_numpy(dst))
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[0][key][:NB].numpy(), np.asarray(want[0][key]))


def test_paged_gather_matches_jax():
    rng = np.random.default_rng(2)
    NB = 5
    jpool, tpool = _pool(rng, NB)
    tables = np.array([[2, 0, NB], [NB, 4, 1]], np.int32)
    want = jatt.paged_gather_kv(jpool, jnp.asarray(tables))
    got = tatt.paged_gather_kv(tpool, torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_decode_attention_matches_jax():
    """GQA (4 query heads over 2 kv heads), a two-token window, sentinel
    pages and ``start``: within 1e-5 of JAX's."""
    rng = np.random.default_rng(3)
    NB = 6
    jk, tk = _pool(rng, NB)
    jv, tv = _pool(rng, NB)
    tables = np.array([[1, 3, NB], [5, 0, 2]], np.int32)
    pos, start = np.array([4, 9], np.int32), np.array([0, 2], np.int32)
    q = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    want = jatt.paged_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(tables),
                                       jnp.asarray(pos), jnp.asarray(start))
    got = tatt.paged_decode_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(tables),
                                      torch.from_numpy(pos), torch.from_numpy(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ (b) paged decode
def _decoders(name):
    if name == "gpt2":
        return j_gpt2_decode_paged, gpt2_decode_paged, gpt2_decode, gpt2_init_cache
    return j_llama_decode_paged, llama_decode_paged, llama_decode, llama_init_cache


def _kv_heads(cfg):
    return getattr(cfg, "n_kv_head", cfg.n_head)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_decode_paged_matches_jax_over_shuffled_tables(fams, name):
    """A prefill and three decode steps through shuffled tables: logits and
    page contents within 1e-5 of JAX's ``*_decode_paged``."""
    jcfg, jparams, tcfg, tparams = (fams[name][k] for k in ("jcfg", "jparams", "tcfg",
                                                            "tparams"))
    jpaged, tdec, _, _ = _decoders(name)
    B, L, bs, NB = 2, 7, 4, 8
    shape = (NB, bs, _kv_heads(tcfg), tcfg.head_dim)
    jpages = [{k: jnp.zeros(shape, jnp.float32) for k in ("k", "v")}
              for _ in range(tcfg.n_layer)]
    tpages = kv_cache.init_pages(tcfg.n_layer, NB, bs, shape[2], shape[3], torch.float32, "cpu")
    tables = np.array([[2, 0, 1, 3], [5, 7, 4, 6]], np.int32)
    toks = np.random.default_rng(4).integers(1, tcfg.vocab_size, (B, L + 3))
    steps = [(0, L)] + [(i, i + 1) for i in range(L, L + 3)]
    jdec = jax.jit(lambda p, t, pg, tab, pos: jpaged(p, t, jcfg, pg, tab, pos))
    for lo, hi in steps:
        pos = np.full((B,), lo, np.int32)
        want, jpages = jdec(jparams, jnp.asarray(toks[:, lo:hi], jnp.int32), jpages,
                            jnp.asarray(tables), jnp.asarray(pos))
        got, tpages = tdec(tparams, torch.from_numpy(toks[:, lo:hi]), tcfg, tpages,
                           torch.from_numpy(tables), torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"{name} {lo}", **TOL)
    for jl, tl in zip(jpages, tpages):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl[key][:NB].numpy(), np.asarray(jl[key]), **TOL)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_decode_paged_equal_to_dense(fams, name):
    """The mirror of tests/test_serve.py:39: a prefill and five greedy
    steps through shuffled tables are ``torch.equal`` to the dense cache's
    at the same attended length (16 slots)."""
    tcfg, tparams = fams[name]["tcfg"], fams[name]["tparams"]
    _, tdec, dense, init_cache = _decoders(name)
    B, L, bs, nbw = 2, 7, 4, 4
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, tcfg.vocab_size, (B, L)))
    cache = init_cache(tcfg, B, bs * nbw)
    pages = kv_cache.init_pages(tcfg.n_layer, B * nbw, bs, _kv_heads(tcfg), tcfg.head_dim,
                                torch.float32, "cpu")
    tables = torch.tensor([[2, 0, 1, 3], [5, 7, 4, 6]])
    dl, cache = dense(tparams, toks, tcfg, cache, 0)
    pl, pages = tdec(tparams, toks, tcfg, pages, tables, torch.zeros(B, dtype=torch.long))
    assert torch.equal(dl, pl)
    cur = torch.argmax(dl[:, -1], -1)
    for i in range(5):
        dl, cache = dense(tparams, cur[:, None], tcfg, cache, L + i)
        pl, pages = tdec(tparams, cur[:, None], tcfg, pages, tables,
                         torch.full((B,), L + i))
        assert torch.equal(dl, pl), i
        cur = torch.argmax(dl[:, -1], -1)


# ----------------------------------------------------- (c) right-padded prefill
def test_padded_prefill_drops_the_tail(fams):
    """The engine's bucketed shape: a prompt of 5 padded to 8 writes only
    the real tokens' cells (every other byte of the pool stays zero); its
    real positions are within 1e-5 of the unpadded prefill's (the port's
    shapes differ, so bit-equality is not claimed) and the next greedy
    token and its logits agree."""
    tcfg, tparams = fams["gpt2"]["tcfg"], fams["gpt2"]["tparams"]
    L, P, bs = 5, 8, 4
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, tcfg.vocab_size, (1, L)))
    padded = torch.cat([toks, torch.zeros(1, P - L, dtype=toks.dtype)], 1)

    def pages():
        return kv_cache.init_pages(tcfg.n_layer, 4, bs, tcfg.n_head, tcfg.head_dim,
                                   torch.float32, "cpu")

    tables, zero = torch.tensor([[0, 1, 2, 3]]), torch.zeros(1, dtype=torch.long)
    ref, ref_pages = gpt2_decode_paged(tparams, toks, tcfg, pages(), tables, zero)
    valid = torch.arange(P)[None, :] < L
    got, got_pages = gpt2_decode_paged(tparams, padded, tcfg, pages(), tables, zero, valid)
    np.testing.assert_allclose(got[:, :L].numpy(), ref.numpy(), **TOL)
    for lp in got_pages:
        for key in ("k", "v"):
            cells = lp[key][:4].reshape(-1, *lp[key].shape[2:])
            assert not cells[L:].any(), key   # no pad byte reached a page
    nxt = torch.argmax(ref[:, L - 1], -1)[:, None]
    assert torch.equal(nxt, torch.argmax(got[:, L - 1], -1)[:, None])
    lens = torch.full((1,), L)
    a, _ = gpt2_decode_paged(tparams, nxt, tcfg, ref_pages, tables, lens)
    b, _ = gpt2_decode_paged(tparams, nxt, tcfg, got_pages, tables, lens)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ------------------------------------------------ (d) tables and prefix cache
def _state(bt, pc):
    return (bt.tables.tolist(), bt.owned.tolist(), bt.refs.tolist(),
            [list(f) for f in bt._free], bt.pages_allocated, pc.chains(), len(pc),
            pc.hits, pc.misses, pc.reclaimed_pages)


def test_block_tables_and_prefix_cache_fuzz_equal_jax():
    """One seeded sequence of grow, shrink, share, cow, free, match,
    register and reclaim through both packages' ``BlockTables`` and
    ``PrefixCache`` (the mirror of tests/test_serve.py:218): every return
    value and the whole state equal after each op."""
    rng = np.random.default_rng(42)
    geom = dict(num_blocks=24, block_size=4, max_seqs=4, max_blocks_per_seq=6)
    pair = []
    for mod in (jkv, kv_cache):
        bt = mod.BlockTables(**geom)
        pair.append((bt, mod.PrefixCache(bt)))
    prompts = [list(rng.integers(1, 9, n)) for n in (7, 10, 13, 5)]
    prompts += [prompts[1][:8] + [7, 7], list(prompts[2])]
    for step in range(500):
        op = rng.choice(["grow", "shrink", "free", "share", "cow", "match", "register",
                         "reclaim"])
        s, donor = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        n = int(rng.integers(0, 24))
        prompt = [int(t) for t in prompts[int(rng.integers(0, len(prompts)))]]
        outs = []
        for bt, pc in pair:
            if op == "grow":
                out = bt.grow(s, n)
            elif op == "shrink":
                out = bt.shrink(s, n)
            elif op == "free":
                out = bt.free_slot(s)
            elif op == "share":
                run = [int(p) for p in bt.tables[donor, :bt.owned[donor]]][:n // 4 + 1]
                out = bt.share(s, run) if run and not bt.owned[s] else "skip"
            elif op == "cow":
                out = bt.cow(s, n) if bt.shared_at(s, n) else "skip"
            elif op == "match":
                out = pc.match(prompt)
            elif op == "register":
                ok = bt.owned[s] * bt.block_size > len(prompt)
                out = pc.register(s, prompt) if ok else "skip"
            else:
                out = pc.reclaim(n)
            outs.append(copy.deepcopy(out))
        assert outs[0] == outs[1], (step, op, outs)
        assert _state(*pair[0]) == _state(*pair[1]), (step, op)


# ------------------------------------------------------------------ (e) engine
def _held_to_jax(name, jcfg, jparams, req, want, got):
    """``got`` equals JAX's ``want`` (tokens and reason), or they part where
    JAX's own top-2 margin is below MARGIN (its dense decode on the history
    up to there)."""
    if got.tokens == want.tokens:
        assert got.reason == want.reason, req.req_id
        return
    j = next(i for i, (a, b) in enumerate(zip(want.tokens, got.tokens)) if a != b)
    dec, init = ((j_gpt2_decode, j_gpt2_init_cache) if name == "gpt2"
                 else (j_llama_decode, j_llama_init_cache))
    hist = jnp.asarray([list(req.tokens) + want.tokens[:j]], jnp.int32)
    logits, _ = dec(jparams, hist, jcfg, init(jcfg, 1, hist.shape[1]), 0)
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    assert top2[1] - top2[0] < MARGIN, (req.req_id, j, top2)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_engine_matches_jax_engine(fams, name):
    """The same weights and staggered requests through both engines:
    tokens and reasons equal (MARGIN rule), the same admission stats."""
    f = fams[name]
    engine = _port_engine(fams, name)
    reqs = _requests(f["tcfg"].vocab_size)
    got = engine.run(reqs, arrivals=ARRIVALS)
    for r in reqs:
        _held_to_jax(name, f["jcfg"], f["jparams"], r, f["done"][r.req_id], got[r.req_id])
    for key in ("ticks", "decode_ticks", "prefill_dispatches", "padded_prefill_tokens",
                "evictions"):
        assert engine.stats[key] == f["stats"][key], key
    assert engine.stats["serve_retraces"] == 0
    assert engine.tables.free_blocks == engine.cfg.resolved_num_blocks()


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_staggered_equals_solo(fams, sampling):
    """A request's tokens depend on neither its slot, its batchmates nor
    arrival order: per-row streams keyed on (seed, token index)."""
    samp = dict(temperature=0.0) if sampling == "greedy" else dict(temperature=0.9, top_k=40)
    reqs = _requests(256)
    batched = _port_engine(fams, "llama", **samp).run(reqs, arrivals=ARRIVALS)
    for r in reqs:
        solo = _port_engine(fams, "llama", **samp).run(
            [Request(r.req_id, list(r.tokens), r.max_new_tokens, r.seed)])
        assert batched[r.req_id].tokens == solo[r.req_id].tokens, r.req_id
        assert batched[r.req_id].reason == solo[r.req_id].reason


def test_prefix_cache_equals_unshared(fams):
    """A shared system prompt through the prefix cache: the unshared
    engine's tokens (sampled), fewer physical pages, hits and copies, and
    only cache refs left after the drain."""
    rng = np.random.default_rng(11)
    sys_p = list(map(int, rng.integers(1, 256, 13)))
    prompts = [sys_p + list(map(int, rng.integers(1, 256, 3))) for _ in range(4)]
    prompts += [list(sys_p)] * 2
    reqs = [Request(i, list(t), 5, i) for i, t in enumerate(prompts)]
    samp = dict(temperature=0.9, top_k=40, num_blocks=48)
    plain = _port_engine(fams, "llama", **samp)
    shared = _port_engine(fams, "llama", prefix_cache=True, **samp)
    base = plain.run([copy.deepcopy(r) for r in reqs])
    got = shared.run([copy.deepcopy(r) for r in reqs], arrivals={4: 2, 5: 3})
    for r in reqs:
        assert got[r.req_id].tokens == base[r.req_id].tokens, r.req_id
    assert shared.stats["prefix_hits"] > 0 and shared.stats["cow_copies"] > 0
    assert shared.tables.pages_allocated < plain.tables.pages_allocated
    assert all(s is None for s in shared.slots)
    assert int(shared.tables.refs.sum()) == shared.tables.physical_pages
    assert shared.export_prefix_chains() and not plain.export_prefix_chains()


def test_eos_and_overflow_evict_and_free_pages(fams):
    reqs = _requests(fams["llama"]["tcfg"].vocab_size, lens=(3, 9), new=16)
    first = _port_engine(fams, "llama").run(
        [Request(reqs[0].req_id, list(reqs[0].tokens), 1, 0)])[reqs[0].req_id].tokens[0]
    eng = _port_engine(fams, "llama", eos_id=first)
    done = eng.run([Request(r.req_id, list(r.tokens), 16, 0) for r in reqs])
    assert done[reqs[0].req_id].reason == "eos" and done[reqs[0].req_id].tokens == [first]
    assert eng.tables.free_blocks == eng.cfg.resolved_num_blocks()
    # a cache of 8 slots: 5 prompt + 3 decode writes, 4 tokens, then overflow
    eng = _port_engine(fams, "llama", max_seqs=2, block_size=4, max_blocks_per_seq=2)
    done = eng.run([Request("big", list(range(1, 6)), 64, 0), Request("long", list(range(8)),
                                                                      4, 0)])
    assert done["big"].reason == "overflow" and len(done["big"].tokens) == 4
    assert done["long"].reason == "rejected" and done["long"].tokens == []
    assert eng.tables.free_blocks == eng.cfg.resolved_num_blocks()
    with pytest.raises(ValueError, match="position budget"):
        _port_engine(fams, "gpt2", block_size=16, max_blocks_per_seq=16)


def test_fairness_cap_changes_when_not_what(fams):
    reqs = _requests(256, lens=(3, 9, 5, 14), new=4)

    def run(cap):
        eng = _port_engine(fams, "llama", prefill_cap_tokens=cap)
        return eng.stats, eng.run([copy.deepcopy(r) for r in reqs])

    small, out_small = run(8)
    big, out_big = run(1 << 30)
    assert big["ticks"] < small["ticks"]
    assert all(out_small[r.req_id].tokens == out_big[r.req_id].tokens for r in reqs)


def test_nf4_engine_serves_and_shrinks_weights(fams):
    tcfg, tparams = fams["gpt2"]["tcfg"], fams["gpt2"]["tparams"]
    eng = _port_engine(fams, "gpt2", quant="nf4")
    n_params = sum(x.size for x in jax.tree.leaves(fams["gpt2"]["jparams"]))
    assert weight_bytes(eng.params) * 3 < 2 * n_params
    assert weight_bytes(tparams) == 4 * n_params
    done = eng.run([Request("q", [1, 2, 3, 4], 6, 0)])
    assert len(done["q"].tokens) == 6
    assert all(0 <= t < tcfg.vocab_size for t in done["q"].tokens)


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_resumed_request_continues_its_stream(fams, sampling):
    """A request exported mid-run (``export_records``) and resumed in a fresh
    engine from its committed tokens ends with the uninterrupted run's
    tokens: the stream resumes at index ``len(committed)``."""
    samp = dict(temperature=0.0) if sampling == "greedy" else dict(temperature=0.9, top_k=40)
    reqs = _requests(256, lens=(5, 11), new=8)
    whole = _port_engine(fams, "llama", **samp).run([copy.deepcopy(r) for r in reqs])
    first = _port_engine(fams, "llama", **samp)
    for r in reqs:
        first.submit(copy.deepcopy(r))
    for _ in range(4):
        first.step()
    recs = first.export_records()
    assert [len(x.committed) for x in recs] == [5, 5]   # the prefill's token and 4 ticks'
    done = _port_engine(fams, "llama", **samp).run([x.to_request() for x in recs])
    for r in reqs:
        assert done[r.req_id].tokens == whole[r.req_id].tokens, r.req_id
    assert all(x.tokens == r.tokens and x.budget == 8 for x, r in zip(recs, reqs))


def test_deadline_expires_with_timeout(fams):
    """A request past its wall-clock deadline leaves with ``timeout`` and its
    partial output at the next tick boundary (an injected clock)."""
    now = [0.0]
    f = fams["llama"]
    eng = ServingEngine(_port_model("llama", f["tcfg"], f["tparams"]), ServeConfig(**GEOM),
                        time_fn=lambda: now[0])
    eng.submit(Request("slow", [1, 2, 3], 50, 0, deadline_s=1.0))
    eng.submit(Request("late", [4, 5], 50, 0, deadline_s=1.0), deadline_at=-1.0)
    out = eng.step()
    assert [(c.req_id, c.reason, c.tokens) for c in out] == [("late", "timeout", [])]
    eng.step()
    now[0] = 2.0
    (c,) = eng.step()
    assert c.req_id == "slow" and c.reason == "timeout" and len(c.tokens) == 3
    assert eng.stats["timeouts"] == 2 and not eng.has_work()
    assert eng.tables.free_blocks == eng.cfg.resolved_num_blocks()


def test_metrics_plane_equals_jax():
    """``serve/metrics.py`` is the JAX module's host code: the same samples
    give the same sketch summaries, SLO snapshots and request clocks."""
    from distributed_lion_tpu.serve import metrics as jm
    from distributed_lion_tpu_torch.serve import metrics as tm

    rng = np.random.default_rng(7)
    samples = rng.lognormal(1.0, 1.5, 300)
    outs = []
    for mod in (jm, tm):
        h, w = mod.LogHistogram(), mod.TickLatencyWindow(window=50)
        slo = mod.SLOMonitor(ttft_ms=5.0, tok_ms=3.0, p99=0.9, window=32, min_count=4)
        times = mod.RequestTimes()
        for i, v in enumerate(samples):
            h.add(v)
            w.add(v)
            slo.observe(v, v / 2, tick=i)
            times.submitted(i, i)
            times.first_token(i, i + 2)
        clocks = [times.finished(i, i + 7) for i in range(0, 300, 37)]
        outs.append((h.summary(), h.merge(h).summary(), w.percentile(90.0), slo.snapshot(),
                     clocks))
    assert outs[0] == outs[1]


# ----------------------------------------------------- (f) request file and CLI
def test_request_file_records_equal_jax(fams, tmp_path):
    """The same request file through both packages' ``serve_request_file``
    (JAX's engine from the fixture): the same records (timing columns
    included); a request with neither tokens nor a prompt is refused."""
    reqs = [{"id": "a", "tokens": [1, 2, 3], "max_new_tokens": 4, "prefix_group": "sys"},
            {"id": "b", "tokens": [9, 8], "max_new_tokens": 4, "arrival_tick": 2, "seed": 5},
            {"id": "c", "prompt": "hi", "max_new_tokens": 3, "deadline_s": 60}]
    inp = tmp_path / "requests.jsonl"
    inp.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    from distributed_lion_tpu.data.tokenizer import ByteTokenizer as JByte
    from distributed_lion_tpu_torch.data.tokenizer import ByteTokenizer

    want = japi.serve_request_file(fams["gpt2"]["engine"], str(inp), str(tmp_path / "j.jsonl"),
                                   JByte())
    got = api.serve_request_file(_port_engine(fams), str(inp), str(tmp_path / "t.jsonl"),
                                 ByteTokenizer())
    assert got == want
    assert [json.loads(ln) for ln in (tmp_path / "t.jsonl").read_text().splitlines()] == got
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"id": "x", "max_new_tokens": 2}\n')
    with pytest.raises(ValueError, match="tokens"):
        api.load_request_file(str(bad))


def test_run_serve_cli_smoke(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    reqs = tmp_path / "requests.jsonl"
    reqs.write_text('{"id": "r1", "prompt": "ab", "max_new_tokens": 3}\n'
                    '{"id": "r2", "tokens": [5, 6, 7], "max_new_tokens": 2}\n')
    out = tmp_path / "responses.jsonl"
    records = run_serve.main(["--model_family", "llama", "--model_name", "tiny", "--requests",
                              str(reqs), "--out", str(out), "--temperature", "0",
                              "--max_seqs", "2", "--block_size", "4", "--prefix_cache",
                              "true", "--serve_metrics", "true", "--journal_dir",
                              str(tmp_path / "j")])
    assert [r["n_generated"] for r in records] == [3, 2]
    assert [json.loads(ln)["id"] for ln in out.read_text().splitlines()] == ["r1", "r2"]
    names = {json.loads(ln).get("name") for ln in
             (tmp_path / "j" / "journal_rank0.jsonl").read_text().splitlines()}
    assert {"serve/admit", "serve/prefill", "serve/decode_tick", "serve/evict",
            "serve_done", "serve_metrics"} <= names
    run_serve.main(["--model_name", "tiny", "--prompt", "Hi", "--max_new_tokens", "2"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["prompt"] == "Hi"
