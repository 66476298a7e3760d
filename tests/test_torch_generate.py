"""Generation from a dense KV cache, port against the JAX package
(tests/test_generate.py, tests/test_moe_serve.py's batched ≡ solo pin).

Tolerances: at float32 compute the prefill and decode logits and the cache
contents are held to JAX's ``gpt2_decode``/``llama_decode`` (GQA) within
``1e-5`` (the bound of the port's other float32 model comparisons), also
for a left-padded batch with ``offset``; decode ≡ the port's own forward
position by position within ``1e-5``. ``filter_logits`` keeps the same
entries as JAX's on seeded logits (exact masks). Draws compare by their
statistics only (the RNG streams differ by design): a draw lands in the
filtered support, and 4,000 draws' frequencies lie within 5 standard
errors of the filtered softmax. Greedy tokens equal JAX ``generate``'s up
to the first step where JAX's top-2 logit margin is below ``1e-4`` (ten
times the logit tolerance). Inside the port, a left-padded batch decodes
each row as its solo run (GPT-2, Llama, GPT-2-MoE): equal tokens and logits
within ``1e-5``. The CLI decodes a ``model.npz`` the JAX package's
``save_pytree`` wrote (its greedy text equal to JAX ``run_generate``'s) and
an HF directory the port's ``hf_export`` wrote, each batched row equal to
its solo run.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.models.generate import filter_logits as j_filter_logits
from distributed_lion_tpu.models.generate import generate as j_generate
from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2Config
from distributed_lion_tpu.models.gpt2 import gpt2_decode as j_gpt2_decode
from distributed_lion_tpu.models.gpt2 import gpt2_init as j_gpt2_init
from distributed_lion_tpu.models.gpt2 import gpt2_init_cache as j_gpt2_init_cache
from distributed_lion_tpu.models.llama import LlamaConfig as JLlamaConfig
from distributed_lion_tpu.models.llama import llama_decode as j_llama_decode
from distributed_lion_tpu.models.llama import llama_init as j_llama_init
from distributed_lion_tpu.models.llama import llama_init_cache as j_llama_init_cache
from distributed_lion_tpu.utils.serialization import save_pytree as j_save_pytree
from distributed_lion_tpu_torch.cli import run_generate
from distributed_lion_tpu_torch.models.generate import filter_logits, generate, sample_logits
from distributed_lion_tpu_torch.models.gpt2 import (
    GPT2,
    GPT2Config,
    gpt2_decode,
    gpt2_init_cache,
)
from distributed_lion_tpu_torch.models.hf_export import gpt2_to_hf
from distributed_lion_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    llama_decode,
    llama_init_cache,
)
from distributed_lion_tpu_torch.utils.serialization import (
    llama_params_from_jax,
    tree_from_state_dict,
)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def fams() -> dict:
    """name → (JAX decode, JAX init_cache, JAX params, port decode, port
    init_cache, port params, port config) at float32 compute; the JAX sides
    jitted (one compile a shape)."""
    out = {}
    for name, jcfg, tcfg, jinit, jdec, jcache, tdec, tcache in (
            ("gpt2", JGPT2Config.tiny(compute_dtype=jnp.float32),
             GPT2Config.tiny(compute_dtype=torch.float32), j_gpt2_init, j_gpt2_decode,
             j_gpt2_init_cache, gpt2_decode, gpt2_init_cache),
            ("llama", JLlamaConfig.tiny(compute_dtype=jnp.float32),
             LlamaConfig.tiny(compute_dtype=torch.float32), j_llama_init, j_llama_decode,
             j_llama_init_cache, llama_decode, llama_init_cache)):
        jparams = jax.jit(jinit, static_argnums=1)(jax.random.key(3), jcfg)
        tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams))
        out[name] = (jax.jit(partial(lambda c, f, p, t, k, pos, off=None: f(p, t, c, k, pos, off),
                                     jcfg, jdec)), partial(jcache, jcfg), jparams,
                     partial(lambda c, f, p, t, k, pos, off=None: f(p, t, c, k, pos, off),
                             tcfg, tdec), partial(tcache, tcfg), tparams, tcfg)
    return out


def _forward(name, cfg, params, tokens):
    if name == "llama":
        return Llama(cfg, params)(tokens)
    model = GPT2(cfg, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(dict(_named(params))[n])
    return model(tokens)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("name", ["gpt2", "llama"])
@pytest.mark.parametrize("padded", [False, True], ids=["plain", "left_padded"])
def test_decode_matches_jax_and_the_forward(fams, name, padded):
    jdec, jcache, jparams, tdec, tcache, tparams, tcfg = fams[name]
    toks = np.random.default_rng(0).integers(1, 256, (3, 11))
    offset = None
    if padded:
        offset = np.array([2, 0, 5])
        toks[np.arange(11)[None, :] < offset[:, None]] = 0   # the left pads
    jc, tc = jcache(3, 12), tcache(3, 12)
    joff = None if offset is None else jnp.asarray(offset, jnp.int32)
    toff = None if offset is None else torch.from_numpy(offset)
    steps = [(0, 8)] + [(i, i + 1) for i in range(8, 11)]   # the prefill, three steps
    got_all = []
    for lo, hi in steps:
        want, jc = jdec(jparams, jnp.asarray(toks[:, lo:hi], jnp.int32), jc, lo, joff)
        got, tc = tdec(tparams, torch.from_numpy(toks[:, lo:hi]), tc, lo, toff)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"{name} {lo}", **TOL)
        got_all.append(got)
    for jl, tl in zip(jc, tc):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]), **TOL)
    if not padded:   # decode ≡ the port's forward, position by position
        full = _forward(name, tcfg, tparams, torch.from_numpy(toks))
        np.testing.assert_allclose(torch.cat(got_all, 1).detach().numpy(),
                                   full.detach().numpy(), **TOL)


def test_filter_logits_masks_match_jax():
    # unit-scale logits: no token's mass is below a float32 ulp of 1, where
    # the two frameworks' cumulative sums (other orders) could round a
    # top_p = 1 boundary apart
    logits = np.random.default_rng(1).normal(size=(4, 50)).astype(np.float32)
    for t, k, p in ((0.7, None, None), (1.0, 5, None), (1.3, None, 0.8), (1.0, 7, 0.5),
                    (1.0, 50, None), (1.0, 80, None), (1.0, None, 1.0), (1.0, None, 0.0),
                    (1.0, None, -0.5), (1.0, 0, None)):
        want = np.asarray(j_filter_logits(jnp.asarray(logits), t, k, p))
        got = filter_logits(torch.from_numpy(logits), t, k, p).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=str((t, k, p)))
        np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-6)


def test_sample_logits_draws_inside_the_support_at_its_law():
    probs = np.array([0.5, 0.3, 0.15, 0.05])
    logits = torch.log(torch.tensor(probs, dtype=torch.float32))[None].repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    assert set(sample_logits(logits[:64], gen, 1.0, None, 0.7).tolist()) == {0, 1}
    assert set(sample_logits(logits[:64], gen, 1.0, None, 0.0).tolist()) == {0}
    assert set(sample_logits(logits[:64], gen, 1.0, 0, None).tolist()) == {0}
    for top_k, top_p, law in ((None, None, probs), (2, None, probs[:2] / 0.8),
                              (None, 0.7, probs[:2] / 0.8)):
        draws = sample_logits(logits, gen, 1.0, top_k, top_p).numpy()
        freq = np.bincount(draws, minlength=4)[:len(law)] / len(draws)
        assert np.bincount(draws, minlength=4)[len(law):].sum() == 0
        assert np.all(np.abs(freq - law) <= 5 * np.sqrt(law * (1 - law) / len(draws))), freq
    assert torch.equal(sample_logits(logits[:3], gen, 0.0), torch.zeros(3, dtype=torch.long))


def test_greedy_generate_matches_jax_generate(fams):
    jdec, jcache, jparams, tdec, tcache, tparams, _ = fams["gpt2"]
    prompt = np.random.default_rng(3).integers(0, 256, (2, 5))
    n = 8
    want = np.asarray(j_generate(jdec, jcache, jparams, jnp.asarray(prompt, jnp.int32), n))
    got = generate(tdec, tcache, tparams, torch.from_numpy(prompt), n).numpy()
    # JAX's logits along its own tokens: the prefill of prompt + tokens
    seq = np.concatenate([prompt, want], 1)
    jlog, _ = jdec(jparams, jnp.asarray(seq, jnp.int32), jcache(2, seq.shape[1]), 0)
    jlog = np.asarray(jlog)[:, prompt.shape[1] - 1:-1]
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    for r in range(2):
        differ = np.flatnonzero(got[r] != want[r])
        if differ.size:
            i = differ[0]
            assert top2[r, i, 1] - top2[r, i, 0] < MARGIN, (r, i)


def test_moe_ffn_inference_arguments_match_jax():
    """``valid`` and ``capacity_override`` (JAX expert.py:72-86): a batch with
    pad lanes interleaved at a binding capacity gives JAX's outputs and aux
    (within 1e-6), exact-zero pad rows, and the real rows of the unpadded
    batch at the same capacity."""
    from distributed_lion_tpu.parallel.expert import moe_ffn as j_moe_ffn
    from distributed_lion_tpu_torch.parallel.expert import moe_ffn, moe_init, route

    params = moe_init(4, 16, 32, gen=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(24, 16)).astype(np.float32))
    valid = torch.from_numpy(np.arange(24) % 3 != 1)
    y, aux = moe_ffn(params, x, capacity_override=3, valid=valid)
    jy, jaux = j_moe_ffn({k: jnp.asarray(v.numpy()) for k, v in params.items()},
                         jnp.asarray(x.numpy()), axis_name=None, capacity_override=3,
                         valid=jnp.asarray(valid.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert not y[~valid].any()
    alone, _ = moe_ffn(params, x[valid], capacity_override=3)
    assert torch.equal(y[valid], alone)
    assert not route(x[valid], params["gate"], 4, 3)[3].all()   # the premise: capacity binds


@pytest.mark.parametrize("family", ["gpt2", "llama", "gpt2_moe"])
def test_batched_left_padded_equals_solo(fams, family):
    if family == "gpt2_moe":
        cfg = GPT2Config.tiny(compute_dtype=torch.float32, moe_experts=2, moe_every=1)
        params = tree_from_state_dict(GPT2(cfg, device="cpu", seed=5))
        dec = partial(lambda c, p, t, k, pos, off=None: gpt2_decode(p, t, c, k, pos, off), cfg)
        cache = partial(gpt2_init_cache, cfg)
    else:
        _, _, _, dec, cache, params, _ = fams[family]
    logs: list = []

    def recording(p, t, k, pos, off=None):
        out = dec(p, t, k, pos, off)
        logs.append(out[0][:, -1])
        return out

    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, n) for n in (3, 7, 5)]
    T = max(len(p) for p in prompts)
    batch = torch.zeros(len(prompts), T, dtype=torch.long)
    for i, p in enumerate(prompts):
        batch[i, T - len(p):] = torch.from_numpy(p)
    out = generate(recording, cache, params, batch, 6,
                   prompt_lens=torch.tensor([len(p) for p in prompts]))
    batched = torch.stack(logs, 1)
    for i, p in enumerate(prompts):
        logs.clear()
        solo = generate(recording, cache, params, torch.from_numpy(p)[None], 6)
        assert torch.equal(out[i], solo[0]), (family, i)
        np.testing.assert_allclose(batched[i].numpy(), torch.stack(logs, 1)[0].numpy(), **TOL)


def test_eos_pads_and_one_new_token(fams):
    _, _, _, dec, cache, params, _ = fams["gpt2"]
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 5)))
    greedy = generate(dec, cache, params, prompt, 8)
    eos = int(greedy[0, 2])
    out = generate(dec, cache, params, prompt, 8, eos_id=eos, pad_id=7)
    for r in range(2):   # the greedy row through its first EOS, then pads
        hits = np.flatnonzero(greedy[r].numpy() == eos)
        first = int(hits[0]) if hits.size else 8
        assert torch.equal(out[r, :first + 1], greedy[r, :first + 1])
        assert (out[r, first + 1:] == 7).all()
    one = generate(dec, cache, params, prompt, 1)
    logits, _ = dec(params, prompt, cache(2, 6), 0)
    assert one.shape == (2, 1) and torch.equal(one[:, 0], logits[:, -1].argmax(-1))


def test_cli_decodes_a_jax_npz_and_a_port_hf_export(tmp_path, monkeypatch, capsys):
    from distributed_lion_tpu.cli.run_generate import main as j_main

    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    pf = tmp_path / "prompts.txt"
    pf.write_text("hello\n\nworld\n")
    npz = tmp_path / "model.npz"
    j_save_pytree(npz, j_gpt2_init(jax.random.key(7), JGPT2Config.tiny(vocab_size=259)))
    cfg = GPT2Config.tiny(vocab_size=259)
    gpt2_to_hf(tree_from_state_dict(GPT2(cfg, device="cpu", seed=9)), cfg, str(tmp_path / "hf"))
    for path in (str(npz), str(tmp_path / "hf")):
        base = ["--model_path", path, "--model_name", "tiny", "--max_new_tokens", "4",
                "--temperature", "0"]
        texts = run_generate.main(base + ["--prompt", "ab", "cdef", "--prompt_file", str(pf)])
        assert len(texts) == 4
        for prompt, text in zip(("ab", "cdef", "hello", "world"), texts):
            assert run_generate.main(base + ["--prompt", prompt]) == text, (path, prompt)
    # the JAX CLI's greedy text from the same model.npz (bf16 compute both sides)
    want = j_main(["--model_path", str(npz), "--model_name", "tiny", "--prompt", "ab",
                   "--max_new_tokens", "4", "--temperature", "0"])
    got = run_generate.main(["--model_path", str(npz), "--model_name", "tiny", "--prompt",
                             "ab", "--max_new_tokens", "4", "--temperature", "0"])
    assert got == want
    assert "loaded" not in capsys.readouterr().err
