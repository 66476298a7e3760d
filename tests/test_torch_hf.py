"""The port's Hugging Face import and export vs the JAX package's, on the CPU.

Mirrors tests/test_hf_import.py and tests/test_hf_export.py. Tiny
``GPT2LMHeadModel`` and ``LlamaForCausalLM`` (GQA; tied and untied heads)
are built by ``transformers`` from a seed and saved locally as one
safetensors file, index-sharded, as ``pytorch_model.bin`` and as an
``.npz``. Tolerances, set before the first run:

- import trees bit for bit the JAX package's, at float32 and bfloat16;
  quantized leaves' codes and absmax bit for bit JAX ``quantize_tree``'s;
- logits against the HF models within the JAX tests' 2e-4 (PEFT: 5e-4);
- the port's safetensors reader and writer byte-exact against the
  ``safetensors`` library; exports read back by the JAX importers exactly,
  equal to the JAX package's own export's tree;
- PEFT adapters bit-identical both ways, refusals the JAX package's;
- ``run_sft`` and ``run_clm`` with ``--model_path`` against the JAX CLIs at
  W = 1 (float32 compute on both, the JAX mesh cut to one device): losses
  within 1e-5, the written HF directories' tensors within 1e-5 (but the
  k third of GPT-2's ``c_attn.bias``, whose gradient is zero in exact
  arithmetic: within 2·lr a step);
  ``run_dpo`` against the JAX library functions.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import load_file, save_file

from distributed_lion_tpu.models import hf_export as j_export
from distributed_lion_tpu.models import hf_import as j_import
from distributed_lion_tpu.models.gpt2 import GPT2Config as JGPT2Config
from distributed_lion_tpu.models.gpt2 import gpt2_init as j_gpt2_init
from distributed_lion_tpu.models.llama import LlamaConfig as JLlamaConfig
from distributed_lion_tpu.models.llama import llama_init as j_llama_init
from distributed_lion_tpu.ops.quant import quantize_tree as j_quantize_tree
from distributed_lion_tpu_torch.cli import run_clm, run_dpo, run_sft
from distributed_lion_tpu_torch.models import hf_export, hf_import
from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_lion_tpu_torch.models.llama import Llama, LlamaConfig
from distributed_lion_tpu_torch.models.lora import (
    DPO_TARGET_PATTERNS,
    LoraConfig,
    apply_adapters,
)
from distributed_lion_tpu_torch.ops.quant import QuantizedTensor, map_tree
from distributed_lion_tpu_torch.utils.serialization import (
    _flatten,
    state_dict_from_tree,
    tree_from_state_dict,
)

VOCAB = 300  # past the byte tokenizer's 259, so the CLIs' vocabulary check passes
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FORMATS = ("single", "sharded", "bin", "npz")


def _save(model, root, fmt: str) -> str:
    """``model`` saved in one of FORMATS under ``root``; returns the path
    the importers take."""
    path = str(root / fmt)
    if fmt == "single":
        model.save_pretrained(path)
    elif fmt == "sharded":
        model.save_pretrained(path, max_shard_size="40KB")
        assert os.path.exists(os.path.join(path, "model.safetensors.index.json"))
    elif fmt == "bin":
        model.save_pretrained(path, safe_serialization=False)
    else:
        sd = j_import.load_state_dict(str(root / "single"))
        path += ".npz"
        np.savez(path, **sd)
    return path


@pytest.fixture(scope="module")
def hf_models(tmp_path_factory):
    """{kind: (HF model, {format: path})} for gpt2, llama (untied, GQA) and
    llama_tied."""
    torch.manual_seed(0)
    models = {
        "gpt2": transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=VOCAB, n_layer=2, n_head=4, n_embd=64, n_positions=128)),
        "llama": transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=VOCAB, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, hidden_size=64, intermediate_size=128,
            max_position_embeddings=128)),
        "llama_tied": transformers.LlamaForCausalLM(transformers.LlamaConfig(
            vocab_size=VOCAB, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, hidden_size=64, intermediate_size=128,
            max_position_embeddings=128, tie_word_embeddings=True)),
    }
    out = {}
    for kind, model in models.items():
        root = tmp_path_factory.mktemp(kind)
        out[kind] = (model.eval(), {fmt: _save(model, root, fmt) for fmt in FORMATS})
    return out


def _np(x) -> np.ndarray:
    """A torch or JAX leaf as numpy, bfloat16 as its 16-bit words."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_trees_equal(ours, theirs) -> None:
    got, want = dict(_flatten(ours)), dict(_flatten(jax.tree.map(np.asarray, theirs)))
    assert got.keys() == want.keys()
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _import(kind, path, dtype, port: bool):
    fam = "gpt2" if kind == "gpt2" else "llama"
    if port:
        return getattr(hf_import, f"{fam}_from_hf")(path, param_dtype=TDT[dtype])
    return getattr(j_import, f"{fam}_from_hf")(path, param_dtype=JDT[dtype])


@pytest.mark.parametrize("dtype", sorted(JDT))
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kind", ["gpt2", "llama", "llama_tied"])
def test_import_trees_equal_jax(kind, fmt, dtype, hf_models):
    path = hf_models[kind][1][fmt]
    (ours, cfg), (theirs, jcfg) = (_import(kind, path, dtype, True),
                                   _import(kind, path, dtype, False))
    _assert_trees_equal(ours, theirs)
    for f in ("vocab_size", "n_layer", "n_head", "d_model", "n_ctx"):
        assert getattr(cfg, f) == getattr(jcfg, f)
    if kind != "gpt2":
        assert (cfg.n_kv_head, cfg.d_ff, cfg.rope_theta, cfg.rms_eps) == (
            jcfg.n_kv_head, jcfg.d_ff, jcfg.rope_theta, jcfg.rms_eps)


@pytest.mark.parametrize("stored", [torch.float16, torch.bfloat16, torch.float64])
def test_import_of_other_stored_dtypes_equals_jax(stored, hf_models, tmp_path):
    """float16 and bfloat16 storage go through float32 exactly; float64 is
    rounded twice, to float32 and then to the param dtype, on both."""
    model = hf_models["llama"][0]
    sd = {k: v.to(stored) for k, v in model.state_dict().items()}
    save_file(sd, str(tmp_path / "m.safetensors"))
    for dtype in JDT:
        ours, _ = hf_import.llama_from_hf(str(tmp_path / "m.safetensors"),
                                          param_dtype=TDT[dtype])
        theirs, _ = j_import.llama_from_hf(str(tmp_path / "m.safetensors"),
                                           param_dtype=JDT[dtype])
        _assert_trees_equal(ours, theirs)


def test_quantized_import_equals_jax_quantize_tree(hf_models):
    path = hf_models["llama"][1]["sharded"]
    ours, _ = hf_import.llama_from_hf(path, quant="nf4", quant_block=32)
    theirs, _ = j_import.llama_from_hf(path)
    want = dict(_flatten(jax.tree.map(
        lambda x: x, j_quantize_tree(theirs, "nf4", block=32),
        is_leaf=lambda x: hasattr(x, "codes"))))
    got = dict(_flatten(ours))
    assert got.keys() == want.keys()
    n_quant = 0
    for k, w in want.items():
        if hasattr(w, "codes"):
            n_quant += 1
            assert isinstance(got[k], QuantizedTensor) and got[k].layout == w.layout
            np.testing.assert_array_equal(got[k].codes.numpy(), np.asarray(w.codes))
            np.testing.assert_array_equal(got[k].absmax.numpy(), np.asarray(w.absmax))
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
    assert n_quant == 2 + 5 * 2  # wk, wv (64 x 32) are under quantize_leaf's 4096


@pytest.mark.parametrize("kind", ["llama", "llama_tied", "peft"])
def test_import_reads_each_tensor_once(kind, hf_models, tmp_path, monkeypatch):
    """Membership tests and key walks touch the headers alone: ``llama_from_hf``
    and ``peft_to_lora`` read each stored tensor from disk exactly once."""
    reads: collections.Counter = collections.Counter()
    tensor = hf_import.SafetensorsFile.tensor

    def counted(self, name):
        reads[name] += 1
        return tensor(self, name)

    monkeypatch.setattr(hf_import.SafetensorsFile, "tensor", counted)
    if kind == "peft":
        cfg = LlamaConfig.tiny(vocab_size=VOCAB)
        ad = _adapters(cfg, ("wq", "wk", "wv", "w_down", "wte"), seed=9)
        hf_export.lora_to_peft({p: {k: torch.from_numpy(v) for k, v in ab.items()}
                                for p, ab in ad.items()}, cfg, LoraConfig(r=4, alpha=8),
                               str(tmp_path))
        hf_import.peft_to_lora(str(tmp_path), cfg)
        path = str(tmp_path)
    else:
        path = hf_models[kind][1]["sharded"]
        hf_import.llama_from_hf(path)
    assert reads == collections.Counter(list(_dir_tensors(path)))


@pytest.mark.parametrize("kind", ["gpt2", "llama", "llama_tied"])
def test_imported_logits_match_the_hf_model(kind, hf_models):
    model, paths = hf_models[kind]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, VOCAB, (2, 16)))
    with torch.no_grad():
        want = model(tokens).logits
        if kind == "gpt2":
            params, cfg = hf_import.gpt2_from_hf(paths["single"])
            ours = GPT2(dataclasses.replace(cfg, compute_dtype=torch.float32, remat=False),
                        device="cpu")
            ours.load_state_dict(state_dict_from_tree(params))
            got = ours(tokens)
        else:
            params, cfg = hf_import.llama_from_hf(paths["single"])
            got = Llama(dataclasses.replace(cfg, compute_dtype=torch.float32, remat=False),
                        params)(tokens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the outcome itself is compared
        return type(e).__name__, str(e)


def test_detect_family_and_load_errors_equal_jax(hf_models, tmp_path):
    (tmp_path / "empty").mkdir()
    bare = str(tmp_path / "bare.safetensors")
    save_file(dict(hf_models["llama"][0].state_dict()), bare)
    paths = [*hf_models["gpt2"][1].values(), *hf_models["llama"][1].values(),
             *hf_models["llama_tied"][1].values(), bare,
             str(tmp_path / "empty"), "/nonexistent", str(tmp_path / "w.onnx")]
    for p in paths:
        assert _outcome(lambda: hf_import.detect_family(p)) == _outcome(
            lambda: j_import.detect_family(p)), p
    for p in (str(tmp_path / "empty"), "/nonexistent", str(tmp_path / "w.onnx")):
        assert _outcome(lambda: hf_import.load_state_dict(p)) == _outcome(
            lambda: j_import.load_state_dict(p)), p
    with hf_import.load_state_dict(hf_models["gpt2"][1]["sharded"]) as sd:
        want = j_import.load_state_dict(hf_models["gpt2"][1]["sharded"])
        assert set(sd) == set(want)
        for k in want:
            np.testing.assert_array_equal(sd[k].float().numpy(), want[k])


def test_safetensors_reader_and_writer_against_the_library(tmp_path):
    g = torch.Generator().manual_seed(0)
    ts = {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
          "bf16": torch.randn(2, 3, generator=g).bfloat16(),
          "f64": torch.randn(4, generator=g).double(), "i64": torch.arange(5) - 2,
          "i32": torch.arange(3, dtype=torch.int32), "u8": torch.arange(9, dtype=torch.uint8),
          "scalar": torch.tensor(3.0), "empty": torch.zeros(0, 4)}
    save_file(ts, str(tmp_path / "lib.safetensors"))
    with hf_import.load_state_dict(str(tmp_path / "lib.safetensors")) as sd:
        assert set(sd) == set(ts)
        for k, v in ts.items():
            assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    hf_export._write_tensors(ts, str(tmp_path), "ours")
    back = load_file(str(tmp_path / "ours.safetensors"))
    assert set(back) == set(ts)
    for k, v in ts.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    raw = (tmp_path / "ours.safetensors").read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + n])
    assert n % 8 == 0 and header["__metadata__"] == {"format": "pt"}
    # an out-of-range data_offsets refuses the file
    header["f32"]["data_offsets"][1] += 4
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    (tmp_path / "bad.safetensors").write_bytes(len(blob).to_bytes(8, "little") + blob
                                               + raw[8 + n:])
    with pytest.raises(ValueError, match="'f32'.*data_offsets"):
        hf_import.load_state_dict(str(tmp_path / "bad.safetensors"))


def _jax_trees(dtype: str):
    """A JAX GPT-2 and two JAX Llamas (untied, tied) at ``dtype``."""
    dt = JDT[dtype]
    gcfg = JGPT2Config.tiny(vocab_size=VOCAB, param_dtype=dt)
    lcfg = JLlamaConfig.tiny(vocab_size=VOCAB, param_dtype=dt)
    tied = j_llama_init(jax.random.key(4), lcfg)
    tied["lm_head"] = jnp.asarray(np.asarray(tied["wte"]).T)
    return {"gpt2": (j_gpt2_init(jax.random.key(1), gcfg), gcfg),
            "llama": (j_llama_init(jax.random.key(2), lcfg), lcfg),
            "llama_tied": (tied, lcfg)}


def _port_cfg(jcfg, dtype):
    if isinstance(jcfg, JGPT2Config):
        return GPT2Config.tiny(vocab_size=VOCAB, param_dtype=TDT[dtype])
    return LlamaConfig.tiny(vocab_size=VOCAB, param_dtype=TDT[dtype])


def _to_torch(tree):
    return map_tree(lambda x: torch.from_numpy(np.array(x.astype(np.float32)) if
                                               x.dtype.name == "bfloat16" else np.array(x)),
                    jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("dtype", sorted(JDT))
@pytest.mark.parametrize("kind", ["gpt2", "llama", "llama_tied"])
def test_export_is_read_back_by_jax_as_its_own_export(kind, dtype, tmp_path):
    jtree, jcfg = _jax_trees(dtype)[kind]
    tree = map_tree(lambda t: t.to(TDT[dtype]), _to_torch(jtree))
    fam = "gpt2" if kind == "gpt2" else "llama"
    getattr(hf_export, f"{fam}_to_hf")(tree, _port_cfg(jcfg, dtype), str(tmp_path / "ours"))
    getattr(j_export, f"{fam}_to_hf")(jtree, jcfg, str(tmp_path / "theirs"))
    for name in ("ours", "theirs"):
        assert json.loads((tmp_path / name / "config.json").read_text()).get(
            "tie_word_embeddings") == (kind != "llama")
    back, _ = _import(kind, str(tmp_path / "ours"), dtype, False)
    want, _ = _import(kind, str(tmp_path / "theirs"), dtype, False)
    _assert_trees_equal(jax.tree.map(np.asarray, back), want)
    _assert_trees_equal(jax.tree.map(np.asarray, back), jtree)  # the round trip is exact
    a, b = load_file(str(tmp_path / "ours" / "model.safetensors")), load_file(
        str(tmp_path / "theirs" / "model.safetensors"))
    assert a.keys() == b.keys() and all(a[k].dtype == b[k].dtype for k in a)


@pytest.mark.parametrize("kind", ["gpt2", "llama", "llama_tied"])
def test_export_loads_in_from_pretrained_with_the_port_logits(kind, tmp_path, monkeypatch):
    jtree, jcfg = _jax_trees("float32")[kind]
    tree = _to_torch(jtree)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, VOCAB, (2, 16)))
    if kind == "gpt2":
        cfg = GPT2Config.tiny(vocab_size=VOCAB, compute_dtype=torch.float32, remat=False,
                              vocab_pad_multiple=64)
        model = GPT2(cfg, device="cpu", seed=5)  # padded: the export slices the rows off
        hf_export.gpt2_to_hf(tree_from_state_dict(model), cfg, str(tmp_path))
        hf = transformers.GPT2LMHeadModel.from_pretrained(str(tmp_path)).eval()
        assert hf.transformer.wte.weight.shape[0] == VOCAB
    else:
        cfg = LlamaConfig.tiny(vocab_size=VOCAB, compute_dtype=torch.float32, remat=False)
        model = Llama(cfg, tree)
        monkeypatch.setattr(hf_export, "MAX_SHARD_BYTES", 60_000)  # shard the tiny model
        hf_export.llama_to_hf(tree, cfg, str(tmp_path))
        assert os.path.exists(tmp_path / "model.safetensors.index.json")
        hf = transformers.LlamaForCausalLM.from_pretrained(str(tmp_path)).eval()
    with torch.no_grad():
        np.testing.assert_allclose(hf(tokens).logits.numpy(), model(tokens).numpy(),
                                   atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="MoE"):
        hf_export.gpt2_to_hf({"wte": torch.zeros(4, 2), "wpe": torch.zeros(4, 2),
                              "ln_f": {"scale": torch.ones(2), "bias": torch.zeros(2)},
                              "blocks": [{"moe": {}}]}, GPT2Config.tiny(vocab_size=4),
                             str(tmp_path / "moe"))


def _adapters(cfg, targets, seed):
    """Random numpy adapters {path: {A [in, r], B [r, out]}} on ``targets``
    of a tiny Llama (B nonzero, so every permutation shows)."""
    rng = np.random.default_rng(seed)
    d, hd, r = cfg.d_model, cfg.head_dim, 4
    outs = {"wq": cfg.n_head * hd, "wk": cfg.n_kv_head * hd, "wv": cfg.n_kv_head * hd,
            "wo": d, "w_gate": cfg.d_ff, "w_up": cfg.d_ff, "w_down": d}
    ins = dict.fromkeys(outs, d) | {"wo": cfg.n_head * hd, "w_down": cfg.d_ff}
    ad = {}
    for i in range(cfg.n_layer):
        for t in targets:
            if t not in outs:  # "wte", or a GPT-2 or HF name of DPO_TARGET_PATTERNS
                continue
            g = "attn" if t in ("wq", "wk", "wv", "wo") else "mlp"
            ad[f"blocks/{i}/{g}/{t}"] = {
                "A": rng.standard_normal((ins[t], r)).astype(np.float32),
                "B": rng.standard_normal((r, outs[t])).astype(np.float32)}
    if "wte" in targets:
        ad["wte"] = {"A": rng.standard_normal((cfg.vocab_size, r)).astype(np.float32),
                     "B": rng.standard_normal((r, d)).astype(np.float32)}
    return ad


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_peft_adapters_round_trip_bit_identically(direction, tmp_path):
    from distributed_lion_tpu.models.lora import LoraConfig as JLoraConfig

    jcfg = JLlamaConfig.tiny(vocab_size=VOCAB)
    cfg = LlamaConfig.tiny(vocab_size=VOCAB)
    targets = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "wte")
    ad = _adapters(cfg, targets, seed=7)
    if direction == "port_to_jax":
        hf_export.lora_to_peft({p: {k: torch.from_numpy(v) for k, v in ab.items()}
                                for p, ab in ad.items()}, cfg, LoraConfig(r=4, alpha=8),
                               str(tmp_path), base_model_name="base")
        back, lcfg = j_import.peft_to_lora(str(tmp_path), jcfg)
        back = jax.tree.map(np.asarray, back)
    else:
        j_export.lora_to_peft(ad, jcfg, JLoraConfig(r=4, alpha=8), str(tmp_path),
                              base_model_name="base")
        back, lcfg = hf_import.peft_to_lora(str(tmp_path), cfg)
        theirs, jl = j_import.peft_to_lora(str(tmp_path), jcfg)
        assert (lcfg.r, lcfg.alpha, tuple(lcfg.target_patterns)) == (
            jl.r, jl.alpha, tuple(jl.target_patterns))
        _assert_trees_equal(back, theirs)
        back = map_tree(lambda t: t.numpy(), back)
    assert (lcfg.r, lcfg.alpha) == (4, 8)
    assert set(back) == set(ad)
    for p, ab in ad.items():
        for k in ("A", "B"):
            np.testing.assert_array_equal(back[p][k], ab[k], err_msg=f"{p}/{k}")
    cfg_json = json.loads((tmp_path / "adapter_config.json").read_text())
    assert cfg_json["base_model_name_or_path"] == "base"


@pytest.mark.parametrize("case", ["use_rslora", "rank_pattern", "alpha_pattern", "not_lora",
                                  "unpaired", "unpaired_embedding", "unknown_module", "empty"])
def test_peft_refusals_equal_jax(case, tmp_path):
    pc = {"peft_type": "LORA", "r": 4, "lora_alpha": 8}
    pre = "base_model.model.model.layers.0."
    sd = {f"{pre}self_attn.q_proj.lora_A.weight": torch.ones(4, 64),
          f"{pre}self_attn.q_proj.lora_B.weight": torch.ones(64, 4)}
    if case in ("use_rslora", "rank_pattern", "alpha_pattern"):
        pc[case] = True if case == "use_rslora" else {"q_proj": 8}
    elif case == "not_lora":
        pc["peft_type"] = "IA3"
    elif case == "unpaired":
        del sd[f"{pre}self_attn.q_proj.lora_B.weight"]
    elif case == "unpaired_embedding":
        sd["base_model.model.model.embed_tokens.lora_embedding_A"] = torch.ones(4, VOCAB)
    elif case == "unknown_module":
        sd = {f"{pre}self_attn.rotary.lora_A.weight": torch.ones(4, 64),
              f"{pre}self_attn.rotary.lora_B.weight": torch.ones(64, 4)}
    else:
        sd = {"something_else": torch.ones(2)}
    (tmp_path / "adapter_config.json").write_text(json.dumps(pc))
    save_file(sd, str(tmp_path / "adapter_model.safetensors"))
    ours = _outcome(lambda: hf_import.peft_to_lora(str(tmp_path), LlamaConfig.tiny()))
    theirs = _outcome(lambda: j_import.peft_to_lora(str(tmp_path), JLlamaConfig.tiny()))
    assert ours[0] == theirs[0] == "ValueError"
    assert ours == theirs


def test_peft_library_loads_the_export_and_its_adapters_import(tmp_path):
    peft = pytest.importorskip("peft")
    jtree, _ = _jax_trees("float32")["llama"]
    cfg = LlamaConfig.tiny(vocab_size=VOCAB, compute_dtype=torch.float32, remat=False)
    base = _to_torch(jtree)
    lcfg = LoraConfig(r=4, alpha=8, target_patterns=("wq", "wk", "wv", "wo"))
    ad = {p: {k: torch.from_numpy(v) * 0.1 for k, v in ab.items()}
          for p, ab in _adapters(cfg, lcfg.target_patterns, seed=11).items()}
    hf_export.llama_to_hf(base, cfg, str(tmp_path / "base"))
    hf_export.lora_to_peft(ad, cfg, lcfg, str(tmp_path / "adapter"))
    hf_base = transformers.LlamaForCausalLM.from_pretrained(str(tmp_path / "base"))
    pm = peft.PeftModel.from_pretrained(hf_base, str(tmp_path / "adapter")).eval()
    tokens = torch.from_numpy(np.random.default_rng(13).integers(0, VOCAB, (2, 16)))
    with torch.no_grad():
        want = pm(tokens).logits.numpy()
        got = Llama(cfg, apply_adapters(base, ad, lcfg))(tokens).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)
    # an adapter the PEFT library itself saved imports to the same logits
    hf_base = transformers.LlamaForCausalLM.from_pretrained(str(tmp_path / "base"))
    pm = peft.get_peft_model(hf_base, peft.LoraConfig(
        r=4, lora_alpha=8, target_modules=["q_proj", "k_proj", "v_proj"],
        task_type="CAUSAL_LM", lora_dropout=0.0))
    with torch.no_grad():
        for n, p in pm.named_parameters():
            if "lora_B" in n:
                p.copy_(torch.randn_like(p) * 0.1)
    pm.save_pretrained(str(tmp_path / "theirs"))
    imported, icfg = hf_import.peft_to_lora(str(tmp_path / "theirs"), cfg)
    with torch.no_grad():
        want = pm.eval()(tokens).logits.numpy()
        got = Llama(cfg, apply_adapters(base, imported, icfg))(tokens).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


# ------------------------------------------------------------------------ CLIs

CLI_COMMON = ["--lion", "--async_grad", "--max_steps", "3", "--per_device_train_batch_size",
              "2", "--gradient_accumulation_steps", "1", "--logging_steps", "1",
              "--learning_rate", "1e-3", "--warmup_steps", "1"]
SFT_ARGS = CLI_COMMON + ["--seq_length", "64", "--num_train_samples", "48",
                         "--size_valid_set", "4", "--quant", "nf4"]


def _jax_cli(monkeypatch, cli, argv) -> list:
    """A JAX CLI's ``main`` on a one-device mesh; its per-step losses."""
    from distributed_lion_tpu.cli import run_clm as j_run_clm
    from distributed_lion_tpu.parallel import make_mesh
    from distributed_lion_tpu.train.loop import Trainer as JTrainer

    monkeypatch.setattr(j_run_clm, "build_mesh", lambda *a, **k: make_mesh(
        data=1, devices=jax.devices()[:1]))
    hist: list = []
    orig = JTrainer.train

    def train(self, *a, **k):
        h = orig(self, *a, **k)
        hist.extend(h)
        return h

    monkeypatch.setattr(JTrainer, "train", train)
    cli.main(argv)
    return [h["loss"] for h in hist if "loss" in h]


def _float32_llama(monkeypatch):
    """Both importers build their LlamaConfig at float32 compute (the
    checkpoint carries no compute dtype), as the trainer comparisons do."""
    import distributed_lion_tpu.models.llama as j_llama

    jcls, tcls = j_llama.LlamaConfig, hf_import.LlamaConfig
    monkeypatch.setattr(j_llama, "LlamaConfig", lambda **kw: jcls(
        **({"compute_dtype": jnp.float32} | kw)))
    monkeypatch.setattr(hf_import, "LlamaConfig", lambda **kw: tcls(
        **({"compute_dtype": torch.float32} | kw)))


def _dir_tensors(path) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".safetensors"):
            out.update(load_file(os.path.join(path, name)))
    return out


def _assert_dirs_close(a, b, k_bias_flip: float = 0.0) -> None:
    """Two written HF directories: the same JSON files, and every tensor
    within 1e-5. With ``k_bias_flip`` > 0, the k third of each GPT-2
    ``c_attn.bias`` alone is held within ``k_bias_flip``: its gradient is
    zero in exact arithmetic, so each of its elections may go either way."""
    assert sorted(n for n in os.listdir(a) if n.endswith(".json")) == sorted(
        n for n in os.listdir(b) if n.endswith(".json"))
    for name in os.listdir(a):
        if name.endswith(".json"):
            assert json.loads(open(os.path.join(a, name)).read()) == json.loads(
                open(os.path.join(b, name)).read()), name
    ta, tb = _dir_tensors(a), _dir_tensors(b)
    assert ta.keys() == tb.keys() and ta
    n_k_bias = 0
    for k in sorted(ta):
        got, want = ta[k].float().numpy(), tb[k].float().numpy()
        if k_bias_flip and k.endswith(".attn.c_attn.bias"):
            d = got.shape[0] // 3  # q | k | v
            np.testing.assert_allclose(got[d:2 * d], want[d:2 * d], atol=k_bias_flip * (1 + 1e-6),
                                       rtol=0, err_msg=k)
            got, want = np.delete(got, np.s_[d:2 * d]), np.delete(want, np.s_[d:2 * d])
            n_k_bias += 1
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=k)
    assert n_k_bias == (2 if k_bias_flip else 0)  # the tiny GPT-2's two blocks


def test_run_sft_from_an_hf_checkpoint_matches_the_jax_cli(hf_models, tmp_path, monkeypatch):
    """``--model_path --adapter_path --adapter_output --merged_output <dir>``
    on both CLIs: the adapters start from one PEFT directory (the two
    frameworks' LoRA inits differ), so the runs are the same computation."""
    from distributed_lion_tpu.cli import run_sft as j_run_sft

    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    _float32_llama(monkeypatch)
    path = hf_models["llama"][1]["single"]
    cfg = LlamaConfig.tiny(vocab_size=VOCAB)
    start = {p: {k: torch.from_numpy(v) * 0.1 for k, v in ab.items()}
             for p, ab in _adapters(cfg, ("wq", "wv"), seed=21).items()}
    hf_export.lora_to_peft(start, cfg, LoraConfig(r=4, alpha=8), str(tmp_path / "start"))
    argv = SFT_ARGS + ["--model_path", path, "--adapter_path", str(tmp_path / "start")]
    want = _jax_cli(monkeypatch, j_run_sft, argv + [
        "--adapter_output", str(tmp_path / "j_ad"), "--merged_output", str(tmp_path / "j_m")])
    trainer, model, adapters = run_sft.main(argv + [
        "--adapter_output", str(tmp_path / "ad"), "--merged_output", str(tmp_path / "m")])
    got = [h["loss"] for h in trainer.history if "loss" in h]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    _assert_dirs_close(tmp_path / "m", tmp_path / "j_m")
    _assert_dirs_close(tmp_path / "ad", tmp_path / "j_ad")
    merged = transformers.LlamaForCausalLM.from_pretrained(str(tmp_path / "m"))
    assert merged.config.num_hidden_layers == 2
    # the frozen base is the checkpoint quantized; the adapters read back exactly
    back, _ = hf_import.peft_to_lora(str(tmp_path / "ad"), cfg)
    for p, ab in adapters.items():
        for k in ("A", "B"):
            assert torch.equal(back[p][k], ab[k].detach())
    assert isinstance(model.params["blocks"][0]["attn"]["wq"], QuantizedTensor)


def test_run_clm_gpt2_from_an_hf_checkpoint_matches_the_jax_cli(hf_models, tmp_path,
                                                                 monkeypatch):
    """``--model_path --vocab_pad_multiple 64 --hf_export`` on both CLIs."""
    from distributed_lion_tpu.cli import run_clm as j_run_clm

    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    path = hf_models["gpt2"][1]["single"]
    argv = CLI_COMMON + ["--model_path", path, "--model_family", "llama", "--dropout", "0",
                         "--vocab_pad_multiple", "64", "--compute_dtype", "float32",
                         "--block_size", "32", "--synthetic_blocks", "64",
                         "--tokenizer_name", "runs/parity/tok"]
    want = _jax_cli(monkeypatch, j_run_clm, argv + ["--hf_export", str(tmp_path / "j_e")])
    trainer = run_clm.main(argv + ["--hf_export", str(tmp_path / "e")])
    got = [h["loss"] for h in trainer.history if "loss" in h]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert trainer.model.wte.shape[0] == 320
    # the k projection's bias has a zero gradient in exact arithmetic (the
    # softmax ignores a constant per query), so its elections follow the two
    # frameworks' rounding: that third of c_attn.bias may differ by 2·lr a step
    _assert_dirs_close(tmp_path / "e", tmp_path / "j_e", k_bias_flip=2 * 1e-3 * 3)
    assert sorted(os.listdir(tmp_path / "e")) == sorted(os.listdir(tmp_path / "j_e"))
    card = (tmp_path / "e" / "README.md").read_text()
    assert "Distributed Lion" in card and "| wire | sign_psum |" in card
    # the export is the trained weights with the alignment rows sliced off
    exported, _ = hf_import.gpt2_from_hf(str(tmp_path / "e"))
    final = tree_from_state_dict(trainer.model)
    assert torch.equal(exported["wte"], final["wte"][:VOCAB].detach())
    assert torch.equal(exported["blocks"][1]["attn"]["qkv"],
                       final["blocks"][1]["attn"]["qkv"].detach())
    hf = transformers.GPT2LMHeadModel.from_pretrained(str(tmp_path / "e"))
    assert hf.config.vocab_size == VOCAB


def test_run_dpo_from_an_hf_checkpoint_against_the_jax_functions(hf_models, tmp_path,
                                                                  monkeypatch):
    """``run_dpo --model_path --adapter_path --adapter_output --quant_ref nf4``:
    the policy base is JAX ``llama_from_hf``'s tree, the reference its
    ``quantize_tree``, the start adapters JAX ``peft_to_lora``'s, and the
    written adapters read back by JAX ``peft_to_lora`` as trained."""
    monkeypatch.setenv("DLION_PLATFORM", "cpu")
    path = hf_models["llama_tied"][1]["sharded"]
    cfg, jcfg = LlamaConfig.tiny(vocab_size=VOCAB), JLlamaConfig.tiny(vocab_size=VOCAB)
    start = {p: {k: torch.from_numpy(v) * 0.1 for k, v in ab.items()}
             for p, ab in _adapters(cfg, DPO_TARGET_PATTERNS, seed=31).items()}
    hf_export.lora_to_peft(start, cfg, LoraConfig(r=4, alpha=8), str(tmp_path / "start"))
    seen = {}
    orig = hf_import.peft_to_lora

    def capture(*a, **k):
        seen["start"] = orig(*a, **k)
        return seen["start"]

    monkeypatch.setattr(hf_import, "peft_to_lora", capture)
    trainer, model, adapters, ref = run_dpo.main([
        "--model_path", path, "--adapter_path", str(tmp_path / "start"), "--adapter_output",
        str(tmp_path / "out"), "--quant_ref", "nf4", "--quant_block", "32", "--max_length",
        "96", "--max_prompt_length", "48", "--num_train_samples", "32", "--size_valid_set",
        "4", "--max_steps", "2", "--per_device_train_batch_size", "1", "--logging_steps",
        "1", "--eval_iters", "1"])
    assert len([h for h in trainer.history if "loss" in h]) == 2
    jbase, _ = j_import.llama_from_hf(path)
    _assert_trees_equal(model.params, jbase)
    jref = dict(_flatten(jax.tree.map(lambda x: x, j_quantize_tree(jbase, "nf4", block=32),
                                      is_leaf=lambda x: hasattr(x, "codes"))))
    for k, leaf in _flatten(ref):
        if isinstance(leaf, QuantizedTensor):
            np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(jref[k].codes))
            np.testing.assert_array_equal(leaf.absmax.numpy(), np.asarray(jref[k].absmax))
    jstart, _ = j_import.peft_to_lora(str(tmp_path / "start"), jcfg)
    _assert_trees_equal(seen["start"][0], jstart)
    jback, jl = j_import.peft_to_lora(str(tmp_path / "out"), jcfg)
    assert (jl.r, jl.alpha) == (4, 8) and set(jback) == set(adapters)
    for p, ab in adapters.items():
        for k in ("A", "B"):
            np.testing.assert_array_equal(np.asarray(jback[p][k]), ab[k].detach().numpy())
