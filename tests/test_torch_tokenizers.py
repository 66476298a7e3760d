"""The port's SentencePiece and ``tokenizer.json`` readers and
``load_tokenizer``'s dispatch vs the JAX package's, on the CPU.

Mirrors tests/test_llama_tokenizer.py on the same fixtures (a Llama-shaped
SentencePiece model written by ``write_model_proto``, a byte-level BPE
trained by the ``tokenizers`` library): ids must be token for token the
JAX package's and, for ``tokenizer.json``, the ``tokenizers`` library's;
errors the JAX package's, message and type. A ``tokenizer.json`` built
from ``runs/parity/tok`` encodes README.md to the port's ``BPETokenizer``
ids.
"""

from __future__ import annotations

import json
import pathlib

import pytest

from distributed_lion_tpu.data import hf_tokenizer_json as j_tj
from distributed_lion_tpu.data import spm as j_spm
from distributed_lion_tpu.data import tokenizer as j_tokenizer
from distributed_lion_tpu_torch.data import hf_tokenizer_json as tj
from distributed_lion_tpu_torch.data import spm
from distributed_lion_tpu_torch.data.bpe import BPETokenizer
from distributed_lion_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer

ROOT = pathlib.Path(__file__).resolve().parents[1]
_BYTE, _CONTROL, _NORMAL, _UNKNOWN, _USER_DEFINED = (
    spm._BYTE, spm._CONTROL, spm._NORMAL, spm._UNKNOWN, spm._USER_DEFINED)

SP_TEXTS = ["hello world", "hello☃", "hold", "<s>", "", " ", "  hello   world ",
            "wörld\nhello\tworld", "hellohello worldworld", "東京 hello"]
SAMPLES = [
    "hello world",
    "Question: What's 2+2?\nAnswer: 4",
    "  leading spaces and   runs",
    "unicode: déjà vu ☃ 日本語",
    "numbers 1234567 and punct!!! ...",
    "tabs\tand\nnewlines\r\n",
]
LLAMA3_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
              r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def _tiny_sp_pieces():
    """tests/test_llama_tokenizer.py's Llama-shaped piece table."""
    pieces = [("<unk>", 0.0, _UNKNOWN), ("<s>", 0.0, _CONTROL), ("</s>", 0.0, _CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, _BYTE) for b in range(256)]
    for ch in ["▁", "h", "e", "l", "o", "w", "r", "d"]:
        pieces.append((ch, -50.0, _NORMAL))
    merged = [("he", -1.0), ("ll", -2.0), ("hell", -3.0), ("hello", -4.0),
              ("▁hello", -5.0), ("wo", -6.0), ("wor", -7.0), ("worl", -8.0),
              ("world", -9.0), ("▁world", -10.0)]
    return pieces + [(p, s, _NORMAL) for p, s in merged]


def _both(blob: bytes):
    return (spm.SentencePieceTokenizer(spm.parse_model_proto(blob)),
            j_spm.SentencePieceTokenizer(j_spm.parse_model_proto(blob)))


def _ab_pieces(ab: float, bc: float):
    return ([("<unk>", 0.0, _UNKNOWN), ("<s>", 0.0, _CONTROL), ("</s>", 0.0, _CONTROL)]
            + [(c, -50.0, _NORMAL) for c in "abc"]
            + [("ab", ab, _NORMAL), ("bc", bc, _NORMAL)])


def _user_defined_pieces():
    return ([("<unk>", 0.0, _UNKNOWN), ("<s>", 0.0, _CONTROL), ("</s>", 0.0, _CONTROL),
             ("<tool>", 0.0, _USER_DEFINED)]
            + [(c, -50.0, _NORMAL) for c in ["▁", "x", "y", "<", ">", "t", "o", "l"]])


SP_MODELS = {
    "llama_shaped": lambda: spm.write_model_proto(_tiny_sp_pieces()),
    "no_dummy_prefix": lambda: spm.write_model_proto(_tiny_sp_pieces(), add_dummy_prefix=False),
    "disabled_specials": lambda: spm.write_model_proto(_tiny_sp_pieces(), bos_id=-1, eos_id=-1,
                                                       unk_id=0, pad_id=-1),
    "bc_outranks_ab": lambda: spm.write_model_proto(_ab_pieces(-2.0, -1.0),
                                                    add_dummy_prefix=False),
    "ab_outranks_bc": lambda: spm.write_model_proto(_ab_pieces(-1.0, -2.0),
                                                    add_dummy_prefix=False),
    "user_defined": lambda: spm.write_model_proto(_user_defined_pieces(),
                                                  add_dummy_prefix=False),
}


@pytest.mark.parametrize("model", sorted(SP_MODELS))
def test_sentencepiece_ids_equal_jax(model):
    blob = SP_MODELS[model]()
    assert blob == bytes(j_spm.write_model_proto(*_args_of(model)))
    ours, theirs = _both(blob)
    assert (ours.bos_id, ours.eos_id, ours.pad_id, ours.unk_id, ours.vocab_size) == (
        theirs.bos_id, theirs.eos_id, theirs.pad_id, theirs.unk_id, theirs.vocab_size)
    texts = SP_TEXTS + ["abc", "abcabc", "x<tool>y", "<tool><tool>xy"]
    for text in texts:
        for bos, eos in ((False, False), (True, True)):
            ids = ours.encode(text, add_bos=bos, add_eos=eos)
            assert ids == theirs.encode(text, add_bos=bos, add_eos=eos), (model, text)
            assert ours.decode(ids) == theirs.decode(ids)


def _args_of(model: str) -> tuple:
    """The JAX writer's arguments for each SP_MODELS entry."""
    return {
        "llama_shaped": (_tiny_sp_pieces(),),
        "no_dummy_prefix": (_tiny_sp_pieces(), 2, False),
        "disabled_specials": (_tiny_sp_pieces(), 2, True, 0, -1, -1, -1),
        "bc_outranks_ab": (_ab_pieces(-2.0, -1.0), 2, False),
        "ab_outranks_bc": (_ab_pieces(-1.0, -2.0), 2, False),
        "user_defined": (_user_defined_pieces(), 2, False),
    }[model]


def test_sentencepiece_pieces_as_the_jax_tests_pin_them(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(spm.write_model_proto(_tiny_sp_pieces()))
    tok = spm.SentencePieceTokenizer.load(str(tmp_path))

    def pieces(t, text):
        return [t.id_to_piece[i] for i in t.encode(text)]

    assert pieces(tok, "hello world") == ["▁hello", "▁world"]
    assert pieces(tok, "hold") == ["▁", "h", "o", "l", "d"]
    assert pieces(tok, "hello☃")[-3:] == ["<0xE2>", "<0x98>", "<0x83>"]
    assert tok.decode(tok.encode("hello☃")) == "hello☃"
    assert tok.bos_id not in tok.encode("<s>")
    ids = tok.encode("hello", add_bos=True, add_eos=True)
    assert (ids[0], ids[-1], tok.decode(ids)) == (1, 2, "hello")
    assert pieces(_both(SP_MODELS["bc_outranks_ab"]())[0], "abc") == ["a", "bc"]
    assert pieces(_both(SP_MODELS["ab_outranks_bc"]())[0], "abc") == ["ab", "c"]
    assert pieces(_both(SP_MODELS["user_defined"]())[0], "x<tool>y") == ["x", "<tool>", "y"]
    off = _both(SP_MODELS["disabled_specials"]())[0]
    assert (off.bos_id, off.eos_id, off.pad_id) == (-1, -1, 0)


def test_sentencepiece_proto_round_trip_and_errors_equal_jax():
    pieces = _tiny_sp_pieces()
    blob = spm.write_model_proto(pieces, add_dummy_prefix=False, pad_id=-1, unk_id=0)
    assert spm.parse_model_proto(blob) == j_spm.parse_model_proto(blob)
    proto = spm.parse_model_proto(blob)
    assert proto["pieces"] == [(p, pytest.approx(s), t) for p, s, t in pieces]
    assert (proto["model_type"], proto["add_dummy_prefix"], proto["pad_id"]) == (2, False, -1)
    unigram = spm.write_model_proto(pieces, model_type=1)
    for bad in (unigram, b"\0"):
        with pytest.raises(Exception) as ours:
            spm.SentencePieceTokenizer(spm.parse_model_proto(bad))
        with pytest.raises(Exception) as theirs:
            j_spm.SentencePieceTokenizer(j_spm.parse_model_proto(bad))
        assert (type(ours.value), str(ours.value)) == (type(theirs.value), str(theirs.value))


@pytest.fixture(scope="module")
def trained_json(tmp_path_factory):
    """tests/test_llama_tokenizer.py's byte-level BPE, trained by the
    ``tokenizers`` library."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=["<|endoftext|>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = [s * 3 for s in SAMPLES] + ["the quick brown fox jumps over the lazy dog " * 5]
    tok.train_from_iterator(corpus, trainer)
    path = tmp_path_factory.mktemp("tj") / "tokenizer.json"
    tok.save(str(path))
    return str(path), tok


def _variant(trained_json, tmp_path, kind: str):
    """A tokenizer.json of one shape: the trained one, Llama-3's
    Sequence[Split, ByteLevel], one with an added special, or ByteLevel
    with a prefix space and its decoder."""
    from tokenizers import Regex, Tokenizer, decoders, pre_tokenizers

    path, _ = trained_json
    hf = Tokenizer.from_str(pathlib.Path(path).read_text(encoding="utf-8"))
    if kind == "llama3_split":
        hf.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.Split(Regex(LLAMA3_PAT), behavior="isolated"),
            pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    elif kind == "added_special":
        hf.add_special_tokens(["<|special|>"])
    elif kind == "prefix_space":
        hf.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
        hf.decoder = decoders.ByteLevel()
    out = tmp_path / "tokenizer.json"
    hf.save(str(out))
    return str(out), hf


@pytest.mark.parametrize("kind", ["trained", "llama3_split", "added_special", "prefix_space"])
def test_tokenizer_json_ids_equal_jax_and_the_tokenizers_library(kind, trained_json, tmp_path):
    path, hf = _variant(trained_json, tmp_path, kind)
    ours, theirs = tj.TokenizerJSON.load(path), j_tj.TokenizerJSON.load(path)
    assert (ours.bos_id, ours.eos_id, ours.pad_id, ours.vocab_size) == (
        theirs.bos_id, theirs.eos_id, theirs.pad_id, theirs.vocab_size)
    for s in SAMPLES + ["hello <|special|> world", " hi", "hi", "  two"]:
        ids = ours.encode(s)
        assert ids == theirs.encode(s) == hf.encode(s).ids, (kind, s)
        assert ours.decode(ids) == theirs.decode(ids)
        assert ours.encode(s, add_bos=True, add_eos=True) == theirs.encode(
            s, add_bos=True, add_eos=True)
    if kind == "prefix_space":
        for s in (" hi", "hi", "  two"):
            assert ours.decode(ours.encode(s)) == hf.decode(hf.encode(s).ids,
                                                            skip_special_tokens=True)
    if kind == "added_special":
        assert "<|special|>" not in ours.decode(ours.encode("hello <|special|> world"))


@pytest.mark.parametrize("spec", [
    {"model": {"type": "Unigram"}},
    {"model": {"type": "BPE", "vocab": {}, "merges": []}, "normalizer": {"type": "NFKC"}},
    {"model": {"type": "BPE", "vocab": {}, "merges": []},
     "pre_tokenizer": {"type": "Metaspace"}},
    {"model": {"type": "BPE", "vocab": {}, "merges": []}, "pre_tokenizer": None},
    {"model": {"type": "BPE", "vocab": {}, "merges": []},
     "pre_tokenizer": {"type": "Split", "pattern": {"String": " "}}}])
def test_tokenizer_json_refusals_equal_jax(spec):
    with pytest.raises(ValueError) as ours:
        tj.TokenizerJSON(spec)
    with pytest.raises(ValueError) as theirs:
        j_tj.TokenizerJSON(spec)
    assert str(ours.value) == str(theirs.value)


def test_gpt2_bpe_as_tokenizer_json_encodes_readme_to_the_bpe_ids(tmp_path):
    from tokenizers import Tokenizer

    bpe = BPETokenizer.load(str(ROOT / "runs" / "parity" / "tok"))
    spec = tj.bpe_tokenizer_json(bpe)
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    ours = load_tokenizer(str(tmp_path))
    assert isinstance(ours, tj.TokenizerJSON)
    assert (ours.vocab_size, ours.eos_id, ours.bos_id) == (16384, bpe.eos_id, bpe.bos_id)
    text = (ROOT / "README.md").read_text(encoding="utf-8")
    ids = ours.encode(text)
    assert ids == bpe.encode(text) == Tokenizer.from_str(json.dumps(spec)).encode(text).ids
    assert bpe.decode(ids) == text
    # TokenizerJSON decodes token by token, as the JAX package's does
    assert ours.decode(ids) == j_tj.TokenizerJSON(spec).decode(ids)


def test_load_tokenizer_dispatches_every_spec_as_jax(tmp_path, trained_json, capsys,
                                                     monkeypatch):
    blob = spm.write_model_proto(_tiny_sp_pieces())
    (tmp_path / "sp").mkdir()
    (tmp_path / "sp" / "tokenizer.model").write_bytes(blob)
    (tmp_path / "llama2.model").write_bytes(blob)
    tok_dir = ROOT / "runs" / "parity" / "tok"
    json_path, _ = trained_json
    specs = {
        f"bpe:{tok_dir}": "BPETokenizer", str(tok_dir): "BPETokenizer",
        f"sp:{tmp_path / 'sp' / 'tokenizer.model'}": "SentencePieceTokenizer",
        f"sp:{tmp_path / 'sp'}": "SentencePieceTokenizer",
        str(tmp_path / "sp"): "SentencePieceTokenizer",
        str(tmp_path / "llama2.model"): "SentencePieceTokenizer",
        json_path: "TokenizerJSON", str(pathlib.Path(json_path).parent): "TokenizerJSON",
        str(tmp_path / "no-such-tokenizer"): "ByteTokenizer",
    }
    for spec, cls in specs.items():
        ours, theirs = load_tokenizer(spec), j_tokenizer.load_tokenizer(spec)
        assert type(ours).__name__ == type(theirs).__name__ == cls, spec
        assert ours.vocab_size == theirs.vocab_size
        assert ours.encode("hello world ☃") == theirs.encode("hello world ☃"), spec
    assert "WARNING: could not resolve" in capsys.readouterr().err
    assert isinstance(load_tokenizer(None), ByteTokenizer)
    # what only transformers.AutoTokenizer loads stays refused by name
    (tmp_path / "hf").mkdir()
    (tmp_path / "hf" / "tokenizer_config.json").write_text("{}")
    (tmp_path / "hub" / "models--org--name").mkdir(parents=True)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    for name in (str(tmp_path / "hf"), "org/name"):
        with pytest.raises(NotImplementedError, match="only through transformers.*item 9"):
            load_tokenizer(name)
