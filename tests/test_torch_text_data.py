"""The port's data path against the JAX package's, on the CPU: the resume
seek, GPT-2 BPE, ``text:`` blocks and the C++ native loader.

- ``BatchIterator.skip(k)`` then ``next()`` equals the (k+1)-th ``next()``
  and the JAX package's skip, across epoch edges; the trainer's resume
  seeks instead of replaying (its reads are counted).
- ``BPETokenizer.encode`` gives the JAX package's ids token for token on
  ``README.md`` with ``runs/parity/tok/`` (a GPT-2-format byte-level BPE of
  16,384 ids), on the C++ merge core and on the Python path; decode
  round-trips.
- ``run_clm.load_blocks("text:...")`` and ``TokenDataset.from_npy`` are
  array-equal to the JAX package's.
- ``NativeTokenLoader`` batches, with and without ``skip``, across an epoch
  edge and under a ``block_range``, equal the JAX package's native loader
  on the same shard and seed (both are built here with g++ from the same
  code); a corrupt shard is skipped loudly.
"""

import pathlib

import numpy as np
import pytest
import torch

from distributed_lion_tpu.cli import run_clm as j_run_clm
from distributed_lion_tpu.data import bpe as j_bpe
from distributed_lion_tpu.data.native_loader import NativeTokenLoader as JLoader
from distributed_lion_tpu.data.sources import BatchIterator as JBatchIterator
from distributed_lion_tpu.data.sources import TokenDataset as JTokenDataset
from distributed_lion_tpu_torch import native
from distributed_lion_tpu_torch.cli import run_clm
from distributed_lion_tpu_torch.data import bpe
from distributed_lion_tpu_torch.data.native_loader import CorruptShardError, NativeTokenLoader
from distributed_lion_tpu_torch.data.sources import BatchIterator, TokenDataset, batch_iterator
from distributed_lion_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOK = ROOT / "runs" / "parity" / "tok"
README = (ROOT / "README.md").read_text(encoding="utf-8")


def _blocks(n=23, t=8):
    return (np.arange(n * t).reshape(n, t) % 251).astype(np.int32)


@pytest.mark.parametrize("k", [0, 1, 3, 5, 11, 30])
def test_skip_matches_replay_and_jax(k):
    ref = batch_iterator(_blocks(), 4, seed=9)
    for _ in range(k):
        next(ref)
    want = next(ref)
    it = batch_iterator(_blocks(), 4, seed=9)
    it.skip(k)
    jit = JBatchIterator(_blocks(), 4, seed=9)
    jit.skip(k)
    got = next(it)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, next(jit))


def test_skip_past_finite_epochs():
    it = BatchIterator(_blocks(), 4, seed=0, epochs=2)
    it.skip(10_000)
    with pytest.raises(StopIteration):
        next(it)


def test_trainer_seeks_and_does_not_replay(tmp_path, monkeypatch):
    from distributed_lion_tpu_torch.data.sources import synthetic_lm_dataset
    from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
    from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer

    blocks = synthetic_lm_dataset(64, 32, 256, seed=1)
    model = GPT2Config.tiny(compute_dtype=torch.float32)

    def trainer(out, steps):
        return Trainer.for_gpt2(TrainConfig(
            learning_rate=1e-3, warmup_steps=1, max_steps=steps, per_device_train_batch_size=1,
            gradient_accumulation_steps=1, block_size=32, logging_steps=1, save_steps=2,
            output_dir=out, seed=5), model, device="cpu")

    t0 = trainer(None, 4)
    ref = [h["loss"] for h in t0.train(batch_iterator(blocks, 1, seed=5))]
    out = str(tmp_path / "run")
    t1 = trainer(out, 2)
    t1.train(batch_iterator(blocks, 1, seed=5))
    t1.close()
    t2 = trainer(out, 4)
    assert t2.step_count == 2
    it = batch_iterator(blocks, 1, seed=5)
    reads = {"n": 0}
    orig_next = type(it).__next__

    def counting_next(self):
        reads["n"] += 1
        return orig_next(self)

    monkeypatch.setattr(type(it), "__next__", counting_next)
    resumed = [h["loss"] for h in t2.train(it) if "loss" in h]
    t2.close()
    assert reads["n"] == 2  # the two live batches; skip() read nothing
    assert resumed == ref[2:]


@pytest.fixture(scope="module")
def toks():
    return bpe.BPETokenizer.load(str(TOK)), j_bpe.BPETokenizer.load(str(TOK))


def test_bpe_native_core_matches_jax_token_for_token(toks):
    tok, jtok = toks
    assert tok.native and jtok._native_core() is not None
    ids = tok.encode(README, add_bos=True, add_eos=True)
    assert ids == jtok.encode(README, add_bos=True, add_eos=True)
    assert tok.vocab_size == jtok.vocab_size == 16384 and ids[0] == ids[-1] == tok.eos_id
    assert len(ids) < len(README.encode()) // 2  # the merges compress
    assert tok.decode(ids) == README


def test_bpe_python_path_matches_jax_and_the_native_core(toks, monkeypatch):
    monkeypatch.setenv("DLION_NATIVE_BPE", "0")
    tok, jtok = bpe.BPETokenizer.load(str(TOK)), j_bpe.BPETokenizer.load(str(TOK))
    assert not tok.native and jtok._native_core() is None
    text = README[:20000] + " naïve café — 東京 emoji 🙂 's 've \t\n  tail"
    ids = tok.encode(text)
    assert ids == jtok.encode(text) == toks[0].encode(text)
    assert tok.decode(ids) == text


def test_bpe_tables_and_save_load(toks, tmp_path):
    tok, _ = toks
    assert bpe.bytes_to_unicode() == j_bpe.bytes_to_unicode()
    assert len(set(bpe.bytes_to_unicode().values())) == 256
    tok.save(str(tmp_path / "tok"))
    again = bpe.BPETokenizer.load(str(tmp_path / "tok"))
    assert again.vocab == tok.vocab and again.ranks == tok.ranks


def test_load_tokenizer_dispatch_and_refusals(tmp_path, capsys, monkeypatch):
    """SentencePiece and tokenizer.json load since the HF slice: a broken
    file meets the JAX package's own error. What only ``transformers`` loads
    (a ``tokenizer_config.json`` directory, an HF-cache name) stays refused."""
    from distributed_lion_tpu.data.tokenizer import load_tokenizer as j_load_tokenizer

    assert isinstance(load_tokenizer(None), ByteTokenizer)
    assert load_tokenizer(f"bpe:{TOK}").vocab_size == 16384
    assert load_tokenizer(str(TOK)).vocab_size == 16384
    (tmp_path / "sp").mkdir()
    (tmp_path / "sp" / "tokenizer.model").write_bytes(b"\0")
    (tmp_path / "tokenizer.json").write_text("{}")
    (tmp_path / "hf").mkdir()
    (tmp_path / "hf" / "tokenizer_config.json").write_text("{}")
    (tmp_path / "hub" / "models--org--name").mkdir(parents=True)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    for name in ("sp:x.model", str(tmp_path / "sp"), str(tmp_path / "sp" / "tokenizer.model"),
                 str(tmp_path / "tokenizer.json"), str(tmp_path)):
        with pytest.raises(Exception) as want:
            j_load_tokenizer(name)
        with pytest.raises(type(want.value)) as got:
            load_tokenizer(name)
        assert str(got.value) == str(want.value), name
    for name in (str(tmp_path / "hf"), "org/name"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
            load_tokenizer(name)
    assert isinstance(load_tokenizer("no-such-tokenizer-name"), ByteTokenizer)
    assert "WARNING: could not resolve 'no-such-tokenizer-name'" in capsys.readouterr().err


def test_text_blocks_equal_jax(tmp_path):
    (tmp_path / "b.txt").write_text("second file, shorter.\n" * 40)
    for name in (None, str(TOK)):
        for pattern in (str(ROOT / "README.md"), str(tmp_path / "*.txt")):
            args = dict(dataset=f"text:{pattern}", tokenizer_name=name,
                        validation_split_percentage=10)
            got = run_clm.load_blocks(run_clm.DataArguments(**args), 64, 16384)
            want = j_run_clm.load_blocks(j_run_clm.DataArguments(**args), 64, 16384)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="vocab_size"):
        run_clm.load_blocks(run_clm.DataArguments(dataset=f"text:{ROOT / 'README.md'}",
                                                  tokenizer_name=str(TOK)), 64, 1000)


def test_npy_dataset_equal_jax(tmp_path):
    np.save(tmp_path / "b.npy", _blocks())
    np.testing.assert_array_equal(TokenDataset.from_npy(tmp_path / "b.npy").blocks,
                                  JTokenDataset.from_npy(tmp_path / "b.npy").blocks)


def _shard(tmp_path, n_tokens=23 * 8 + 5, dtype=np.uint16, name="s.bin"):
    tokens = np.random.default_rng(0).integers(0, 60000, size=n_tokens).astype(dtype)
    path = tmp_path / name
    tokens.tofile(path)
    return path, tokens


@pytest.mark.parametrize("block_range", [None, (3, 21)])
def test_native_loader_batches_and_skip_equal_jax(tmp_path, block_range):
    path, tokens = _shard(tmp_path)
    loader, jloader = NativeTokenLoader([path], 8), JLoader([path], 8)
    assert len(loader) == len(jloader) == 23
    np.testing.assert_array_equal(loader.read_blocks(0, 23), tokens[:184].reshape(23, 8))
    np.testing.assert_array_equal(loader.read_blocks(5, 9), jloader.read_blocks(5, 9))
    it = loader.batches(4, seed=9, block_range=block_range)
    jit = jloader.batches(4, seed=9, block_range=block_range)
    batches = [next(it) for _ in range(12)]  # past two epoch edges
    for b in batches:
        np.testing.assert_array_equal(b, next(jit))
    loader.close()
    jloader.close()
    for k in (0, 1, 4, 7):
        loader, jloader = NativeTokenLoader([path], 8), JLoader([path], 8)
        it = loader.batches(4, seed=9, block_range=block_range)
        jit = jloader.batches(4, seed=9, block_range=block_range)
        it.skip(k)
        jit.skip(k)
        got = next(it)
        np.testing.assert_array_equal(got, batches[k], err_msg=f"k={k}")
        np.testing.assert_array_equal(got, next(jit), err_msg=f"k={k}")
        with pytest.raises(RuntimeError, match="cannot skip"):
            it.skip(1)
        loader.close()
        jloader.close()


def test_native_loader_uint32_and_multi_shard_equal_jax(tmp_path):
    a, _ = _shard(tmp_path, 70, np.uint32, "a.bin")
    b, _ = _shard(tmp_path, 45, np.uint32, "b.bin")
    loader = NativeTokenLoader([a, b], 8, dtype=np.uint32)
    jloader = JLoader([a, b], 8, dtype=np.uint32)
    assert len(loader) == 8 + 5
    np.testing.assert_array_equal(loader.read_blocks(0, 13), jloader.read_blocks(0, 13))
    with pytest.raises(IndexError):
        loader.read_block(13)
    loader.close()
    jloader.close()


def test_corrupt_shard_is_skipped_loudly(tmp_path, capsys):
    good, _ = _shard(tmp_path)
    bad = tmp_path / "torn.bin"
    bad.write_bytes(b"\x01\x02\x03")  # not a whole uint16
    loader = NativeTokenLoader([bad, good], 8)
    assert len(loader) == 23 and loader.shards == [str(good)]
    assert loader.health_metrics() == {"skipped_shards": 1, "shard_read_retries": 0}
    assert loader.batches(4).health_metrics()["skipped_shards"] == 1
    assert "skipping corrupt/unreadable shard" in capsys.readouterr().err
    loader.close()
    with pytest.raises(CorruptShardError):
        NativeTokenLoader([bad], 8)


def test_native_pipeline_equals_the_python_path_and_jax(tmp_path, monkeypatch):
    """``make_native_pipeline``: the held-out blocks and the first batches
    equal the JAX package's native pipeline; its train blocks are those of
    ``load_blocks``."""
    path, _ = _shard(tmp_path, 60 * 8)
    args = dict(dataset=f"bin:{tmp_path}/*.bin", validation_split_percentage=10)
    it, ev, loader = run_clm.make_native_pipeline(run_clm.DataArguments(**args), 8, 60000, 4,
                                                  seed=3)
    jit, jev, jloader = j_run_clm.make_native_pipeline(j_run_clm.DataArguments(**args), 8,
                                                       60000, 4, seed=3)
    np.testing.assert_array_equal(ev, jev)
    for _ in range(16):
        np.testing.assert_array_equal(next(it), next(jit))
    train, val = run_clm.load_blocks(run_clm.DataArguments(**args), 8, 60000)
    np.testing.assert_array_equal(val, ev)
    assert len(train) == len(loader) - len(ev)
    loader.close()
    jloader.close()
    monkeypatch.setattr(native, "available", lambda: False)
    assert run_clm.make_native_pipeline(run_clm.DataArguments(**args), 8, 60000, 4, 3) is None


def test_native_sources_are_copies_of_the_jax_packages():
    """The same code line for line; only comments may differ (one names
    the reference's file without its path on another machine)."""
    def code(path):
        return [line.split("//")[0].rstrip() for line in path.read_text().splitlines()]

    for name in ("bpe_core.cc", "dataloader.cc"):
        port = ROOT / "distributed_lion_tpu_torch" / "native" / name
        ref = ROOT / "distributed_lion_tpu" / "native" / name
        assert code(port) == code(ref), name
    assert ((ROOT / "distributed_lion_tpu_torch" / "native" / "dataloader.cc").read_bytes()
            == (ROOT / "distributed_lion_tpu" / "native" / "dataloader.cc").read_bytes())
    lib = native.library_path(native.SRC_DIR / "dataloader.cc")
    assert lib.parent == ROOT / "build" / "native" and native.available() and lib.exists()
