"""The run journal, port against the JAX package (tests/test_journal.py).

- the recorder: the JAX module's schema constants and strict-JSON field
  rules on the same inputs; atomic rotation and the recovery from a torn
  write (the ``journal_torn_write`` fault), every surviving file passing
  ``scripts/validate_metrics.validate_journal_file``; a bounded cost per
  event; the emitter (printing, recording, ``echo=False``);
- the trainer: journal on and off ``torch.equal`` in params and momentum
  at W = 1 (W = 4: ``tests/test_torch_control_plane.py``); a journaled leg
  with async checkpoints whose attribution closes with coverage >= 0.95,
  its caller-thread ckpt spans near the ``ckpt_stall_s`` ledger and the
  commit thread's spans left out; only the analyzer's span heads; the
  crash bundle's ``journal_tail.jsonl`` ending in the trip; the
  ``preempt_drain`` event; the metrics rows kept out of the journal;
- the modules that journal: the vote guard's transitions as JAX's guard
  journals them, the native loader's ``shard_retry`` and ``shard_skipped``,
  the tokenizer's fallback warning, the profiler's notice.

The bounds are the JAX tests'.
"""

import importlib.util
import json
import os
import pathlib
import time

import numpy as np
import pytest
import torch

from distributed_lion_tpu_torch.cli import run_analyze
from distributed_lion_tpu_torch.data import native_loader, tokenizer
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.train import journal, resilience
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from distributed_lion_tpu_torch.train.profiling import StepProfiler
from distributed_lion_tpu_torch.train.vote_guard import VoteGuard

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(compute_dtype=torch.float32, dropout=0.0)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


validate_metrics = _load("torch_journal_validate_metrics", "scripts/validate_metrics.py")


@pytest.fixture(autouse=True)
def _clean():
    resilience.clear_faults()
    yield
    resilience.clear_faults()
    assert journal.active() is journal.NULL  # every test's trainer uninstalled its journal


def _cfg(**kw):
    """tests/test_journal.py's ``_tiny_cfg``."""
    base = dict(lion=True, async_grad=True, wire="sign_psum", vote_every=1, vote_buckets=1,
                learning_rate=1e-3, warmup_steps=1, max_steps=3,
                per_device_train_batch_size=1, gradient_accumulation_steps=1, block_size=32,
                logging_steps=1, output_dir=None, save_steps=10**6,
                resume_from_checkpoint=False)
    base.update(kw)
    return TrainConfig(**base)


def _train(cfg, trainer=None):
    tr = trainer or Trainer.for_gpt2(cfg, GPT2Config.tiny(**TINY), device="cpu")
    blocks = synthetic_lm_dataset(32, 32, 256, seed=4)
    try:
        hist = tr.train(batch_iterator(blocks, tr.global_train_batch(), seed=0))
    finally:
        tr.close()
    return tr, hist


def _records(directory):
    out = []
    for f in sorted(pathlib.Path(directory).glob("journal_rank*.jsonl")):
        out += [json.loads(line) for line in f.read_text().splitlines() if line.strip()]
    return out


# ------------------------------------------------------------ the recorder
def test_schema_constants_equal_jax():
    from distributed_lion_tpu.train import journal as j_journal

    assert journal.SCHEMA_VERSION == j_journal.SCHEMA_VERSION
    assert journal.KINDS == j_journal.KINDS
    assert (journal.DEFAULT_MAX_BYTES, journal.DEFAULT_RING) == (j_journal.DEFAULT_MAX_BYTES,
                                                                 j_journal.DEFAULT_RING)
    assert journal.journal_filename(3) == j_journal.journal_filename(3)
    assert validate_metrics._JOURNAL_KINDS == journal.KINDS


FIELDS = {
    "scalars": {"a": 1, "b": 2.5, "c": "x", "d": None, "e": True},
    "nonfinite": {"loss": float("nan"), "g": float("inf"), "h": -float("inf")},
    "flat_lists": {"mask": [True, False, True], "mixed": [1, "a", None, 2.0], "bad": [1.0, 0.0]},
    "nested": {"nest": [[1, 2]], "nan_list": [1.0, float("nan")], "obj": object.__name__,
               "arr": (3, 4)},
    "dicts": {"stats": {"ticks": 3, "ok": True}, "deep": {"a": {"b": 1}}},
}


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_record_fields_equal_jax(name):
    """The strict-JSON view of free-form fields (non-finite floats as null
    with their repr, flat lists kept, one-level dicts flattened) equals
    JAX's, and every record serializes with ``allow_nan=False``."""
    from distributed_lion_tpu.train import journal as j_journal

    got = journal._safe_fields(FIELDS[name])
    assert got == j_journal._safe_fields(FIELDS[name])
    j = journal.Journal(None, rank=2)
    j.event("e", **FIELDS[name])
    rec = j.tail()[-1]
    json.dumps(rec, allow_nan=False)
    assert rec["rank"] == 2 and rec["kind"] == "event"


def test_event_overhead_bounded(tmp_path):
    j = journal.Journal(str(tmp_path), ring=64)
    n = 2000
    t0 = time.perf_counter()
    for i in range(n):
        j.event("step_log", step=i, steps_per_sec=123.456)
    dt = time.perf_counter() - t0
    j.close()
    assert dt / n < 1e-3, f"{dt / n * 1e6:.1f} us/event"
    assert len(j.tail()) == 64


def test_rotation_and_crash_mid_write_recovery(tmp_path):
    d = str(tmp_path)
    j = journal.Journal(d, max_bytes=700, ring=16)
    for i in range(12):
        j.event("filler", step=i, pad="x" * 80)
    rotated = [f for f in os.listdir(d) if f.startswith("journal_rank0.")
               and f != "journal_rank0.jsonl"]
    assert rotated, "tiny max_bytes produced no rotation"
    resilience.inject_fault("journal_torn_write", 1)
    j.event("doomed", step=99)          # torn on disk, sink disabled
    j.event("ring_only", step=100)      # the ring keeps recording
    assert any(r["name"] == "ring_only" for r in j.tail())
    j.close()
    raw = open(os.path.join(d, "journal_rank0.jsonl"), "rb").read()
    assert not raw.endswith(b"\n")
    j2 = journal.Journal(d, ring=16)
    j2.event("after_recovery", step=101)
    j2.close()
    names = []
    for f in sorted(os.listdir(d)):
        assert validate_metrics.validate_journal_file(os.path.join(d, f)) == [], f
        with open(os.path.join(d, f)) as fh:
            names += [json.loads(line)["name"] for line in fh]
    assert "after_recovery" in names and "journal_recovered" in names
    assert "doomed" not in names
    # every file starts with its own clock anchor, so the analyzer merges them
    report = run_analyze.analyze_dir(d)
    assert report["schema_errors"] == 0 and report["ranks"] == [0]


def test_emitter_mirrors_and_records(tmp_path, capsys):
    journal.emit("[x] no journal yet")
    assert capsys.readouterr().out == "[x] no journal yet\n"
    j = journal.Journal(str(tmp_path))
    journal.install(j)
    try:
        journal.emit("[x] hello")
        journal.emit("[x] quiet", echo=False)
        journal.emit("[x] err", stderr=True)
        journal.emit("[x] not kept", record=False)
        journal.event("side_event", k=1)
        out = capsys.readouterr()
        assert out.out == "[x] hello\n[x] not kept\n" and out.err == "[x] err\n"
        logs = [(r["msg"], r["stream"]) for r in j.tail() if r["kind"] == "log"]
        assert logs == [("[x] hello", "stdout"), ("[x] quiet", "stdout"),
                        ("[x] err", "stderr")]
        assert any(r["name"] == "side_event" for r in j.tail())
        assert journal.active() is j
    finally:
        journal.uninstall(j)
        j.close()
    journal.emit("[x] after uninstall")
    assert journal.active() is journal.NULL


def test_null_journal_has_the_journal_surface():
    with journal.NULL.span("x", step=1) as sp:
        sp.set(a=1)
    journal.NULL.event("e")
    journal.NULL.record({"kind": "span"})
    journal.NULL.log("m")
    journal.NULL.flush()
    journal.NULL.close()
    assert journal.NULL.tail() == journal.NULL.records() == []
    public = {n for n in dir(journal.Journal) if not n.startswith("_")}
    assert public <= {n for n in dir(journal.NULL) if not n.startswith("_")}


# -------------------------------------------------------------- the trainer
@pytest.mark.parametrize("buckets", [1, 4])
def test_journal_on_off_equal_at_w1(tmp_path, buckets):
    runs = {}
    for on in (False, True):
        tr, hist = _train(_cfg(vote_buckets=buckets, journal=on, telemetry=True,
                               output_dir=str(tmp_path / f"b{buckets}{on}")))
        runs[on] = ([h["loss"] for h in hist if "loss" in h], tr.flat.params.clone(),
                    tr.state.exp_avg.clone())
    assert runs[True][0] == runs[False][0]
    assert torch.equal(runs[True][1], runs[False][1])
    assert torch.equal(runs[True][2], runs[False][2])


def test_trainer_leg_attribution_coverage(tmp_path):
    """tests/test_journal.py::test_trainer_leg_attribution_coverage: a
    journaled leg with async checkpoints attributes >= 95% of its wall to
    the named buckets and closes; both analyzers agree on it; its ckpt
    spans on the step thread match the stall ledger; the commit thread's
    spans exist and are left out; the trainer's span heads are the
    analyzer's buckets (and ``eval``)."""
    tr, _ = _train(_cfg(journal=True, output_dir=str(tmp_path), save_steps=2, max_steps=6,
                        logging_steps=2))
    stall = tr.checkpointer.total_stall_s
    report = run_analyze.analyze_dir(str(tmp_path))
    ja = _load("torch_journal_run_analyze", "distributed_lion_tpu/cli/run_analyze.py")
    assert report == ja.analyze_dir(str(tmp_path))
    att = report["attribution"]
    assert report["schema_errors"] == 0 and att["closes"], att
    assert att["steps"] == 6 and att["coverage"] >= 0.95, att
    assert att["buckets"]["dispatch"]["s"] > 0 and att["buckets"]["logging"]["s"] > 0
    recs = _records(tmp_path / "journal")
    for f in (tmp_path / "journal").iterdir():
        assert validate_metrics.validate_journal_file(str(f)) == []
    spans = [r for r in recs if r["kind"] == "span"]
    ckpt = [r for r in spans if r["name"].startswith("ckpt") and not r.get("thread")]
    committer = [r for r in spans if r.get("thread") == "committer"]
    assert {r["name"] for r in committer} >= {"ckpt/write", "ckpt/digest", "ckpt/commit_marker"}
    span_s = sum(r["dur"] for r in ckpt)
    assert abs(span_s - stall) <= 0.05 + 0.25 * stall, (span_s, stall)
    heads = {r["name"].split("/", 1)[0] for r in spans if not r.get("thread")}
    assert heads <= set(run_analyze.BUCKET_OF) | {"eval"}, heads
    names = [r["name"] for r in recs if r["kind"] == "event"]
    assert names.count("train_start") == names.count("train_end") == 1
    assert names.count("step_log") == 3
    # the metrics rows stay in metrics.jsonl: no log record repeats one
    assert not [r for r in recs if r["kind"] == "log" and "train/loss=" in r["msg"]]


def test_crash_bundle_carries_journal_tail(tmp_path):
    """The sentinel's bundle holds ``journal_tail.jsonl`` in the journal's
    strict schema, with the step's spans and, last, the trip."""
    tr = Trainer.for_gpt2(_cfg(journal=True, nan_sentinel=True, output_dir=str(tmp_path)),
                          GPT2Config.tiny(**TINY), device="cpu")
    with torch.no_grad():
        tr.flat.params[0] = float("nan")
    with pytest.raises(FloatingPointError):
        _train(None, trainer=tr)
    tail = sorted((tmp_path / "crash").iterdir())[0] / "journal_tail.jsonl"
    assert validate_metrics.validate_journal_file(str(tail)) == []
    recs = [json.loads(line) for line in tail.read_text().splitlines()]
    assert "span" in {r["kind"] for r in recs}
    assert recs[-1]["kind"] == "log" and recs[-1]["msg"].startswith("[trainer] ANOMALY:")


def test_preempt_drain_event_recorded(tmp_path):
    tr = Trainer.for_gpt2(_cfg(journal=True, max_steps=8, output_dir=str(tmp_path)),
                          GPT2Config.tiny(**TINY), device="cpu")
    tr._preempt.trigger()
    _train(None, trainer=tr)
    assert tr.preempted
    recs = _records(tmp_path / "journal")
    drain = [r for r in recs if r["name"] == "preempt_drain"]
    assert len(drain) == 1 and drain[0]["signal_to_boundary_s"] >= 0
    end = [r for r in recs if r["name"] == "train_end"]
    assert end and end[0]["preempted"] is True


def test_preemption_guard_journals_once_like_jax():
    from distributed_lion_tpu.train import resilience as j_resilience

    got = []
    for mod in (resilience, j_resilience):
        jr = _FakeJournal()
        guard = mod.PreemptionGuard(signals=(), journal=jr)
        assert not guard.should_stop() and jr.records == []
        guard.trigger()
        assert guard.should_stop() and guard.should_stop()
        got.append([(r["name"], sorted(r)) for r in jr.records])
    assert got[0] == got[1] == [("preempt_drain", ["kind", "name", "signal_to_boundary_s"])]


class _FakeJournal:
    def __init__(self):
        self.records = []

    def event(self, name, **fields):
        self.records.append({"kind": "event", "name": name, **fields})

    def record(self, rec):
        self.records.append(dict(rec))


def test_vote_guard_journals_transitions_like_jax():
    from distributed_lion_tpu.train.vote_guard import VoteGuard as JVoteGuard

    streams = []
    for cls in (VoteGuard, JVoteGuard):
        jr = _FakeJournal()
        g = cls(4, "enforce", strike_threshold=1, cooldown_steps=2, journal=jr)
        g.update(10, {"guard_nonfinite": np.array([0, 1, 0, 0]), "guard_frozen": np.zeros(4),
                      "guard_disagree": np.zeros(4), "guard_voted_steps": np.array(1)}, 1)
        g.update(13, {"guard_nonfinite": np.zeros(4), "guard_frozen": np.zeros(4),
                      "guard_disagree": np.zeros(4), "guard_voted_steps": np.array(1)}, 1)
        streams.append(jr.records)
    assert streams[0] == streams[1]
    assert [r["name"] for r in streams[0]] == ["guard_quarantine", "guard_readmit"]


# ------------------------------------------------- the modules that journal
def test_native_loader_journals_retries_and_skips(tmp_path, monkeypatch):
    bad = tmp_path / "flaky.bin"
    bad.write_bytes(b"\x00\x01")

    def flaky(path, dtype_bytes):
        raise OSError("transient read error")

    monkeypatch.setattr(native_loader.native, "load", lambda: None)
    monkeypatch.setattr(native_loader, "_validate_shard", flaky)
    monkeypatch.setattr(native_loader, "SHARD_BACKOFF_S", 0.0)
    j = journal.Journal(None)
    journal.install(j)
    try:
        with pytest.raises(native_loader.CorruptShardError):
            native_loader.NativeTokenLoader([bad], 8)
    finally:
        journal.uninstall(j)
    names = [r["name"] for r in j.tail()]
    assert names.count("shard_retry") == native_loader.SHARD_RETRIES
    skipped = [r for r in j.tail() if r["name"] == "shard_skipped"]
    assert skipped[0]["shard"] == str(bad) and "OSError" in skipped[0]["error"]
    assert any(r["kind"] == "log" and r["stream"] == "stderr" for r in j.tail())


def test_tokenizer_fallback_and_profiler_notice_are_journaled(tmp_path, capsys):
    j = journal.Journal(None)
    journal.install(j)
    try:
        tok = tokenizer.load_tokenizer(str(tmp_path / "no_such_tokenizer"))
        prof = StepProfiler(str(tmp_path / "trace"), start_step=0, num_steps=1)
        prof.maybe_start(0)
        prof.maybe_stop(1)
    finally:
        journal.uninstall(j)
    assert tok.vocab_size == 259
    msgs = [r["msg"] for r in j.tail() if r["kind"] == "log"]
    assert any(m.startswith("[tokenizer] WARNING") for m in msgs)
    assert any(m.startswith("[profiler] trace for steps [0, 1)") for m in msgs)
    assert "[tokenizer] WARNING" in capsys.readouterr().err
