"""The offline journal analyzer, port against the JAX package's
``cli/run_analyze.py`` (both stdlib only; the JAX one is loaded by file
path).

On every journal below the port's ``analyze_dir``, ``render``, ``main``
(its exit code, its printed report and its ``--json-out`` file) and the
``--serve`` view equal JAX's, and every file passes
``scripts/validate_metrics.validate_journal_file``: the synthetic journals
of JAX ``tests/test_journal.py:234-347`` (two ranks with a deliberate clock
skew, appended legs, overlapping spans) and others of the same kind (four
ranks journaling one membership transition, a serving journal, a torn last
line, a file without its clock anchor, a baseline diff); journals the
port's trainer wrote; and the journal the JAX trainer wrote of the
control-plane pin (``tests/test_torch_control_plane.py``'s ``jax_pin``,
run once per session).
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import pytest
import torch

from distributed_lion_tpu_torch.cli import run_analyze
from distributed_lion_tpu_torch.data.sources import batch_iterator, synthetic_lm_dataset
from distributed_lion_tpu_torch.models.gpt2 import GPT2Config
from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer
from test_torch_control_plane import jax_pin  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX = _load("torch_ra_jax_run_analyze", "distributed_lion_tpu/cli/run_analyze.py")
VALIDATE = _load("torch_ra_validate_metrics", "scripts/validate_metrics.py")


def rec(**kw):
    return json.dumps(kw, allow_nan=False)


def _skewed():
    """tests/test_journal.py::test_analyzer_merges_skewed_multi_host_journals."""
    r0 = [rec(kind="meta", name="journal_start", t=100.0, rank=0, wall=1000.0, pid=1, version=1),
          rec(kind="event", name="train_start", t=100.0, rank=0, step=0),
          rec(kind="span", name="data_wait", t=100.1, rank=0, dur=0.1, step=0),
          rec(kind="span", name="dispatch", t=100.7, rank=0, dur=0.6, step=0),
          rec(kind="span", name="device_wait", t=100.9, rank=0, dur=0.2, step=1),
          rec(kind="span", name="logging_drain", t=100.95, rank=0, dur=0.05, step=1),
          rec(kind="span", name="ckpt/drain", t=100.99, rank=0, dur=0.04, step=1),
          rec(kind="span", name="ckpt/digest", t=100.99, rank=0, dur=0.5, step=1,
              thread="committer"),
          rec(kind="event", name="step_log", t=100.96, rank=0, step=1),
          rec(kind="event", name="train_end", t=101.0, rank=0, step=2)]
    r1 = [rec(kind="meta", name="journal_start", t=5000.0, rank=1, wall=1000.02, pid=2,
              version=1),
          rec(kind="event", name="step_log", t=5000.97, rank=1, step=1)]
    return {"journal_rank0.jsonl": r0, "journal_rank1.jsonl": r1}


def _legs(overlap=False):
    """tests/test_journal.py::test_analyzer_latest_leg_window_and_overlap_detection."""
    rows = [rec(kind="meta", name="journal_start", t=0.0, rank=0, wall=1000.0, version=1),
            rec(kind="event", name="train_start", t=0.0, rank=0, step=0),
            rec(kind="span", name="dispatch", t=9.0, rank=0, dur=9.0, step=0),
            rec(kind="event", name="train_end", t=10.0, rank=0, step=9),
            rec(kind="event", name="train_start", t=100.0, rank=0, step=9),
            rec(kind="span", name="dispatch", t=100.9, rank=0, dur=0.9, step=9),
            rec(kind="event", name="step_log", t=100.95, rank=0, step=12),
            rec(kind="event", name="train_end", t=101.0, rank=0, step=12)]
    if overlap:
        rows.append(rec(kind="span", name="device_wait", t=100.9, rank=0, dur=0.9, step=12))
    return {"journal_rank0.jsonl": rows}


def _membership():
    """Four ranks journaling the same transitions (the timeline keeps one
    row each; the generic twin of a specific event is dropped)."""
    files = {}
    for r in range(4):
        rows = [rec(kind="meta", name="journal_start", t=10.0 * r, rank=r, wall=500.0 + r * 1e-3,
                    version=1),
                rec(kind="event", name="train_start", t=10.0 * r, rank=r, step=0)]
        for step, name, cause, alive in ((3, "worker_left", "injected_drop", 3),
                                         (9, "worker_rejoined", "rejoin", 4)):
            rows.append(rec(kind="event", name=name, t=10.0 * r + step, rank=r, step=step,
                            worker=2, cause=cause, alive=alive, world=4,
                            mask_before=[True] * 4, mask_after=[True] * 4))
            rows.append(rec(kind="event", name="membership_transition", t=10.0 * r + step,
                            rank=r, step=step, worker=2, cause=cause, transition=name,
                            alive=alive, world=4))
        rows += [rec(kind="event", name="membership_transition", t=10.0 * r + 13, rank=r,
                     step=13, worker=2, cause="probe_complete", transition="healthy", alive=4,
                     world=4),
                 rec(kind="span", name="dispatch", t=10.0 * r + 13.5, rank=r, dur=13.0, step=0),
                 rec(kind="event", name="step_log", t=10.0 * r + 13.6, rank=r, step=14,
                     skew_steps=0),
                 rec(kind="event", name="train_end", t=10.0 * r + 14, rank=r, step=14)]
        files[f"journal_rank{r}.jsonl"] = rows
    return files


def _serve():
    rows = [rec(kind="meta", name="journal_start", t=1.0, rank=0, wall=2000.0, version=1),
            rec(kind="span", name="serve/prefill", t=1.2, rank=0, dur=0.05, req_id="a",
                prompt_len=12, shared=False),
            rec(kind="event", name="serve_finish", t=1.5, rank=0, req_id="a", reason="length",
                queue_ticks=2, ttft_ticks=3, decode_ticks=7, ttft_ms=12.5),
            rec(kind="event", name="serve_finish", t=1.6, rank=0, req_id="b", reason="timeout",
                queue_ticks=60),
            rec(kind="event", name="serve_metrics", t=1.7, rank=0, tick=10, ttft_ms_p50=10.0,
                ttft_ms_p99=20.0, tok_ms_p99=3.0, gauge_queue_depth=1.0),
            rec(kind="event", name="slo_breach", t=1.8, rank=0, tick=11, burn_rate=2.5,
                window_violations=3, window=10),
            rec(kind="event", name="replica_left", t=1.9, rank=0, tick=12, replica=1,
                cause="crash", alive=1, world=2),
            rec(kind="event", name="request_migrated", t=1.95, rank=0, tick=12, req_id="c",
                from_replica=1, to_replica=0, committed=4)]
    return {"journal_rank0.jsonl": rows}


def _torn():
    rows = _legs()["journal_rank0.jsonl"]
    return {"journal_rank0.jsonl": rows[:-1] + ['{"kind": "event", "na']}


def _unanchored():
    files = _skewed()
    files["journal_rank1.jsonl"] = files["journal_rank1.jsonl"][1:]
    return files


def _rotated():
    files = _legs()
    rows = files.pop("journal_rank0.jsonl")
    files["journal_rank0.0.jsonl"] = rows[:4]
    files["journal_rank0.jsonl"] = [rows[0]] + rows[4:]
    return files


SCENARIOS = {"skewed_two_ranks": _skewed, "latest_leg": _legs,
             "overlapping_spans": lambda: _legs(overlap=True), "membership": _membership,
             "serve": _serve, "torn_tail": _torn, "no_anchor": _unanchored,
             "rotated": _rotated}


def _write(directory: pathlib.Path, files: dict) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    for name, rows in files.items():
        (directory / name).write_text("\n".join(rows) + "\n")


def _main(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        code = mod.main(argv)
    return code, out.getvalue()


def assert_same_reports(directory: pathlib.Path, tmp: pathlib.Path, serve=False) -> dict:
    """Every output of the two analyzers on ``directory`` is the same."""
    d = str(directory)
    report = run_analyze.analyze_dir(d)
    assert report == JAX.analyze_dir(d)
    if report is not None:
        assert run_analyze.render(report) == JAX.render(report)
        for r in report["ranks"]:
            assert run_analyze.analyze_dir(d, rank=r) == JAX.analyze_dir(d, rank=r)
    for flag in ([], ["--serve"]) if serve else ([],):
        outs = []
        for mod, tag in ((run_analyze, "port"), (JAX, "jax")):
            path = tmp / f"{tag}{''.join(flag)}.json"
            code, text = _main(mod, [d, "--json-out", str(path)] + flag)
            outs.append((code, text, path.read_text() if path.exists() else None))
        assert outs[0] == outs[1]
    return report


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_synthetic_journals_equal_jax(tmp_path, name):
    _write(tmp_path / "run", SCENARIOS[name]())
    report = assert_same_reports(tmp_path / "run", tmp_path, serve=name == "serve")
    if name not in ("torn_tail", "no_anchor"):
        for f in (tmp_path / "run").iterdir():
            assert VALIDATE.validate_journal_file(str(f)) == [], f
    att = report["attribution"]
    if name == "skewed_two_ranks":
        assert report["ranks"] == [0, 1] and att["wall_s"] == pytest.approx(1.0)
        assert att["buckets"]["ckpt"]["s"] == pytest.approx(0.04)  # committer left out
        assert report["step_skew"]["max_s"] == pytest.approx(0.03, abs=1e-6)
    elif name == "latest_leg":
        assert att["wall_s"] == pytest.approx(1.0) and att["steps"] == 3 and att["closes"]
    elif name == "overlapping_spans":
        assert att["unattributed_s"] < 0 and not att["closes"]
    elif name == "membership":
        assert [r["event"] for r in report["membership"]] == [
            "worker_left", "worker_rejoined", "membership_transition"]
    elif name == "no_anchor":
        assert report["schema_errors"] == 1 and report["ranks"] == [0]
    elif name == "torn_tail":
        assert report["schema_errors"] == 0


def test_baseline_diff_equals_jax(tmp_path):
    _write(tmp_path / "run", _skewed())
    base = {"value": 1.0, "journal_attribution": {"buckets": {
        b: {"s": 0.0, "frac": f} for b, f in (("device", 0.8), ("dispatch", 0.1),
                                              ("data", 0.02), ("ckpt", 0.02),
                                              ("logging", 0.06))}}}
    (tmp_path / "BENCH_base.json").write_text(json.dumps(base))
    (tmp_path / "BENCH_old.json").write_text(json.dumps({"value": 1.0}))
    for b in ("BENCH_base.json", "BENCH_old.json", "missing.json"):
        args = (str(tmp_path / "run"), None, str(tmp_path / b))
        got = run_analyze.analyze_dir(*args)
        assert got == JAX.analyze_dir(*args)
        assert run_analyze.render(got) == JAX.render(got)
    assert run_analyze.analyze_dir(*args[:2], str(tmp_path / "BENCH_base.json"))[
        "baseline_diff"]["regressing_bucket"] == "dispatch"


def test_no_journal_exits_1_like_jax(tmp_path):
    for argv in ([str(tmp_path)], [str(tmp_path), "--serve"]):
        assert _main(run_analyze, argv) == _main(JAX, argv) == (1, "")
    assert run_analyze.analyze_dir(str(tmp_path)) is None
    assert run_analyze.BUCKET_OF == JAX.BUCKET_OF
    assert run_analyze.NAMED_BUCKETS == JAX.NAMED_BUCKETS
    assert run_analyze.MEMBERSHIP_EVENTS == JAX.MEMBERSHIP_EVENTS


def test_port_trainer_journal_read_by_both(tmp_path):
    """A journaled port run with a checkpoint and an eval: both analyzers
    give the same report, its files pass the schema, and the CLI exits 0."""
    cfg = TrainConfig(lion=True, async_grad=True, wire="sign_psum", learning_rate=1e-3,
                      warmup_steps=1, max_steps=4, per_device_train_batch_size=1,
                      gradient_accumulation_steps=2, block_size=32, logging_steps=2,
                      eval_steps=2, eval_iters=1, save_steps=2, journal=True, telemetry=True,
                      output_dir=str(tmp_path / "run"))
    tr = Trainer.for_gpt2(cfg, GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0),
                          device="cpu")
    blocks = synthetic_lm_dataset(32, 32, 256, seed=4)
    try:
        tr.train(batch_iterator(blocks, tr.global_train_batch(), seed=0), eval_blocks=blocks[:4])
    finally:
        tr.close()
    report = assert_same_reports(tmp_path / "run", tmp_path)
    for f in (tmp_path / "run" / "journal").iterdir():
        assert VALIDATE.validate_journal_file(str(f)) == []
    att = report["attribution"]
    assert att["steps"] == 4 and att["closes"] and report["schema_errors"] == 0
    assert att["other_s"] > 0  # the eval spans
    assert _main(run_analyze, [str(tmp_path / "run")])[0] == 0


def test_jax_trainer_journal_read_by_both(jax_pin, tmp_path):  # noqa: F811
    """The journal the JAX trainer wrote (the control-plane pin at
    ``data=4``): the same report from both analyzers, schema-valid."""
    report = assert_same_reports(jax_pin["journal"], tmp_path)
    for f in pathlib.Path(jax_pin["journal"]).iterdir():
        assert VALIDATE.validate_journal_file(str(f)) == []
    assert report["attribution"]["closes"] and len(report["membership"]) == 3
