"""The port's checkpointer (``train/checkpoint.py``, ``train/resilience.py``)
against the JAX package's on-disk contract, on the CPU.

A step the port commits must be accepted by the JAX package's own
``verify_step_dir`` and ``latest_valid_step_in``, and rejected by them once
the port's corruption helpers tear a data file, flip a manifest byte or
drop the commit marker; autodetect then falls back to the newest good step
in both packages. The fault registry drives the retry budget and the
crashes before the manifest and the marker. That an async save returns
before its commit is held by the ``ckpt_slow_commit`` fault and the
commit future's state, not by a wall-clock bound. At W = 2 over gloo an
async save commits on the commit thread with no later save and no
``close()``, and a peer that never saves makes the drain raise within the
commit group's timeout.
"""

import json
import shutil
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from distributed_lion_tpu.train import resilience as j_resilience
from distributed_lion_tpu_torch.train import resilience
from distributed_lion_tpu_torch.train.checkpoint import MANIFESTS_STAMP, Checkpointer


@pytest.fixture(autouse=True)
def _clean_faults():
    resilience.clear_faults()
    yield
    resilience.clear_faults()


def _files(step: int) -> dict:
    return {"params.pt": {"flat": torch.full((64,), float(step)), "names": ["a", "b"],
                          "shapes": [[32], [32]]},
            "exp_avg/rank00000.pt": torch.arange(48, dtype=torch.bfloat16) * step,
            "state.pt": {"step": step, "count": torch.tensor(step, dtype=torch.int32)}}


def test_commit_writes_manifest_marker_and_stamp_the_jax_package_accepts(tmp_path):
    ck = Checkpointer(tmp_path / "ck", async_save=False)
    ck.save(3, _files(3), meta={"world": 2, "tag": "periodic"})
    sdir = tmp_path / "ck" / "3"
    assert (sdir / "manifest.json").exists() and (sdir / "COMMITTED").exists()
    assert (tmp_path / "ck" / MANIFESTS_STAMP).read_bytes() == b"1\n"
    assert resilience.verify_step_dir(sdir) and j_resilience.verify_step_dir(sdir)
    assert ck.latest_valid_step() == 3
    assert j_resilience.latest_valid_step_in(tmp_path / "ck") == 3
    assert resilience.latest_valid_step_in(tmp_path / "ck") == 3
    manifest = j_resilience.read_manifest(sdir)
    assert manifest == resilience.read_manifest(sdir)
    assert manifest["format"] == 1 and manifest["step"] == 3
    assert manifest["meta"] == ck.manifest_meta(3) == {"world": 2, "tag": "periodic"}
    assert sorted(manifest["files"]) == ["exp_avg/rank00000.pt", "params.pt", "state.pt"]
    assert torch.equal(ck.restore(3, "exp_avg/rank00000.pt"),
                       torch.arange(48, dtype=torch.bfloat16) * 3)
    ck.close()


@pytest.mark.parametrize("damage", ["torn", "manifest", "uncommitted"])
def test_corruption_falls_back_to_newest_good_in_both_packages(tmp_path, damage):
    src = tmp_path / "src"
    ck = Checkpointer(src, async_save=False)
    for step in (2, 4):
        ck.save(step, _files(step))
    ck.close()
    dst = tmp_path / damage
    shutil.copytree(src, dst)
    {"torn": resilience.tear_leaf_file, "manifest": resilience.corrupt_manifest,
     "uncommitted": resilience.delete_commit_marker}[damage](dst, 4)
    assert not resilience.verify_step_dir(dst / "4")
    assert not j_resilience.verify_step_dir(dst / "4")
    assert j_resilience.verify_step_dir(dst / "2")
    assert Checkpointer(dst).latest_valid_step() == 2
    assert j_resilience.latest_valid_step_in(dst) == 2
    assert resilience.latest_valid_step_in(dst) == 2


def test_purge_steps_after_removes_every_newer_step(tmp_path):
    ck = Checkpointer(tmp_path / "ck", async_save=False)
    for step in (2, 4, 6):
        ck.save(step, _files(step))
    resilience.tear_leaf_file(tmp_path / "ck", 6)
    assert ck.latest_valid_step() == 4
    assert ck.purge_steps_after(2) == [4, 6]
    assert ck.all_steps() == [2] and ck.latest_step() == 2
    ck.save(3, _files(3))
    assert ck.latest_valid_step() == 3
    assert ck.purge_steps_after(3) == []
    ck.close()


def test_legacy_unstamped_dir_is_grandfathered(tmp_path):
    ck = Checkpointer(tmp_path / "ck", async_save=False, integrity=False)
    ck.save(5, _files(5))
    ck.close()
    assert not (tmp_path / "ck" / MANIFESTS_STAMP).exists()
    ck2 = Checkpointer(tmp_path / "ck", async_save=False, integrity=True)
    assert not (tmp_path / "ck" / MANIFESTS_STAMP).exists()  # not stamped after the fact
    assert ck2.latest_valid_step() == 5
    assert j_resilience.latest_valid_step_in(tmp_path / "ck") == 5
    ck2.close()


def test_save_retries_transient_failures_then_raises(tmp_path):
    resilience.inject_fault("ckpt_save_raise", 2)
    ck = Checkpointer(tmp_path / "ok", async_save=False, max_retries=3, retry_backoff_s=0.001)
    ck.save(1, _files(1))
    assert ck.latest_valid_step() == 1
    assert resilience.fault("ckpt_save_raise") == 0  # both charges spent on retries
    ck.close()
    resilience.inject_fault("ckpt_save_raise", 99)
    ck = Checkpointer(tmp_path / "bad", async_save=False, max_retries=2, retry_backoff_s=0.001)
    with pytest.raises(OSError, match="injected"):
        ck.save(1, _files(1))
    assert resilience.fault("ckpt_save_raise") == 96
    ck.close()


@pytest.mark.parametrize("crash", ["ckpt_crash_before_manifest", "ckpt_crash_before_marker"])
def test_crash_mid_commit_recovers(tmp_path, crash):
    root = tmp_path / "ck"
    ck = Checkpointer(root, async_save=True)
    ck.save(2, _files(2))
    ck.finalize()
    resilience.inject_fault(crash)
    ck.save(4, _files(4))
    ck.close()
    resilience.clear_faults()
    assert (root / "4" / "params.pt").exists()  # the data landed, the commit did not
    assert not (root / "4" / "COMMITTED").exists()
    assert (root / "4" / "manifest.json").exists() == (crash == "ckpt_crash_before_marker")
    assert j_resilience.latest_valid_step_in(root) == 2
    ck2 = Checkpointer(root, async_save=True)
    assert ck2.valid_steps() == [2]
    assert ck2.purge_steps_after(2) == [4]
    ck2.save(4, _files(4))
    ck2.close()
    assert j_resilience.latest_valid_step_in(root) == 4


def test_async_save_returns_before_its_commit(tmp_path):
    """The commit thread is held by ``ckpt_slow_commit``: when ``save``
    returns, its future is still pending and no marker exists; the live
    tensor may change at once without reaching the file."""
    resilience.inject_fault("ckpt_slow_commit", 2.0)
    ck = Checkpointer(tmp_path / "ck", async_save=True)
    live = torch.arange(1024, dtype=torch.float32)
    ck.save(7, {"live.pt": live})
    (_, future), = ck._inflight
    assert not future.done()
    assert not (tmp_path / "ck" / "7" / "COMMITTED").exists()
    live.mul_(-1)  # the next step updates its buffers in place
    ck.close()
    assert future.done() and future.result() == 7
    assert j_resilience.latest_valid_step_in(tmp_path / "ck") == 7
    assert torch.equal(ck.restore(7, "live.pt"), torch.arange(1024, dtype=torch.float32))
    assert ck.total_stall_s > 0


def test_rotation_keeps_save_total_limit_committed_steps(tmp_path):
    ck = Checkpointer(tmp_path / "ck", save_total_limit=2, async_save=True)
    for step in (2, 4, 6, 8):
        ck.save(step, _files(step))
    ck.close()
    assert ck.all_steps() == [6, 8]
    assert j_resilience.latest_valid_step_in(tmp_path / "ck") == 8


def test_bfloat16_and_float32_round_trip_bit_exact(tmp_path):
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    bf16 = bits.view(torch.bfloat16)  # every bfloat16 pattern, NaNs and subnormals included
    f32 = torch.randn(4099).mul_(1e-39)  # float32 subnormals
    ck = Checkpointer(tmp_path / "ck", async_save=True)
    ck.save(1, {"t.pt": {"bf16": bf16, "f32": f32}})
    ck.close()
    back = ck.restore(1, "t.pt")
    assert back["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["bf16"].view(torch.int16), bits)
    assert torch.equal(back["f32"].view(torch.int32), f32.view(torch.int32))


def test_counted_faults_spend_their_charges():
    resilience.inject_fault("ckpt_save_raise", 2)
    assert [resilience.consume_fault_count("ckpt_save_raise") for _ in range(3)] == [
        True, True, False]
    resilience.inject_fault("ckpt_crash_before_marker")
    assert resilience.consume_fault_count("ckpt_crash_before_marker") is True
    assert resilience.fault("missing", 5) == 5


COMMIT_POLL_S = 30.0   # the bounded wait for the commit thread's marker


def _w2_commit_rank(rank, pg, root, out):
    dist.init_process_group("gloo", init_method=f"file://{pg}", rank=rank, world_size=2)
    torch.set_num_threads(1)
    result = {}
    try:
        ck = Checkpointer(f"{root}/a", async_save=True, group=dist.group.WORLD)
        ck.save(2, {f"exp_avg/rank{rank:05d}.pt": torch.full((16,), float(rank))})
        marker = ck.directory / "2" / "COMMITTED"
        deadline = time.monotonic() + COMMIT_POLL_S
        while not marker.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        dist.barrier()  # both ranks looked before either goes on
        result["committed"] = marker.exists()
        result["latest_valid"] = ck.latest_valid_step()
        # a peer that never saves: rank 0's commit waits out the group's
        # timeout and its drain raises
        lone = Checkpointer(f"{root}/b", async_save=True, group=dist.group.WORLD,
                            commit_timeout_s=1.0)
        if rank == 0:
            lone.save(4, {"exp_avg/rank00000.pt": torch.zeros(16)})
            try:
                lone.finalize()
                result["lone"] = "no error"
            except RuntimeError as e:
                result["lone"] = str(e)
        dist.barrier()
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def test_async_save_commits_at_two_ranks_without_a_later_save(tmp_path):
    """W = 2 over gloo: an async ``save(2, ...)`` shows ``2/COMMITTED`` and
    ``latest_valid_step() == 2`` on both ranks with no later save and no
    ``close()`` (the JAX package commits on its committer thread); a save
    whose peer never saves fails loudly, naming its step."""
    root, out = tmp_path / "ck", tmp_path / "out"
    out.mkdir()
    mp.spawn(_w2_commit_rank, args=(str(tmp_path / "pg"), str(root), str(out)), nprocs=2,
             join=True)
    for rank in range(2):
        got = json.loads((out / f"rank{rank}.json").read_text())
        assert got["committed"] and got["latest_valid"] == 2, (rank, got)
    assert j_resilience.latest_valid_step_in(root / "a") == 2
    assert sorted(j_resilience.read_manifest(root / "a" / "2")["files"]) == [
        "exp_avg/rank00000.pt", "exp_avg/rank00001.pt"]
    lone = json.loads((out / "rank0.json").read_text())["lone"]
    assert "step 4" in lone and "failed on the commit thread" in lone
    assert j_resilience.latest_valid_step_in(root / "b") is None
