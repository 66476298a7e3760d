"""Port vs JAX package: Lion math, local Lion, LR schedules, the codec, and
the port's device rule. Same inputs (numpy, seeded) through both; the JAX
functions run eagerly, op by op, as the port does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.ops import codec as jcodec
from distributed_lion_tpu.ops import lion_math as jlm
from distributed_lion_tpu.optim.lion import lion as jlion
from distributed_lion_tpu.train import schedule as jsched
from distributed_lion_tpu_torch.ops import codec as tcodec
from distributed_lion_tpu_torch.ops import lion_math as tlm
from distributed_lion_tpu_torch.optim.lion import FlatParams, lion as tlion
from distributed_lion_tpu_torch.train import schedule as tsched

# tiny shapes: more intra-op threads only add contention with the other
# test workers
torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _bits(x) -> np.ndarray:
    """Float32 bit patterns (bf16 widens exactly), for bit-identity."""
    if isinstance(x, torch.Tensor):
        a = x.detach().to(torch.float32).numpy()
    else:
        a = np.asarray(jnp.asarray(x).astype(jnp.float32))
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lion_math_bit_identical(dtype):
    rng = np.random.default_rng(0)
    n = 5000
    (gj, gt), (mj, mt), (pj, pt) = (_pair(rng.normal(size=n).astype(np.float32), dtype)
                                    for _ in range(3))
    lr_j, lr_t = jnp.float32(3e-3), torch.tensor(3e-3, dtype=torch.float32)
    cases = [
        (jlm.interp(gj, mj, 0.9), tlm.interp(gt, mt, 0.9)),
        (jlm.momentum_update(gj, mj, 0.99), tlm.momentum_update(gt, mt, 0.99)),
        (jlm.decay_params(pj, lr_j, 0.1), tlm.decay_params(pt, lr_t, 0.1)),
        (jlm.sign_vote_bool(gj, mj, 0.9), tlm.sign_vote_bool(gt, mt, 0.9)),
        (jlm.apply_signed_update(pj, gj > 0, lr_j),
         tlm.apply_signed_update(pt, gt > 0, lr_t)),
    ]
    cases += list(zip(jlm.local_lion_leaf(pj, gj, mj, lr_j, 0.1, 0.9, 0.99),
                      tlm.local_lion_leaf(pt, gt, mt, lr_t, 0.1, 0.9, 0.99)))
    for j, t in cases:
        np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_lion_three_steps_bit_identical(dtype):
    """Local Lion (the axis_name=None fallback) over a pytree vs the port's
    flat buffers, 3 steps, each with fresh grads."""
    rng = np.random.default_rng(1)
    shapes = {"b": (130,), "w": (33, 7)}  # jax.tree.leaves order
    p_np = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jdt, tdt = DTYPES[dtype]
    jp = {k: jnp.asarray(v, jdt) for k, v in p_np.items()}
    tparams = [(k, torch.nn.Parameter(torch.from_numpy(np.array(jp[k].astype(jnp.float32))).to(tdt)))
               for k in shapes]
    flat = FlatParams(tparams)
    jopt, topt = jlion(0.02, weight_decay=0.05), tlion(0.02, weight_decay=0.05)
    jstate, tstate = jopt.init(jp), topt.init(flat)
    for _ in range(3):
        g_np = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jg = {k: jnp.asarray(v, jdt) for k, v in g_np.items()}
        jp, jstate = jopt.step(jp, jg, jstate)
        for k, view in flat.views(flat.grads).items():
            view.copy_(torch.from_numpy(np.array(jg[k].astype(jnp.float32))))
        tstate = topt.step(flat, tstate)
    tp, tm = flat.views(flat.params), flat.views(tstate.exp_avg)
    for k in shapes:
        np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]))
        np.testing.assert_array_equal(_bits(tm[k]), _bits(jstate.exp_avg[k]))
    assert int(tstate.count) == int(jstate.count) == 3


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedules_bit_identical_in_warmup_and_linear_parts(kind):
    """Every step of the linear and constant schedules and the warm-up of
    the cosine one are bit-identical; the cosine tail is checked below."""
    build = {"cosine": (jsched.cosine_schedule_with_warmup, tsched.cosine_schedule_with_warmup),
             "linear": (jsched.linear_schedule_with_warmup, tsched.linear_schedule_with_warmup),
             "constant": (lambda *a: jsched.constant_schedule(a[0]),
                          lambda *a: tsched.constant_schedule(a[0]))}[kind]
    js, ts = build[0](3e-4, 7, 40), build[1](3e-4, 7, 40)
    steps = range(7) if kind == "cosine" else range(45)
    for s in steps:
        np.testing.assert_array_equal(
            _bits(ts(torch.tensor(s, dtype=torch.int32))), _bits(js(jnp.int32(s))))


def test_cosine_tail_within_one_ulp():
    """After warm-up the two frameworks' float32 ``cos`` may differ by one
    ulp (different libm polynomials); the rest of the schedule's arithmetic
    is the same, so the LR agrees to a float32 ulp."""
    js, ts = (jsched.cosine_schedule_with_warmup(3e-4, 7, 40),
              tsched.cosine_schedule_with_warmup(3e-4, 7, 40))
    got = np.array([float(ts(torch.tensor(s))) for s in range(7, 45)], np.float32)
    want = np.array([float(js(jnp.int32(s))) for s in range(7, 45)], np.float32)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


WIRES = ["sign_psum", "packed_allgather", "packed_a2a"]


@pytest.mark.parametrize("wire", WIRES)
def test_codec_bounds_and_bytes_equal_jax(wire):
    for n in (1, 7, 8, 9, 1000, 4101, 124_439_808):
        for w in (1, 2, 3, 8, 200):
            assert tcodec.a2a_chunk_bytes(n, w) == jcodec.a2a_chunk_bytes(n, w)
            assert tcodec.bucket_alignment(w, wire) == jcodec.bucket_alignment(w, wire)
            for b in (1, 3, 4):
                assert tcodec.bucket_bounds(n, b, w, wire) == jcodec.bucket_bounds(n, b, w, wire)
                for ve in (1, 4):
                    assert (tcodec.wire_bytes_per_param(n, w, wire, vote_every=ve,
                                                        accum_steps=8, vote_buckets=b)
                            == jcodec.wire_bytes_per_param(n, w, wire, vote_every=ve,
                                                           accum_steps=8, vote_buckets=b))


@pytest.mark.parametrize("n", [1, 8, 13, 1000, 4101])
def test_pack_signs_bytes_equal_jax(n):
    pos = np.random.default_rng(n).random(n) > 0.5
    packed = tcodec.pack_signs(torch.from_numpy(pos))
    assert packed.dtype == torch.uint8 and packed.numel() == tcodec.packed_size(n)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jcodec.pack_signs(jnp.asarray(pos))))
    np.testing.assert_array_equal(tcodec.unpack_signs(packed, (n,)).numpy(), pos)


def test_hier_wire_refused():
    """``hier:<g>`` parses as in the JAX package; bad specs are refused by both."""
    for wire in ("hier:1", "hier:2", "hier:8", "sign_psum"):
        assert tcodec.parse_wire(wire) == jcodec.parse_wire(wire)
    for bad in ("hier:0", "hier:two", "carrier_pigeon"):
        for parse in (tcodec.parse_wire, jcodec.parse_wire):
            with pytest.raises(ValueError):
                parse(bad)


def test_entry_points_refuse_without_cuda(monkeypatch):
    """With no CUDA and no request for the CPU, every entry point raises
    instead of running quietly on the CPU."""
    from distributed_lion_tpu_torch.cli import run_clm
    from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from distributed_lion_tpu_torch.parallel.mesh import platform_device
    from distributed_lion_tpu_torch.train.loop import TrainConfig, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DLION_PLATFORM", raising=False)
    for call in (lambda: GPT2(GPT2Config.tiny()),
                 lambda: Trainer.for_gpt2(TrainConfig(), GPT2Config.tiny()),
                 platform_device,
                 lambda: run_clm.main(["--model_name", "tiny", "--max_steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    monkeypatch.setenv("DLION_PLATFORM", "cpu8")
    with pytest.raises(ValueError, match="cpu8"):
        platform_device()
