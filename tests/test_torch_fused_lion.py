"""The fused Lion kernels' plain versions vs the JAX package's Pallas
kernels (``pallas_lion.*``, interpret mode on the CPU), and the wrappers'
routing. The Triton and CUDA kernels themselves run only on the card:
chip_smoke.py holds them ``torch.equal`` to these plain versions there.

Tolerance: ballots exact; params and momentum ``rtol=1e-6, atol=0``. The
cause of the 1-ulp float32 differences: XLA:CPU compiles the interpreted
Pallas body with FMA contraction (``p*(1-lr*wd) - lr*s`` and
``m*b2 + g*(1-b2)`` each become one fused multiply-add), while the port
rounds after every multiply and add, as the Pallas source reads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.ops import pallas_lion
from distributed_lion_tpu_torch.ops import cuda_build, fused_lion

# tiny shapes: more intra-op threads only add contention with the other
# test workers
torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for _ in range(3):
        j = jnp.asarray(rng.normal(size=n).astype(np.float32), jdt)
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)))
    tot = rng.integers(-4, 5, size=n).astype(np.int32)
    return out, tot


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("n", [1, 1000, 4101])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ballots_plain_equals_pallas(n, dtype):
    ((gj, gt), (mj, mt), _), _ = _inputs(n, dtype, n)
    want = np.asarray(pallas_lion.fused_ballots(gj, mj, 0.9, interpret=True))
    got = fused_lion.fused_ballots(gt, mt, 0.9)  # CPU tensors → plain version
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def assert_close_but_fma(got, want, addend, dtype):
    """``rtol=1e-6, atol=0``, except where one FMA rounding explains the gap:
    within one float32 ulp of the larger addend (when the two addends
    cancel, that ulp is large against the result) and, for a bfloat16
    result, the one bfloat16 ulp a float32 ulp can tip it over; on at most
    0.1% of the coordinates."""
    d = np.abs(got - want)
    bad = d > 1e-6 * np.abs(want)
    slack = np.spacing(np.abs(addend).astype(np.float32))
    if dtype == "bfloat16":
        slack = np.maximum(slack, np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16)
    assert np.all(d[bad] <= slack[bad]), (d[bad], slack[bad])
    assert bad.mean() <= 1e-3, f"{bad.sum()} of {bad.size} coordinates differ"


@pytest.mark.parametrize("n", [1, 1000, 4101])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_plain_matches_pallas(n, dtype):
    """Against the Pallas kernel's int32 tally, with the port's int8 and
    int32 tallies."""
    ((gj, gt), (mj, mt), (pj, pt)), tot = _inputs(n, dtype, n + 1)
    p0, g0, m0 = _f32(pt), _f32(gt), _f32(mt)
    lr = np.float32(3e-3)
    pw, mw = pallas_lion.fused_apply(pj, gj, mj, jnp.asarray(tot), lr, 0.1, 0.99,
                                     interpret=True)
    for tally in (torch.int8, torch.int32):
        p, m = pt.clone(), mt.clone()
        p_out, m_out = fused_lion.fused_apply(p, gt, m, torch.from_numpy(tot).to(tally),
                                              torch.tensor(lr), 0.1, 0.99)
        assert p_out is p and m_out is m  # in place
        assert_close_but_fma(_f32(p), _f32(pw), np.maximum(np.abs(p0), lr), dtype)
        assert_close_but_fma(_f32(m), _f32(mw),
                             np.maximum(np.abs(m0 * 0.99), np.abs(g0 * 0.01)), dtype)


def test_ballots_zero_votes_minus_one():
    z = torch.zeros(8)
    np.testing.assert_array_equal(fused_lion.fused_ballots(z, z, 0.9).numpy(), -1)


def test_apply_tie_elects_minus_one():
    n = 16
    p, g, m = torch.ones(n), torch.zeros(n), torch.zeros(n)
    tot = torch.tensor([0, 1, -1, 2] * 4, dtype=torch.int8)
    fused_lion.fused_apply(p, g, m, tot, torch.tensor(0.5), 0.0, 0.9)
    np.testing.assert_array_equal(p.numpy(), np.where(tot.numpy() > 0, 0.5, 1.5))


def test_cpu_path_counts_no_launches():
    wrappers = (fused_lion.fused_ballots, fused_lion.fused_apply, fused_lion.bucket_vote_stats)
    before = [fn.launches for fn in wrappers]
    x = torch.randn(100)
    ballots = fused_lion.fused_ballots(x, x, 0.9)
    fused_lion.fused_apply(x.clone(), x, x.clone(), ballots, torch.tensor(1e-3), 0.1, 0.99)
    hist, dis = fused_lion.bucket_vote_stats(ballots, ballots, 1, 8)
    assert hist.tolist() == [0] * 7 + [100] and int(dis) == 0
    assert [fn.launches for fn in wrappers] == before
    assert fused_lion.triton is None  # no kernel was built here
    assert fused_lion._STATS_LIB is None and "vote_stats" not in cuda_build._LIBS


def test_wrappers_refuse_what_no_kernel_takes():
    x = torch.randn(64)
    lr = torch.tensor(1e-3)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_lion.fused_ballots(x.to("meta"), x.to("meta"), 0.9)
    with pytest.raises(ValueError, match="share"):
        fused_lion.fused_ballots(x, x.double(), 0.9)
    with pytest.raises(ValueError, match="contiguous"):
        fused_lion.fused_ballots(x[::2], x[::2], 0.9)
    with pytest.raises(ValueError, match="tally"):
        fused_lion.fused_apply(x, x, x, x, lr, 0.1, 0.99)
    with pytest.raises(ValueError, match="lr"):
        fused_lion.fused_apply(x, x, x, torch.ones(64, dtype=torch.int8),
                               lr.double(), 0.1, 0.99)
    votes = torch.ones(64, dtype=torch.int8)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_lion.bucket_vote_stats(votes.to("meta"), votes.to("meta"), 4, 8)
    with pytest.raises(ValueError, match="tally"):
        fused_lion.bucket_vote_stats(votes, votes.to(torch.int16), 4, 8)
    with pytest.raises(ValueError, match="tally"):
        fused_lion.bucket_vote_stats(x, votes, 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fused_lion.bucket_vote_stats(votes[::2], votes[::2], 4, 8)
    with pytest.raises(ValueError, match="must be >= 1"):
        fused_lion.bucket_vote_stats(votes, votes, 0, 8)
