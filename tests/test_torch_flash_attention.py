"""The port's causal flash attention vs the JAX package, on the CPU.

On CPU tensors the port's ``flash`` runs the plain PyTorch versions of its
three kernels through the same ``torch.autograd.Function`` the card uses
(forward, then ``di`` and the dK/dV and dQ passes). The JAX package's flash
kernel cannot run on the CPU (jax's ``flash_attention`` has no interpret
mode), so the references are ``attention_splash(..., interpret=True)``, a
Pallas kernel in interpret mode, and ``attention_xla``.

Tolerances: float32 ``atol = rtol = 1e-5`` (the frameworks sum in other
orders). bfloat16: both sides round the probabilities to bfloat16 before
the value product and the outputs to bfloat16, at other points of their
sums, so outputs and grads are held to two bfloat16 ulps of each tensor's
largest magnitude (2**-7 relative to it); ``lse`` is float32 on both sides
and held to 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_lion_tpu.models.gpt2 import GPT2Config as JConfig
from distributed_lion_tpu.models.gpt2 import gpt2_apply as j_apply
from distributed_lion_tpu.models.gpt2 import gpt2_init as j_init
from distributed_lion_tpu.models.loss import clm_loss_and_metrics as j_loss
from distributed_lion_tpu.ops.attention import attention_splash as j_splash
from distributed_lion_tpu.ops.attention import attention_xla as j_xla
from distributed_lion_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_lion_tpu_torch.models.loss import clm_loss_and_metrics
from distributed_lion_tpu_torch.ops import cuda_build
from distributed_lion_tpu_torch.ops import flash_attention as fa
from distributed_lion_tpu_torch.ops.attention import attention, resolve_impl
from distributed_lion_tpu_torch.utils.serialization import params_from_jax

torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)


def _inputs(T, B=2, H=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, T, D)).astype(np.float32) for _ in range(4)]


def _jax_lse(q, k):
    T = q.shape[2]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s / math.sqrt(q.shape[-1]), -1e30)
    return jax.scipy.special.logsumexp(s, axis=-1)


def _jax(fn, arrays, dtype):
    q, k, v, do = (jnp.asarray(a, dtype) for a in arrays)
    out, vjp = jax.vjp(fn, q, k, v)
    grads = vjp(do)
    return [np.asarray(x, np.float32) for x in (out, _jax_lse(q, k), *grads)]


def _port(arrays, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays[:3])
    do = torch.from_numpy(arrays[3]).to(dtype)
    out = attention(q, k, v, impl="flash")
    out.backward(do)
    _, lse = fa.flash_attention_fwd(q.detach(), k.detach(), v.detach())
    assert out.dtype == dtype and lse.dtype == torch.float32
    return [t.detach().float().numpy() for t in (out, lse, q.grad, k.grad, v.grad)]


def _assert_close(got, want, dtype):
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        if dtype == torch.float32 or name == "lse":
            np.testing.assert_allclose(g, w, err_msg=name, **F32)
        else:
            np.testing.assert_allclose(g, w, atol=2.0 ** -7 * np.abs(w).max(), rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_flash_matches_jax_splash_and_xla(dtype):
    """T 128, head_dim 64: forward, lse and grads against the Pallas splash
    kernel in interpret mode (one call per dtype) and ``attention_xla``."""
    arrays = _inputs(128)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = _port(arrays, dtype)
    _assert_close(got, _jax(lambda q, k, v: j_splash(q, k, v, interpret=True), arrays, jdt),
                  dtype)
    _assert_close(got, _jax(j_xla, arrays, jdt), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_flash_ragged_T_matches_jax_xla(dtype):
    """A T that is not a multiple of the kernels' 64-row tile."""
    arrays = _inputs(100, B=1, H=3, seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _assert_close(_port(arrays, dtype), _jax(j_xla, arrays, jdt), dtype)


def test_backward_pieces_compose_to_the_plain_backward():
    """The autograd function's backward (``di`` then the dK/dV and dQ
    wrappers) equals ``flash_attention_bwd_plain`` on the same inputs."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(96, seed=2))
    o, lse = fa.flash_attention_fwd(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention(qg, kg, vg).backward(do)
    for got, want in ((qg.grad, dq), (kg.grad, dk), (vg.grad, dv)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("device,T,hd,dtype,want", [
    ("cuda", 1024, 64, torch.bfloat16, "flash"),     # GPT-2 124M, the JAX table's tuned cell
    ("cuda", 2048, 64, torch.bfloat16, "flash"),     # T >= 2048: flash's memory regime
    ("cuda", 4096, 64, torch.bfloat16, "flash"),
    ("cuda", 512, 64, torch.bfloat16, "xla"),
    ("cuda", 1000, 64, torch.bfloat16, "xla"),
    ("cuda", 1024, 128, torch.bfloat16, "xla"),      # the JAX table keeps hd 128 at T 1024 on xla
    ("cuda", 2048, 128, torch.bfloat16, "xla"),      # no hd-128 kernel yet
    ("cuda", 1024, 64, torch.float32, "xla"),        # the kernels are bfloat16-only
    ("cpu", 1024, 64, torch.bfloat16, "xla"),        # off the card, as JAX off the TPU
    ("cpu", 4096, 64, torch.bfloat16, "xla"),
])
def test_auto_resolution_table(device, T, hd, dtype, want):
    assert resolve_impl("auto", device, T, hd, dtype) == want


def test_explicit_impls_resolve_or_raise():
    for impl in ("xla", "flash", "splash"):
        assert resolve_impl(impl, "cpu", 128, 64, torch.float32) == impl
        assert resolve_impl(impl, "cuda", 128, 64, torch.bfloat16) == impl
    for impl in ("flash", "splash"):
        with pytest.raises(NotImplementedError, match="Queue 2 item 4"):
            resolve_impl(impl, "cuda", 1024, 64, torch.float32)
    with pytest.raises(ValueError, match="unknown attention impl"):
        resolve_impl("xla_bf16", "cpu", 128, 64, torch.float32)
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="causal only"):
        attention(q, q, q, causal=False, impl="flash")


def test_model_qkv_views_are_the_kernels_layout():
    """The model's q/k/v (transposed views of the qkv projection) meet the
    kernels' stride rule as they are, so no copy is made; a transposed
    head_dim does not."""
    B, T, H, D = 2, 40, 12, 64
    qkv = torch.zeros(B, T, 3, H * D, dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].reshape(B, T, H, D).transpose(1, 2) for i in range(3))
    assert all(fa.strided_ok(t) and not t.is_contiguous() for t in (q, k, v))
    assert not fa.strided_ok(q.transpose(-1, -2))
    # TMA's rules: byte strides positive multiples of 16, a 16-byte aligned base
    assert fa.strided_ok(torch.zeros(B, 12, T, D, dtype=torch.bfloat16))
    padded = torch.zeros(B, 12, T, D + 1, dtype=torch.bfloat16)[..., :D]
    assert padded.stride(2) * 2 % 16 == 2 and not fa.strided_ok(padded)
    shifted = torch.zeros(B * 12 * T * D + 1, dtype=torch.bfloat16)[1:].view(B, 12, T, D)
    assert shifted.data_ptr() % 16 == 2 and not fa.strided_ok(shifted)
    assert not fa.strided_ok(torch.zeros(1, 12, T, D, dtype=torch.bfloat16).expand(B, -1, -1, -1))


def test_no_nvcc_raises_and_sources_key_the_build(tmp_path, monkeypatch):
    """Without nvcc the build raises (no fallback); an edited source gets
    another library name."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = cuda_build.library_path(src)
    src.write_text("// two\n")
    assert cuda_build.library_path(src) != first
    assert first.parent == cuda_build.BUILD_DIR


def test_headers_key_the_build(tmp_path):
    """A header beside the source (``*.cuh``, ``*.h``) is part of the
    library's key: editing only the header, or adding one, names another
    library; an unchanged tree names the same one."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src, header = csrc / "k.cu", csrc / "blocks.cuh"
    src.write_text('#include "blocks.cuh"\n')
    header.write_text("// one\n")
    first = cuda_build.library_path(src)
    assert cuda_build.library_path(src) == first
    header.write_text("// two\n")
    second = cuda_build.library_path(src)
    assert second != first and second.name.startswith("k-")
    (csrc / "more.h").write_text("// three\n")
    assert cuda_build.library_path(src) not in (first, second)


SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_116flash_fwd_kernelILi64EEEv14CUtensorMap_st
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.4D [UR16], [UR12] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0210*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;
                Function : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64EEEvPK13__nv_bfloat16
        /*0300*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""

PTXAS = """
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Function properties for _Z3barPf
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
"""


def test_sass_and_spill_reports_are_read_per_kernel():
    """What ``chip_smoke.py`` checks in the built library: opcode lines per
    kernel from ``cuobjdump -sass`` and spill bytes per kernel from the
    ``-Xptxas -v`` report."""
    counts = cuda_build.count_sass(SASS, ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                          "flash_bwd_dkv_kernel"), ("HGMMA", "UTMALDG", "HMMA"))
    assert counts == {"flash_fwd_kernel": {"HGMMA": 2, "UTMALDG": 2, "HMMA": 0},
                      "flash_bwd_dq_kernel": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 1},
                      "flash_bwd_dkv_kernel": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}}
    assert cuda_build.ptxas_spills(PTXAS) == {"_Z3fooPf": (0, 0), "_Z3barPf": (12, 4)}


def test_gpt2_dropout0_flash_matches_jax_logits_and_grads():
    """A tiny GPT-2 at dropout 0 with ``attn_impl="flash"`` (remat on)
    against the JAX package's ``gpt2`` on carried-over weights, float32."""
    jcfg = JConfig.tiny(compute_dtype=jnp.float32, dropout=0.0)
    jparams = jax.tree.map(np.asarray, j_init(jax.random.key(0), jcfg))
    model = GPT2(GPT2Config.tiny(compute_dtype=torch.float32, dropout=0.0, attn_impl="flash"),
                 device="cpu")
    model.load_state_dict(params_from_jax(jparams))
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 100)).astype(np.int32)

    def loss_fn(p):
        return j_loss(j_apply(p, jnp.asarray(tokens), jcfg), jnp.asarray(tokens))[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    want_logits = jax.jit(lambda p: j_apply(p, jnp.asarray(tokens), jcfg))(jparams)
    logits = model(torch.from_numpy(tokens), dropout_seed=7)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=1e-4)
    loss, _ = clm_loss_and_metrics(logits, torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5, rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name,
                                   atol=1e-5, rtol=1e-4)
