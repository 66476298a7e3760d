"""The port's causal flash attention vs the JAX package, on the CPU.

On CPU tensors the port's ``flash`` runs the plain PyTorch versions of its
four kernels through the same ``torch.autograd.Function`` the card uses
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
def test_flash_hd128_matches_jax_splash_and_xla(dtype):
    """head_dim 128 (Llama), at T 128 and a ragged T 100: the
    plain versions the hd128 kernels are held to, against the Pallas splash
    kernel in interpret mode (no head_dim padding at 128) and
    ``attention_xla``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    arrays = _inputs(128, B=1, H=2, D=128, seed=3)
    got = _port(arrays, dtype)
    _assert_close(got, _jax(lambda q, k, v: j_splash(q, k, v, interpret=True), arrays, jdt),
                  dtype)
    _assert_close(got, _jax(j_xla, arrays, jdt), dtype)
    ragged = _inputs(100, B=1, H=2, D=128, seed=4)
    _assert_close(_port(ragged, dtype), _jax(j_xla, ragged, jdt), dtype)


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
    ("cuda", 2048, 128, torch.bfloat16, "flash"),    # hd 128 (Llama) at T >= 2048: the kernels
    ("cuda", 4096, 128, torch.bfloat16, "flash"),
    ("cuda", 512, 128, torch.bfloat16, "xla"),
    ("cuda", 2048, 128, torch.float32, "xla"),
    ("cuda", 2048, 96, torch.bfloat16, "xla"),       # no kernel at another head_dim
    ("cpu", 2048, 128, torch.bfloat16, "xla"),
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
    """Without nvcc the build raises (no fallback), for the flash and the
    stats library alike; an edited source gets another library name, and
    the two sources name different libraries."""
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
    # the port's two libraries: each its own name, and neither builds without nvcc
    libs = {name: cuda_build.library_path(cuda_build.CSRC / f"{name}.cu")
            for name in ("flash_attention", "vote_stats")}
    assert libs["flash_attention"] != libs["vote_stats"]
    assert all(path.name.startswith(f"{name}-") for name, path in libs.items())
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    for name in libs:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.load(name)
    assert not (tmp_path / "build").exists()


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

SERIALIZED = ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions "
              "are serialized due to non wgmma instructions defining accumulator registers of a "
              "wgmma between start and end of the pipeline stage in the function '_Z3barPf'\n"
              "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions "
              "are serialized due to insufficient register resources for the function '_Z3bazPf'\n")
PTXAS = SERIALIZED + """
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Function properties for _Z3barPf
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
"""


def test_sass_and_spill_reports_are_read_per_kernel():
    """What ``chip_smoke.py`` checks in the built library: opcode lines per
    kernel from ``cuobjdump -sass``, and spill bytes and serialized wgmma per
    kernel from the ``-Xptxas -v`` report."""
    counts = cuda_build.count_sass(SASS, ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                          "flash_bwd_dkv_kernel"), ("HGMMA", "UTMALDG", "HMMA"))
    assert counts == {"flash_fwd_kernel": {"HGMMA": 2, "UTMALDG": 2, "HMMA": 0},
                      "flash_bwd_dq_kernel": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 1},
                      "flash_bwd_dkv_kernel": {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}}
    assert cuda_build.ptxas_spills(PTXAS) == {"_Z3fooPf": (0, 0), "_Z3barPf": (12, 4)}
    assert cuda_build.ptxas_serialized(PTXAS) == {
        "_Z3barPf": "non wgmma instructions defining accumulator registers of a wgmma between "
                    "start and end of the pipeline stage",
        "_Z3bazPf": "insufficient register resources"}


SASS_REGS = """
                Function : _ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi128EEEv14CUtensorMap_st
        /*0500*/                   USETMAXREG.TRY_ALLOC.CTAPOOL UP0, 0xf0 ;
        /*0600*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR16].tnspB, R24, gsb0 ;
        /*0610*/                   HGMMA.64x64x16.F32.BF16 R200, gdesc[UR8], RZ, !UPT, gsb0 ;
        /*0620*/                   FMUL R218, R3, R2 ;
        /*0700*/                   USETMAXREG.DEALLOC.CTAPOOL 0x18 ;
                Function : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128EEEv14CUtensorMap_st
        /*0100*/                   IMAD R7, R1, R2, RZ ;
"""


def test_sass_registers_count_accumulator_ranges_and_setmaxnreg():
    """The registers ``chip_smoke.py`` prints for a kernel: the highest one
    its code names, a wgmma's accumulator counted over its whole range (64
    x 64: 32 registers from the one named), and the register counts its
    ``setmaxnreg`` instructions hand out."""
    regs = cuda_build.sass_registers(SASS_REGS, ("flash_bwd_dkv_kernelILi128E",
                                                 "flash_bwd_dq_kernelILi128E"))
    assert regs == {"flash_bwd_dkv_kernelILi128E": (232, [240, 24]),
                    "flash_bwd_dq_kernelILi128E": (8, [])}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_di_is_the_float32_sum_of_float32_products(dtype):
    """``di`` takes ``do`` as the model hands it (a transposed view) and
    promotes it inside the product: the same bits as summing the product of
    two float32 copies, and its inputs untouched."""
    o_np, do_np = _inputs(40, seed=5)[:2]
    o = torch.from_numpy(o_np).to(dtype)
    do = torch.from_numpy(np.ascontiguousarray(do_np.transpose(0, 2, 1, 3))).to(dtype)
    do = do.transpose(1, 2)
    o0, do0 = o.clone(), do.clone()
    di = fa.attention_di(o, do)
    assert di.dtype == torch.float32 and di.shape == o.shape[:3]
    assert torch.equal(di, (o.to(torch.float32) * do.to(torch.float32)).sum(-1))
    assert torch.equal(o, o0) and torch.equal(do, do0)


@pytest.mark.parametrize("layout", ["contiguous", "gpt2_view"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_di_matches_plain_and_jax(D, layout):
    """The di wrapper on CPU tensors is the plain ``attention_di``, bit for
    bit, and agrees with JAX's ``jnp.sum(o.astype(f32) * do.astype(f32), -1)``
    (jax ``flash_attention.py:273``) row by row within the bound of a
    float32 sum of D exact products in another order, ``D 2**-24 sum|o do|``;
    ``do`` contiguous or as GPT-2 hands it back (a transposed view of
    [B, T, H, D])."""
    rng = np.random.default_rng(11 + D)
    B, H, T = 2, 3, 40
    o_np = rng.normal(size=(B, H, T, D)).astype(np.float32)
    do_np = rng.normal(size=(B, T, H, D)).astype(np.float32)
    o = torch.from_numpy(o_np).bfloat16()
    do = torch.from_numpy(do_np).bfloat16().transpose(1, 2)
    if layout == "contiguous":
        do = do.contiguous()
    assert do.is_contiguous() == (layout == "contiguous") and fa.strided_ok(do)
    di = fa.flash_attention_di(o, do)
    assert di.dtype == torch.float32 and di.shape == (B, H, T) and di.is_contiguous()
    assert torch.equal(di, fa.attention_di(o, do))
    o32, do32 = o.float().numpy(), do.float().numpy()
    o_j, do_j = (jnp.asarray(x).astype(jnp.bfloat16) for x in (o32, do32))   # exact
    want = np.asarray(jnp.sum(o_j.astype(jnp.float32) * do_j.astype(jnp.float32), -1),
                      np.float64)
    bound = D * 2.0 ** -24 * np.abs(o32.astype(np.float64) * do32).sum(-1)
    assert (np.abs(di.numpy().astype(np.float64) - want) <= bound).all()


def test_flash_backward_computes_di_through_the_di_wrapper(monkeypatch):
    """``FlashAttention.backward`` takes ``di`` from ``flash_attention_di``
    (the wrapper that launches the kernel on the card), once per backward,
    on the forward's ``o`` and the incoming ``do``, and not from the plain
    ``attention_di`` directly; the wrapper refuses a device with no kernel
    rather than computing a plain version there."""
    calls = []
    wrapped = fa.flash_attention_di

    def spy(o, do):
        calls.append((o, do))
        return wrapped(o, do)

    monkeypatch.setattr(fa, "flash_attention_di", spy)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(48, D=128, seed=6))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(qg, kg, vg)
    out.backward(do)
    assert len(calls) == 1
    o, got_do = calls[0]
    assert torch.equal(o, out.detach()) and torch.equal(got_do, do)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, *fa.flash_attention_fwd(q, k, v), do)
    assert all(torch.equal(g, w) for g, w in ((qg.grad, dq), (kg.grad, dk), (vg.grad, dv)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wrapped(o.to("meta"), do.to("meta"))
    with pytest.raises(ValueError, match="operands"):
        wrapped(o[..., :64], do)


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


def test_cpu_path_counts_no_launch_at_either_head_dim():
    """On CPU tensors the wrappers run their plain versions at head_dim 64
    and 128: no count moves (the di wrapper's included) and no library is
    built."""
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq,
                fa.flash_attention_di)
    before = [dict(fn.by_head_dim) for fn in wrappers]
    assert all(set(b) == {64, 128} for b in before)
    for D in (64, 128):
        q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(20, B=1, H=1, D=D))
        o, lse = fa.flash_attention_fwd(q, k, v)
        di = fa.flash_attention_di(o, do)
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, di)
        fa.flash_attention_bwd_dq(q, k, v, do, lse, di)
        q.requires_grad_()
        fa.flash_attention(q, k, v).backward(do)
    after = [dict(fn.by_head_dim) for fn in wrappers]
    assert after == before
    assert fa._LIB is None and "flash_attention" not in cuda_build._LIBS
