"""Llama-class decoder: port of ``distributed_lion_tpu/models/llama.py``.

RMSNorm, rotary position embeddings (the interleaved form, pairing even and
odd columns), a SwiGLU MLP, grouped-query attention, no biases and an
untied head. The weights are a nested dict and list tree with the JAX
package's paths and layouts (``blocks/0/attn/wq`` is ``[d, n_head·hd]``),
so they carry over one to one (``utils.serialization.llama_params_from_jax``
and ``llama_params_to_jax``). The tree is frozen for LoRA (its leaves plain
tensors) or trainable (:func:`as_parameters`: every leaf an
``nn.Parameter``, which :meth:`Llama.jax_named_parameters` lists in the
JAX package's leaf order, the flat buffers' layout).
Any weight leaf may be a :class:`~distributed_lion_tpu_torch.ops.quant.QuantizedTensor`
(the QLoRA base) or a :class:`~distributed_lion_tpu_torch.models.lora.LoraTensor`;
every projection goes through ``models.lora.lora_matmul``.

Rounding follows the JAX package: float32 RMSNorm, float32 rope tables cast
to the compute dtype before the rotation, compute-dtype products, and the
head's logits a compute-dtype product with a float32 result
(``ops.products.matmul_f32``). Each block is rematerialized in the backward
pass when ``remat`` is on (``torch.utils.checkpoint``).

Under a tensor axis (``tp``, JAX llama.py:175-220) the tree holds this
rank's slices (``parallel.tensor_parallel.llama_shard_dim``; :func:`llama_init`
cuts them from the unsplit init, quantized leaves included): ``wq``, ``wk``
and ``wv`` column-parallel with ``n_head/tp`` query and ``n_kv_head/tp`` kv
heads (GQA repeats the local kv heads), ``wo`` row-parallel; ``w_gate`` and
``w_up`` column-parallel, ``w_down`` row-parallel; each region entered
through *f* and left through *g*. With ``vocab_parallel`` the ``lm_head`` is
split by vocab columns and the loss runs over the rank's columns
(``ops.xent.tp_vocab_clm_loss_and_metrics``). Under a seq axis (``seq``,
JAX llama.py:174-205, 403-415) the tokens are this rank's chunk: the rope
angles start at position ``s·T``, the GQA repeat runs before the ring, and
attention is ``cfg.seq_impl``'s (``parallel.ring_attention``).
``remat_policy`` (``full`` | ``dots``) is GPT-2's (``models.gpt2.remat``).

**Decoding** (JAX llama.py:237-318): :func:`llama_decode` runs the next S
tokens against a static per-layer KV cache of the kv heads,
un-repeated (:func:`llama_init_cache`, ``[B, n_kv_head, max_len, hd]``), the
GQA repeat at attend time, the rope angles of a ``max_len`` table taken at
the slots' positions or, with ``offset``, at each row's shifted positions;
materialized scores as :func:`models.gpt2.gpt2_decode`. The paged cache
waits for ROADMAP Queue 1 item 12(b).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_lion_tpu_torch.models.gpt2 import (
    check_remat_policy,
    decode_mask,
    fold_seed,
    jax_leaf_order,
    remat,
)
from distributed_lion_tpu_torch.models.lora import iter_paths, lora_embed, lora_matmul
from distributed_lion_tpu_torch.ops.attention import attention
from distributed_lion_tpu_torch.ops.products import matmul_f32
from distributed_lion_tpu_torch.ops.quant import (
    map_tree,
    maybe_dequant,
    quantize_leaf,
    validate_quant_tp,
)
from distributed_lion_tpu_torch.parallel.mesh import SeqAxis, TensorAxis, resolve_device
from distributed_lion_tpu_torch.parallel.ring_attention import seq_attention
from distributed_lion_tpu_torch.parallel.tensor_parallel import (
    copy_to_tp_region,
    llama_shard_dim,
    reduce_from_tp_region,
    shard,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32          # < n_head: grouped-query attention
    d_model: int = 4096
    d_ff: int = 11008
    n_ctx: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    attn_impl: str = "auto"      # ops.attention: auto | xla | flash | splash
    seq_impl: str = "ring"       # under a seq axis: ring | ulysses
    remat: bool = True           # recompute each block in backward
    remat_policy: str = "full"   # what a remat block keeps: full | dots
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        check_remat_policy(self.remat_policy)

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        return LlamaConfig(**(dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2,
                                   d_model=64, d_ff=128, n_ctx=128) | kw))

    @staticmethod
    def small(**kw) -> "LlamaConfig":
        """About 25M params at a byte-level vocabulary."""
        return LlamaConfig(**(dict(vocab_size=256, n_layer=8, n_head=8, n_kv_head=4,
                                   d_model=512, d_ff=1376, n_ctx=1024) | kw))

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(**(dict(vocab_size=128256, n_layer=32, n_head=32, n_kv_head=8,
                                   d_model=4096, d_ff=14336, n_ctx=8192,
                                   rope_theta=500000.0) | kw))

    @classmethod
    def named(cls, name: str, **kw) -> "LlamaConfig":
        ctors = {"tiny": cls.tiny, "small": cls.small,
                 "llama2_7b": cls.llama2_7b, "llama3_8b": cls.llama3_8b}
        if name not in ctors:
            raise ValueError(f"unknown llama model_name {name!r}; pick one of {sorted(ctors)}")
        return ctors[name](**kw)


def llama_init(cfg: LlamaConfig, *, seed: int = 0, device="cuda", quant: Optional[str] = None,
               quant_block: Optional[int] = None, tp: Optional[TensorAxis] = None,
               vocab_parallel: bool = False, layers: Optional[range] = None) -> dict:
    """Random weights (std 0.02, the residual projections 0.02/sqrt(2L);
    norm scales 1) in the JAX package's tree, made leaf by leaf on
    ``device`` from ``seed``. With ``quant`` ('nf4' or 'int8') each leaf is
    quantized as it is made (``ops.quant.quantize_leaf``, the leaves
    ``quantize_tree`` would pick), so the dense tree never exists whole.
    With ``tp`` (size > 1) each leaf is then cut to this rank's slice
    (``llama_shard_dim``): the slices of the unsplit init. With ``layers``
    the tree's ``blocks`` hold only those layers (a pipeline stage's), the
    same leaves as the whole init's."""
    device = resolve_device(device)
    tp = tp or TensorAxis()
    d, dt, hd = cfg.d_model, cfg.param_dtype, cfg.head_dim
    counter = iter(range(2 + 7 * cfg.n_layer))

    def normal(name, shape, std):
        gen = torch.Generator(device=device).manual_seed(fold_seed(seed, next(counter)))
        w = (torch.randn(shape, generator=gen, device=device) * std).to(dt)
        w = w if quant is None else quantize_leaf(w, quant, block=quant_block)
        if tp.size == 1:
            return w
        dim = llama_shard_dim(name, vocab_parallel)
        validate_quant_tp({name: w}, lambda _: dim, tp.size)
        return shard(w, dim, tp.size, tp.rank)

    def ones():
        return torch.ones(d, dtype=dt, device=device)

    resid = 0.02 / math.sqrt(2 * cfg.n_layer)
    params: dict = {"wte": normal("wte", (cfg.vocab_size, d), 0.02),
                    "lm_head": normal("lm_head", (d, cfg.vocab_size), 0.02),
                    "ln_f": {"scale": ones()}, "blocks": []}
    for i in range(cfg.n_layer):
        if layers is not None and i not in layers:
            for _ in range(7):   # the leaves another stage draws
                next(counter)
            continue
        b = f"blocks.{i}."
        params["blocks"].append({
            "ln_attn": {"scale": ones()},
            "attn": {"wq": normal(b + "attn.wq", (d, cfg.n_head * hd), 0.02),
                     "wk": normal(b + "attn.wk", (d, cfg.n_kv_head * hd), 0.02),
                     "wv": normal(b + "attn.wv", (d, cfg.n_kv_head * hd), 0.02),
                     "wo": normal(b + "attn.wo", (cfg.n_head * hd, d), resid)},
            "ln_mlp": {"scale": ones()},
            "mlp": {"w_gate": normal(b + "mlp.w_gate", (d, cfg.d_ff), 0.02),
                    "w_up": normal(b + "mlp.w_up", (d, cfg.d_ff), 0.02),
                    "w_down": normal(b + "mlp.w_down", (cfg.d_ff, d), resid)},
        })
    return params


def rms_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """In float32, cast back to x's dtype (llama.py:134-137)."""
    x32 = x.to(torch.float32)
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale * p["scale"].to(torch.float32)).to(x.dtype)


def rope_angles(t: int, head_dim: int, theta: float, device=None, offset: int = 0) -> tuple:
    """float32 cos and sin tables ``[t, head_dim / 2]`` of positions
    ``offset`` … ``offset + t − 1`` (a seq chunk's)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    pos = torch.arange(t, dtype=torch.float32, device=device) + offset
    ang = torch.outer(pos, inv_freq)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x ``[B, H, T, hd]``: rotate the (even, odd) column pairs, the tables
    (``[T, hd/2]``, or ``[B, T, hd/2]``: a row's own positions) cast to x's
    dtype first (llama.py:140-163)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    lead = (slice(None), None) if cos.dim() == 3 else (None, None)
    c, s = cos[lead].to(x.dtype), sin[lead].to(x.dtype)
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)


def _attention(x, p, cfg: LlamaConfig, cos, sin, tp: TensorAxis, seq: SeqAxis):
    B, T, _ = x.shape
    H, KV, hd = cfg.n_head // tp.size, cfg.n_kv_head // tp.size, cfg.head_dim
    x = copy_to_tp_region(x, tp.group)
    q = lora_matmul(x, p["wq"]).reshape(B, T, H, hd).transpose(1, 2)
    k = lora_matmul(x, p["wk"]).reshape(B, T, KV, hd).transpose(1, 2)
    v = lora_matmul(x, p["wv"]).reshape(B, T, KV, hd).transpose(1, 2)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if KV != H:  # GQA: repeat each kv head for its query heads (jnp.repeat)
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    if seq.size > 1:
        out = seq_attention(q, k, v, seq, cfg.seq_impl)
    else:
        out = attention(q, k, v, causal=True, impl=cfg.attn_impl)
    return reduce_from_tp_region(lora_matmul(out.transpose(1, 2).reshape(B, T, H * hd), p["wo"]),
                                 tp.group)


def _mlp(x, p, tp: TensorAxis):
    x = copy_to_tp_region(x, tp.group)
    gate = F.silu(lora_matmul(x, p["w_gate"]))
    return reduce_from_tp_region(lora_matmul(gate * lora_matmul(x, p["w_up"]), p["w_down"]),
                                 tp.group)


def _block(x, p, cfg: LlamaConfig, cos, sin, tp: TensorAxis, seq: SeqAxis):
    x = x + _attention(rms_norm(x, p["ln_attn"], cfg.rms_eps), p["attn"], cfg, cos, sin, tp,
                       seq)
    return x + _mlp(rms_norm(x, p["ln_mlp"], cfg.rms_eps), p["mlp"], tp)


def as_parameters(params: Any) -> Any:
    """The same tree with every tensor leaf an ``nn.Parameter`` (full-parameter
    training, ``train.loop.Trainer.for_llama``)."""
    return map_tree(nn.Parameter, params)


class Llama(nn.Module):
    """The model over a weight tree; ``forward(tokens, params)`` returns
    float32 logits ``[B, T, vocab_size]``. ``params`` defaults to the tree
    the model was built with; the trainer passes the tree with the adapters
    swapped in (``models.lora.apply_adapters``). The tree's tensors are not
    registered as module parameters: a frozen base stays out of autograd,
    and a trainable tree (:func:`as_parameters`) is listed by
    :meth:`jax_named_parameters`. ``tp`` (size > 1): the tree holds this
    rank's slices; ``seq`` (size > 1): the tokens are this rank's chunk
    (module doc)."""

    def __init__(self, cfg: LlamaConfig, params: dict, tp: Optional[TensorAxis] = None,
                 seq: Optional[SeqAxis] = None):
        super().__init__()
        self.cfg = cfg
        self.params = params
        self.tp = tp or TensorAxis()
        self.seq = seq or SeqAxis()

    def hidden(self, tokens: torch.Tensor, params: Optional[dict] = None) -> torch.Tensor:
        """Backbone: tokens ``[B, T]`` → final hidden ``[B, T, d]`` after the
        last RMSNorm."""
        cfg, params = self.cfg, self.params if params is None else params
        T = tokens.shape[1]
        if self.seq.size == 1 and T > cfg.n_ctx:
            raise ValueError(f"sequence length {T} exceeds n_ctx {cfg.n_ctx}")
        x = lora_embed(params["wte"], tokens, cfg.compute_dtype)
        cos, sin = rope_angles(T, cfg.head_dim, cfg.rope_theta, tokens.device,
                               offset=self.seq.rank * T)
        for p in params["blocks"]:
            x = remat(_block, cfg, x, p, cfg, cos, sin, self.tp, self.seq)
        return rms_norm(x, params["ln_f"], cfg.rms_eps)

    def head(self, x: torch.Tensor, params: Optional[dict] = None) -> torch.Tensor:
        """Untied head: hidden ``[B, T, d]`` → float32 logits (the JAX
        ``preferred_element_type`` einsum, llama.py:436-439)."""
        params = self.params if params is None else params
        return matmul_f32(x, maybe_dequant(params["lm_head"], x.dtype).to(x.dtype))

    def forward(self, tokens: torch.Tensor, params: Optional[dict] = None) -> torch.Tensor:
        return self.head(self.hidden(tokens, params), params)

    def jax_named_parameters(self) -> list[tuple[str, nn.Parameter]]:
        """The tree's leaves in ``jax.tree.leaves`` order (``blocks.<i>.attn.
        {wk,wo,wq,wv}``, ``blocks.<i>.ln_attn.scale``, ``blocks.<i>.ln_mlp.
        scale``, ``blocks.<i>.mlp.{w_down,w_gate,w_up}``, then ``lm_head``,
        ``ln_f.scale``, ``wte``): the flat layout. Every leaf must be an
        ``nn.Parameter``."""
        named = jax_leaf_order((".".join(path), t) for path, t in iter_paths(self.params))
        frozen = [name for name, t in named if not isinstance(t, nn.Parameter)]
        if frozen:
            raise TypeError(f"leaves {frozen[:3]} are not parameters; build the tree with "
                            "models.llama.as_parameters")
        return named


def tree_nbytes(params: Any) -> int:
    """Bytes a weight tree holds on its device (codes and absmax for a
    quantized leaf)."""
    if isinstance(params, dict):
        return sum(tree_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_nbytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return params.nbytes()


# ------------------------------------------------------------------ decoding
def llama_init_cache(cfg: LlamaConfig, batch: int, max_len: int, device=None) -> list:
    """Per-layer KV cache ``[B, n_kv_head, max_len, hd]`` in the compute
    dtype, the kv heads un-repeated (JAX ``llama_init_cache``)."""
    shape = (batch, cfg.n_kv_head, max_len, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.n_layer)]


def _decode_attention(x, p, cfg: LlamaConfig, c: dict, pos: int, cos, sin, offset=None):
    """Attention of S new tokens at cache slots ``[pos, pos+S)`` (JAX
    :248-279): roped k and v written into the cache in place, each kv head
    repeated for its query heads, q over the masked cache."""
    B, S, _ = x.shape
    H, KV, hd, dt = cfg.n_head, cfg.n_kv_head, cfg.head_dim, x.dtype
    q = apply_rope(lora_matmul(x, p["wq"]).reshape(B, S, H, hd).transpose(1, 2), cos, sin)
    k = apply_rope(lora_matmul(x, p["wk"]).reshape(B, S, KV, hd).transpose(1, 2), cos, sin)
    v = lora_matmul(x, p["wv"]).reshape(B, S, KV, hd).transpose(1, 2)
    c["k"][:, :, pos:pos + S] = k.to(c["k"].dtype)
    c["v"][:, :, pos:pos + S] = v.to(c["v"].dtype)
    k_all, v_all = c["k"].to(dt), c["v"].to(dt)
    if KV != H:
        k_all = k_all.repeat_interleave(H // KV, dim=1)
        v_all = v_all.repeat_interleave(H // KV, dim=1)
    scores = matmul_f32(q, k_all.transpose(-1, -2)) / math.sqrt(hd)
    scores = scores.masked_fill(~decode_mask(k_all.shape[2], pos, S, offset, x.device), -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = matmul_f32(probs, v_all).to(dt).transpose(1, 2).reshape(B, S, H * hd)
    return lora_matmul(out, p["wo"])


def _head_logits(x, params) -> torch.Tensor:
    return matmul_f32(x, maybe_dequant(params["lm_head"], x.dtype).to(x.dtype))


@torch.no_grad()
def llama_decode(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, cache: list, pos: int,
                 offset: Optional[torch.Tensor] = None):
    """The next S tokens ``[B, S]`` at cache slots ``[pos, pos+S)`` (JAX
    :288-318): returns ``(float32 logits [B, S, vocab_size], cache)``, the
    cache written in place; position for position :meth:`Llama.forward`'s
    logits. ``offset`` ``[B]``: each row's left-pad width; its slot ``t``
    gets rotary position ``t - offset`` and attends no slot below it."""
    S = tokens.shape[1]
    x = lora_embed(params["wte"], tokens, cfg.compute_dtype)
    max_len = cache[0]["k"].shape[2]
    cos_all, sin_all = rope_angles(max_len, cfg.head_dim, cfg.rope_theta, tokens.device)
    if offset is None:
        cos, sin = cos_all[pos:pos + S], sin_all[pos:pos + S]
    else:
        ids = torch.clamp(pos + torch.arange(S, device=tokens.device)[None, :] - offset[:, None],
                          0, max_len - 1)
        cos, sin = cos_all[ids], sin_all[ids]
    no_tp = TensorAxis()
    for p, c in zip(params["blocks"], cache):
        x = x + _decode_attention(rms_norm(x, p["ln_attn"], cfg.rms_eps), p["attn"], cfg, c,
                                  pos, cos, sin, offset)
        x = x + _mlp(rms_norm(x, p["ln_mlp"], cfg.rms_eps), p["mlp"], no_tp)
    return _head_logits(rms_norm(x, params["ln_f"], cfg.rms_eps), params), cache
