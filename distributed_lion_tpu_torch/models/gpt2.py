"""GPT-2-class decoder as an ``nn.Module``: port of ``distributed_lion_tpu/models/gpt2.py``.

The dense, non-MoE, single-axis model: pre-LN residual blocks, learned
positions, tanh-GELU MLP, head tied to ``wte``. Parameter names keep the
JAX pytree paths (``wte``, ``blocks.0.attn.qkv``, …) and the JAX layouts
(``qkv`` is ``[d, 3, d]``), so weights carry over one to one
(``utils.serialization.params_from_jax``).

Rounding follows the JAX package: float32 layer norm, compute-dtype
matmuls accumulated in float32 and rounded to the compute dtype, the tanh
GELU. The attention scores and the tied-head logits are compute-dtype
products with a float32 result (``ops.products.matmul_f32``), never rounded
to the compute dtype before their float32 softmax. Dropout masks come from
``torch.Generator``s seeded per call site from an integer ``dropout_seed``,
so a rematerialized block (``torch.utils.checkpoint``) draws the same mask
again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_lion_tpu_torch.ops.attention import attention
from distributed_lion_tpu_torch.ops.products import matmul_f32
from distributed_lion_tpu_torch.parallel.mesh import resolve_device


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    n_ctx: int = 1024
    dropout: float = 0.0
    attn_impl: str = "auto"   # ops.attention: auto | xla | flash | splash
    remat: bool = True        # recompute each block in backward
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 0  # > 0: round the embedding rows up to a
    # multiple (zero rows); logits are sliced back to vocab_size

    def __post_init__(self):
        if self.vocab_pad_multiple < 0:
            raise ValueError(
                f"vocab_pad_multiple must be >= 0, got {self.vocab_pad_multiple}")

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_head == 0
        return self.d_model // self.n_head

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return self.vocab_size if m <= 0 else -(-self.vocab_size // m) * m

    @staticmethod
    def tiny(**kw) -> "GPT2Config":
        """A test-sized config."""
        return GPT2Config(**(dict(vocab_size=256, n_layer=2, n_head=4,
                                  d_model=64, n_ctx=128) | kw))

    @staticmethod
    def small(**kw) -> "GPT2Config":
        """The reduced evidence-scale preset (~12.7M params at a 16k vocab)."""
        return GPT2Config(**(dict(vocab_size=16384, n_layer=6, n_head=5,
                                  d_model=320, n_ctx=256) | kw))

    @staticmethod
    def gpt2_124m(**kw) -> "GPT2Config":
        return GPT2Config(**kw)


def pad_wte(wte: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """Append the zero alignment rows of ``cfg.vocab_pad_multiple``."""
    extra = cfg.padded_vocab - wte.shape[0]
    if extra <= 0:
        return wte
    return torch.cat([wte, wte.new_zeros(extra, wte.shape[1])])


def fold_seed(*xs: int) -> int:
    """A 63-bit seed from integers (splitmix64 chain): the port's
    ``fold_in``. Deterministic across processes and devices."""
    h = 0x9E3779B97F4A7C15
    for x in xs:
        h = (h ^ (x & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return h >> 1


def _dropout(x: torch.Tensor, rate: float, seed: Optional[int]) -> torch.Tensor:
    if rate == 0.0 or seed is None:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _layer_norm(x: torch.Tensor, ln: "LayerNorm", eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * ln.scale.to(torch.float32) + ln.bias.to(torch.float32)).to(x.dtype)


def _param(shape, dtype, device, std=None, gen=None) -> nn.Parameter:
    if std is None:
        t = torch.zeros(shape, dtype=torch.float32)
    else:
        t = torch.randn(shape, generator=gen, dtype=torch.float32) * std
    return nn.Parameter(t.to(dtype=dtype, device=device))


class LayerNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


class Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, device, gen):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        resid_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        # [d, 3, d]: q/k/v stacked on axis 1, the JAX package's layout
        self.qkv = _param((d, 3, d), dt, device, 0.02, gen)
        self.qkv_b = _param((3, d), dt, device)
        self.proj = _param((d, d), dt, device, resid_std, gen)
        self.proj_b = _param((d,), dt, device)

    def forward(self, x, cfg: GPT2Config, seed: Optional[int]):
        B, T, D = x.shape
        H, hd = cfg.n_head, cfg.head_dim
        dt = x.dtype
        qkv = (x @ self.qkv.to(dt).reshape(D, 3 * D)).view(B, T, 3, D)
        qkv = qkv + self.qkv_b.to(dt)
        q, k, v = (qkv[:, :, i].reshape(B, T, H, hd).transpose(1, 2)
                   for i in range(3))
        if cfg.dropout > 0.0 and seed is not None:
            # attention-prob dropout needs materialized scores, so training
            # with dropout always takes this branch (gpt2.py:253-265); eval
            # and dropout-0 training take ops.attention (flash on the card
            # at GPT-2's shape)
            scores = matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(hd)
            causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~causal, -1e30)
            probs = torch.softmax(scores, dim=-1).to(dt)
            probs = _dropout(probs, cfg.dropout, fold_seed(seed, 0))
            out = torch.matmul(probs, v).to(dt)
        else:
            out = attention(q, k, v, causal=True, impl=cfg.attn_impl)
        out = out.transpose(1, 2).reshape(B, T, H * hd)
        return out @ self.proj.to(dt) + self.proj_b.to(dt)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device, gen):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        resid_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        self.fc = _param((d, 4 * d), dt, device, 0.02, gen)
        self.fc_b = _param((4 * d,), dt, device)
        self.proj = _param((4 * d, d), dt, device, resid_std, gen)
        self.proj_b = _param((d,), dt, device)

    def forward(self, x):
        dt = x.dtype
        h = F.gelu(x @ self.fc.to(dt) + self.fc_b.to(dt), approximate="tanh")
        return h @ self.proj.to(dt) + self.proj_b.to(dt)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device, gen):
        super().__init__()
        d = cfg.d_model
        self.ln_1 = LayerNorm(d, cfg.param_dtype, device)
        self.attn = Attention(cfg, device, gen)
        self.ln_2 = LayerNorm(d, cfg.param_dtype, device)
        self.mlp = MLP(cfg, device, gen)

    def forward(self, x, cfg: GPT2Config, seed: Optional[int]):
        s = (None, None, None) if seed is None else tuple(fold_seed(seed, i) for i in (1, 2, 3))
        x = x + _dropout(self.attn(_layer_norm(x, self.ln_1), cfg, s[0]),
                         cfg.dropout, s[1])
        return x + _dropout(self.mlp(_layer_norm(x, self.ln_2)), cfg.dropout, s[2])


class GPT2(nn.Module):
    """The model; ``forward(tokens, dropout_seed)`` returns float32 logits
    ``[B, T, vocab_size]``. ``dropout_seed=None`` disables dropout (eval)."""

    def __init__(self, cfg: GPT2Config, *, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)  # CPU draws: same weights on any device
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.param_dtype
        self.wte = nn.Parameter(pad_wte(
            _param((cfg.vocab_size, d), dt, device, 0.02, gen).data, cfg))
        self.wpe = _param((cfg.n_ctx, d), dt, device, 0.02, gen)
        self.ln_f = LayerNorm(d, dt, device)
        self.blocks = nn.ModuleList(Block(cfg, device, gen) for _ in range(cfg.n_layer))

    def hidden(self, tokens: torch.Tensor, dropout_seed: Optional[int] = None):
        """Backbone: tokens [B, T] → final hidden [B, T, d] after ln_f."""
        cfg = self.cfg
        T = tokens.shape[1]
        if T > cfg.n_ctx:
            raise ValueError(f"sequence length {T} exceeds n_ctx {cfg.n_ctx}")
        cd = cfg.compute_dtype
        x = F.embedding(tokens, self.wte).to(cd) + self.wpe[:T].to(cd)
        x = _dropout(x, cfg.dropout,
                     None if dropout_seed is None else fold_seed(dropout_seed, cfg.n_layer))
        for i, block in enumerate(self.blocks):
            seed = None if dropout_seed is None else fold_seed(dropout_seed, i)
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, cfg, seed, use_reentrant=False)
            else:
                x = block(x, cfg, seed)
        return _layer_norm(x, self.ln_f)

    def forward(self, tokens: torch.Tensor, dropout_seed: Optional[int] = None):
        return self.head(self.hidden(tokens, dropout_seed))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Tied head: hidden [B, T, d] → float32 logits [B, T, vocab_size]."""
        logits = matmul_f32(x, self.wte.to(x.dtype).t())
        return logits[..., : self.cfg.vocab_size]

    def jax_named_parameters(self) -> list[tuple[str, nn.Parameter]]:
        """Named parameters in ``jax.tree.leaves`` order of the JAX pytree:
        the flat layout."""
        return jax_leaf_order(self.named_parameters())


def jax_leaf_order(named) -> list:
    """``(dotted name, value)`` pairs sorted as ``jax.tree.leaves`` orders
    the leaves of the nested tree the names spell: dict keys sorted, list
    entries (the numeric parts) by index."""
    def key(name):
        return [(0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split(".")]

    return sorted(named, key=lambda kv: key(kv[0]))


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
