"""Attention with one dispatch point: port of ``distributed_lion_tpu/ops/attention.py``.

- ``xla``: materialized scores (float32 scores from a float32-result
  product, ``ops.products.matmul_f32``; a −1e30 causal mask; float32
  softmax), as the JAX package leaves it to XLA.
- ``flash``: the port's causal flash attention (``ops/flash_attention.py``,
  hand-written CUDA kernels for the forward, dK/dV and dQ); on CPU tensors
  its plain PyTorch versions.
- ``splash``: the same causal function, routed to the same kernels. The
  JAX package's splash kernel pads head_dim to the TPU's 128 lanes; the
  card does not need that, and the package is causal-only, so there is no
  sparse mask to port.
- ``auto``: :func:`resolve_impl`, the JAX table (attention.py:301-379) with
  "on TPU" read as "on CUDA": flash for T ≥ 2048, and at T = 1024 with
  head_dim 64 (GPT-2); xla everywhere else, so Llama's head_dim 128 takes
  flash from T = 2048 and xla at T = 1024, as in the JAX table. Two
  conditions are the card's own: the kernels take bfloat16 only, so float32
  inputs take xla, and they are built for head_dim 64 and 128 only, so other
  head dims take xla. Off
  CUDA, auto is always xla, as the JAX package is off the TPU. The TPU tile
  knobs (``flash@BQxBKV``) and the autotune cache are not ported.

Tensors are ``[B, H, T, head_dim]``, as in the JAX package.

The paged primitives (``paged_scatter_kv``, ``paged_copy_pages``,
``paged_gather_kv``, ``paged_decode_attention``) are the serving engine's
gathers, scatters and materialized scores over a page pool
(``serve/kv_cache.py``). The JAX package's are ``jnp`` outside any Pallas
kernel, and so are these: plain PyTorch, no kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distributed_lion_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS,
    UNPORTED_DTYPE,
    flash_attention,
)
from distributed_lion_tpu_torch.ops.products import matmul_f32

IMPLS = ("auto", "xla", "flash", "splash")


def attention_xla(q, k, v, *, causal: bool = True):
    """Materialized-scores attention (attention.py:43-67)."""
    T = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = matmul_f32(q, k.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v).to(q.dtype)


def attention_flash(q, k, v, *, causal: bool = True):
    """Causal flash attention (attention.py:70); ``splash``
    (attention.py:104) computes the same function and runs this one."""
    if not causal:
        raise ValueError("the port's flash attention is causal only, as the "
                         "package's decoders are")
    return flash_attention(q, k, v)


def resolve_impl(impl: str, device_type: str, T: int, head_dim: int,
                 dtype: torch.dtype) -> str:
    """The implementation ``attention`` runs: a pure function of the device
    type, sequence length, head_dim and dtype. An explicit ``flash`` or
    ``splash`` at a dtype other than bfloat16 on CUDA raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} ({' | '.join(IMPLS)})")
    if impl == "auto":
        on_cuda = device_type == "cuda"
        kernel_ok = dtype == torch.bfloat16 and head_dim in KERNEL_HEAD_DIMS
        if on_cuda and kernel_ok and (T >= 2048 or (T == 1024 and head_dim == 64)):
            return "flash"
        return "xla"
    if impl in ("flash", "splash") and device_type == "cuda" and dtype != torch.bfloat16:
        raise NotImplementedError(f"attention impl {impl!r} at {dtype}: {UNPORTED_DTYPE}")
    return impl


def attention(q, k, v, *, causal: bool = True, impl: str = "auto"):
    impl = resolve_impl(impl, q.device.type, q.shape[2], q.shape[-1], q.dtype)
    if impl == "xla":
        return attention_xla(q, k, v, causal=causal)
    return attention_flash(q, k, v, causal=causal)


# ------------------------------------------------------------- paged decode
# The serving engine's KV layout (serve/kv_cache.py; JAX attention.py:
# 150-276): each layer's cache is a pool of pages [num_blocks + 1,
# block_size, kv_heads, head_dim] and a sequence owns an ordered list of
# page ids, its block table. Unused table entries hold the sentinel
# num_blocks. XLA drops a scatter to an out-of-range page and fills a
# gather from one with zeros; torch has neither mode, so the port's pool
# keeps one scratch page past its num_blocks pages, at the sentinel's id:
# every dropped write (a sentinel or invalid lane) lands there, and every
# gather reads a sentinel id as zeros, so the scratch page is never read
# and never counted. The writes are ``index_put_``s on the pool in place:
# duplicate indices only ever meet in the scratch page, so no real cell
# sees a race, and no lane is selected by a boolean mask (that would read
# the mask back to the host).


def pool_blocks(pages: torch.Tensor) -> int:
    """The real pages of a pool: its length less the scratch page."""
    return pages.shape[0] - 1


def _sentinel_or(ids: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """``ids`` with every entry outside ``[0, num_blocks)`` replaced by the
    sentinel ``num_blocks`` (the scratch page)."""
    return torch.where((ids >= 0) & (ids < num_blocks), ids, num_blocks)


def paged_scatter_kv(pages: torch.Tensor, tables: torch.Tensor, pos: torch.Tensor,
                     new: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write each row's new k (or v) rows into its block-table pages, in
    place (JAX attention.py:161), and return ``pages``.

    pages ``[num_blocks + 1, block_size, KV, hd]``; tables ``[B,
    blocks_per_seq]`` page ids (sentinel ``num_blocks``); pos ``[B]``, the
    absolute position of each row's first new token; new ``[B, S, KV,
    hd]``; valid optional ``[B, S]`` bool, False lanes dropped. Token s of
    row b lands in page ``tables[b, (pos[b]+s) // block_size]`` (the block
    index clipped to the table, as JAX's ``mode="clip"``) at offset
    ``(pos[b]+s) % block_size``; a sentinel page or a False lane writes the
    scratch page."""
    B, S = new.shape[:2]
    nb, bs = pool_blocks(pages), pages.shape[1]
    abs_pos = pos.to(torch.int64)[:, None] + torch.arange(S, device=pages.device)[None, :]
    col = torch.clamp(abs_pos // bs, 0, tables.shape[1] - 1)
    blk = _sentinel_or(torch.gather(tables.to(torch.int64), 1, col), nb)
    if valid is not None:
        blk = torch.where(valid, blk, nb)
    cells = (blk * bs + abs_pos % bs).reshape(-1)
    flat = pages.view(-1, *pages.shape[2:])
    flat.index_put_((cells,), new.reshape(B * S, *new.shape[2:]).to(pages.dtype))
    return pages


def paged_copy_pages(pages: list, src: torch.Tensor, dst: torch.Tensor) -> list:
    """Copy whole pages inside each layer's pool, in place (JAX
    attention.py:200): the device half of copy-on-write prefix sharing.
    src/dst ``[C]`` page-id pairs padded with the sentinel: a sentinel
    ``dst`` writes the scratch page and a sentinel ``src`` reads zeros. Every
    source page is read before any is written. The copy is bytewise."""
    for layer in pages:
        for pool in (layer["k"], layer["v"]):
            nb = pool_blocks(pool)
            s, d = _sentinel_or(src.to(torch.int64), nb), _sentinel_or(dst.to(torch.int64), nb)
            pool.index_put_((d,), torch.where((s < nb)[:, None, None, None], pool[s], 0))
    return pages


def paged_gather_kv(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """``[num_blocks + 1, bs, KV, hd]`` pool and ``[B, nb]`` tables → ``[B,
    nb·bs, KV, hd]``, each row's history in order (JAX attention.py:227);
    sentinel pages read as zeros."""
    B, nbw = tables.shape
    nb = pool_blocks(pages)
    ids = _sentinel_or(tables.to(torch.int64), nb)
    got = torch.where((ids < nb)[:, :, None, None, None], pages[ids], 0)
    return got.reshape(B, nbw * pages.shape[1], *pages.shape[2:])


def paged_decode_attention(q, k_pages, v_pages, tables, pos, start=None):
    """Decode attention over a paged KV cache, the new k/v already scattered
    (JAX attention.py:237). q ``[B, H, S, hd]``; k_pages/v_pages ``[num_blocks
    + 1, bs, KV, hd]``; tables ``[B, nb]``; pos ``[B]``, each row's first new
    position; ``start`` optional ``[B]``, each row's first valid slot.
    Returns ``[B, H, S, hd]`` in q's dtype.

    The gather rebuilds each row's history in the dense cache's layout
    (``[B, H, T, hd]``, contiguous; GQA kv heads repeated at attend time)
    and runs the dense decode's chain (``models.gpt2._decode_attention``):
    float32-result scores over ``sqrt(hd)``, ``-1e30`` outside ``t <= pos +
    s`` (and ``t >= start``), a float32 softmax cast to q's dtype, and the
    float32-result product with v. So paged decode equals the dense cache's
    at the same attended length. Query s of a window attends causally
    inside it; the rows of invalid queries are garbage the caller drops."""
    B, H, S, hd = q.shape
    KV = k_pages.shape[2]
    dt = q.dtype
    k_all = paged_gather_kv(k_pages, tables).transpose(1, 2).to(dt)
    v_all = paged_gather_kv(v_pages, tables).transpose(1, 2).to(dt)
    if KV != H:
        k_all = k_all.repeat_interleave(H // KV, dim=1)
        v_all = v_all.repeat_interleave(H // KV, dim=1)
    k_all, v_all = k_all.contiguous(), v_all.contiguous()
    T = k_all.shape[2]
    scores = matmul_f32(q, k_all.transpose(-1, -2)) / math.sqrt(hd)
    t_idx = torch.arange(T, device=q.device)
    last = pos.to(torch.int64)[:, None] + torch.arange(S, device=q.device)[None, :]
    valid = t_idx[None, None, :] <= last[:, :, None]
    if start is not None:
        valid = valid & (t_idx[None, None, :] >= start.to(torch.int64)[:, None, None])
    scores = scores.masked_fill(~valid[:, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    return matmul_f32(probs, v_all).to(dt)
