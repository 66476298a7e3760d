"""Continuous-batching inference engine over the paged KV cache: port of
``distributed_lion_tpu/serve/engine.py`` (one device, ``tp = 0``, ``ep = 0``).

Requests join a rolling batch on arrival and leave on EOS, length or
overflow. Every tick is a bucketed prefill per admitted request and one
decode dispatch over every active slot. The host's work a tick is table
math (``serve/kv_cache.py``), one host-to-device copy of each dispatch's
operands and one read back of its sampled tokens: one host read a prefill
and one a decode tick (JAX engine.py:1203, 1371).

- **admit**: pending requests take a free slot while pages fit, under a
  cap on the padded prefill tokens a tick (``prefill_cap_tokens``), so a
  burst of long prompts holds the decode batch back one tick at most.
- **prefill**: one call of the model's paged decode a request, at a
  power-of-two bucketed length (``kv_cache.bucket_tokens``: the operand
  shapes a run can see are O(log max)), the tail masked through the
  scatter's ``valid`` lanes; it samples the request's first token.
- **decode tick**: one call over every slot, inactive ones on sentinel
  table rows and ``valid`` False, then per-row sampling.
- **evict**: EOS, ``max_new_tokens`` or a full cache release the slot's
  page refs; its table row goes back to the sentinel.

**Sampling.** :func:`_sample_rows` draws row b from a stream keyed only on
(request seed, token index): a ``torch.Generator`` seeded with
``models.gpt2.fold_seed(seed, index)``, as JAX's ``fold_in(key(seed),
index)``. A row's draw depends neither on its slot nor on its batchmates
nor on arrival order, so a staggered run gives each request its solo
stream, and a request resumed from ``committed`` tokens continues it. The
draws compare with JAX's by their statistics only.

**Prefix sharing** (``ServeConfig.prefix_cache``): an admitted request
shares the cached pages of its prompt prefix (``kv_cache.PrefixCache``),
prefills only the rest, and copies a shared page before its first write
into it (``ops.attention.paged_copy_pages``, one dispatch a tick). Its
tokens are those of the unshared engine.

**Quantized weights**: ``quant='nf4'`` or ``'int8'`` re-packs the tree
once at build (``ops.quant.quantize_tree``); the decode paths dequantize
inside each product (``maybe_dequant``).

**Retrace guard** (``retrace_guard``): JAX's guard counts jit retraces; the
port's watches the same thing, the operand signature (shapes and dtypes)
of each dispatch kind: one decode signature, one copy-on-write signature,
one prefill signature per bucket. A signature past that budget is counted
in ``stats['serve_retraces']`` and warned, or raised under ``error``.

**Refused**: tensor- and expert-parallel serving (``tp``, ``ep``,
``ep_batch``, ``ep_overlap``), the MoE routing stats (``moe_stats``) and
speculation (``speculate``, ``draft_model``) are ROADMAP Queue 1 item
12(d). The jit registry of the JAX engine (``compile_counts``,
``param_specs``, the shard-mapped dispatch) has nothing to port.

Journal spans (``serve/admit``, ``serve/prefill``, ``serve/decode_tick``,
``serve/cow``, ``serve/evict``) go to the run journal when one is installed
(``train/journal.install``).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from distributed_lion_tpu_torch.models.generate import filter_logits
from distributed_lion_tpu_torch.models.gpt2 import fold_seed
from distributed_lion_tpu_torch.models.llama import tree_nbytes
from distributed_lion_tpu_torch.models.lora import iter_paths
from distributed_lion_tpu_torch.ops.attention import paged_copy_pages
from distributed_lion_tpu_torch.serve.kv_cache import (
    BlockTables,
    PrefixCache,
    bucket_tokens,
    init_pages,
)
from distributed_lion_tpu_torch.serve.metrics import RequestTimes, ServeMetrics
from distributed_lion_tpu_torch.serve.unported import ITEM_D, refuse
from distributed_lion_tpu_torch.train import journal


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seqs: int = 8            # rolling-batch width (decode slots)
    block_size: int = 16         # tokens per KV page
    max_blocks_per_seq: int = 8  # block-table width; a sequence holds at most
    #                              block_size * max_blocks_per_seq tokens
    num_blocks: int = 0          # page-pool size; 0 = max_seqs * max_blocks_per_seq
    prefill_cap_tokens: int = 512  # padded prefill tokens admitted a tick (one
    #                              over-cap prompt still admits into an empty tick)
    max_new_tokens: int = 64     # a request's default budget
    temperature: float = 0.0     # 0 = greedy; the sampling knobs are the
    top_k: Optional[int] = None  # engine's, the seeds a request's own
    top_p: Optional[float] = None
    quant: str = "none"          # none | nf4 | int8 frozen-weight serving
    quant_block: Optional[int] = None  # quant block override (elements)
    eos_id: Optional[int] = None
    tp: int = 0                  # tensor-parallel serving: Queue 1 item 12(d)
    ep: int = 0                  # expert-parallel serving: item 12(d)
    ep_batch: bool = False       # batch-sharded expert serving: item 12(d)
    ep_overlap: bool = False     # two-microbatch decode tick: item 12(d)
    moe_stats: bool = False      # MoE routing-load counters: item 12(d)
    prefix_cache: bool = False   # share prompt-prefix pages (copy-on-write)
    speculate: str = ""          # speculative decode: item 12(d)
    metrics: bool = False        # the request-lifecycle metrics plane
    #                              (serve/metrics.ServeMetrics); tokens unchanged
    retrace_guard: str = "warn"  # off | warn | error (module doc)

    def resolved_num_blocks(self) -> int:
        return self.num_blocks or self.max_seqs * self.max_blocks_per_seq


@dataclasses.dataclass
class Request:
    req_id: Any
    tokens: List[int]                    # prompt token ids (non-empty)
    max_new_tokens: Optional[int] = None  # None = the engine's default
    seed: int = 0
    prefix_group: Optional[str] = None   # routing/accounting tag, echoed on
    #                                      the response; sharing matches tokens
    committed: List[int] = dataclasses.field(default_factory=list)
    # tokens already generated elsewhere: the engine prefills tokens +
    # committed as one history and resumes the request's stream at index
    # len(committed)
    deadline_s: Optional[float] = None   # wall-clock budget from submit; on
    #                                      expiry the 'timeout' status, output attached


@dataclasses.dataclass
class Completion:
    req_id: Any
    prompt_len: int
    tokens: List[int]    # generated ids (EOS included when emitted)
    reason: str          # eos | length | overflow | rejected | timeout
    timing: Optional[Dict[str, Any]] = None  # tick-domain clocks
    #                      (serve/metrics.RequestTimes), wall ttft_ms with metrics


@dataclasses.dataclass
class RecoveryRecord:
    """What a survivor needs to continue a request token for token: the
    prompt, the committed tokens, the seed, the resolved budget and the
    deadline. The per-request stream (:func:`_sample_rows`) carries the
    rest: re-prefilling the history and resuming at index
    ``len(committed)`` reproduces the stream."""

    req_id: Any
    tokens: List[int]                    # the original prompt
    committed: List[int]                 # tokens generated so far
    seed: int
    budget: Optional[int]                # total max_new_tokens
    prefix_group: Optional[str] = None
    deadline_at: Optional[float] = None  # absolute time.monotonic() stamp

    def to_request(self) -> "Request":
        return Request(req_id=self.req_id, tokens=list(self.tokens),
                       max_new_tokens=self.budget, seed=int(self.seed),
                       prefix_group=self.prefix_group, committed=list(self.committed))

    @staticmethod
    def from_request(req: "Request", committed, budget,
                     deadline_at: Optional[float]) -> "RecoveryRecord":
        """The one construction site; ``req.tokens`` is shared (a prompt is
        never written after submit), ``committed`` copied."""
        return RecoveryRecord(req_id=req.req_id, tokens=req.tokens, committed=list(committed),
                              seed=int(req.seed), budget=budget,
                              prefix_group=req.prefix_group, deadline_at=deadline_at)


@dataclasses.dataclass
class _Slot:
    req: Request
    budget: int          # max new tokens of this request
    cache_len: int       # tokens whose k/v are in the pages
    last_tok: int        # newest sampled token (not yet in the cache)
    gen: List[int] = dataclasses.field(default_factory=list)


def dispatch_signature(operands) -> tuple:
    """The retrace guard's operand signature: (shape, dtype) of each
    operand, attribute reads only (a Python scalar by its type name)."""
    return tuple((tuple(getattr(a, "shape", ())), str(getattr(a, "dtype", type(a).__name__)))
                 for a in operands)


class _RetraceGuard:
    """Each dispatch kind carries a budget of operand signatures (decode and
    cow one, prefill one a bucket). A new signature past the budget is
    counted in ``stats['serve_retraces']`` and warned once, or raised under
    ``error`` before the dispatch runs."""

    def __init__(self, mode: str, budgets: Dict[str, int], stats: Dict[str, Any]):
        self.mode = mode
        self.budgets = budgets
        self.stats = stats
        self.seen: Dict[str, set] = {}

    def observe(self, kind: str, operands) -> None:
        sig = dispatch_signature(operands)
        seen = self.seen.setdefault(kind, set())
        if sig in seen:
            return
        budget = self.budgets.get(kind, 1)
        if len(seen) < budget:
            seen.add(sig)
            return
        msg = (f"serve retrace guard: dispatch {kind!r} saw a new operand signature past its "
               f"budget ({budget}), a shape the serving design forbids; new signature: {sig}")
        if self.mode == "error":
            raise RuntimeError(msg)
        seen.add(sig)
        self.stats["serve_retraces"] = self.stats.get("serve_retraces", 0) + 1
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


class ServeModel:
    """Family adapter: the paged decode hook and the cache geometry the
    engine needs. ``decode_paged(params, tokens, pages, tables, pos, valid)``
    returns ``(logits [B, S, V] float32, pages)``: ``models.gpt2.
    gpt2_decode_paged`` or ``models.llama.llama_decode_paged``."""

    def __init__(self, family: str, cfg: Any, params: Any, decode_paged: Callable,
                 n_layer: int, kv_heads: int, head_dim: int, cache_dtype: Any,
                 max_positions: Optional[int] = None):
        self.family = family
        self.cfg = cfg
        self.params = params
        self.decode_paged = decode_paged
        self.n_layer = n_layer
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.cache_dtype = cache_dtype
        # the model's position budget (GPT-2's learned wpe rows; Llama's
        # trained horizon): the engine refuses a geometry past it
        self.max_positions = max_positions

    @staticmethod
    def for_gpt2(params: Any, cfg: Any) -> "ServeModel":
        from distributed_lion_tpu_torch.models.gpt2 import gpt2_decode_paged

        def decode(p, toks, pages, tables, pos, valid=None):
            return gpt2_decode_paged(p, toks, cfg, pages, tables, pos, valid)

        return ServeModel("gpt2", cfg, params, decode, cfg.n_layer, cfg.n_head, cfg.head_dim,
                          cfg.compute_dtype, max_positions=cfg.n_ctx)

    @staticmethod
    def for_llama(params: Any, cfg: Any) -> "ServeModel":
        from distributed_lion_tpu_torch.models.llama import llama_decode_paged

        def decode(p, toks, pages, tables, pos, valid=None):
            return llama_decode_paged(p, toks, cfg, pages, tables, pos, valid)

        return ServeModel("llama", cfg, params, decode, cfg.n_layer, cfg.n_kv_head,
                          cfg.head_dim, cfg.compute_dtype, max_positions=cfg.n_ctx)


def weight_bytes(params: Any) -> int:
    """Storage bytes of a weight tree: a quantized leaf counts its packed
    codes and absmax scales, a dense leaf its tensor's bytes."""
    return tree_nbytes(params)


def _row_uniforms(seed: int, count: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(fold_seed(seed, count))
    return torch.rand(n, generator=gen, device=device)


def _sample_rows(logits: torch.Tensor, seeds, counts, temperature: float,
                 top_k: Optional[int], top_p: Optional[float]) -> torch.Tensor:
    """``[B, V]`` logits → ``[B]`` tokens, row b drawn from the stream of
    (``seeds[b]``, ``counts[b]``) alone (module doc): Gumbel-max over the
    filtered logits (``models.generate.filter_logits``), as
    ``models.generate.sample_logits``. Greedy at ``temperature == 0``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    filtered = filter_logits(logits.to(torch.float32), temperature, top_k, top_p)
    u = torch.stack([_row_uniforms(int(s), int(c), filtered.shape[-1], filtered.device)
                     for s, c in zip(seeds, counts)])
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
    return torch.argmax(filtered + gumbel, dim=-1)


class ServingEngine:
    """See module doc. ``submit`` requests and call ``step()`` a tick (or
    ``run()`` to drain a workload); both return :class:`Completion`s. The
    engine runs where the model's weights lie."""

    def __init__(self, model: ServeModel, cfg: ServeConfig,
                 draft_model: Optional[ServeModel] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.model = model
        self.cfg = cfg
        self._now = time_fn   # every wall-clock read goes through this clock
        refuse(ITEM_D, {f"ServeConfig.{name}": getattr(cfg, name) for name in
                        ("tp", "ep", "ep_batch", "ep_overlap", "moe_stats", "speculate")})
        refuse(ITEM_D, {"draft_model": draft_model})
        if cfg.quant not in ("none", "nf4", "int8"):
            raise ValueError(f"unknown quant mode {cfg.quant!r}")
        if cfg.retrace_guard not in ("off", "warn", "error"):
            raise ValueError(f"unknown retrace_guard mode {cfg.retrace_guard!r} "
                             "(off | warn | error)")
        params = model.params
        if cfg.quant != "none":
            from distributed_lion_tpu_torch.ops.quant import quantize_tree

            params = quantize_tree(params, cfg.quant, block=cfg.quant_block)
        horizon = cfg.block_size * cfg.max_blocks_per_seq
        if model.max_positions is not None and horizon > model.max_positions:
            raise ValueError(
                f"page geometry allows {horizon} tokens/seq but the model's position budget "
                f"is {model.max_positions} (n_ctx); shrink --block_size/--max_blocks_per_seq "
                "— positions past the trained horizon would silently alias")
        self.params = params
        self.device = next(leaf for _, leaf in iter_paths(params)).device
        self.tables = BlockTables(cfg.resolved_num_blocks(), cfg.block_size, cfg.max_seqs,
                                  cfg.max_blocks_per_seq)
        self.pages = init_pages(model.n_layer, cfg.resolved_num_blocks(), cfg.block_size,
                                model.kv_heads, model.head_dim, model.cache_dtype, self.device)
        self.prefix = PrefixCache(self.tables) if cfg.prefix_cache else None
        self.slots: List[Optional[_Slot]] = [None] * cfg.max_seqs
        self.pending: deque = deque()
        self._deadline_at: Dict[Any, float] = {}   # req_id -> absolute deadline
        self.stats = {"ticks": 0, "decode_ticks": 0, "prefill_dispatches": 0,
                      "decode_tokens": 0, "prefill_tokens": 0, "padded_prefill_tokens": 0,
                      "evictions": 0, "freed_pages": 0, "timeouts": 0, "resumed_requests": 0,
                      "resumed_tokens": 0}
        if self.prefix is not None:
            self.stats.update(prefix_hits=0, shared_tokens=0, cow_copies=0, reclaimed_pages=0)
        # tick-domain request clocks always run; the wall-clock plane only when
        # armed (``self.metrics`` may be replaced before the first submit by
        # one carrying an SLOMonitor, as cli/run_serve does)
        self.times = RequestTimes()
        self.metrics: Optional[ServeMetrics] = (
            ServeMetrics(self.times, time_fn=time_fn) if cfg.metrics else None)
        self._retrace_guard: Optional[_RetraceGuard] = None
        if cfg.retrace_guard != "off":
            self.stats["serve_retraces"] = 0
            self._retrace_guard = _RetraceGuard(cfg.retrace_guard, self.compile_budget(),
                                                self.stats)

    def compile_budget(self) -> Dict[str, int]:
        """The retrace guard's budget of operand signatures per dispatch
        kind: one decode, one cow, one prefill a power-of-two bucket."""
        cap = self.cfg.block_size * self.cfg.max_blocks_per_seq
        buckets = {bucket_tokens(n, self.cfg.block_size, self.cfg.max_blocks_per_seq)
                   for n in range(1, cap + 1)}
        return {"decode": 1, "cow": 1, "prefill": len(buckets)}

    def _guard(self, kind: str, operands) -> None:
        if self._retrace_guard is not None:
            self._retrace_guard.observe(kind, operands)

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """One host-to-device copy of a dispatch's packed operands."""
        return torch.from_numpy(host).to(self.device, non_blocking=True)

    # ------------------------------------------------------------- intake
    def submit(self, req: Request, deadline_at: Optional[float] = None) -> None:
        """Queue a request. ``deadline_at`` (absolute ``time.monotonic()``)
        overrides the fresh ``deadline_s`` stamp: a resumed request keeps
        the budget of its first submission."""
        if deadline_at is None and req.deadline_s is not None:
            deadline_at = self._now() + float(req.deadline_s)
        if deadline_at is not None:
            self._deadline_at[req.req_id] = float(deadline_at)
        self.times.submitted(req.req_id, self.stats["ticks"])
        if self.metrics is not None:
            self.metrics.on_submit(req.req_id)
        self.pending.append(req)

    def _finish_timing(self, req_id, status: str) -> Dict[str, Any]:
        """Retire the request's clocks into its timing dict and journal its
        ``serve_finish`` event."""
        timing = self.times.finished(req_id, self.stats["ticks"])
        if self.metrics is not None:
            timing = self.metrics.on_finish(req_id, timing, status, tick=self.stats["ticks"])
        journal.active().event("serve_finish", req_id=str(req_id), reason=status, **timing)
        return timing

    def has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    def export_records(self) -> List[RecoveryRecord]:
        """Every unfinished request (resident slots, then the queue) as a
        :class:`RecoveryRecord`; host reads only."""
        recs = [RecoveryRecord.from_request(s.req, s.gen, int(s.budget),
                                            self._deadline_at.get(s.req.req_id))
                for s in self.slots if s is not None]
        recs += [RecoveryRecord.from_request(req, req.committed, req.max_new_tokens,
                                             self._deadline_at.get(req.req_id))
                 for req in self.pending]
        return recs

    def export_prefix_chains(self) -> List[List[int]]:
        """The prefix cache's maximal cached token chains, deduplicated and
        sorted (empty without ``prefix_cache``)."""
        if self.prefix is None:
            return []
        return [list(k) for k in sorted({tuple(c) for c in self.prefix.chains()},
                                        key=lambda k: (len(k), k))]

    def _bucket(self, n: int) -> int:
        return bucket_tokens(n, self.cfg.block_size, self.cfg.max_blocks_per_seq)

    # ------------------------------------------------- page bookkeeping
    def _grow(self, slot: int, n_tokens: int) -> bool:
        """``tables.grow``, reclaiming least-recently-used cached prefix
        pages when the pool is short (never past the table's width)."""
        if self.tables.grow(slot, n_tokens):
            return True
        if self.prefix is None:
            return False
        if self.tables.blocks_for(n_tokens) > self.tables.max_blocks_per_seq:
            return False
        need = self.tables.blocks_for(n_tokens) - int(self.tables.owned[slot])
        self.stats["reclaimed_pages"] += self.prefix.reclaim(need)
        return self.tables.grow(slot, n_tokens)

    def _cow_if_shared(self, slot: int, pos: int, pairs: List[tuple]) -> bool:
        """Queue a copy-on-write of the page holding ``pos`` when it is
        shared; the caller flushes ``pairs`` in one dispatch before any write.
        False only when no page can be found even after reclaim."""
        if self.prefix is None or not self.tables.shared_at(slot, pos):
            return True
        pair = self.tables.cow(slot, pos)
        if pair is None:
            self.stats["reclaimed_pages"] += self.prefix.reclaim(1)
            if not self.tables.shared_at(slot, pos):
                return True   # the reclaim dropped the cache's ref: private now
            pair = self.tables.cow(slot, pos)
            if pair is None:
                return False
        pairs.append(pair)
        self.stats["cow_copies"] += 1
        return True

    def _flush_cow(self, pairs: List[tuple]) -> None:
        """The tick's queued page copies as one dispatch of fixed width
        (``max_seqs`` pairs, sentinel-padded); nothing on an empty queue."""
        if not pairs:
            return
        width = self.cfg.max_seqs
        assert len(pairs) <= width, "more CoW copies than slots"
        ids = np.full((2, width), self.tables.sentinel, np.int64)
        for i, (s, d) in enumerate(pairs):
            ids[:, i] = s, d
        with journal.active().span("serve/cow", copies=len(pairs)):
            dev = self._to_device(ids)
            self._guard("cow", (dev[0], dev[1]))
            paged_copy_pages(self.pages, dev[0], dev[1])

    # -------------------------------------------------------------- ticks
    def _dispatch_prefill(self, req: Request, slot: int, covered: int, suffix: List[int],
                          padded: int) -> int:
        """One admitted request's prefill; returns its sampled first token
        (the one host read of the dispatch)."""
        nbw = self.tables.max_blocks_per_seq
        host = np.zeros((padded + nbw,), np.int64)
        host[:len(suffix)] = suffix
        host[padded:] = self.tables.tables[slot]
        dev = self._to_device(host)
        toks, table = dev[None, :padded], dev[None, padded:]
        start = torch.full((1,), covered, dtype=torch.int64, device=self.device)
        valid = torch.arange(padded, device=self.device)[None, :] < len(suffix)
        self._guard("prefill", (table, toks, start, len(suffix), req.seed, len(req.committed)))
        logits, self.pages = self.model.decode_paged(self.params, toks, self.pages, table,
                                                     start, valid)
        # the draw of index len(committed): where a resumed stream continues
        tok = _sample_rows(logits[0, max(len(suffix) - 1, 0)][None], [req.seed],
                           [len(req.committed)], *self._sampling())
        return int(tok.item())

    def _sampling(self) -> tuple:
        return self.cfg.temperature, self.cfg.top_k, self.cfg.top_p

    def _admit(self, completions: List[Completion]) -> None:
        budget = self.cfg.prefill_cap_tokens
        admitted = 0
        jrnl = journal.active()
        while self.pending:
            req = self.pending[0]
            # a resumed request prefills its whole history, prompt and
            # committed tokens, and resumes its stream at len(committed)
            hist = list(req.tokens) + list(req.committed)
            L = len(hist)
            cap = self.tables.max_tokens_per_seq
            if not req.tokens or len(req.tokens) > cap - 1:
                # a prompt must leave room for one decode write
                self.pending.popleft()
                self._deadline_at.pop(req.req_id, None)
                completions.append(Completion(
                    req.req_id, len(req.tokens), list(req.committed), "rejected",
                    timing=self._finish_timing(req.req_id, "rejected")))
                continue
            if L > cap:
                # a resumption already past the horizon: the uninterrupted run
                # overflow-evicted here, with these tokens
                self.pending.popleft()
                self._deadline_at.pop(req.req_id, None)
                completions.append(Completion(
                    req.req_id, len(req.tokens), list(req.committed), "overflow",
                    timing=self._finish_timing(req.req_id, "overflow")))
                continue
            slot = self.tables.find_free_slot()
            if slot is None:
                break   # checked before the prefix match: a stalled queue costs O(1)
            run, covered = self.prefix.match(hist) if self.prefix is not None else ([], 0)
            P = self._bucket(L - covered)
            if admitted and P > budget:
                break   # the fairness cap, never starving an empty tick
            if run:
                self.tables.share(slot, run)
            cow_pairs: List[tuple] = []
            if not (self._grow(slot, min(L + 1, cap))
                    and self._cow_if_shared(slot, covered, cow_pairs)):
                # no pages even after reclaim: roll the slot back empty
                self.stats["freed_pages"] += self.tables.free_slot(slot)
                break
            self.pending.popleft()
            self._flush_cow(cow_pairs)
            suffix = hist[covered:]
            with jrnl.span("serve/prefill", req_id=str(req.req_id), prompt_len=L, padded=P,
                           slot=slot, shared=covered, resumed=len(req.committed)):
                first = self._dispatch_prefill(req, slot, covered, suffix, P)
            budget -= P
            admitted += 1
            self.stats["prefill_dispatches"] += 1
            self.stats["prefill_tokens"] += len(suffix)
            self.stats["padded_prefill_tokens"] += P
            if req.committed:
                self.stats["resumed_requests"] += 1
                self.stats["resumed_tokens"] += len(req.committed)
            if self.prefix is not None:
                if covered:
                    self.stats["prefix_hits"] += 1
                    self.stats["shared_tokens"] += covered
                self.prefix.register(slot, hist)
            state = _Slot(req=req, cache_len=L, last_tok=first,
                          budget=req.max_new_tokens or self.cfg.max_new_tokens)
            state.gen = list(req.committed) + [first]
            self.slots[slot] = state
            self.times.first_token(req.req_id, self.stats["ticks"])
            if self.metrics is not None:
                self.metrics.on_first_token(req.req_id)
            self._maybe_finish(slot, completions)

    def _maybe_finish(self, slot: int, completions: List[Completion], overflow: bool = False,
                      timeout: bool = False) -> None:
        s = self.slots[slot]
        reason = None
        if overflow:
            reason = "overflow"
        elif timeout:
            reason = "timeout"
        elif self.cfg.eos_id is not None and s.gen and s.gen[-1] == self.cfg.eos_id:
            reason = "eos"
        elif len(s.gen) >= s.budget:
            reason = "length"
        if reason is None:
            return
        with journal.active().span("serve/evict", req_id=str(s.req.req_id), slot=slot,
                                   reason=reason, n_generated=len(s.gen)):
            # evicting a sharer whose pages outlive it frees no physical page
            self.stats["freed_pages"] += self.tables.free_slot(slot)
            self.slots[slot] = None
            self.stats["evictions"] += 1
            if reason == "timeout":
                self.stats["timeouts"] += 1
        self._deadline_at.pop(s.req.req_id, None)
        completions.append(Completion(s.req.req_id, len(s.req.tokens), list(s.gen), reason,
                                      timing=self._finish_timing(s.req.req_id, reason)))

    def _decode(self, completions: List[Completion]) -> None:
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        # one write a slot this tick (a shared boundary page copied first); a
        # slot the pool cannot serve even after reclaim is evicted as overflow
        cow_pairs: List[tuple] = []
        for i in list(active):
            s = self.slots[i]
            if not (self._grow(i, s.cache_len + 1)
                    and self._cow_if_shared(i, s.cache_len, cow_pairs)):
                self._maybe_finish(i, completions, overflow=True)
                active.remove(i)
        if not active:
            return
        self._flush_cow(cow_pairs)
        S, nbw = self.cfg.max_seqs, self.tables.max_blocks_per_seq
        host = np.zeros((S, nbw + 3), np.int64)   # tables, lens, last token, active
        host[:, :nbw] = self.tables.tables
        seeds, counts = [0] * S, [0] * S
        for i in active:
            s = self.slots[i]
            host[i, nbw:] = s.cache_len, s.last_tok, 1
            seeds[i], counts[i] = s.req.seed, len(s.gen)   # the index being sampled
        with journal.active().span("serve/decode_tick", batch=len(active)):
            dev = self._to_device(host)
            tables, lens, last = dev[:, :nbw], dev[:, nbw], dev[:, nbw + 1]
            act = dev[:, nbw + 2] == 1
            self._guard("decode", (tables, lens, last, act, np.asarray(seeds, np.uint32),
                                   np.asarray(counts, np.int32)))
            logits, self.pages = self.model.decode_paged(self.params, last[:, None], self.pages,
                                                         tables, lens, act[:, None])
            toks = _sample_rows(logits[:, -1], seeds, counts, *self._sampling()).tolist()
        self.stats["decode_ticks"] += 1
        self.stats["decode_tokens"] += len(active)
        for i in active:
            s = self.slots[i]
            s.cache_len += 1
            s.last_tok = toks[i]
            s.gen.append(toks[i])
            self._maybe_finish(i, completions)

    def _expire_deadlines(self, completions: List[Completion]) -> None:
        """Evict every request past its deadline with the ``timeout``
        status (partial output attached), at the tick boundary, before
        admission and decode."""
        if not self._deadline_at:
            return
        now = self._now()
        jrnl = journal.active()
        keep: deque = deque()
        while self.pending:
            req = self.pending.popleft()
            at = self._deadline_at.get(req.req_id)
            if at is not None and now >= at:
                self._deadline_at.pop(req.req_id, None)
                self.stats["timeouts"] += 1
                jrnl.event("serve/timeout", req_id=str(req.req_id), where="pending",
                           n_generated=len(req.committed))
                completions.append(Completion(
                    req.req_id, len(req.tokens), list(req.committed), "timeout",
                    timing=self._finish_timing(req.req_id, "timeout")))
            else:
                keep.append(req)
        self.pending = keep
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            at = self._deadline_at.get(s.req.req_id)
            if at is not None and now >= at:
                self._maybe_finish(i, completions, timeout=True)

    def step(self) -> List[Completion]:
        """One engine tick: expire deadlines, admit and prefill under the
        fairness cap, then one decode dispatch over the rolling batch.
        Returns the requests that finished this tick."""
        completions: List[Completion] = []
        self.stats["ticks"] += 1
        self._expire_deadlines(completions)
        with journal.active().span("serve/admit", pending=len(self.pending)):
            self._admit(completions)
        if self.metrics is not None:
            t0 = self._now()
            tok0 = self.stats["decode_tokens"]
        self._decode(completions)
        if self.metrics is not None:
            # a token's decode interval: the tick's wall time over its tokens
            made = self.stats["decode_tokens"] - tok0
            if made > 0:
                self.metrics.on_decode_tick((self._now() - t0) * 1e3 / made, made)
            self.metrics.set_gauges(**self._gauge_snapshot())
            if self.metrics.maybe_drain(self.stats["ticks"]) is not None:
                journal.active().event("serve_stats", **self.stats)
        return completions

    def _gauge_snapshot(self) -> Dict[str, float]:
        """Live gauges for the metrics drain, all host scalars."""
        g = {"queue_depth": len(self.pending),
             "active_slots": sum(s is not None for s in self.slots),
             "pages_allocated": self.tables.pages_allocated,
             "free_blocks": self.tables.free_blocks,
             "evictions": self.stats["evictions"],
             "timeouts": self.stats["timeouts"]}
        if self.prefix is not None:
            g["prefix_hit_rate"] = (self.stats["prefix_hits"]
                                    / max(self.stats["prefill_dispatches"], 1))
            g["cow_copies"] = self.stats["cow_copies"]
        return g

    # ---------------------------------------------------- draining a workload
    def run(self, requests: List[Request], arrivals: Optional[Dict[Any, int]] = None,
            max_ticks: int = 100_000) -> Dict[Any, Completion]:
        """Drain a workload: ``arrivals`` maps req_id to the tick at which the
        request becomes visible (default 0), the staggered-arrival harness."""
        arrivals = arrivals or {}
        todo = sorted(requests, key=lambda r: arrivals.get(r.req_id, 0))
        out: Dict[Any, Completion] = {}
        tick = 0
        while todo or self.has_work():
            while todo and arrivals.get(todo[0].req_id, 0) <= tick:
                self.submit(todo.pop(0))
            for c in self.step():
                out[c.req_id] = c
            tick += 1
            if tick > max_ticks:
                raise RuntimeError(
                    f"serving engine did not drain within {max_ticks} ticks "
                    f"({len(self.pending)} pending, "
                    f"{sum(s is not None for s in self.slots)} active)")
        return out
