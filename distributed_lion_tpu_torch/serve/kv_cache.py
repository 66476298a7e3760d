"""Paged KV cache: port of ``distributed_lion_tpu/serve/kv_cache.py``.

The vLLM PagedAttention design (Kwon et al., 2023): each layer's cache is
one device tensor, the pool, and a sequence owns an ordered list of page
indices, its block table. All allocation and freeing is host-side integer
table math in this module (numpy and the standard library, the JAX
module's code as it is), so the device sees the same shapes every decode
tick while sequences join and leave the batch (``serve/engine.py``). The
device side is ``ops.attention``'s ``paged_scatter_kv``,
``paged_gather_kv``, ``paged_copy_pages`` and ``paged_decode_attention``.

Sentinel convention: unallocated table entries hold ``num_blocks``. The
port's pool (:func:`init_pages`) keeps one scratch page at that id, past
the ``num_blocks`` real pages: writes to a sentinel entry land there and
gathers from one read zeros, so inactive decode slots and right-padded
prefill tails are inert without a host branch. The scratch page is never
read, never allocated and never counted here.

Prefix sharing: every page carries a refcount. ``grow`` mints ref-1
pages; :meth:`BlockTables.share` points an empty slot's leading entries at
pages another sequence (or the :class:`PrefixCache`) owns, bumping their
refs; ``shrink`` and ``free_slot`` release refs, and a page returns to the
free list only at ref 0. N requests carrying the same system prompt hold
one physical copy of its pages. A write into a ref > 1 page is forbidden:
the engine first calls :meth:`BlockTables.cow`, whose device copy is
``ops.attention.paged_copy_pages``, so the first divergent write targets a
private copy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def init_pages(n_layer: int, num_blocks: int, block_size: int, kv_heads: int,
               head_dim: int, dtype, device) -> list:
    """The per-layer page pool on ``device``: ``[{"k", "v"}] * n_layer`` of
    zeros ``[num_blocks + 1, block_size, kv_heads, head_dim]``, the last
    page the scratch page (module doc). Allocated once at engine start;
    the ticks write it in place."""
    shape = (num_blocks + 1, block_size, kv_heads, head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(n_layer)]


def bucket_tokens(n: int, block_size: int, max_blocks_per_seq: int) -> int:
    """Padded prefill length for an ``n``-token prompt: power-of-two
    pages, so prompt-length variety costs O(log(max)) operand shapes, not
    one per length (the engine's retrace guard counts them). The one
    bucketing rule of every prefill. For MoE checkpoints the bucket
    also sizes the no-drop expert dispatch buffer ([E, bucket, D] per MoE
    block, models/gpt2._decode_mlp): pad lanes are valid-masked out of
    routing, so the bucket choice changes memory, never an output."""
    blocks = 1
    while blocks * block_size < n:
        blocks *= 2
    return min(blocks, max_blocks_per_seq) * block_size


class BlockTables:
    """Host-side page allocator + per-slot block tables.

    ``tables`` is the ``[max_seqs, max_blocks_per_seq]`` int32 array the
    engine ships to the device each tick (sentinel-padded); ``owned[slot]``
    counts the pages slot currently holds. Pure numpy/stdlib — this is
    the host half of the paged design.
    """

    def __init__(self, num_blocks: int, block_size: int, max_seqs: int,
                 max_blocks_per_seq: int, groups: int = 1):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need positive pool dims, got num_blocks={num_blocks} "
                f"block_size={block_size}")
        if groups < 1 or num_blocks % groups or max_seqs % groups:
            raise ValueError(
                f"groups={groups} must divide num_blocks={num_blocks} and "
                f"max_seqs={max_seqs}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_seqs = int(max_seqs)
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.sentinel = self.num_blocks
        # ``groups`` contiguous spans of the pool (batch-sharded expert
        # serving's layout, kept here as the JAX module has it; the port's
        # engine runs one group): group g owns pages [g*bpg, (g+1)*bpg)
        # and slots [g*spg, (g+1)*spg), so a slot's table entries minus
        # the group base are the group's local page ids.
        self.groups = int(groups)
        self.blocks_per_group = self.num_blocks // self.groups
        self.slots_per_group = self.max_seqs // self.groups
        # per-group LIFO free lists: recently-freed pages are re-used
        # first, which keeps the working set of the pool small and
        # cache-warm. groups=1 is bit-identical to the historical single
        # list (same pop/append order).
        bpg = self.blocks_per_group
        self._free = [list(range((g + 1) * bpg - 1, g * bpg - 1, -1))
                      for g in range(self.groups)]
        self.tables = np.full((max_seqs, max_blocks_per_seq), self.sentinel,
                              np.int32)
        self.owned = np.zeros((max_seqs,), np.int32)
        # per-page refcounts: a table entry AND a PrefixCache registration
        # each hold one ref; a page is free iff refs == 0 (then it sits on
        # the free list). pages_allocated counts every mint (grow pops +
        # CoW pops) — the bench's physical-page ledger.
        self.refs = np.zeros((self.num_blocks,), np.int32)
        self.pages_allocated = 0

    # ------------------------------------------------------------ capacity
    @property
    def free_blocks(self) -> int:
        return sum(len(f) for f in self._free)

    def group_of(self, slot: int) -> int:
        """The pool group ``slot`` allocates from (group 0 covers
        everything when groups == 1)."""
        return int(slot) // self.slots_per_group

    def group_base(self, group: int) -> int:
        """First page id of ``group``'s pool span — subtract it from a
        table entry to get the shard-LOCAL page id."""
        return int(group) * self.blocks_per_group

    def free_blocks_in(self, group: int) -> int:
        return len(self._free[group])

    @property
    def max_tokens_per_seq(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache entries."""
        return -(-max(n_tokens, 0) // self.block_size)

    def can_grow(self, slot: int, n_tokens: int) -> bool:
        """Would :meth:`grow` succeed for ``n_tokens`` total tokens?"""
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks_per_seq:
            return False
        return need - int(self.owned[slot]) <= len(
            self._free[self.group_of(slot)])

    # ---------------------------------------------------------- alloc/free
    def _mint(self, group: int = 0) -> int:
        """Pop a fresh page off ``group``'s free list at ref 1 (counted)."""
        p = self._free[group].pop()
        assert self.refs[p] == 0, f"page {p} on the free list with refs"
        self.refs[p] = 1
        self.pages_allocated += 1
        return p

    def _release(self, page: int) -> int:
        """Drop one ref; the page returns to its group's LIFO free list
        only at ref 0. Returns 1 when the page was physically freed."""
        page = int(page)
        assert self.refs[page] > 0, f"double free of page {page}"
        self.refs[page] -= 1
        if self.refs[page] == 0:
            self._free[page // self.blocks_per_group].append(page)
            return 1
        return 0

    def grow(self, slot: int, n_tokens: int) -> bool:
        """Ensure ``slot``'s table covers ``n_tokens`` total cache
        entries, allocating pages as needed. Returns False (allocating
        NOTHING — all-or-nothing, so a half-grown slot can't strand
        pages) when the pool or the table width can't fit it."""
        if not self.can_grow(slot, n_tokens):
            return False
        need = self.blocks_for(n_tokens)
        have = int(self.owned[slot])
        if need <= have:
            # grow never shrinks: writing owned = need here would orphan
            # the tail pages' refs (table entries past owned are invisible
            # to every release path) — the refcount fuzz test caught this
            return True
        g = self.group_of(slot)
        for i in range(have, need):
            self.tables[slot, i] = self._mint(g)
        self.owned[slot] = need
        return True

    def shrink(self, slot: int, n_tokens: int) -> int:
        """Release ``slot``'s pages beyond those ``n_tokens`` total cache
        entries need — the EXACT inverse of :meth:`grow`: ref-1 pages
        return to the LIFO free list in reverse allocation order, so
        ``grow(slot, a); shrink(slot, b)`` leaves the allocator (tables,
        owned, free-list order) bit-identical to ``grow(slot, b)`` for any
        ``b <= a``. This is the speculative-decode rollback primitive: a
        verify window optimistically grows the table for k draft tokens
        and the rejected tail's pages are handed back as if they were never
        allocated. SHARED tail pages (refs > 1 — a rollback over a shared
        prefix) only drop this slot's ref: the physical page survives for
        its other holders. Returns the count of pages physically freed."""
        need = self.blocks_for(n_tokens)
        have = int(self.owned[slot])
        if need >= have:
            return 0
        freed = 0
        for i in range(have - 1, need - 1, -1):
            freed += self._release(self.tables[slot, i])
            self.tables[slot, i] = self.sentinel
        self.owned[slot] = need
        return freed

    def free_slot(self, slot: int) -> int:
        """Release all of ``slot``'s refs; the table row goes back to
        sentinel (inert on device). Returns the count of pages physically
        freed — evicting a sharer whose pages all outlive it (the prefix
        cache or another slot still holds them) frees ZERO pages, and the
        engine's accounting must say so."""
        n = int(self.owned[slot])
        freed = 0
        for i in range(n):
            freed += self._release(self.tables[slot, i])
        self.tables[slot, :] = self.sentinel
        self.owned[slot] = 0
        return freed

    def find_free_slot(self) -> Optional[int]:
        """Lowest slot index owning zero pages (the engine marks a slot
        occupied by growing it; completed slots are freed)."""
        for s in range(self.max_seqs):
            if self.owned[s] == 0:
                return s
        return None

    # ------------------------------------------------------ prefix sharing
    def share(self, slot: int, pages: list) -> None:
        """Point an EMPTY slot's leading table entries at already-owned
        pages (a prefix-cache hit), taking one ref per page. ``grow`` then
        extends the row with fresh private pages as usual."""
        if int(self.owned[slot]) != 0:
            raise ValueError(
                f"share() needs an empty slot, slot {slot} owns "
                f"{int(self.owned[slot])} pages")
        if len(pages) > self.max_blocks_per_seq:
            raise ValueError(
                f"shared run of {len(pages)} pages exceeds the table "
                f"width {self.max_blocks_per_seq}")
        g = self.group_of(slot)
        for i, p in enumerate(pages):
            assert self.refs[p] > 0, f"sharing unowned page {p}"
            assert int(p) // self.blocks_per_group == g, (
                f"page {p} belongs to group "
                f"{int(p) // self.blocks_per_group}, slot {slot} is in "
                f"group {g} — prefix sharing is group-local")
            self.tables[slot, i] = int(p)
            self.refs[p] += 1
        self.owned[slot] = len(pages)

    def page_at(self, slot: int, pos: int) -> int:
        """The page id holding cache position ``pos`` of ``slot``."""
        return int(self.tables[slot, pos // self.block_size])

    def shared_at(self, slot: int, pos: int) -> bool:
        """True when the page holding ``pos`` is shared (refs > 1) — a
        write there needs :meth:`cow` first."""
        idx = pos // self.block_size
        if idx >= int(self.owned[slot]):
            return False
        return int(self.refs[self.tables[slot, idx]]) > 1

    def cow(self, slot: int, pos: int) -> Optional[tuple]:
        """Copy-on-write: replace the shared page holding ``pos`` with a
        fresh private page (the caller device-copies the content via
        ``ops.attention.paged_copy_pages`` before any write lands).
        Returns ``(src_page, dst_page)`` — or None when the pool is dry
        (caller falls back to reclaim/overflow, nothing changed)."""
        idx = pos // self.block_size
        src = int(self.tables[slot, idx])
        assert self.refs[src] > 1, \
            f"cow on unshared page {src} (slot {slot} pos {pos})"
        g = self.group_of(slot)
        if not self._free[g]:
            return None
        dst = self._mint(g)
        self.refs[src] -= 1  # > 0 by the assert: never returns to the pool
        self.tables[slot, idx] = dst
        return src, dst

    # ----------------------------------------------- cache-side ref plumbing
    def add_ref(self, page: int) -> None:
        """One more holder of ``page`` (the PrefixCache's registration)."""
        assert self.refs[page] > 0, f"ref on unowned page {page}"
        self.refs[page] += 1

    def release_page(self, page: int) -> int:
        """Drop a non-table ref (PrefixCache eviction). Returns 1 when the
        page was physically freed."""
        return self._release(page)

    @property
    def physical_pages(self) -> int:
        """Pages currently holding data (refs > 0)."""
        return self.num_blocks - self.free_blocks


class PrefixCache:
    """Prompt-prefix → page-run cache over a :class:`BlockTables` pool.

    Keys are the literal token tuples a page's content depends on (causal
    attention: page ``i``'s k/v are a pure function of ``tokens[:cover]``
    where ``cover`` is the page's last covered position + 1), so a hit can
    never alias two different prefixes — no hash-collision risk, and the
    chain walk is one dict probe per page. Entries hold one allocator ref
    each (``BlockTables.add_ref``), so cached pages survive their creating
    request; :meth:`reclaim` drops least-recently-used chains when the
    engine needs pages back.

    Full pages register under their exact coverage key; a PARTIAL tail
    page (a prompt whose length is not a page multiple) registers under
    every prefix of its coverage too — page content at offsets < t depends
    only on ``tokens[:k*bs + t]``, so a request matching just a prefix of
    the partial page may still share it (its first own write then lands
    inside the shared page and triggers the engine's CoW). Matches are
    capped at ``len(prompt) - 1``: a request must always prefill at least
    its last prompt token to produce the logits its first sample needs.
    """

    def __init__(self, tables: BlockTables, group: Optional[int] = None):
        self.tables = tables
        # one PrefixCache per pool group (sharing is group-local);
        # ``group`` scopes reclaim's free-count check to that group's
        # span. None = the whole pool.
        self.group = group
        self.bs = tables.block_size
        # key (token tuple) -> {"page": id, "full": bool, "tick": lru}
        # partial pages appear under EVERY prefix key of their coverage;
        # all keys of one physical page share the ONE entry dict, so a
        # touch through any key refreshes the whole page's recency
        self._entries = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.reclaimed_pages = 0

    def __len__(self) -> int:
        return len({id(e) for e in self._entries.values()})

    def _touch(self, entry: dict) -> None:
        self._tick += 1
        entry["tick"] = self._tick

    # --------------------------------------------------------------- match
    def match(self, tokens: list) -> tuple:
        """Longest cached prefix of ``tokens`` usable by a new request:
        ``(pages, covered)`` with ``covered <= len(tokens) - 1`` (the last
        prompt token always prefills — see class doc). Pages are returned
        in table order; the caller shares them into a slot via
        :meth:`BlockTables.share` BEFORE growing the private tail."""
        L = len(tokens)
        pages, covered = [], 0
        while covered + self.bs <= L - 1:
            e = self._entries.get(tuple(tokens[:covered + self.bs]))
            if e is None or not e["full"]:
                break
            pages.append(e["page"])
            self._touch(e)
            covered += self.bs
        # a full page whose coverage ends EXACTLY at the prompt end may
        # still be shared for its first bs-1 tokens (the last prompt token
        # re-prefills through the engine's CoW copy — identical k/v, but
        # its logits must be computed for this request's first sample)
        if covered + self.bs == L:
            e = self._entries.get(tuple(tokens[:L]))
            if e is not None and e["full"]:
                pages.append(e["page"])
                self._touch(e)
                covered += self.bs - 1
        # the partial tail: longest registered prefix of the next page
        # (an empty range when the edge above already covered L-1)
        for t in range(min(self.bs - 1, L - 1 - covered), 0, -1):
            e = self._entries.get(tuple(tokens[:covered + t]))
            if e is not None and not e["full"]:
                pages.append(e["page"])
                self._touch(e)
                covered += t
                break
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return pages, covered

    # ------------------------------------------------------------ register
    def register(self, slot: int, tokens: list) -> int:
        """Bank ``slot``'s freshly-prefilled prompt pages: one entry per
        full page plus the partial tail (under all its prefix keys).
        Already-cached keys are touched, not re-registered — a sharer's
        own table entries ARE the cached pages for the shared span, so the
        walk naturally skips them. Returns the number of NEW pages the
        cache took a ref on."""
        bt = self.tables
        L = len(tokens)
        added = 0
        for k in range(L // self.bs):
            key = tuple(tokens[:(k + 1) * self.bs])
            e = self._entries.get(key)
            if e is not None:
                self._touch(e)
                continue
            page = int(bt.tables[slot, k])
            bt.add_ref(page)
            entry = {"page": page, "full": True, "tick": 0}
            self._touch(entry)
            self._entries[key] = entry
            added += 1
        rem = L % self.bs
        if rem:
            full_key = tuple(tokens[:L])
            if full_key not in self._entries:
                page = int(bt.tables[slot, L // self.bs])
                bt.add_ref(page)
                entry = {"page": page, "full": False, "tick": 0}
                self._touch(entry)
                for t in range(1, rem + 1):
                    # prefix keys may already belong to an older entry on
                    # the same chain — first registration wins (both
                    # contents are valid for that prefix; the outer
                    # full-coverage guard means t == rem is always new)
                    key = tuple(tokens[:L - rem + t])
                    if key not in self._entries:
                        self._entries[key] = entry
                added += 1
        return added

    # ------------------------------------------------------------- reclaim
    def chains(self) -> list:
        """The MAXIMAL cached token prefixes, as token lists — the
        restart-persistence export (serve/fleet_state): a key is maximal
        when no other key extends it, so re-prefilling just these chains
        on a fresh fleet re-banks every cached page (every shorter prefix
        registers along the way). O(n²) over entry keys — the cache holds
        tens of chains, not thousands, and this runs on the persistence
        cadence, never per tick."""
        keys = list(self._entries)
        return sorted(
            (list(k) for k in keys
             if not any(len(o) > len(k) and o[:len(k)] == k
                        for o in keys)),
            key=lambda c: (len(c), c))

    def reclaim(self, n_pages: int) -> int:
        """Drop least-recently-used cached pages until ``n_pages`` are
        physically free (or the cache is empty). Evicting a page also
        evicts every longer chain that extends through it — a child whose
        parent is gone can never be matched again and would leak its ref.
        Returns the count of pages physically freed."""
        freed = 0

        def _free_now():
            if self.group is None:
                return self.tables.free_blocks
            return self.tables.free_blocks_in(self.group)

        while _free_now() < n_pages and self._entries:
            # distinct entries, oldest first
            oldest = min({id(e): e for e in self._entries.values()}.values(),
                         key=lambda e: e["tick"])
            roots = sorted((k for k, e in self._entries.items()
                            if e is oldest), key=len)
            # phase 1: a key extending any victim key is a descendant —
            # its whole ENTRY dies (an entry whose page ref is released
            # must lose every key, or a surviving shorter prefix key
            # would dangle onto a freed page)
            dead = {id(oldest): oldest}
            for key, e in self._entries.items():
                if any(len(key) >= len(r) and key[:len(r)] == r
                       for r in roots):
                    dead[id(e)] = e
            # phase 2: drop every key of every dead entry, then the refs
            self._entries = {k: e for k, e in self._entries.items()
                             if id(e) not in dead}
            for e in dead.values():
                n = self.tables.release_page(e["page"])
                freed += n
                self.reclaimed_pages += n
        return freed
