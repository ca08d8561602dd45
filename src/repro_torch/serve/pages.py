"""Paged KV-cache bookkeeping: page pool, block tables, prefix sharing
(counterpart of ``repro/serve/pages.py``, the whole module, with the same
names and the same page ids, refcounts and reports).

The serving cache is re-laid as a **pool of fixed-size pages** indexed
through per-slot block tables (DESIGN.md §18):

* :class:`PagePool` owns the physical pages: a free list, per-page
  refcounts, and a radix-style prefix index that hash-conses token-id
  prefixes (one node per page, keyed by its token tuple under its
  parent) so requests sharing a prompt prefix share physical pages.
* Block tables are plain host-side ``np.int32 [B, pages_per_slot]``
  arrays owned by the engine; the pool only tracks which pages they
  reference (refcounts), never the tables themselves.
* Copy-on-write: a page referenced by more than one table entry -- or
  frozen immutable by the prefix index -- is copied before a slot writes
  into it (:func:`copy_page` copies the whole page in place across all
  attention layers' pools).
* Eviction is page-level: retiring a slot only drops its references;
  pages held by the prefix index stay cached (a warm prefix cache) until
  allocation pressure evicts idle leaves LRU-first.

For ``kv_bits`` in {4, 2} the cache stores bit-dense int32 words
(``32 // kv_bits`` values per word), so ``page_size`` must be a multiple
of that word-packing tail: every page then holds whole words and is
independently dequantizable, and the per-(pos, kv-head) scale planes page
alongside the words (:func:`validate_page_size`).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.parallel import sharding

__all__ = ["PagePool", "copy_page", "page_granularity", "validate_page_size"]


def page_granularity(kv_bits: int) -> int:
    """Token-count granularity a page must respect for ``kv_bits``.

    Sub-byte caches store ``32 // kv_bits`` values per int32 word
    (attention.kv_quantize via packing.pack_words), so pages sized to a
    multiple of that tail always hold whole packed words — vector-lane
    loads over page rows never straddle a page boundary and each page
    dequantizes independently.  bf16 / int8 layouts have no tail (1).
    """
    return 32 // kv_bits if kv_bits in (4, 2) else 1


def validate_page_size(page_size: int, kv_bits: int) -> None:
    """Raise unless ``page_size`` respects the word-packing tail."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    g = page_granularity(kv_bits)
    if page_size % g:
        raise ValueError(
            f"page_size {page_size} is not a multiple of the {kv_bits}-bit "
            f"word-packing tail ({g} values per int32 word, "
            f"packing.LAYOUT_FAMILY); pages must hold whole packed words "
            f"to stay independently dequantizable (DESIGN.md §18)")


def copy_page(caches, src: int, dst: int):
    """Copy physical page ``src`` -> ``dst`` in every attn pool leaf, in
    place.

    The COW primitive: one whole-page device copy per (layer, leaf) --
    words and their scale planes move together, so the copy is exact at
    any ``kv_bits``.  Where the reference returns new arrays
    (``.at[dst].set``), the port copies into the existing tensors, so
    every cache leaf keeps its ``data_ptr()`` (the serving steps write
    into fixed addresses).  Returns ``caches``."""
    for layer in caches:
        sub = layer.get("attn")
        if isinstance(sub, dict):
            for leaf in sub.values():
                for buf in sharding.parts(leaf):    # each kv-head shard's
                    buf[dst].copy_(buf[src])
    return caches


@dataclasses.dataclass
class _Node:
    """One cached prefix page: ``tokens`` (<= page_size ids) stored at
    physical page ``page``, chained under ``parent`` (None = root).
    Only full pages carry children — a partial tail is a leaf, because
    positions past its token count are unwritten."""

    tokens: tuple
    page: int
    parent: "_Node | None"
    children: dict = dataclasses.field(default_factory=dict)
    stamp: int = 0


class PagePool:
    """Refcounted page pool + radix-style prefix index (DESIGN.md §18;
    the module docstring carries the layout story).

    Units: ``page_size`` counts token *rows*, not bytes, and must pass
    :func:`validate_page_size` — a multiple of the sub-byte word-packing
    granularity (8 rows at 4-bit KV, 16 at 2-bit) so every page holds
    whole packed words and dequantizes independently.

    Refcount convention: ``alloc`` hands pages out at ref 1 (the caller's
    block-table reference); ``retain``/``release`` adjust for sharing; a
    page registered in the prefix index holds one extra ref and is marked
    immutable, so it survives slot retirement (ref >= 1) and any writer
    must COW first.  ``ref == 0`` returns the page to the free list.
    """

    def __init__(self, num_pages: int, page_size: int, kv_bits: int = 0):
        validate_page_size(page_size, kv_bits)
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.kv_bits = int(kv_bits)
        self.ref = np.zeros(self.num_pages, np.int64)
        self._immutable = np.zeros(self.num_pages, bool)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._top: dict = {}                 # root children: tokens -> _Node
        self._node_of_page: dict[int, _Node] = {}
        self._clock = itertools.count(1)
        # counters surfaced through capacity_report (DESIGN.md §18)
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------------
    # Physical pages
    # ------------------------------------------------------------------

    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` pages at ref 1, evicting idle prefix leaves
        (LRU-first) under pressure.  All-or-nothing: returns None — with
        nothing taken — when even eviction cannot satisfy the request,
        so admission can simply leave the request queued."""
        out: list[int] = []
        while len(out) < n:
            if not self._free and not self._evict_one():
                for p in out:
                    self.ref[p] = 0
                    self._free.append(p)
                return None
            p = self._free.pop()
            self.ref[p] = 1
            self._immutable[p] = False
            out.append(p)
        return out

    def retain(self, page: int) -> None:
        self.ref[page] += 1

    def release(self, page: int) -> None:
        self.ref[page] -= 1
        if self.ref[page] < 0:
            raise RuntimeError(f"page {page} over-released")
        if self.ref[page] == 0:
            self._immutable[page] = False
            self._free.append(page)

    def is_shared(self, page: int) -> bool:
        return bool(self.ref[page] > 1)

    def is_immutable(self, page: int) -> bool:
        return bool(self._immutable[page])

    def _evict_one(self) -> bool:
        """Drop the least-recently-touched idle prefix leaf (ref == 1:
        only the index holds it).  A leaf still shared with a live slot
        (ref > 1) is skipped — and keeps its ancestors pinned, since
        evicting a parent would strand reachable descendants."""
        victim = None
        for node in self._node_of_page.values():
            if node.children or self.ref[node.page] != 1:
                continue
            if victim is None or node.stamp < victim.stamp:
                victim = node
        if victim is None:
            return False
        parent_children = (victim.parent.children if victim.parent
                           else self._top)
        del parent_children[victim.tokens]
        del self._node_of_page[victim.page]
        self.evicted_pages += 1
        self.release(victim.page)            # index ref -> free list
        return True

    # ------------------------------------------------------------------
    # Prefix index (radix over token-id pages)
    # ------------------------------------------------------------------

    def match_prefix(self, tokens, max_tokens: int | None = None):
        """Longest cached prefix of ``tokens`` -> (n_matched, pages).

        ``pages`` is ``[(page, rows_used)]`` covering tokens
        ``0..n_matched-1`` in order; full-page matches descend the radix
        chain, a partial match (against a full page's head or a partial
        tail leaf) ends the walk.  The caller retains every returned
        page before using it.  ``max_tokens`` caps the match (admission
        passes ``len(prompt) - 1`` so the last prompt token — whose
        logits seed generation — is always computed, never skipped).
        """
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if max_tokens is not None:
            toks = toks[:max_tokens]
        ps = self.page_size
        pages: list[tuple[int, int]] = []
        children = self._top
        n = 0
        while n < len(toks):
            chunk = tuple(toks[n:n + ps])
            node = children.get(chunk) if len(chunk) == ps else None
            if node is not None:             # whole page matches: descend
                self._touch(node)
                pages.append((node.page, ps))
                n += ps
                children = node.children
                continue
            best, blen = None, 0
            for ctoks, cnode in children.items():
                m = 0
                for a, b in zip(ctoks, chunk):
                    if a != b:
                        break
                    m += 1
                if m > blen:
                    best, blen = cnode, m
            if blen:
                self._touch(best)
                pages.append((best.page, blen))
                n += blen
            break                            # divergence (or exhausted)
        return n, pages

    def register_prefix(self, tokens, pages) -> int:
        """Hash-cons ``tokens`` (a completed prompt) into the index.

        ``pages[i]`` is the slot's physical page holding token rows
        ``i*page_size..`` — full pages plus the partial tail.  Chunks
        already cached are skipped (the existing node keeps serving
        matches; the duplicate page stays slot-owned and frees at
        retirement).  New nodes retain their page and freeze it
        immutable; the owning slot's next write into a registered page
        (its first generated token landing in the prompt's tail page)
        copy-on-writes — that is the divergence case.  Returns the
        number of pages newly registered.
        """
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        ps = self.page_size
        children = self._top
        parent = None
        added = 0
        for i, start in enumerate(range(0, len(toks), ps)):
            chunk = tuple(toks[start:start + ps])
            node = children.get(chunk)
            if node is None:
                page = int(pages[i])
                node = _Node(tokens=chunk, page=page, parent=parent)
                children[chunk] = node
                self._node_of_page[page] = node
                self.retain(page)
                self._immutable[page] = True
                added += 1
            self._touch(node)
            if len(chunk) < ps:
                break                        # partial tail is a leaf
            parent = node
            children = node.children
        return added

    def _touch(self, node: _Node) -> None:
        node.stamp = next(self._clock)

    # ------------------------------------------------------------------
    # Accounting / serialization
    # ------------------------------------------------------------------

    def report(self) -> dict:
        """Physical-vs-logical page counters for ``capacity_report``."""
        free = len(self._free)
        return {
            "free_pages": free,
            "live_pages": self.num_pages - free,
            "shared_pages": int((self.ref > 1).sum()),
            "cached_prefix_pages": len(self._node_of_page),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.cow_copies,
            "evicted_pages": self.evicted_pages,
        }

    def export_meta(self) -> dict:
        """JSON-able pool state (checkpoint manifest `extra`): refcounts,
        free list, immutability, and the prefix index as a parent-before-
        child node list keyed by page id (drain/restore, DESIGN.md §18)."""
        nodes = []

        def walk(children):
            for node in children.values():
                nodes.append({
                    "tokens": list(node.tokens),
                    "page": int(node.page),
                    "parent_page": (None if node.parent is None
                                    else int(node.parent.page)),
                    "stamp": int(node.stamp),
                })
                walk(node.children)

        walk(self._top)
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "kv_bits": self.kv_bits,
            "ref": [int(r) for r in self.ref],
            "immutable": [bool(b) for b in self._immutable],
            "free": [int(p) for p in self._free],
            "nodes": nodes,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "cow_copies": self.cow_copies,
            "evicted_pages": self.evicted_pages,
        }

    @classmethod
    def from_meta(cls, meta: dict) -> "PagePool":
        pool = cls(meta["num_pages"], meta["page_size"],
                   meta.get("kv_bits", 0))
        pool.ref = np.asarray(meta["ref"], np.int64).copy()
        pool._immutable = np.asarray(meta["immutable"], bool).copy()
        pool._free = [int(p) for p in meta["free"]]
        by_page: dict[int, _Node] = {}
        max_stamp = 0
        for rec in meta["nodes"]:            # parents precede children
            parent = (None if rec["parent_page"] is None
                      else by_page[rec["parent_page"]])
            node = _Node(tokens=tuple(rec["tokens"]), page=rec["page"],
                         parent=parent, stamp=rec.get("stamp", 0))
            (parent.children if parent else pool._top)[node.tokens] = node
            by_page[node.page] = node
            max_stamp = max(max_stamp, node.stamp)
        pool._node_of_page = by_page
        pool._clock = itertools.count(max_stamp + 1)
        pool.prefix_hits = int(meta.get("prefix_hits", 0))
        pool.prefix_hit_tokens = int(meta.get("prefix_hit_tokens", 0))
        pool.cow_copies = int(meta.get("cow_copies", 0))
        pool.evicted_pages = int(meta.get("evicted_pages", 0))
        return pool
