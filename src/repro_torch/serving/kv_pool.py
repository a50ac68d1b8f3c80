"""Paged KV-cache bookkeeping: page allocator + shared-prefix cache.

The port's own copy of ``repro.serving.kv_pool`` (framework-free, copied
rather than imported: the port imports nothing of the JAX package).

The paged ``EngineCore`` replaces its dense ``(slots, N_r + 1 +
max_answer_len)`` slot cache with a pool of fixed-size KV pages addressed
through a per-slot block table.  This module owns the **host-side**
bookkeeping only — the device tensors (the per-layer page pools and the
``(slots, pages)`` block table) live on the engine; what needs careful
invariants is the allocation state:

- ``KVPagePool``   — free-list allocator over a fixed number of pages with
  per-page reference counts.  Page 0 is reserved as the **trash page**: it
  is never allocated, and block-table rows of inactive slots point at it so
  the fixed-shape decode step can keep writing "one token per row" without
  ever touching a page another sequence owns.

- ``PrefixCache``  — scene-keyed LRU over *shared prefix* page groups.  A
  scene's image-region KV occupies whole pages that are mapped read-only
  into every requesting slot's block table (refcount++ per user); the cache
  keeps zero-user entries resident so later queries over the same scene skip
  the region prefill entirely, and evicts them LRU-first under pool
  pressure.

The paged engine's safety argument, in terms of these invariants:

1. a page is referenced by at most one *writer* (the slot whose private
   block-table entries name it) — shared prefix pages have many readers but
   their positions are all ``< N_r`` and decode only ever writes at
   positions ``>= N_r``;
2. freed pages return to the free list only when their refcount reaches
   zero, so a prefix page stays alive while any slot still reads it;
3. the trash page absorbs the writes of inactive / padding rows and is never
   handed out by ``alloc``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

TRASH_PAGE = 0


def page_nbytes(page_size: int, kv_heads: int, head_dim: int, *,
                kv_dtype: Optional[str] = None, fp_bytes: int = 4) -> int:
    """Device bytes ONE page of ONE attention layer's K+V pools costs,
    scale buffers included — the single accounting rule capacity planning
    (``EngineCoreConfig.pool_bytes``) and ``EngineCore.kv_stats`` share.

    fp: ``page·2·KH·hd·fp_bytes``.  int8/fp8: one byte per element plus one
    f32 scale per (token slot, head) — ``page·2·KH·(hd + 4)`` — so the same
    byte budget buys ``≈ fp_bytes·hd/(hd+4)`` × more pages (3.56× for
    hd = 32 over fp32), which is exactly the admission headroom overload
    control gets to spend.  fp8 (e4m3) matches int8 byte-for-byte: the win
    is numerics (relative precision below the row amax) and the native-fp8
    dot path, not bytes."""
    per_tok = 2 * kv_heads * head_dim
    if kv_dtype is None:
        return page_size * per_tok * fp_bytes
    if kv_dtype not in ("int8", "fp8"):
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r} (None, 'int8' or 'fp8')")
    return page_size * (per_tok + 2 * kv_heads * 4)


class KVPagePool:
    """Free-list page allocator with reference counts.

    Pages are plain ``int`` ids in ``[1, n_pages)`` (page 0 is the reserved
    trash page).  ``alloc`` hands out pages with refcount 1; ``incref`` adds
    readers (prefix sharing); ``free`` drops one reference and returns the
    page to the free list when the count reaches zero.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need at least one allocatable page + trash")
        if page_size < 1:
            raise ValueError("page_size must be positive")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, 0, -1))  # pop() → 1 first
        self._ref = [0] * n_pages
        self._ref[TRASH_PAGE] = 1           # permanently held, never freed

    # ------------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    # ------------------------------------------------------------------
    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` pages (refcount 1 each); raises if short."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, pages: Iterable[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("trash page cannot be shared")
            if self._ref[p] <= 0:
                raise ValueError(f"incref on unallocated page {p}")
            self._ref[p] += 1

    def free(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; zero-ref pages return to the pool."""
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("trash page is never freed")
            if self._ref[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)


@dataclasses.dataclass
class PrefixEntry:
    """One resident scene prefix: its shared pages + the recurrent-state
    snapshot taken after the region tokens (pytree, batch row of 1; ``None``
    leaves for pure-attention stacks)."""
    scene: Any
    pages: Tuple[int, ...]
    state: Any
    users: int = 0                      # active slots currently mapping it


class PrefixCache:
    """Scene-keyed LRU of shared prefix page groups.

    The cache itself holds one pool reference per page (taken at ``put``);
    each mapped slot holds one more (``acquire``/``release``).  Eviction only
    considers zero-user entries, so an in-flight request can never lose its
    prefix from under it.
    """

    def __init__(self, pool: KVPagePool, capacity: int):
        self.pool = pool
        self.capacity = capacity
        self._entries: "OrderedDict[Any, PrefixEntry]" = OrderedDict()

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, scene: Any) -> bool:
        return scene in self._entries

    def get(self, scene: Any) -> Optional[PrefixEntry]:
        e = self._entries.get(scene)
        if e is not None:
            self._entries.move_to_end(scene)
        return e

    def put(self, scene: Any, pages: Sequence[int], state: Any
            ) -> PrefixEntry:
        if scene in self._entries:
            raise ValueError(f"scene {scene!r} already resident")
        e = PrefixEntry(scene=scene, pages=tuple(pages), state=state)
        self._entries[scene] = e
        return e

    def acquire(self, scene: Any) -> PrefixEntry:
        """Map a resident prefix into one more slot: users++ / refcount++."""
        e = self._entries[scene]
        e.users += 1
        self.pool.incref(e.pages)
        self._entries.move_to_end(scene)
        return e

    def release(self, scene: Any) -> None:
        e = self._entries[scene]
        if e.users <= 0:
            raise ValueError(f"release of unmapped prefix {scene!r}")
        e.users -= 1
        self.pool.free(e.pages)

    # ------------------------------------------------------------------
    def evictable_pages(self, protect: Optional[Iterable[Any]] = None
                        ) -> int:
        """Pages that ``evict_for`` COULD free right now: the shared pages
        of zero-user entries outside ``protect``.  A pure probe — admission
        control uses ``pool.free_pages + evictable_pages()`` as the page
        headroom a request's worst-case demand is checked against, without
        actually evicting anything for a request that may not be admitted."""
        protected = frozenset(protect or ())
        return sum(len(e.pages) for s, e in self._entries.items()
                   if e.users == 0 and s not in protected)

    def evictable_entries(self, protect: Optional[Iterable[Any]] = None
                          ) -> int:
        """Entry slots ``evict_for`` could free (same probe, capacity axis)."""
        protected = frozenset(protect or ())
        return sum(1 for s, e in self._entries.items()
                   if e.users == 0 and s not in protected)

    def evict_for(self, need_pages: int, need_entries: int = 1,
                  protect: Optional[Iterable[Any]] = None) -> None:
        """Evict zero-user entries (LRU first) until the pool has
        ``need_pages`` free pages and the cache has room for
        ``need_entries`` more entries.  Entries named in ``protect`` are
        never evicted — the paged engine passes the current admission
        batch's scenes so a zero-user prefix a request is *about to*
        acquire can't be evicted from under it.  Raises ``MemoryError`` if
        even full eviction cannot satisfy the request."""
        protected = frozenset(protect or ())

        def satisfied():
            return (self.pool.free_pages >= need_pages
                    and len(self._entries) + need_entries <= self.capacity)

        if satisfied():
            return
        for scene in list(self._entries):
            e = self._entries[scene]
            if e.users > 0 or scene in protected:
                continue
            del self._entries[scene]
            self.pool.free(e.pages)        # the cache's own reference
            if satisfied():
                return
        if not satisfied():
            raise MemoryError(
                f"prefix cache cannot free {need_pages} pages / "
                f"{need_entries} entries (all remaining prefixes in use)")

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "entries_in_use": sum(e.users > 0 for e in self._entries.values()),
            "shared_pages": sum(len(e.pages) for e in self._entries.values()),
        }
