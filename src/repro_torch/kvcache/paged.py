"""Paged KV cache: block-table allocator + device page pool.

Two layers, mirroring vLLM's split (§2.1, [21]):

* ``PagedAllocator`` — host-side bookkeeping: free-list, per-request page
  lists, refcounts, the cross-request prefix cache, watermark/swap
  accounting.  The decode-instance schedulers (greedy / reserve-static /
  reserve-dynamic, §3.4) make admission decisions against this, and the
  cluster monitor broadcasts its load.
* ``PagePool`` — the device-side tensors (layers, n_pages, page, kvh, hd)
  plus in-place scatter/gather ops.  The serving engines attend against it
  through the hand-written CUDA paged-prefill and paged-decode kernels
  (``kernels/``); ``gather``/``install``
  are the page-granular KV-transfer endpoints.  Engines reserve one extra
  physical page past the allocator's range as a scratch ("trash") page:
  pad tokens and dead slots scatter there and no block table references
  it.

Ownership model (docs/prefix_cache.md): every physical page carries a
refcount — one per block table referencing it plus one if a cache entry
holds it.  Pages return to the free list only at refcount zero, so
``free``/``trim`` are decrefs, never unconditional releases.  With
``prefix_cache=True`` full prompt-prefix pages get a content-hash
identity (chain hash, ``prefix_page_keys``): ``alloc`` aliases the
leading run of already-cached pages read-only instead of drawing fresh
ones, ``commit`` publishes a finished request's pages under their keys,
and cache-only entries (refcount 1) are LRU-evicted under pressure.
``append_token`` never writes into a shared page: it copy-on-writes to a
fresh page and records the (src, dst) pair for the engine to replay on
the device pool.  The same refcounts dedupe read-only cross pages
(``cross_key``): N requests sharing one image/audio run the encoder
once.  With the flag off (default) no aliasing ever happens, every
refcount stays 1, and free-list order is byte-identical to the
pre-cache allocator.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch


class OutOfPages(Exception):
    pass


def window_dead_pages(n_tokens: int, window: int, page_size: int) -> int:
    """Leading pages wholly outside a sliding window once ``n_tokens``
    are present: every future query sits at position >= n_tokens and
    attends keys > pos - window, so a page is dead iff its last token
    <= n_tokens - window.  The single source of this arithmetic — the
    allocator, the KV-transfer accounting and the kernels' skip logic
    all must agree with it."""
    if not window:
        return 0
    return max(0, n_tokens - window + 1) // page_size


def prefix_page_keys(tokens, page_size: int) -> List[bytes]:
    """Content-hash identity for every FULL page of a token sequence.

    Chain hash: page i's key digests (key of page i-1, page i's token
    ids), so a key identifies the whole prefix up to and including that
    page, not just the page's own tokens — two prompts share key i iff
    they share their first (i+1)*page_size tokens.  KV content for a
    prefix token depends only on the prefix tokens and their positions
    (causal attention, deterministic kernels), so equal keys imply
    byte-equal pool pages."""
    toks = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    keys: List[bytes] = []
    prev = b""
    for i in range(len(toks) // page_size):
        prev = hashlib.sha1(
            prev + toks[i * page_size:(i + 1) * page_size].tobytes()
        ).digest()
        keys.append(prev)
    return keys


def request_page_keys(req, page_size: int) -> Optional[List[bytes]]:
    """Prefix-cache keys for a Request, or None if it has no cacheable
    identity.  Engine requests carry real token ids -> chain content
    hash.  Sim requests have no tokens; when the workload stamped a
    shared ``prefix_id`` the cost model keys the leading
    ``prefix_len``-token pages off that id instead (same sharing
    structure, fictional content)."""
    if req.prompt_tokens is not None:
        return prefix_page_keys(req.prompt_tokens, page_size)
    if getattr(req, "prefix_id", None):
        n = min(req.prefix_len, req.prompt_len) // page_size
        return [hashlib.sha1(f"sim:{req.prefix_id}:{i}".encode()).digest()
                for i in range(n)]
    return None


def request_cross_key(req) -> Optional[bytes]:
    """Content identity of a request's encoder input (cross-KV dedupe):
    requests with byte-equal ``enc_embeds`` produce byte-equal cross
    pages, so they can share one read-only set and one encoder run."""
    if req.enc_embeds is None:
        return None
    emb = np.ascontiguousarray(np.asarray(req.enc_embeds))
    return hashlib.sha1(emb.tobytes()).digest()


def _locked(fn):
    """Run an allocator method inside ``_mutate()`` (see below): one
    reentrant lock per allocator serializes every mutation and every
    compound admission read against concurrent workers."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._mutate():
            return fn(self, *args, **kwargs)
    return wrapper


@dataclasses.dataclass
class PagedAllocator:
    """Free-list page allocator with per-request block tables.

    ``window > 0`` makes the allocator sliding-window aware: block-table
    slots whose pages slid wholly out of the attention window are freed
    (the slot entry becomes ``None`` — engines point it at the scratch
    page), so a windowed request holds O(window) physical pages while its
    logical table keeps absolute slot indexing for the kernels.

    ``cross_tokens > 0`` (VLM / enc-dec archs) makes every request also
    hold a READ-ONLY cross-attention block table: ``alloc`` draws the
    cross pages from the same free list, they are never appended to or
    trimmed (the encoder output is fixed for the request's lifetime),
    and ``free`` decrefs them exactly once.

    ``prefix_cache=True`` enables cross-request page sharing: see the
    module docstring for the ownership model.  The flag only gates the
    *cache* (aliasing on alloc, commit, LRU eviction); refcounts and
    copy-on-write are always live so explicit ``fork`` sharing is safe
    either way.
    """
    n_pages: int
    page_size: int
    window: int = 0
    cross_tokens: int = 0
    prefix_cache: bool = False

    def __post_init__(self):
        # -- thread safety (docs/async_runtime.md) ---------------------
        # The wall-clock runtime mutates one allocator from several
        # threads at once: a prefill/decode worker appending or freeing
        # while the client thread cancels, or the transfer worker
        # installing received pages.  A single reentrant lock serializes
        # every mutation and every compound read (can_admit must see a
        # consistent free-list + cache); single-threaded callers (the
        # sync Cluster event loop) pay one uncontended acquire, which is
        # noise next to the bookkeeping itself.  ``_mut_depth`` is the
        # debug guard: internal free-list/refcount helpers assert they
        # run inside ``_mutate`` so any future mutation path that skips
        # the lock trips an assertion in tests instead of corrupting
        # the free list silently in production.
        self._lock = threading.RLock()
        self._mut_depth = 0
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._tables: Dict[str, List[Optional[int]]] = {}
        self._lens: Dict[str, int] = {}
        self._trimmed: Dict[str, int] = {}   # leading slots already None
        self._cross: Dict[str, List[int]] = {}
        self.swap_events = 0
        # -- ownership / sharing state --------------------------------
        self._refs: Dict[int, int] = {}            # page -> refcount
        self._cache: "OrderedDict[Hashable, int]" = OrderedDict()
        self._cross_cache: "OrderedDict[Hashable, List[int]]" = OrderedDict()
        self._cached_pages: Dict[str, int] = {}    # rid -> leading aliased
        self._cross_hit: Dict[str, bool] = {}      # rid -> cross aliased?
        self._cross_key_pending: Dict[str, Hashable] = {}
        self._cow_pending: List[Tuple[int, int]] = []   # (src, dst)
        # -- stats (summarize()/bench surface them) --------------------
        self.cache_lookups = 0     # prefix keys consulted at alloc
        self.cache_hits = 0        # prefix pages aliased (== pages saved)
        self.cross_lookups = 0
        self.cross_hits = 0        # cross-page SETS deduped

    # -- queries -------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def utilization(self) -> float:
        return self.used_pages / self.n_pages

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size) if n_tokens > 0 else 0

    def dead_slots(self, n_tokens: int) -> int:
        """Leading block-table slots wholly outside the sliding window
        once ``n_tokens`` are present."""
        return window_dead_pages(n_tokens, self.window, self.page_size)

    def pages_for_request(self, n_tokens: int) -> int:
        """Physical pages a request with n_tokens actually holds —
        window-aware (the admission policies budget against this)."""
        return self.pages_for(n_tokens) - self.dead_slots(n_tokens)

    @property
    def cross_pages_per_request(self) -> int:
        """Read-only cross-KV pages every request holds for its whole
        lifetime (0 for self-attention-only archs)."""
        return self.pages_for(self.cross_tokens)

    def table(self, rid: str) -> List[Optional[int]]:
        """Block-table row: absolute slot indexing; ``None`` marks slots
        whose pages slid out of the window (engines map them to the
        scratch page)."""
        return list(self._tables[rid])

    def table_padded(self, rid: str, trash: int) -> List[int]:
        """Block-table row with slid-out slots mapped to the scratch
        page ``trash`` — the form the engines feed the kernels (which
        never read those slots: page-skip + masks)."""
        return [trash if p is None else p for p in self._tables[rid]]

    def cross_table(self, rid: str) -> List[int]:
        """The request's read-only cross-attention block table — distinct
        from the self-attention table, never grown or trimmed."""
        return list(self._cross[rid])

    def live_pages(self, rid: str) -> List[int]:
        return [p for p in self._tables[rid] if p is not None]

    def pages_held(self, rid: str) -> int:
        return len(self.live_pages(rid))

    def length(self, rid: str) -> int:
        return self._lens[rid]

    def has(self, rid: str) -> bool:
        return rid in self._tables

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def cached_prefix_pages(self, rid: str) -> int:
        """Leading table slots that were aliased from the prefix cache
        at ``alloc`` (read-only shared pages whose contents already sit
        in the pool — the transfer/install paths skip them)."""
        return self._cached_pages.get(rid, 0)

    def cached_prefix_tokens(self, rid: str) -> int:
        return self.cached_prefix_pages(rid) * self.page_size

    def cross_cached(self, rid: str) -> bool:
        """Whether the request's cross pages were aliased from the cache
        (encoder run + scatter + transfer payload all skippable)."""
        return self._cross_hit.get(rid, False)

    def cache_pages(self) -> List[int]:
        """Distinct physical pages the caches hold a reference to."""
        pages = set(self._cache.values())
        for plist in self._cross_cache.values():
            pages.update(plist)
        return sorted(pages)

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / self.cache_lookups if self.cache_lookups \
            else 0.0

    # -- internals -----------------------------------------------------
    @contextlib.contextmanager
    def _mutate(self):
        """Serialize a mutation (reentrant).  Every public mutator wraps
        itself in this; ``_decref``/``_take_page`` assert they run
        inside it, so an unlocked mutation path fails loudly in debug
        runs (tests) rather than racing the free list."""
        with self._lock:
            self._mut_depth += 1
            try:
                yield
            finally:
                self._mut_depth -= 1

    def _decref(self, page: int) -> None:
        assert self._mut_depth > 0, "allocator mutated outside its lock"
        r = self._refs[page] - 1
        assert r >= 0, f"negative refcount for page {page}"
        if r == 0:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = r

    def _prefix_hits(self, page_keys) -> int:
        """Leading run of keys already in the cache (only a LEADING run
        is usable: page i's KV is valid only with pages 0..i-1 present,
        which the chain hash already encodes)."""
        h = 0
        for key in page_keys:
            if key not in self._cache:
                break
            h += 1
        return h

    def _evictable(self, exclude=frozenset()) -> int:
        """Cache entries reclaimable right now: held by NO block table
        (refcount 1 == the cache's own reference) and not needed by the
        allocation being sized (``exclude``)."""
        n = sum(1 for k, p in self._cache.items()
                if self._refs[p] == 1 and k not in exclude)
        for key, plist in self._cross_cache.items():
            if key not in exclude and all(self._refs[p] == 1 for p in plist):
                n += len(plist)
        return n

    def _evict(self, need: int, exclude=frozenset()) -> None:
        """LRU-evict cache-only entries until ``need`` pages are free."""
        while len(self._free) < need:
            victim = None
            for key, page in self._cache.items():
                if self._refs[page] == 1 and key not in exclude:
                    victim = key
                    break
            if victim is not None:
                self._decref(self._cache.pop(victim))
                continue
            cvictim = None
            for key, plist in self._cross_cache.items():
                if key not in exclude and all(self._refs[p] == 1
                                              for p in plist):
                    cvictim = key
                    break
            if cvictim is None:
                return
            for p in self._cross_cache.pop(cvictim):
                self._decref(p)

    def _take_page(self, why: str) -> int:
        assert self._mut_depth > 0, "allocator mutated outside its lock"
        if not self._free and self.prefix_cache:
            self._evict(1)
        if not self._free:
            raise OutOfPages(why)
        return self._free.pop()

    # -- mutations -----------------------------------------------------
    @_locked
    def alloc(self, rid: str, n_tokens: int, *,
              materialize_all: bool = False,
              page_keys: Optional[List[Hashable]] = None,
              cross_key: Optional[Hashable] = None
              ) -> List[Optional[int]]:
        """Allocate pages for a new request with n_tokens already present
        (e.g. a received prefilled KV).  With a window, only in-window
        pages are physically allocated (dead leading slots are ``None``)
        unless ``materialize_all`` — prefill needs every page live while
        chunks stream through it, then trims as the window slides.

        ``page_keys`` (prefix cache on): content identities for the
        request's leading full pages — the leading run already cached is
        ALIASED read-only (incref, no free-list draw) and reported by
        ``cached_prefix_pages``.  ``cross_key``: content identity of the
        encoder input; a hit aliases the whole read-only cross-page set,
        a miss draws fresh pages and remembers the key for
        ``commit_cross``."""
        assert rid not in self._tables, rid
        if not self.prefix_cache:
            page_keys = cross_key = None
        assert page_keys is None or not self.window, \
            "prefix cache is incompatible with sliding-window tables"
        total = max(1, self.pages_for(n_tokens))
        dead = 0 if materialize_all else min(self.dead_slots(n_tokens),
                                             total - 1)
        hits = 0
        if page_keys:
            self.cache_lookups += len(page_keys)
            hits = min(self._prefix_hits(page_keys), total)
            self.cache_hits += hits
        need = total - dead - hits
        cross = self.cross_pages_per_request
        cross_hit = cross_key is not None and cross_key in self._cross_cache
        cross_need = 0 if cross_hit else cross
        if cross_key is not None:
            self.cross_lookups += 1
            self.cross_hits += cross_hit
        if need + cross_need > len(self._free):
            if self.prefix_cache:
                exclude = set(page_keys[:hits]) if page_keys else set()
                if cross_hit:
                    exclude.add(cross_key)
                self._evict(need + cross_need, exclude)
            if need + cross_need > len(self._free):
                raise OutOfPages(f"{rid}: need {need + cross_need}, "
                                 f"free {len(self._free)}")
        aliased: List[int] = []
        for key in (page_keys or [])[:hits]:
            p = self._cache[key]
            self._refs[p] += 1
            self._cache.move_to_end(key)
            aliased.append(p)
        pages = [self._free.pop() for _ in range(need)]
        for p in pages:
            self._refs[p] = 1
        self._tables[rid] = [None] * dead + aliased + pages
        self._lens[rid] = n_tokens
        self._trimmed[rid] = dead
        if hits:
            self._cached_pages[rid] = hits
        if cross:
            if cross_hit:
                cpages = self._cross_cache[cross_key]
                for p in cpages:
                    self._refs[p] += 1
                self._cross_cache.move_to_end(cross_key)
                self._cross[rid] = list(cpages)
                self._cross_hit[rid] = True
            else:
                cpages = [self._free.pop() for _ in range(cross)]
                for p in cpages:
                    self._refs[p] = 1
                self._cross[rid] = cpages
                if cross_key is not None:
                    self._cross_key_pending[rid] = cross_key
        return self.table(rid)

    @_locked
    def commit(self, rid: str, page_keys: List[Hashable]) -> int:
        """Publish the request's leading pages into the prefix cache
        under their content keys (one extra ref per new entry), after
        their contents are final in the pool — prefill calls this right
        before ``free``, decode right after admission install.  Pages
        already cached under the same key keep the existing entry.
        Returns the number of new entries."""
        if not self.prefix_cache:
            return 0
        table = self._tables[rid]
        added = 0
        for i, key in enumerate(page_keys):
            if i >= len(table) or table[i] is None:
                break
            if key in self._cache:
                self._cache.move_to_end(key)
                continue
            page = table[i]
            self._cache[key] = page
            self._refs[page] += 1
            added += 1
        return added

    @_locked
    def commit_cross(self, rid: str) -> bool:
        """Publish the request's cross pages under the ``cross_key`` its
        ``alloc`` recorded — called after the engine's one-shot encoder
        scatter lands, so cache entries never expose unwritten pages."""
        key = self._cross_key_pending.pop(rid, None)
        if key is None or not self.prefix_cache or key in self._cross_cache:
            return False
        pages = self._cross[rid]
        for p in pages:
            self._refs[p] += 1
        self._cross_cache[key] = list(pages)
        return True

    @_locked
    def fork(self, dst: str, src: str) -> List[Optional[int]]:
        """Alias ``dst`` to every page of ``src`` (self + cross tables):
        pure refcount sharing, no copies.  Decode appends into a forked
        table copy-on-write.  This is the explicit ``share`` operation
        the property suite interleaves; serving reaches the same state
        via alloc-time prefix hits."""
        assert dst not in self._tables, dst
        table = self._tables[src]
        for p in table:
            if p is not None:
                self._refs[p] += 1
        self._tables[dst] = list(table)
        self._lens[dst] = self._lens[src]
        self._trimmed[dst] = self._trimmed[src]
        cross = self._cross.get(src)
        if cross is not None:
            for p in cross:
                self._refs[p] += 1
            self._cross[dst] = list(cross)
            self._cross_hit[dst] = True
        return self.table(dst)

    @_locked
    def append_token(self, rid: str) -> int:
        """Account one decoded token; grows the table when a page fills
        and frees pages that slid out of the window.  Never writes into
        a shared page: appending into a page with refcount > 1 allocates
        a fresh page, redirects this table's slot to it, and records the
        (src, dst) pair for ``take_cow_copies`` so the engine replays
        the page contents on the device pool before scattering.  Returns
        the physical page holding the new token."""
        ln = self._lens[rid]
        # trim for queries >= ln (the appended token IS this iteration's
        # query and still attends key ln - window + 1) BEFORE growing:
        # at a page boundary the free and the grow can land on the same
        # call, and the freed page must be reusable for the grow so a
        # full pool never raises while net usage stays O(window)
        if self.window:
            self.trim(rid, ln)
        table = self._tables[rid]
        if ln == len(table) * self.page_size:
            table.append(self._take_page(f"{rid}: decode append"))
            self._refs[table[-1]] = 1
        slot = ln // self.page_size
        page = table[slot]
        if self._refs[page] > 1:       # shared: copy-on-write
            dst = self._take_page(f"{rid}: cow append")
            self._refs[page] -= 1
            self._refs[dst] = 1
            table[slot] = dst
            if slot < self._cached_pages.get(rid, 0):
                self._cached_pages[rid] = slot
            self._cow_pending.append((page, dst))
            page = dst
        self._lens[rid] = ln + 1
        return page

    @_locked
    def take_cow_copies(self) -> List[Tuple[int, int]]:
        """Drain pending copy-on-write (src, dst) page pairs.  The engine
        must replay these on the device pool (``PagePool.copy_pages``)
        before the next kernel call that reads the dst pages."""
        out, self._cow_pending = self._cow_pending, []
        return out

    @_locked
    def trim(self, rid: str, processed: int) -> int:
        """Release pages wholly outside the window of any query at
        position >= ``processed`` (chunked prefill calls this as chunks
        complete; ``append_token`` calls it every decode step).  Resumes
        from the last trimmed slot, so each call is O(pages freed now),
        not O(slots ever freed).  A shared page is only decref'd — it
        stays live for its other holders.  Returns slots released."""
        if not self.window:
            return 0
        table = self._tables[rid]
        start = self._trimmed[rid]
        # keep-one-page clamp, same as alloc()/kv_page_bytes: the last
        # page always stays live so the shipped payload and the decode
        # side's window-aware alloc agree even at degenerate windows
        stop = min(self.dead_slots(processed), len(table) - 1)
        freed = 0
        for s in range(start, stop):
            if table[s] is not None:
                self._decref(table[s])
                table[s] = None
                freed += 1
        self._trimmed[rid] = max(start, stop)
        return freed

    @_locked
    def free(self, rid: str) -> None:
        """Release the request's references.  Pages shared with other
        tables or pinned by a cache entry survive (decref); exclusively
        held pages return to the free list in the same order the
        pre-refcount allocator used."""
        for p in reversed(self._tables.pop(rid)):
            if p is not None:
                self._decref(p)
        self._lens.pop(rid)
        self._trimmed.pop(rid, None)
        self._cached_pages.pop(rid, None)
        # cross pages are decref'd exactly once: pop() makes a double
        # free a loud KeyError via _tables above, and the cross list is
        # dropped with the table entry
        for p in reversed(self._cross.pop(rid, [])):
            self._decref(p)
        self._cross_key_pending.pop(rid, None)
        self._cross_hit.pop(rid, None)

    @_locked
    def pages_needed(self, n_tokens: int, *,
                     materialize_all: bool = False,
                     page_keys: Optional[List[Hashable]] = None) -> int:
        """Fresh pages an ``alloc`` for n_tokens would draw — admission
        policies budget against this so shared prefix pages are counted
        once across the batch, not once per request."""
        n = max(1, n_tokens)
        need = (self.pages_for(n) if materialize_all
                else max(1, self.pages_for_request(n)))
        if page_keys and self.prefix_cache and not self.window:
            need -= min(self._prefix_hits(page_keys), need)
        return need

    @_locked
    def can_admit(self, n_tokens: int, *,
                  materialize_all: bool = False,
                  page_keys: Optional[List[Hashable]] = None,
                  cross_key: Optional[Hashable] = None) -> bool:
        if not self.prefix_cache:
            page_keys = cross_key = None
        need = self.pages_needed(n_tokens, materialize_all=materialize_all,
                                 page_keys=page_keys)
        cross_hit = cross_key is not None and cross_key in self._cross_cache
        need += 0 if cross_hit else self.cross_pages_per_request
        avail = len(self._free)
        if self.prefix_cache:
            exclude = set(page_keys[:self._prefix_hits(page_keys)]) \
                if page_keys else set()
            if cross_hit:
                exclude.add(cross_key)
            avail += self._evictable(exclude)
        return need <= avail


# ---------------------------------------------------------------------------
# Device page pool
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PagePool:
    """Per-layer K/V page pools.  GQA layout (``create``): k/v are (L,
    n_pages, page, kvh, hd).  MLA latent layout (``create_latent``): the
    pair holds (compressed latent, decoupled RoPE key), k: (L, n_pages,
    page, kv_lora_rank) and v: (L, n_pages, page, qk_rope_head_dim).
    Every op below indexes dim 1 only, so gather/install/copy_pages work
    for both layouts.

    Unlike the reference, whose functional ``.at[].set`` returns new
    pools, ``install`` and ``copy_pages`` update ``k``/``v`` IN PLACE
    (``index_copy_``) and return ``self``, so an engine never holds two
    copies of its pool.  ``gather`` returns a COPY: the prefill side
    frees the pages right after gathering, and the shipped payload must
    survive their reuse.
    """
    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, n_layers: int, n_pages: int, page_size: int, kvh: int,
               hd: int, dtype=torch.bfloat16, device="cuda") -> "PagePool":
        shape = (n_layers, n_pages, page_size, kvh, hd)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @classmethod
    def create_latent(cls, n_layers: int, n_pages: int, page_size: int,
                      kv_lora_rank: int, rope_dim: int,
                      dtype=torch.bfloat16, device="cuda") -> "PagePool":
        """MLA latent pool: per token the compressed latent
        (kv_lora_rank) and the shared RoPE key (rope_dim), not per-head
        K/V."""
        return cls(
            k=torch.zeros((n_layers, n_pages, page_size, kv_lora_rank),
                          dtype=dtype, device=device),
            v=torch.zeros((n_layers, n_pages, page_size, rope_dim),
                          dtype=dtype, device=device))

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    def _index(self, pages) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pages, np.int64),
                               device=self.k.device)

    # -- serving-path transfer helpers ---------------------------------
    def gather(self, pages):
        """Extract the page contents for one request — what the prefill
        instance ships to decode.  pages: (n,) physical ids.  Returns a
        copy (k, v) of shape (L, n, page, ...)."""
        idx = self._index(pages)
        return self.k.index_select(1, idx), self.v.index_select(1, idx)

    def install(self, pages, k_pages, v_pages) -> "PagePool":
        """Install received page contents (all layers at once) into local
        physical pages, in place — decode-side admission.  pages: (n,)
        ids; k_pages/v_pages: (L, n, page, ...)."""
        idx = self._index(pages)
        self.k.index_copy_(1, idx, k_pages.to(self.k.device, self.k.dtype))
        self.v.index_copy_(1, idx, v_pages.to(self.v.device, self.v.dtype))
        return self

    def copy_pages(self, src, dst) -> "PagePool":
        """Replay the allocator's copy-on-write pairs on the device pool,
        in place: page dst becomes a byte copy of page src (all layers).
        src/dst: (n,) physical ids."""
        s, d = self._index(src), self._index(dst)
        self.k.index_copy_(1, d, self.k.index_select(1, s))
        self.v.index_copy_(1, d, self.v.index_select(1, s))
        return self
