"""Prefill instance (paper §3.3): local scheduler -> chunked-prefill LLM
engine -> dispatcher.

Execution backends (``core.backend.backend_for``):

  * ``paged`` (every uniform-attention arch) — see below.
  * ``dense`` (the recurrent and hybrid archs, or any arch on request)
    — each request gets a batch=1 dense cache of ``max_seq`` positions
    at refill, and every segment of a chunk runs its own
    ``model.prefill`` call against it (attention through kernel 5, the
    recurrent states carried between chunks).  A cross-attention
    request's first segment also passes its frontend embeddings (zeros
    without them), so the cross layers store the encoder K/V in the
    cache.  The finished request ships the cache itself
    (``PrefilledKV.cache``); the prefix cache is a no-op there, as in
    the reference.

On the paged backend the engine owns a device ``PagePool``; one ``step``
executes the WHOLE fixed-size chunk as a single fused
``model.prefill_paged`` call (segments of multiple requests packed on
the batch dim), writing K/V straight into pages. Finished requests ship
``(live page contents)`` through ``PrefilledKV`` and free their pages.
Cross-attention archs (VLM / enc-dec) also hold READ-ONLY cross pages
per request: the encoder K/V is scattered once, by the chunk holding the
request's first segment; every chunk attends it through a second block
table, and the finished request ships the cross pages beside the self
KV. With a sliding window, the pages the processed prefix slid past are
freed after every chunk, so a finished request ships only its in-window
pages.

With ``prefix_cache=True`` (unwindowed configs; a no-op with a sliding
window, as in the reference) each request's full prompt pages are keyed
by a chain hash of their tokens: a request whose leading pages another
finished request already committed aliases them and its segments start
after them (up to the last full page before its final prompt token),
and a request whose encoder input equals a committed one's aliases its
cross pages and runs no encoder work.  A finished request commits its
pages to the cache before it frees them.

Host-side bookkeeping is the reference's: pad to powers of two, tables
built with numpy, first tokens copied to the host.  ``tokens_prefilled``
counts the prompt tokens computed and ``rows_computed`` the rows sent to
the model (on the paged backend a chunk's padded ``ns x sq``), so their
ratio is the share of prefill work that was not padding.  A caller that
sets ``phase_hook`` is called ``hook(phase, **args)`` as each phase of a
chunk starts (``prefill.build``, with the chunk's ``step``,
``segments``, ``tokens``, ``rows`` and ``rids``; ``prefill.launch``,
``prefill.sync``, ``prefill.post``); ``None``, the default, calls
nothing.  The model runs on
``device`` ("cuda" unless the caller asks for "cpu"); ``params`` must
live there.  On the card every step runs on the calling thread's
current stream; a finished request's payload carries an event recorded
on it after the gather, which the decode side waits on before it reads
the payload: on the dense backend, after the request's last chunk has
written its cache.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import chunking
from repro_torch.core.backend import backend_for
from repro_torch.core.kv_transfer import NetworkStack
from repro_torch.core.sched.dispatcher import Dispatcher
from repro_torch.core.sched.prefill_scheduler import PrefillScheduler
from repro_torch.kvcache.paged import (OutOfPages, PagedAllocator,
                                       PagePool, request_cross_key,
                                       request_page_keys)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.request import Phase, Request


@dataclasses.dataclass
class PrefilledKV:
    """What the dispatcher ships to a decode instance: the request's
    LIVE page contents ``pages_k``/``pages_v``, copies of (L, n_pages,
    page, kvh, hd) K/V pages or, for MLA, of (L, n_pages, page, lora)
    latent and (L, n_pages, page, rope) RoPE-key pages, plus ``kv_len``
    valid tokens.  The receiver installs them into its own pool and
    builds a block-table row.  On the dense backend ``cache`` is the
    request's batch=1 dense cache (``model.init_cache``: a dict a
    layer) and no pages travel.  Cross-attention archs also ship
    ``cross_k``/``cross_v``, copies of the read-only encoder pages (L,
    cross_pages, page, kvh, hd), covering ``enc_len`` encoder tokens:
    a one-shot payload, amortized over the whole decode.  On the card
    ``ready`` is a CUDA event recorded on the prefill side's stream
    after the copies: a reader on another stream waits on it first (and
    marks the tensors used by its stream).  ``None`` on the CPU."""
    req: Request
    first_token: int             # argmax token from prefill (the 'first token')
    transfer_delay_s: float      # emulated network wait
    n_chunks: int = 1
    cache: object = None         # dense backend only
    pages_k: object = None       # paged backend only
    pages_v: object = None
    kv_len: int = 0
    cross_k: object = None       # cross-attention archs only
    cross_v: object = None
    enc_len: int = 0
    # prefix-cache accounting: leading prompt tokens whose pages the
    # prefill side aliased (skipped recompute and wire bytes), and
    # whether the cross pages were aliased (the encoder ran 0 times for
    # this request)
    cached_tokens: int = 0
    cross_cached: bool = False
    ready: Optional[torch.cuda.Event] = None


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def make_page_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                   device="cuda"):
    """Device pool with one extra physical page past the allocator's
    range — the scratch ("trash") page pad tokens and dead slots scatter
    to.  MLA configs get the latent layout (compressed latent + RoPE key
    pages), everything else per-head GQA K/V pages.
    Returns (pool, trash_page_id)."""
    dtype = M.torch_dtype(cfg)
    if backend_for(cfg).layout == "latent":
        pool = PagePool.create_latent(
            cfg.n_layers, n_pages + 1, page_size, cfg.mla.kv_lora_rank,
            cfg.mla.qk_rope_head_dim, dtype=dtype, device=device)
    else:
        pool = PagePool.create(cfg.n_layers, n_pages + 1, page_size,
                               cfg.n_kv_heads, cfg.resolved_head_dim,
                               dtype=dtype, device=device)
    return pool, n_pages


def to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


class PrefillEngine:
    def __init__(self, iid: str, cfg: ModelConfig, params,
                 scheduler: Optional[PrefillScheduler] = None,
                 dispatcher: Optional[Dispatcher] = None,
                 network: Optional[NetworkStack] = None,
                 predictor=None,
                 chunk_size: int = 64, max_seq: int = 512,
                 backend: str = "auto",
                 n_pages: int = 512, page_size: int = 16,
                 prefix_cache: bool = False, device="cuda"):
        self.iid = iid
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        # explicit None check: an EMPTY scheduler is falsy (__len__), so
        # `scheduler or ...` would silently discard a caller's policy/
        # batch-window configuration
        self.scheduler = scheduler if scheduler is not None \
            else PrefillScheduler()
        self.dispatcher = dispatcher or Dispatcher()
        self.network = network or NetworkStack()
        self.predictor = predictor
        self.chunk_size = chunk_size
        self.max_seq = max_seq
        self.spec = backend_for(cfg, backend)
        self.backend = self.spec.backend
        self.page_size = page_size
        self._chunk_queue: Deque[chunking.Chunk] = collections.deque()
        self._reqs: Dict[str, Request] = {}
        self.chunk_steps = 0         # steps that actually ran a chunk
        self.fused_calls = 0         # one per chunk on the paged backend
        self.encoder_calls = 0       # chunks that ran encoder + scatter
        self.tokens_prefilled = 0    # prompt tokens computed
        self.rows_computed = 0       # rows sent to the model, padding too
        self.phase_hook = None
        self.enc_ctx = self.spec.cross_ctx
        # the prefix cache needs stable page content (no sliding-window
        # trims) and the paged pool; a no-op elsewhere
        self.prefix_cache = (prefix_cache and self.backend == "paged"
                             and not cfg.sliding_window)
        self._page_keys: Dict[str, List[bytes]] = {}
        if self.backend == "dense":
            self._caches: Dict[str, object] = {}
            return
        self.alloc = PagedAllocator(n_pages=n_pages, page_size=page_size,
                                    window=cfg.sliding_window,
                                    cross_tokens=self.enc_ctx,
                                    prefix_cache=self.prefix_cache)
        self.pool, self._trash = make_page_pool(cfg, n_pages, page_size,
                                                self.device)
        self._bt_width = self.alloc.pages_for(max_seq)
        self._cross_bt_width = self.alloc.cross_pages_per_request

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        # strict bound: decode must append at least one token at position
        # prompt_len inside a pages_for(max_seq)-wide block-table row
        if req.prompt_len >= self.max_seq:
            raise ValueError(f"{req.rid}: prompt {req.prompt_len} >= "
                             f"max_seq {self.max_seq}")
        self.scheduler.add(req)
        self._reqs[req.rid] = req

    @property
    def queued_tokens(self) -> int:
        return self.scheduler.queued_tokens + sum(
            c.tokens for c in self._chunk_queue)

    def idle(self) -> bool:
        return len(self.scheduler) == 0 and not self._chunk_queue

    def resident(self) -> List[Request]:
        """Requests this engine still owns (queued or mid-prefill)."""
        return list(self._reqs.values())

    def cancel(self, rid: str) -> bool:
        """User cancel before/while prefilling: drop the request from the
        local scheduler and the chunk queue and free any pages it holds.
        Returns whether this engine still owned the request."""
        if rid not in self._reqs:
            return False
        self._reqs.pop(rid)
        self.scheduler.remove(rid)
        self._chunk_queue = collections.deque(
            chunking.drop_rid(self._chunk_queue, rid))
        if self.backend == "dense":
            self._caches.pop(rid, None)
        elif self.alloc.has(rid):
            self.alloc.free(rid)
        self._page_keys.pop(rid, None)
        return True

    # ------------------------------------------------------------------
    def _refill_chunks(self) -> None:
        batch = self.scheduler.next_batch(self.scheduler.sched_batch)
        if not batch:
            return
        if self.backend == "dense":
            for r in batch:
                self._caches[r.rid] = M.init_cache(
                    self.cfg, 1, self.max_seq, device=self.device)
            fit = batch
        else:
            fit = self._reserve_pages(batch)
        if not fit:
            return
        pairs = [(r.rid, r.prompt_len) for r in fit]
        # cached-prefix pages are skipped, not recomputed: each request's
        # segments start at its first uncached token
        starts = {r.rid: r.cached_prefix_tokens for r in fit
                  if r.cached_prefix_tokens}
        self._chunk_queue.extend(chunking.partition(
            pairs, self.chunk_size, starts=starts or None))
        for r in fit:
            r.phase = Phase.PREFILL

    def _reserve_pages(self, batch: List[Request]) -> List[Request]:
        """Reserve each request's prompt pages up front — prefill writes
        every prompt position, so ALL pages materialize; requests that
        don't fit the pool right now go back to the head of the queue —
        backpressure instead of an OutOfPages crash mid-batch.  Returns
        the requests that fit."""
        fit, defer = [], []
        for r in batch:
            keys = cross_key = None
            if self.prefix_cache:
                # alias at most up to the last FULL page strictly before
                # the final prompt token: the last token is always
                # recomputed, so the request still emits its first token
                full = request_page_keys(r, self.page_size) or []
                self._page_keys[r.rid] = full
                keys = full[:max(0, (r.prompt_len - 1) // self.page_size)]
                if self.spec.cross == "pages":
                    cross_key = request_cross_key(r)
            if self.alloc.can_admit(r.prompt_len, materialize_all=True,
                                    page_keys=keys, cross_key=cross_key):
                self.alloc.alloc(r.rid, r.prompt_len, materialize_all=True,
                                 page_keys=keys, cross_key=cross_key)
                r.cached_prefix_pages = self.alloc.cached_prefix_pages(r.rid)
                r.cached_prefix_tokens = self.alloc.cached_prefix_tokens(
                    r.rid)
                fit.append(r)
            else:
                if self.alloc.pages_for(max(1, r.prompt_len)) \
                        > self.alloc.n_pages:
                    raise OutOfPages(
                        f"{r.rid}: prompt {r.prompt_len} exceeds the "
                        f"whole pool ({self.alloc.n_pages} pages)")
                defer.append(r)
        if defer:
            self.scheduler.requeue_front(defer)
        return fit

    @torch.no_grad()
    def step(self, now: float) -> List[PrefilledKV]:
        """Run ONE fixed-size chunk (the paper's prefill iteration unit).
        Returns requests whose prefill completed this step.  No autograd
        graph is recorded, whatever the weights' ``requires_grad``."""
        if not self._chunk_queue:
            self._refill_chunks()
        if not self._chunk_queue:
            return []
        chunk = self._chunk_queue.popleft()
        self.chunk_steps += 1
        if self.backend == "dense":
            return self._step_dense(chunk, now)
        return self._step_paged(chunk, now)

    # -- paged backend -------------------------------------------------
    def _step_paged(self, chunk: chunking.Chunk, now: float
                    ) -> List[PrefilledKV]:
        """Pack the chunk's segments flat and issue exactly ONE fused
        model call for the whole chunk.  For cross-attention archs the
        call carries the encoder work (encoder stack, one-shot cross-KV
        scatter) only when some segment is its request's first; else it
        reads the cross pages only."""
        segs = chunk.segments
        n = len(segs)
        ns = _pow2(n)                          # stable batch dim
        sq = _pow2(max(s.length for s in segs))
        tokens = sum(s.length for s in segs)
        self.tokens_prefilled += tokens
        self.rows_computed += ns * sq
        hook = self.phase_hook
        if hook is not None:
            hook("prefill.build", step=self.chunk_steps, segments=n,
                 tokens=tokens, rows=ns * sq, rids=[s.rid for s in segs])
        ps, trash = self.page_size, self._trash
        toks = np.zeros((ns, sq), np.int32)
        qoff = np.zeros((ns,), np.int32)
        kvlen = np.zeros((ns,), np.int32)
        last = np.zeros((ns,), np.int32)
        bt = np.full((ns, self._bt_width), trash, np.int32)
        pg = np.full((ns, sq), trash, np.int32)
        off = np.tile(np.arange(sq, dtype=np.int32) % ps, (ns, 1))
        dev = self.device
        cross = self.spec.cross == "pages"
        scattered: List[str] = []   # rids whose cross pages land this call
        if cross:
            ec = self.enc_ctx
            # f32 whatever the model's dtype, as in the reference: the
            # encoder and the cross K/V projections run in f32
            enc = torch.zeros((ns, ec, self.cfg.d_model),
                              dtype=torch.float32, device=dev)
            cbt = np.full((ns, self._cross_bt_width), trash, np.int32)
            clen = np.zeros((ns,), np.int32)
            cpg = np.full((ns, ec), trash, np.int32)
            coff = np.tile(np.arange(ec, dtype=np.int32) % ps, (ns, 1))
        for i, seg in enumerate(segs):
            req = self._reqs[seg.rid]
            if req.t_prefill_start < 0:
                req.t_prefill_start = now
            if req.prompt_tokens is not None:
                toks[i, :seg.length] = req.prompt_tokens[
                    seg.req_start: seg.req_start + seg.length]
            qoff[i] = seg.req_start
            kvlen[i] = seg.req_start + seg.length
            last[i] = seg.length - 1
            table = np.asarray(self.alloc.table_padded(seg.rid, trash),
                               np.int32)
            bt[i, :len(table)] = table
            pos = seg.req_start + np.arange(seg.length)
            pg[i, :seg.length] = table[pos // ps]
            off[i, :seg.length] = pos % ps
            if cross:
                ctab = np.asarray(self.alloc.cross_table(seg.rid),
                                  np.int32)
                cbt[i, :len(ctab)] = ctab
                clen[i] = self.enc_ctx
                if (seg.req_start == self.alloc.cached_prefix_tokens(
                        seg.rid)
                        and not self.alloc.cross_cached(seg.rid)):
                    # one-shot cross-KV prefill: only a request's FIRST
                    # segment (right after any cached prefix) scatters the
                    # encoder K/V into its cross pages; later chunks only
                    # read them, and a request whose cross pages are
                    # aliased from the cache never writes them (cpg stays
                    # at the scratch page: those writes land there)
                    if req.enc_embeds is not None:
                        enc[i].copy_(torch.as_tensor(req.enc_embeds))
                    cpg[i] = ctab[np.arange(self.enc_ctx) // ps]
                    scattered.append(seg.rid)
        cross_args = {}
        if cross:
            cross_args = dict(cross_bt=to_device(cbt, dev),
                              cross_len=to_device(clen, dev))
            if scattered:
                cross_args.update(enc_embeds=enc,
                                  cross_pg=to_device(cpg, dev),
                                  cross_off=to_device(coff, dev))
                self.encoder_calls += 1
        inputs = [to_device(a, dev)
                  for a in (toks, qoff, kvlen, last, bt, pg, off)]
        if hook is not None:
            hook("prefill.launch")
        next_tok, _ = M.prefill_paged(
            self.params, self.cfg, *inputs, self.pool.k, self.pool.v,
            **cross_args)
        self.fused_calls += 1
        for rid in scattered:
            # the cross pages now hold the encoder K/V: publish them, so
            # later requests with the same encoder input alias them
            self.alloc.commit_cross(rid)
        if hook is not None:
            hook("prefill.sync")
        next_tok = next_tok.cpu().numpy()
        if hook is not None:
            hook("prefill.post")
        finished: List[PrefilledKV] = []
        for i, seg in enumerate(segs):
            req = self._reqs[seg.rid]
            req.prefilled = seg.req_start + seg.length
            # windowed: pages the processed prefix slid past go back to
            # the free list (no-op for unwindowed configs)
            self.alloc.trim(seg.rid, req.prefilled)
            if req.prefilled >= req.prompt_len:
                finished.append(
                    self._finish_paged(req, int(next_tok[i]), now))
        return finished

    def _finish_paged(self, req: Request, first_tok: int, now: float
                      ) -> PrefilledKV:
        n_chunks = self._note_finished(req, now)
        enc_len = self.enc_ctx
        cross_cached = self.alloc.cross_cached(req.rid)
        delay = self.network.send_kv(self.cfg, req.prompt_len,
                                     n_chunks=n_chunks,
                                     page_size=self.page_size,
                                     enc_len=enc_len,
                                     cached_tokens=req.cached_prefix_tokens,
                                     cross_cached=cross_cached)
        req.phase = Phase.TRANSFER
        # gather() returns a COPY of the live pages, which are freed right
        # below: the payload survives the next chunk scattering into them.
        # It still carries any cached-prefix pages (live aliases in this
        # pool), so a decode side without those cache entries stays
        # correct; the wire accounting above leaves them out.
        pages_k, pages_v = self.pool.gather(self.alloc.live_pages(req.rid))
        cross_k = cross_v = None
        if enc_len:
            # plus the one-shot read-only cross pages, across every layer
            # of the pool as in the reference (only the cross layers hold
            # encoder K/V; the wire bytes count those alone)
            cross_k, cross_v = self.pool.gather(
                self.alloc.cross_table(req.rid))
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        # publish the finished request's full prompt pages under their
        # keys BEFORE freeing: the cache keeps them alive (refcounted)
        # for the next request sharing this prefix
        if self.prefix_cache:
            self.alloc.commit(req.rid, self._page_keys.pop(req.rid, []))
        self.alloc.free(req.rid)
        self._reqs.pop(req.rid)
        return PrefilledKV(req=req, first_token=first_tok,
                           transfer_delay_s=delay, n_chunks=n_chunks,
                           pages_k=pages_k, pages_v=pages_v,
                           kv_len=req.prompt_len, cross_k=cross_k,
                           cross_v=cross_v, enc_len=enc_len,
                           cached_tokens=req.cached_prefix_tokens,
                           cross_cached=cross_cached, ready=ready)

    # -- dense backend -------------------------------------------------
    def _step_dense(self, chunk: chunking.Chunk, now: float
                    ) -> List[PrefilledKV]:
        """One ``model.prefill`` call a segment, each against its
        request's dense cache at the segment's start; a cross-attention
        request's first segment carries its frontend embeddings (f32, as
        in the reference: zeros for a request without any, whose cross
        output is then 0)."""
        finished: List[PrefilledKV] = []
        segs = chunk.segments
        tokens = sum(s.length for s in segs)
        self.tokens_prefilled += tokens
        self.rows_computed += tokens
        hook = self.phase_hook
        if hook is not None:
            hook("prefill.build", step=self.chunk_steps,
                 segments=len(segs), tokens=tokens, rows=tokens,
                 rids=[s.rid for s in segs])
        for seg in segs:
            req = self._reqs[seg.rid]
            if req.t_prefill_start < 0:
                req.t_prefill_start = now
            if hook is not None:
                hook("prefill.build")
            toks = np.zeros((1, seg.length), np.int32)
            if req.prompt_tokens is not None:
                toks[0] = req.prompt_tokens[
                    seg.req_start: seg.req_start + seg.length]
            enc = None
            if self.enc_ctx and seg.req_start == 0:
                enc = torch.zeros((1, self.enc_ctx, self.cfg.d_model),
                                  dtype=torch.float32, device=self.device)
                if req.enc_embeds is not None:
                    enc[0].copy_(torch.as_tensor(req.enc_embeds))
            toks = to_device(toks, self.device)
            if hook is not None:
                hook("prefill.launch")
            logits, self._caches[seg.rid] = M.prefill(
                self.params, self.cfg, toks, self._caches[seg.rid],
                q_offset=seg.req_start, enc_embeds=enc)
            req.prefilled = seg.req_start + seg.length
            if req.prefilled >= req.prompt_len:
                if hook is not None:
                    hook("prefill.sync")
                finished.append(self._finish_dense(req, logits, now))
        if hook is not None:
            hook("prefill.post")
        return finished

    def _finish_dense(self, req: Request, logits, now: float
                      ) -> PrefilledKV:
        n_chunks = self._note_finished(req, now)
        delay = self.network.send_kv(self.cfg, req.prompt_len,
                                     n_chunks=n_chunks,
                                     enc_len=self.enc_ctx)
        req.phase = Phase.TRANSFER
        # the host copy of the argmax waits for the request's last chunk
        first_tok = int(torch.argmax(logits[0, -1]))
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        cache = self._caches.pop(req.rid)
        self._reqs.pop(req.rid)
        return PrefilledKV(req=req, cache=cache, first_token=first_tok,
                           transfer_delay_s=delay, n_chunks=n_chunks,
                           kv_len=req.prompt_len, enc_len=self.enc_ctx,
                           ready=ready)

    def _note_finished(self, req: Request, now: float) -> int:
        req.t_first_token = now     # chunked prefill emits the first token
        if self.predictor is not None:
            b, lo, hi = self.predictor.predict_range(
                req.prompt_tokens, req.decode_len)
            req.predicted_bucket, req.predicted_lo, req.predicted_hi = \
                b, lo, hi
        # cached-prefix tokens were never chunked, so they add no
        # chunk-granular transfer slices either
        return chunking.chunks_for(
            req.prompt_len - req.cached_prefix_tokens, self.chunk_size)

    def select_decode_instance(self, loads, req: Request) -> Optional[str]:
        return self.dispatcher.select(
            loads, req.prompt_len, req.predicted_hi,
            heavy=req.is_heavy_decode())
