"""Prefill instance (paper §3.3): local scheduler -> chunked-prefill LLM
engine -> dispatcher, on the paged backend.

The engine owns a device ``PagePool``; one ``step`` executes the WHOLE
fixed-size chunk as a single fused ``model.prefill_paged`` call
(segments of multiple requests packed on the batch dim), writing K/V
straight into pages.  Finished requests ship ``(live page contents)``
through ``PrefilledKV`` and free their pages.  Cross-attention archs
(VLM / enc-dec) also hold READ-ONLY cross pages per request: the encoder
K/V is scattered once, by the chunk holding the request's first
segment; every chunk attends it through a second block table, and the
finished request ships the cross pages beside the self KV.

Host-side bookkeeping is the reference's: pad to powers of two, tables
built with numpy, first tokens copied to the host.  The model runs on
``device`` ("cuda" unless the caller asks for "cpu"); ``params`` must
live there.  The dense backend and the prefix cache (with its cross-page
dedupe) come with their slices.
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
from repro_torch.kvcache.paged import OutOfPages, PagedAllocator, PagePool
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
    builds a block-table row.  Cross-attention archs also ship
    ``cross_k``/``cross_v``, copies of the read-only encoder pages (L,
    cross_pages, page, kvh, hd), covering ``enc_len`` encoder tokens:
    a one-shot payload, amortized over the whole decode."""
    req: Request
    first_token: int             # argmax token from prefill (the 'first token')
    transfer_delay_s: float      # emulated network wait
    n_chunks: int = 1
    pages_k: object = None
    pages_v: object = None
    kv_len: int = 0
    cross_k: object = None       # cross-attention archs only
    cross_v: object = None
    enc_len: int = 0
    # whether the cross pages were aliased from the prefix cache (the
    # encoder ran 0 times for this request); False until the port has
    # the cache
    cross_cached: bool = False


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
        if prefix_cache:
            raise NotImplementedError(
                "prefix cache on the engines: comes with the prefix-cache "
                "slice")
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
        self.enc_ctx = self.spec.cross_ctx
        self.alloc = PagedAllocator(n_pages=n_pages, page_size=page_size,
                                    cross_tokens=self.enc_ctx)
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
        if self.alloc.has(rid):
            self.alloc.free(rid)
        return True

    # ------------------------------------------------------------------
    def _refill_chunks(self) -> None:
        batch = self.scheduler.next_batch(self.scheduler.sched_batch)
        if not batch:
            return
        # reserve each request's prompt pages up front — prefill writes
        # every prompt position, so ALL pages materialize; requests that
        # don't fit the pool right now go back to the head of the queue —
        # backpressure instead of an OutOfPages crash mid-batch
        fit, defer = [], []
        for r in batch:
            if self.alloc.can_admit(r.prompt_len, materialize_all=True):
                self.alloc.alloc(r.rid, r.prompt_len, materialize_all=True)
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
        if not fit:
            return
        pairs = [(r.rid, r.prompt_len) for r in fit]
        self._chunk_queue.extend(chunking.partition(pairs, self.chunk_size))
        for r in fit:
            r.phase = Phase.PREFILL

    def step(self, now: float) -> List[PrefilledKV]:
        """Run ONE fixed-size chunk (the paper's prefill iteration unit).
        Returns requests whose prefill completed this step."""
        if not self._chunk_queue:
            self._refill_chunks()
        if not self._chunk_queue:
            return []
        chunk = self._chunk_queue.popleft()
        self.chunk_steps += 1
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
                    # segment scatters the encoder K/V into its cross
                    # pages; later chunks only read them (cpg stays at
                    # the scratch page: their write lands there)
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
        next_tok, _ = M.prefill_paged(
            self.params, self.cfg, to_device(toks, dev),
            to_device(qoff, dev), to_device(kvlen, dev),
            to_device(last, dev), to_device(bt, dev), to_device(pg, dev),
            to_device(off, dev), self.pool.k, self.pool.v, **cross_args)
        self.fused_calls += 1
        for rid in scattered:
            # a no-op until the prefix cache publishes cross pages
            self.alloc.commit_cross(rid)
        next_tok = next_tok.cpu().numpy()
        finished: List[PrefilledKV] = []
        for i, seg in enumerate(segs):
            req = self._reqs[seg.rid]
            req.prefilled = seg.req_start + seg.length
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
                                     cross_cached=cross_cached)
        req.phase = Phase.TRANSFER
        # gather() returns a COPY of the live pages, which are freed right
        # below: the payload survives the next chunk scattering into them
        pages_k, pages_v = self.pool.gather(self.alloc.live_pages(req.rid))
        cross_k = cross_v = None
        if enc_len:
            # plus the one-shot read-only cross pages, across every layer
            # of the pool as in the reference (only the cross layers hold
            # encoder K/V; the wire bytes count those alone)
            cross_k, cross_v = self.pool.gather(
                self.alloc.cross_table(req.rid))
        self.alloc.free(req.rid)
        self._reqs.pop(req.rid)
        return PrefilledKV(req=req, first_token=first_tok,
                           transfer_delay_s=delay, n_chunks=n_chunks,
                           pages_k=pages_k, pages_v=pages_v,
                           kv_len=req.prompt_len, cross_k=cross_k,
                           cross_v=cross_v, enc_len=enc_len,
                           cross_cached=cross_cached)

    def _note_finished(self, req: Request, now: float) -> int:
        req.t_first_token = now     # chunked prefill emits the first token
        if self.predictor is not None:
            b, lo, hi = self.predictor.predict_range(
                req.prompt_tokens, req.decode_len)
            req.predicted_bucket, req.predicted_lo, req.predicted_hi = \
                b, lo, hi
        return chunking.chunks_for(req.prompt_len, self.chunk_size)

    def select_decode_instance(self, loads, req: Request) -> Optional[str]:
        return self.dispatcher.select(
            loads, req.prompt_len, req.predicted_hi,
            heavy=req.is_heavy_decode())
