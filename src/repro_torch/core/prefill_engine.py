"""Prefill instance (paper §3.3): local scheduler -> chunked-prefill LLM
engine -> dispatcher, on the paged backend.

The engine owns a device ``PagePool``; one ``step`` executes the WHOLE
fixed-size chunk as a single fused ``model.prefill_paged`` call
(segments of multiple requests packed on the batch dim), writing K/V
straight into pages.  Finished requests ship ``(live page contents)``
through ``PrefilledKV`` and free their pages.

Host-side bookkeeping is the reference's: pad to powers of two, tables
built with numpy, first tokens copied to the host.  The model runs on
``device`` ("cuda" unless the caller asks for "cpu"); ``params`` must
live there.  The dense backend, cross-attention pages and the prefix
cache come with their slices.
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
    builds a block-table row."""
    req: Request
    first_token: int             # argmax token from prefill (the 'first token')
    transfer_delay_s: float      # emulated network wait
    n_chunks: int = 1
    pages_k: object = None
    pages_v: object = None
    kv_len: int = 0


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
        self.alloc = PagedAllocator(n_pages=n_pages, page_size=page_size)
        self.pool, self._trash = make_page_pool(cfg, n_pages, page_size,
                                                self.device)
        self._bt_width = self.alloc.pages_for(max_seq)

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
        model call for the whole chunk."""
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
        dev = self.device
        next_tok, _ = M.prefill_paged(
            self.params, self.cfg, to_device(toks, dev),
            to_device(qoff, dev), to_device(kvlen, dev),
            to_device(last, dev), to_device(bt, dev), to_device(pg, dev),
            to_device(off, dev), self.pool.k, self.pool.v)
        self.fused_calls += 1
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
        delay = self.network.send_kv(self.cfg, req.prompt_len,
                                     n_chunks=n_chunks,
                                     page_size=self.page_size)
        req.phase = Phase.TRANSFER
        # gather() returns a COPY of the live pages, which are freed right
        # below: the payload survives the next chunk scattering into them
        pages_k, pages_v = self.pool.gather(self.alloc.live_pages(req.rid))
        self.alloc.free(req.rid)
        self._reqs.pop(req.rid)
        return PrefilledKV(req=req, first_token=first_tok,
                           transfer_delay_s=delay, n_chunks=n_chunks,
                           pages_k=pages_k, pages_v=pages_v,
                           kv_len=req.prompt_len)

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
