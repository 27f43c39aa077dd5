"""Decode instance (paper §3.4): receiver -> working-set-aware local
scheduler -> continuous-batching decode engine, on the paged backend.

Slot-based continuous batching: a fixed-capacity slot batch with a
validity mask; the admission policy (greedy / reserve-static /
reserve-dynamic) decides which queued requests join each iteration
against the paged-KV allocator.  K/V lives in a shared device
``PagePool``; admission INSTALLS the received page contents (in place)
and a block-table row, every iteration runs the full slot batch through
the CUDA paged-decode kernel (the paged MLA decode kernel over latent
pages for MLA configs), block tables grow page-at-a-time via the
allocator's ``append_token``, and argmax stays on the device (one int
per slot crosses to the host).  Cross-attention archs (VLM / enc-dec)
install the shipped encoder pages once at admission, in the same
scatter as the self pages; every iteration reads them through a second
block table (the cross decode kernel; nothing is scattered into them)
and they are freed exactly once when the request finishes.

The model runs on ``device`` ("cuda" unless the caller asks for "cpu");
``params`` must live there.  Decoding is greedy: a request whose
``SamplingParams`` asks for sampling raises ``NotImplementedError``
(on-device sampling is a later slice), as do the dense backend and the
prefix cache.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backend import backend_for
from repro_torch.core.decode_types import FinishedRequest
from repro_torch.core.prefill_engine import (PrefilledKV, make_page_pool,
                                             to_device)
from repro_torch.core.sched.decode_scheduler import DecodeScheduler
from repro_torch.kvcache.paged import PagedAllocator
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.request import Phase, Request


@dataclasses.dataclass
class SlotState:
    req: Request
    last_token: int
    tokens: List[int]


class DecodeEngine:
    def __init__(self, iid: str, cfg: ModelConfig, params, *,
                 max_slots: int = 8, max_seq: int = 512,
                 policy: str = "reserve-dynamic",
                 n_pages: int = 512, page_size: int = 16,
                 backend: str = "auto", prefix_cache: bool = False,
                 device="cuda"):
        if prefix_cache:
            raise NotImplementedError(
                "prefix cache on the engines: comes with the prefix-cache "
                "slice")
        self.iid = iid
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.spec = backend_for(cfg, backend)
        self.backend = self.spec.backend
        self.enc_ctx = self.spec.cross_ctx
        self.alloc = PagedAllocator(n_pages=n_pages, page_size=page_size,
                                    cross_tokens=self.enc_ctx)
        self.scheduler = DecodeScheduler(self.alloc, policy=policy,
                                         max_batch=max_slots)
        self.page_size = page_size
        self.slots: Dict[int, SlotState] = {}
        self._pending: Dict[str, PrefilledKV] = {}
        self.iterations = 0
        # (rid, token) pairs emitted by the LAST step() — the streaming
        # feed a serving layer forwards to request handles
        self.stream_events: List[Tuple[str, int]] = []
        # the allocator's block tables ARE the physical mapping
        self.pool, self._trash = make_page_pool(cfg, n_pages, page_size,
                                                self.device)
        self._bt_width = self.alloc.pages_for(max_seq)
        self._cross_bt_width = self.alloc.cross_pages_per_request

    # ------------------------------------------------------------------
    def receive(self, pk: PrefilledKV,
                now: Optional[float] = None) -> None:
        """Receiver module: prefilled KV has arrived (post transfer wait).
        ``now`` (when the caller tracks time) stamps the transfer-done
        timestamp that ``summarize`` turns into ``avg_transfer``."""
        sp = pk.req.sampling
        if sp is not None and not sp.greedy:
            raise NotImplementedError(
                f"{pk.req.rid}: sampled decoding (temperature "
                f"{sp.temperature}) comes with the on-device sampling "
                "slice; the port decodes greedily")
        # block-table rows are sized for max_seq; the finish condition in
        # step() keeps every admitted sequence inside that bound
        if pk.req.prompt_len >= self.max_seq:
            raise ValueError(f"{pk.req.rid}: prompt {pk.req.prompt_len} "
                             f">= max_seq {self.max_seq}")
        pk.req.phase = Phase.DECODE_QUEUED
        if now is not None:
            pk.req.t_transfer_done = now
        self._pending[pk.req.rid] = pk
        self.scheduler.enqueue(pk.req)

    def _free_slot(self) -> Optional[int]:
        for s in range(self.max_slots):
            if s not in self.slots:
                return s
        return None

    def admit(self, now: float) -> List[Request]:
        admitted = self.scheduler.admit()
        pages: List[int] = []
        payload_k, payload_v = [], []
        for req in admitted:
            slot = self._free_slot()
            if slot is None:
                raise RuntimeError("scheduler admitted past slot capacity")
            pk = self._pending.pop(req.rid)
            # stage the received pages for the pages the scheduler's
            # admission just allocated; the block-table row is the
            # allocator's table
            live = self.alloc.live_pages(req.rid)
            if pk.pages_k is None or pk.pages_k.shape[1] != len(live):
                raise ValueError(
                    f"{req.rid}: the paged decode engine needs a "
                    "page-granular payload from a paged prefill engine "
                    "with the same page_size")
            pages.extend(live)
            payload_k.append(pk.pages_k)
            payload_v.append(pk.pages_v)
            if self.spec.cross == "pages":
                # the one-shot cross payload lands in the cross pages the
                # admission alloc drew from the same pool
                ctab = self.alloc.cross_table(req.rid)
                if pk.cross_k is None or pk.cross_k.shape[1] != len(ctab):
                    raise ValueError(
                        f"{req.rid}: a cross-attention arch needs the "
                        "encoder pages shipped beside the self KV")
                pages.extend(ctab)
                payload_k.append(pk.cross_k)
                payload_v.append(pk.cross_v)
                self.alloc.commit_cross(req.rid)
            self.slots[slot] = SlotState(req=req,
                                         last_token=pk.first_token,
                                         tokens=[pk.first_token])
            req.phase = Phase.DECODE
            if req.t_decode_start < 0:
                req.t_decode_start = now
        if pages:
            # one in-place scatter for the whole admitted batch
            self.pool.install(pages, torch.cat(payload_k, dim=1),
                              torch.cat(payload_v, dim=1))
        # the prefill-emitted first token can itself satisfy the user's
        # stop criteria (e.g. immediate EOS): finish before any decode
        # iteration runs, releasing the slot and pages right away
        admitted_rids = {r.rid for r in admitted}
        for s in list(self.slots):
            st = self.slots[s]
            req = st.req
            if req.rid in admitted_rids and req.sampling is not None \
                    and req.sampling.should_stop(1, st.last_token):
                req.phase = Phase.FINISHED
                req.t_finish = now
                self.scheduler.finish(req.rid)
                del self.slots[s]
        return admitted

    def step(self, now: float) -> List[FinishedRequest]:
        """One continuous-batching decode iteration over the slot batch."""
        self.stream_events = []    # even on the empty early return: a
        if not self.slots:         # cancel can drain the batch with a
            return []              # decode_done event still in flight
        self.iterations += 1
        nxt = self._iteration_paged()
        finished: List[FinishedRequest] = []
        for s in list(self.slots):
            st = self.slots[s]
            req = st.req
            st.last_token = int(nxt[s])
            st.tokens.append(st.last_token)
            self.stream_events.append((req.rid, st.last_token))
            # stop criteria: the user's SamplingParams when attached,
            # else the ground-truth decode_len (oracle mode); the max_seq
            # guard always bounds the block table
            if req.sampling is not None:
                stop = req.sampling.should_stop(len(st.tokens),
                                                st.last_token)
            else:
                stop = req.generated >= req.decode_len
            if stop or req.prompt_len + req.generated >= self.max_seq - 1:
                req.phase = Phase.FINISHED
                req.t_finish = now
                self.scheduler.finish(req.rid)
                finished.append(FinishedRequest(req=req, tokens=st.tokens))
                del self.slots[s]
        return finished

    def cancel(self, rid: str) -> bool:
        """User cancel mid-decode: releases the slot and frees the
        request's pages (running) or drops it from the queue (pending).
        Returns whether this engine knew the request."""
        for s, st in list(self.slots.items()):
            if st.req.rid == rid:
                del self.slots[s]
                return self.scheduler.cancel(rid)
        known = rid in self._pending
        self._pending.pop(rid, None)
        return self.scheduler.cancel(rid) or known

    def _iteration_paged(self) -> np.ndarray:
        """Full-slot-batch fused decode against the page pool."""
        ms, ps, trash = self.max_slots, self.page_size, self._trash
        toks = np.zeros((ms, 1), np.int32)
        pos = np.zeros((ms,), np.int32)
        pages = np.full((ms,), trash, np.int32)
        offs = np.zeros((ms,), np.int32)
        bt = np.full((ms, self._bt_width), trash, np.int32)
        lens = np.zeros((ms,), np.int32)
        cross = self.spec.cross == "pages"
        if cross:
            # empty slots keep enc_len 0 and a row on the scratch page
            cbt = np.full((ms, self._cross_bt_width), trash, np.int32)
            clens = np.zeros((ms,), np.int32)
        for s, st in self.slots.items():
            p = st.req.prompt_len + st.req.generated
            # account the token being appended THIS iteration; the
            # returned physical page is where its K/V scatters
            pages[s] = self.scheduler.step_token(st.req.rid)
            toks[s, 0] = st.last_token
            pos[s] = p
            offs[s] = p % ps
            table = self.alloc.table_padded(st.req.rid, trash)
            bt[s, :len(table)] = table
            lens[s] = p + 1
            if cross:
                ctab = self.alloc.cross_table(st.req.rid)
                cbt[s, :len(ctab)] = ctab
                clens[s] = self.enc_ctx
        # copy-on-write: step_token may have redirected a slot's tail
        # page off a shared page — replay the page copies on the device
        # pool BEFORE the kernels scatter this iteration's tokens
        cows = self.alloc.take_cow_copies()
        if cows:
            src, dst = zip(*cows)
            self.pool.copy_pages(list(src), list(dst))
        dev = self.device
        cross_args = {}
        if cross:
            cross_args = dict(cross_bt=to_device(cbt, dev),
                              cross_len=to_device(clens, dev))
        nxt = M.decode_step_paged(
            self.params, self.cfg, to_device(toks, dev),
            to_device(pos, dev), to_device(pages, dev),
            to_device(offs, dev), to_device(bt, dev), to_device(lens, dev),
            self.pool.k, self.pool.v, **cross_args)
        return nxt.cpu().numpy()

    # ------------------------------------------------------------------
    def load(self) -> dict:
        return self.scheduler.load()

    def idle(self) -> bool:
        return not self.slots and not self.scheduler.queue

    def resident(self) -> List[Request]:
        """Requests this engine still owns (pending install, queued or
        in a slot)."""
        seen: Dict[str, Request] = {}
        for pk in self._pending.values():
            seen[pk.req.rid] = pk.req
        for r in self.scheduler.queue:
            seen[r.rid] = r
        for st in self.slots.values():
            seen[st.req.rid] = st.req
        return list(seen.values())
