"""Coupled prefill + decode baseline (vanilla-vLLM-style, paper §5).

One engine owns both phases: continuous batching admits waiting
requests greedily, and a prefill iteration (a fixed batch of whole
prompts, no chunking) preempts decode whenever new requests wait, which
reproduces the interference of paper §2.2.2 structurally.  It is the
comparison point of the end-to-end runs and of the output-equivalence
checks: the disaggregated ``Cluster`` must give its tokens.

The model runs on the dense backend on ``device`` ("cuda" unless the
caller asks for "cpu"): each prompt prefills whole into a batch=1 dense
cache (attention through kernel 5) that is copied into the request's
slot of a (max_slots, max_seq) cache; a decode iteration runs
``model.decode_step`` over every slot and takes the argmax.  A
``PagedAllocator`` keeps the page accounts that admission checks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.decode_types import FinishedRequest
from repro_torch.kvcache.paged import PagedAllocator
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.request import Phase, Request


@dataclasses.dataclass
class _Slot:
    req: Request
    last_token: int
    tokens: List[int]


class CoupledEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8,
                 max_seq: int = 512, prefill_batch: int = 4,
                 n_pages: int = 512, page_size: int = 16, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.prefill_batch = prefill_batch
        self.alloc = PagedAllocator(n_pages=n_pages, page_size=page_size)
        self.waiting: List[Request] = []
        self.slots: Dict[int, _Slot] = {}
        self.cache = M.init_cache(cfg, max_slots, max_seq,
                                  device=self.device)
        self.iterations = 0
        self.prefill_iterations = 0

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _free_slot(self) -> Optional[int]:
        for s in range(self.max_slots):
            if s not in self.slots:
                return s
        return None

    @torch.no_grad()
    def step(self, now: float) -> List[FinishedRequest]:
        """One engine iteration: prefill if requests wait, else decode.
        No autograd graph is recorded, whatever the weights'
        ``requires_grad``."""
        self.iterations += 1
        if self.waiting:
            return self._prefill_iteration(now)
        return self._decode_iteration(now)

    def _prefill_iteration(self, now: float) -> List[FinishedRequest]:
        self.prefill_iterations += 1
        batch = []
        while (self.waiting and len(batch) < self.prefill_batch
               and self._free_slot() is not None
               and self.alloc.can_admit(self.waiting[0].prompt_len + 1)):
            req = self.waiting.pop(0)
            self.alloc.alloc(req.rid, req.prompt_len)
            batch.append(req)
        for req in batch:
            slot = self._free_slot()
            req.phase = Phase.PREFILL
            if req.t_prefill_start < 0:
                req.t_prefill_start = now
            toks = np.zeros((1, req.prompt_len), np.int32)
            if req.prompt_tokens is not None:
                toks[0] = req.prompt_tokens[: req.prompt_len]
            sub = M.init_cache(self.cfg, 1, self.max_seq,
                               device=self.device)
            logits, sub = M.prefill(self.params, self.cfg,
                                    torch.from_numpy(toks).to(self.device),
                                    sub, q_offset=0)
            M.cache_insert(self.cache, sub, slot)
            first = int(torch.argmax(logits[0, -1]))
            req.t_first_token = now
            req.phase = Phase.DECODE
            req.t_decode_start = now
            self.slots[slot] = _Slot(req=req, last_token=first,
                                     tokens=[first])
        return []

    def _decode_iteration(self, now: float) -> List[FinishedRequest]:
        if not self.slots:
            return []
        toks = np.zeros((self.max_slots, 1), np.int32)
        pos = np.zeros((self.max_slots,), np.int32)
        for s, st in self.slots.items():
            toks[s, 0] = st.last_token
            pos[s] = st.req.prompt_len + st.req.generated
        logits, self.cache = M.decode_step(
            self.params, self.cfg, torch.from_numpy(toks).to(self.device),
            self.cache, torch.from_numpy(pos).to(self.device))
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        finished: List[FinishedRequest] = []
        for s in list(self.slots):
            st = self.slots[s]
            req = st.req
            self.alloc.append_token(req.rid)
            req.generated += 1
            st.last_token = int(nxt[s])
            st.tokens.append(st.last_token)
            if (req.generated >= req.decode_len
                    or req.prompt_len + req.generated >= self.max_seq - 1):
                req.phase = Phase.FINISHED
                req.t_finish = now
                self.alloc.free(req.rid)
                finished.append(FinishedRequest(req=req, tokens=st.tokens))
                del self.slots[s]
        return finished

    def done(self) -> bool:
        return not self.waiting and not self.slots
