"""Cluster simulator entry points (paper-scale experiments, §5), the
reference's ``repro.runtime.simulator`` on the port.

The TetriInfer orchestration itself lives in ``repro_torch.serving.Cluster``
(one event loop for both the cost-model runtime and the engines);
``DisaggSimulator`` is the reference's thin compatibility shim over
``Cluster(runtime="sim")``, metric-identical to it on fixed seeds
(pinned by tests/golden_sim_metrics.json).

``CoupledSimulator`` — the vanilla-vLLM baseline where prefill and
decode share each instance and prefill iterations preempt decode (the
§2.2.2 interference, structurally) — remains a standalone loop: it is
the comparison *baseline*, not a disaggregated orchestration.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.kv_transfer import NetworkStack
from repro_torch.core.predictor import OraclePredictor
from repro_torch.kvcache.paged import OutOfPages, PagedAllocator
from repro_torch.runtime.costmodel import CostModel
from repro_torch.runtime.request import Phase, Request, summarize
from repro_torch.serving.cluster import Cluster, SimResult
from repro_torch.serving.sim_instance import SWAP_BW

__all__ = ["DisaggSimulator", "CoupledSimulator", "SimResult", "SWAP_BW"]


class DisaggSimulator:
    """Compat shim: the reference's simulator constructor/result
    surface, delegating to the serving ``Cluster`` (see
    docs/serving_api.md).  New code should use
    ``repro_torch.serving.Cluster`` directly."""

    def __init__(self, cfg, cost: CostModel, *, n_prefill=1, n_decode=1,
                 prefill_policy="sjf", sched_batch=16, chunk_size=512,
                 decode_policy="reserve-dynamic", dispatch_policy="power2",
                 predictor: Optional[OraclePredictor] = None,
                 network: Optional[NetworkStack] = None,
                 n_pages=4096, page_size=16, max_batch=64,
                 enable_flip=False, flip_idle_s=60.0,
                 co_run_predictor=True):
        self.cluster = Cluster(
            cfg, runtime="sim", cost=cost,
            n_prefill=n_prefill, n_decode=n_decode,
            prefill_policy=prefill_policy, sched_batch=sched_batch,
            chunk_size=chunk_size, decode_policy=decode_policy,
            dispatch_policy=dispatch_policy,
            # the old simulator defaulted a missing predictor to the
            # oracle — preserve that here
            predictor=predictor or OraclePredictor(),
            network=network, n_pages=n_pages, page_size=page_size,
            max_batch=max_batch, enable_flip=enable_flip,
            flip_idle_s=flip_idle_s, co_run_predictor=co_run_predictor)

    @property
    def instances(self):
        return self.cluster.instances

    def run(self, requests: List[Request]) -> SimResult:
        return self.cluster.serve(requests)


class CoupledSimulator:
    """vanilla-vLLM: fixed-batch prefill preempts decode in one instance."""

    def __init__(self, cfg, cost: CostModel, *, n_instances=1,
                 prefill_batch=16, n_pages=4096, page_size=16,
                 max_batch=64):
        self.cfg = cfg
        self.cost = cost
        self.prefill_batch = prefill_batch
        self.n_instances = n_instances
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_batch = max_batch

    def run(self, requests: List[Request]) -> SimResult:
        insts = [{"waiting": [], "alloc": PagedAllocator(self.n_pages,
                                                         self.page_size),
                  "running": {}, "busy": 0.0, "t": 0.0, "swaps": 0}
                 for _ in range(self.n_instances)]
        # round-robin arrival routing
        for i, r in enumerate(sorted(requests, key=lambda r: r.arrival)):
            insts[i % self.n_instances]["waiting"].append(r)

        for inst in insts:
            t = 0.0
            waiting: List[Request] = inst["waiting"]
            running: Dict[str, Request] = inst["running"]
            alloc: PagedAllocator = inst["alloc"]
            while waiting or running:
                # continuous batching: admit waiting prefills into this
                # iteration alongside every running decode (§2.2.2)
                batch = []
                while (waiting and len(batch) < self.prefill_batch
                       and len(running) + len(batch) < self.max_batch
                       and waiting[0].arrival <= t
                       and alloc.can_admit(waiting[0].prompt_len + 1)):
                    r = waiting.pop(0)
                    alloc.alloc(r.rid, r.prompt_len)
                    batch.append(r)
                if not batch and not running:
                    t = max(t, waiting[0].arrival)
                    continue
                p_toks = sum(r.prompt_len for r in batch)
                d_n = len(running)
                d_ctx = sum(r.prompt_len + r.generated
                            for r in running.values())
                dur = self.cost.mixed_time(p_toks, d_n, d_ctx)
                for r in batch:
                    if r.swapped:   # swap the evicted KV back in
                        dur += self.cfg.kv_bytes_per_token() \
                            * (r.prompt_len + r.generated) / SWAP_BW
                        r.swapped = False
                for r in batch:
                    r.t_prefill_start = t
                t += dur
                inst["busy"] += dur
                for r in batch:       # prefilled this iteration
                    r.t_first_token = t
                    r.t_decode_start = t
                    r.phase = Phase.DECODE
                    running[r.rid] = r
                for rid in list(running):
                    r = running[rid]
                    if r.t_first_token == t:
                        continue      # joined this iteration; decodes next
                    try:
                        alloc.append_token(rid)
                    except OutOfPages:
                        inst["swaps"] += 1
                        kvb = self.cfg.kv_bytes_per_token() \
                            * (r.prompt_len + r.generated)
                        inst["busy"] += kvb / SWAP_BW
                        t += kvb / SWAP_BW
                        alloc.free(rid)
                        r.phase = Phase.WAITING
                        r.swapped = True
                        waiting.append(r)
                        del running[rid]
                        continue
                    r.generated += 1
                    if r.generated >= r.decode_len:
                        r.phase = Phase.FINISHED
                        r.t_finish = t
                        alloc.free(rid)
                        del running[rid]
            inst["t"] = t

        busy = sum(i["busy"] for i in insts)
        return SimResult(
            metrics=summarize(requests), resource_time=busy,
            prefill_busy=0.0, decode_busy=busy,
            swap_events=sum(i["swaps"] for i in insts), flips=0,
            requests=requests)
