"""Roofline accounting of one eager step, op by op (the counterpart of
the reference's ``launch/hlo_cost.py``, which parses XLA's optimized
HLO; PyTorch has no HLO, so this reads the dispatched operations).

``analyze(fn, *args)`` runs ``fn`` under
``torch.utils.flop_counter.FlopCounterMode`` (flops),
``torch.distributed.tensor.debug.CommDebugMode`` (collective counts)
and a dispatch mode of its own that sums each operation's operand and
output bytes, the output bytes of each collective by kind, and the peak
bytes of live intermediate tensors.  Run on the local shards of the
sharded forward (``models/sharding.py``), every number is per device,
as the reference's post-SPMD HLO is.  An eager loop runs once for each
pass, so every trip is counted (``unknown_trip_loops`` is 0).  Views
and metadata operations move no bytes; an operation on DTensors is
skipped (its local operations are counted as they run).

Kernel 5 has no meta kernel (its wrapper refuses a meta tensor), so
while ``analyze`` runs, its forward and backward wrappers take meta
tensors to a stand-in (``kernel5_on_meta``) that returns empty results
of the right shapes and counts the work the kernel would do: the
query-key pairs it reads (the causal triangle up to q_offset + sq,
inside the window; every key of a non-causal call), 2 (hd + hd_v)
flops a pair and head forward and 2 (3 hd + 2 hd_v) backward, and the
bytes of q, the live K/V rows and the output (twice each backward).
Its plain version would count full score matrices the kernel never
materializes.  Any other tensor goes to the wrapper as before.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the functional collectives and their names in the reference's tables
COLLECTIVES = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "broadcast"}
# ring all-reduce moves ~2x the shard over the link (reduce-scatter +
# all-gather); the others ~1x
LINK_FACTOR = {"all-reduce": 2.0}
_FREE = {"detach", "wait_tensor", "empty", "empty_strided", "lift_fresh"}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CostSummary:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    unknown_trip_loops: int = 0
    peak_live_bytes: int = 0
    output: Any = None

    def link_bytes(self) -> float:
        return sum(LINK_FACTOR.get(k, 1.0) * v
                   for k, v in self.collective_bytes.items())


class _ByteMode(TorchDispatchMode):
    def __init__(self, summary: CostSummary):
        super().__init__()
        self.s = summary
        self.live = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in ins):
            return out
        name = func.overloadpacket.__name__
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if func.namespace == "_c10d_functional" and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            b = sum(tensor_bytes(t) for t in outs)
            self.s.collective_bytes[kind] += b
            self.s.hbm_bytes += b
        elif func.is_view or name in _FREE:
            if name == "wait_tensor":
                # the waited tensor aliases the collective's output: keep
                # that object (and its live count) as long as this one
                for t in outs:
                    t._op_cost_keep = ins
            return out
        else:
            self.s.hbm_bytes += (sum(tensor_bytes(t) for t in ins)
                                 + sum(tensor_bytes(t) for t in outs))
        ids = {id(t) for t in ins}
        for t in outs:
            if id(t) in ids or t._is_view():
                continue             # in place, or a view of an input
            n = tensor_bytes(t)
            self.live += n
            self.s.peak_live_bytes = max(self.s.peak_live_bytes, self.live)
            weakref.finalize(t, self._free, n)
        return out


def _live_pairs(sq: int, skv: int, q_offset: int, window: int,
                causal: bool) -> tuple:
    """(query-key pairs a call reads a head, first live key) for the
    model's dense calls: causal ones end at q_offset + sq."""
    if not causal:
        return sq * skv, 0
    pairs = 0
    for i in range(q_offset, q_offset + sq):
        lo = max(0, i - window + 1) if window else 0
        pairs += i + 1 - lo
    return pairs, max(0, q_offset - window + 1) if window else 0


@contextlib.contextmanager
def kernel5_on_meta(summary: CostSummary):
    """Kernel 5's wrappers with a meta stand-in (see the module's
    docstring) adding its work to ``summary``; restored on exit."""
    from repro_torch.kernels import chunked_prefill_attention as K
    from repro_torch.kernels import ops
    fwd, bwd = K.chunked_prefill_attention, K.chunked_prefill_attention_bwd

    def work(q, k_cache, v_cache, q_offset, window, causal, grads):
        b, sq, h, hd = q.shape
        skv, kvh, hd_v = k_cache.shape[1], k_cache.shape[2], \
            v_cache.shape[3]
        pairs, lo = _live_pairs(sq, skv, int(q_offset), window, causal)
        per = (3 * hd + 2 * hd_v) if grads else (hd + hd_v)
        summary.flops += 2.0 * b * h * pairs * per
        keys = (int(q_offset) + sq if causal else skv) - lo
        summary.hbm_bytes += q.element_size() * b * (2 if grads else 1) * (
            sq * h * (hd + hd_v) + keys * kvh * (hd + hd_v))

    def meta_fwd(q, k_cache, v_cache, kv_len, q_offset, *, window=0,
                 causal=True):
        if q.device.type != "meta":
            return fwd(q, k_cache, v_cache, kv_len, q_offset,
                       window=window, causal=causal)
        work(q, k_cache, v_cache, q_offset, window, causal, False)
        return q.new_empty(q.shape[:3] + v_cache.shape[3:])

    def meta_bwd(q, k_cache, v_cache, out, dout, kv_len, q_offset, *,
                 window=0, causal=True):
        if q.device.type != "meta":
            return bwd(q, k_cache, v_cache, out, dout, kv_len, q_offset,
                       window=window, causal=causal)
        work(q, k_cache, v_cache, q_offset, window, causal, True)
        return (torch.empty_like(q), torch.empty_like(k_cache),
                torch.empty_like(v_cache))

    K.chunked_prefill_attention = ops.chunked_prefill_attention = meta_fwd
    K.chunked_prefill_attention_bwd = meta_bwd
    try:
        yield
    finally:
        K.chunked_prefill_attention = ops.chunked_prefill_attention = fwd
        K.chunked_prefill_attention_bwd = bwd


def analyze(fn, *args, **kwargs) -> CostSummary:
    """Run ``fn(*args, **kwargs)`` once and account for it; the result is
    in the summary's ``output``."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    s = CostSummary()
    flops = FlopCounterMode(display=False)
    comm = CommDebugMode()
    with kernel5_on_meta(s), flops, comm, _ByteMode(s):
        s.output = fn(*args, **kwargs)
    s.flops += float(flops.get_total_flops())
    for op, n in comm.get_comm_counts().items():
        kind = COLLECTIVES.get(op.__name__)
        if kind is not None:
            s.collective_counts[kind] += n
    return s
