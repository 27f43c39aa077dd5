"""SLO attainment accounting (DistServe-style goodput).

Disaggregation quality is not raw throughput but *goodput* — the
fraction of requests that finished AND met their latency targets:
TTFT (time to first token, the prefill-side SLO) and TBT (average
time between tokens, the decode-side SLO).  ``SLOSpec`` names the
targets; ``summarize(reqs, slo=...)`` and ``FleetReport`` report
attainment next to avg/p90 latencies.

The attainment predicate is the reference's, verbatim (its fleet
harness shares it):

  meets ⟺ finished ∧ ttft ≤ ttft_target ∧
          (t_finish − t_first_token) / max(1, generated) ≤ tbt_target
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-request latency targets (seconds)."""
    ttft_target_s: float = 5.0
    tbt_target_s: float = 0.25

    def __post_init__(self):
        assert self.ttft_target_s > 0 and self.tbt_target_s > 0, \
            "SLO targets must be positive"


def meets_slo(req, slo: SLOSpec) -> bool:
    """True iff ``req`` finished within both targets."""
    from repro_torch.runtime.request import Phase
    if req.phase is not Phase.FINISHED:
        return False
    if req.ttft > slo.ttft_target_s:
        return False
    tbt = (req.t_finish - req.t_first_token) / max(1, req.generated)
    return tbt <= slo.tbt_target_s


def good_count(reqs: List, slo: SLOSpec) -> int:
    return sum(1 for r in reqs if meets_slo(r, slo))


def attainment(reqs: List, slo: SLOSpec) -> dict:
    """Goodput block for ``summarize()``: attainment over SUBMITTED
    requests (a shed/failed/cancelled request is a missed SLO, exactly
    like the fleet harness counts it)."""
    good = good_count(reqs, slo)
    return {
        "slo_good": good,
        "goodput": good / len(reqs) if reqs else 0.0,
        "slo_ttft_s": slo.ttft_target_s,
        "slo_tbt_s": slo.tbt_target_s,
    }
