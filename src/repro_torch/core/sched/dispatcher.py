"""Prefill-instance dispatcher: inter-decode-instance scheduling (§3.3.4).

Decentralized power-of-two load balancing over predicted resource usage:
  1. split decode instances into alpha (enough free KV pages for the
     request's predicted upper bound) and beta (not enough);
  2. sample two instances from alpha uniformly;
  3. of the two, pick the one whose heavy:light decode ratio would stay
     lowest — spreading heavy decodes evenly (Fig. 5's interference).

``random`` and ``imbalance`` policies reproduce Fig. 19's baselines.
"""
from __future__ import annotations

import dataclasses
import random as _random
from typing import Dict, Optional

POLICIES = ("power2", "random", "imbalance")


@dataclasses.dataclass
class DecodeLoad:
    """Load snapshot of one decode instance, broadcast by the cluster
    monitor (§3.2) every interval."""
    iid: str
    free_pages: int
    n_heavy: int
    n_light: int
    queued: int = 0

    @property
    def ratio(self) -> float:
        return self.n_heavy / max(1, self.n_light)


class Dispatcher:
    def __init__(self, policy: str = "power2", page_size: int = 16,
                 seed: int = 0):
        assert policy in POLICIES, policy
        self.policy = policy
        self.page_size = page_size
        self.rng = _random.Random(seed)

    def pages_needed(self, prompt_len: int, predicted_hi: int) -> int:
        """Upper-bound KV pages for prompt + predicted generation."""
        toks = prompt_len + max(predicted_hi, 1)
        return -(-toks // self.page_size)

    def select(self, loads: Dict[str, DecodeLoad], prompt_len: int,
               predicted_hi: int, heavy: bool) -> Optional[str]:
        """Pick a decode instance id, or None if all are saturated."""
        if not loads:
            return None
        insts = list(loads.values())
        if self.policy == "imbalance":
            # worst case: heavy decodes all pile onto the first instance
            insts.sort(key=lambda l: l.iid)
            return insts[0].iid if heavy else insts[-1].iid
        if self.policy == "random":
            return self.rng.choice(insts).iid

        need = self.pages_needed(prompt_len, predicted_hi)
        alpha = [l for l in insts if l.free_pages >= need]
        if not alpha:
            # fall back: least-loaded beta instance (request will queue)
            return max(insts, key=lambda l: l.free_pages).iid
        two = self.rng.sample(alpha, min(2, len(alpha)))
        # least interference: lowest heavy:light ratio after placement
        def ratio_after(l: DecodeLoad) -> float:
            return (l.n_heavy + (1 if heavy else 0)) / max(
                1, l.n_light + (0 if heavy else 1))
        return min(two, key=ratio_after).iid
