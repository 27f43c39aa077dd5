"""Mixed downstream-workload generator (paper Fig. 1, §5.1).

Synthesizes ShareGPT-like request mixes offline (no internet): log-normal
prompt/decode length distributions calibrated to the paper's medians —
ShareGPT short-prompt median 18, answer median 128, accelerator-saturate
threshold 512 — for the five workload classes LPLD/LPHD/HPLD/HPHD/Mixed.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.runtime.request import Request

HEAVY_PREFILL_THRESH = 512       # tokens (§5.1)
HEAVY_DECODE_THRESH = 128        # ShareGPT answer median (§5.1)

# (prompt_median, prompt_sigma, decode_median, decode_sigma)
_CLASSES = {
    "LPLD": (18, 0.8, 40, 0.7),       # chat
    "LPHD": (18, 0.8, 420, 0.6),      # content creation
    "HPLD": (1100, 0.5, 40, 0.7),     # summarization / prompt engineering
    "HPHD": (1100, 0.5, 420, 0.6),
}
_MIX_WEIGHTS = {"LPLD": 0.45, "LPHD": 0.2, "HPLD": 0.2, "HPHD": 0.15}


def _lognormal(rng, median, sigma, size):
    return np.maximum(1, rng.lognormal(np.log(median), sigma,
                                       size).astype(int))


def generate(workload: str, n: int, *, seed: int = 0,
             arrival_rate: Optional[float] = None,
             max_prompt: int = 2048, max_decode: int = 2048,
             vocab_size: int = 0, enc_ctx: int = 0,
             enc_dim: int = 0, prefix_pool: int = 0,
             prefix_len: int = 0,
             prefix_zipf: float = 1.1) -> List[Request]:
    """workload in {LPLD, LPHD, HPLD, HPHD, Mixed}. ``arrival_rate`` in
    req/s (None = all arrive at t=0, the paper's batch-of-128 setup).
    ``enc_ctx``/``enc_dim`` > 0 attach synthetic frontend embeddings
    (whisper frames / VLM patches) of shape (enc_ctx, enc_dim) per
    request — the stub-frontend input cross-attention archs consume.

    ``prefix_pool``/``prefix_len`` > 0 turn on shared-prefix traffic
    (system prompts / few-shot templates): each request draws one of
    ``prefix_pool`` templates under a Zipf(``prefix_zipf``) popularity
    law and its first ``min(prefix_len, prompt_len - 1)`` tokens become
    that template's tokens — identical across sharers, so the prefix
    cache (docs/prefix_cache.md) can alias their leading pages.  The
    template draw uses an INDEPENDENT RNG stream: the per-request
    length/arrival/token stream is byte-identical to prefix-off runs."""
    rng = np.random.default_rng(seed)
    # separate stream — the legacy stream above is digest-pinned by the
    # fleet harness tests, so prefix sharing must not perturb it
    prng = np.random.default_rng([seed, 0x5EED])
    share = prefix_pool > 0 and prefix_len > 0
    pool_toks = None
    pool_p = None
    if share:
        ranks = np.arange(1, prefix_pool + 1, dtype=np.float64)
        w = 1.0 / ranks ** prefix_zipf
        pool_p = w / w.sum()
        if vocab_size:
            pool_toks = [prng.integers(1, vocab_size, size=prefix_len)
                         .astype(np.int32) for _ in range(prefix_pool)]
    if workload == "Mixed":
        names = list(_MIX_WEIGHTS)
        picks = rng.choice(len(names), size=n,
                           p=[_MIX_WEIGHTS[k] for k in names])
        classes = [names[i] for i in picks]
    else:
        classes = [workload] * n

    reqs = []
    t = 0.0
    for i, cls in enumerate(classes):
        pm, ps, dm, ds = _CLASSES[cls]
        plen = int(min(_lognormal(rng, pm, ps, 1)[0], max_prompt))
        dlen = int(min(_lognormal(rng, dm, ds, 1)[0], max_decode))
        if arrival_rate:
            t += rng.exponential(1.0 / arrival_rate)
        toks = (rng.integers(1, vocab_size, size=plen).astype(np.int32)
                if vocab_size else None)
        enc = (rng.standard_normal((enc_ctx, enc_dim)).astype(np.float32)
               if enc_ctx and enc_dim else None)
        pid, peff = None, 0
        if share:
            pick = int(prng.choice(prefix_pool, p=pool_p))
            pid = f"p{pick:03d}"
            peff = min(prefix_len, plen - 1)
            if toks is not None and peff > 0:
                toks[:peff] = pool_toks[pick][:peff]
        reqs.append(Request(rid=f"r{i:05d}", prompt_len=plen,
                            decode_len=dlen, arrival=t,
                            prompt_tokens=toks, enc_embeds=enc,
                            prefix_id=pid, prefix_len=peff))
    return reqs


def length_histogram(reqs: List[Request], granularity: int = 200):
    """Bucketed decode-length histogram — predictor training labels."""
    buckets = [r.decode_len // granularity for r in reqs]
    return np.bincount(buckets)
