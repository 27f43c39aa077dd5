"""Inference request model + lifecycle timestamps (TTFT/JCT accounting).

Also home of ``SamplingParams`` — the user-facing stop criteria the
serving API attaches to a request.  Engines consult
``Request.sampling`` when present; when absent they fall back to the
ground-truth ``decode_len`` (oracle mode: simulator parity tests and the
paper-figure benchmarks, where the generated length is an experiment
input rather than a model decision).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np


class Phase(enum.Enum):
    WAITING = "waiting"          # at global scheduler / prefill queue
    PREFILL = "prefill"
    TRANSFER = "transfer"        # KV cache in flight prefill -> decode
    DECODE_QUEUED = "decode_queued"
    DECODE = "decode"
    FINISHED = "finished"
    CANCELLED = "cancelled"      # user cancel — pages/slots already freed
    FAILED = "failed"            # recovery budget exhausted / shed / no
    #                              capacity left — terminal, never hangs


#: phases a request can never leave (docs/fault_tolerance.md)
TERMINAL_PHASES = (Phase.FINISHED, Phase.CANCELLED, Phase.FAILED)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """User-facing stop criteria (the serving API's replacement for the
    engines' reliance on ground-truth ``decode_len``).

    ``max_new_tokens`` caps ALL generated tokens, including the first
    token emitted by prefill (so a finished request's token list has at
    most ``max_new_tokens`` entries).  ``stop_token_ids`` ends generation
    when the model emits any of them (the stop token is kept in the
    output, vLLM-style); ``ignore_eos`` disables that check while the cap
    still applies — the standard benchmarking knob.
    """
    max_new_tokens: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    ignore_eos: bool = False
    # --- on-device sampling (docs/async_runtime.md) ---
    # temperature == 0.0 -> greedy argmax, byte-identical to the
    # pre-sampling engines.  temperature > 0 draws from the softmax of
    # logits/temperature, restricted to the top_k highest logits when
    # top_k > 0.  seed makes a request's sample stream deterministic
    # regardless of batch composition or decode-slot placement: the
    # per-step key is derived from (seed, n_generated), never from the
    # slot index.
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.max_new_tokens is not None and self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        # normalize lists/sets passed by callers
        object.__setattr__(self, "stop_token_ids",
                           tuple(self.stop_token_ids))

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def should_stop(self, n_new_tokens: int, last_token: Optional[int]
                    ) -> bool:
        """``n_new_tokens`` counts every generated token so far including
        prefill's first token; ``last_token`` is the newest one (None on
        the cost-model runtime, which generates lengths, not tokens)."""
        if (self.max_new_tokens is not None
                and n_new_tokens >= self.max_new_tokens):
            return True
        if (not self.ignore_eos and last_token is not None
                and last_token in self.stop_token_ids):
            return True
        return False


@dataclasses.dataclass
class Request:
    rid: str
    prompt_len: int
    decode_len: int                      # ground-truth generated length
    arrival: float = 0.0
    sla_ms: float = 0.0
    prompt_tokens: Optional[np.ndarray] = None
    # frontend embeddings for cross-attention archs (whisper frames /
    # VLM patches): (enc_ctx, d_model) float32; None = no-frontend
    # request (the engines substitute zeros, which makes cross-attention
    # output exactly zero on both backends)
    enc_embeds: Optional[np.ndarray] = None
    # user stop criteria (serving API); None = oracle mode (decode_len)
    sampling: Optional[SamplingParams] = None
    # --- shared-prefix identity (prefix cache, docs/prefix_cache.md) ---
    # prefix_id/prefix_len let the COST-MODEL runtime (no real tokens)
    # express "the first prefix_len tokens are the shared template
    # prefix_id"; engine requests derive sharing from prompt_tokens
    # content instead and ignore these
    prefix_id: Optional[str] = None
    prefix_len: int = 0
    # stamped by the prefill side at alloc: leading prompt pages/tokens
    # aliased from the prefix cache (skipped recompute + wire bytes)
    cached_prefix_tokens: int = 0
    cached_prefix_pages: int = 0
    # --- scheduling state ---
    phase: Phase = Phase.WAITING
    predicted_bucket: int = -1           # length-range bucket (§3.3.2)
    predicted_hi: int = 0                # upper bound of predicted range
    predicted_lo: int = 0
    prefilled: int = 0                   # tokens prefilled so far (chunked)
    generated: int = 0
    swapped: bool = False                # victim of a memory-pressure swap
    # --- fault tolerance (docs/fault_tolerance.md) ---
    retries: int = 0                     # transfer retransmits + re-prefills
    error: Optional[str] = None          # why the request FAILED
    # --- timestamps (seconds) ---
    t_prefill_start: float = -1.0
    t_first_token: float = -1.0          # == prefill done (TTFT)
    t_transfer_done: float = -1.0
    t_decode_start: float = -1.0
    t_finish: float = -1.0

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.arrival

    @property
    def jct(self) -> float:
        return self.t_finish - self.arrival

    def is_heavy_prefill(self, thresh: int = 512) -> bool:
        return self.prompt_len > thresh

    def is_heavy_decode(self, thresh: int = 128) -> bool:
        """Uses the *predicted* range when available (the scheduler never
        sees ground truth), else the true length (oracle mode)."""
        if self.predicted_hi > 0:
            return self.predicted_hi > thresh
        return self.decode_len > thresh


def summarize(reqs: List[Request]) -> dict:
    """Aggregate metrics over a run's requests.

    The reference's ``slo=`` option (SLO attainment and goodput) comes
    with the port of the observability plane; without it the output is
    the reference's ``slo=None`` summary, key for key.
    """
    done = [r for r in reqs if r.phase == Phase.FINISHED]
    failed = [r for r in reqs if r.phase == Phase.FAILED]
    if not done:
        out = {"n": 0}
        if failed:
            out["failed"] = len(failed)
            # all-failed diagnostics, guarded only-when-nonzero: a run
            # where every request failed before first token (e.g. total
            # capacity loss) previously summarized to just {"n": 0,
            # "failed": k} with no latency/retry signal at all
            fttfts = [r.ttft for r in failed if r.t_first_token >= 0]
            if fttfts:
                out["failed_avg_ttft"] = float(np.mean(fttfts))
            retries = sum(r.retries for r in failed)
            if retries:
                out["failed_retries"] = retries
        return out
    ttfts = np.array([r.ttft for r in done])
    jcts = np.array([r.jct for r in done])
    out = {
        "n": len(done),
        "avg_ttft": float(ttfts.mean()),
        "p90_ttft": float(np.percentile(ttfts, 90)),
        "avg_jct": float(jcts.mean()),
        "p90_jct": float(np.percentile(jcts, 90)),
        "makespan": float(max(r.t_finish for r in done)
                          - min(r.arrival for r in done)),
    }
    # prefill->decode KV transfer wait (t_transfer_done is stamped on the
    # kv_arrive event / DecodeEngine.receive; absent for coupled runs)
    xfers = [r.t_transfer_done - r.t_first_token for r in done
             if r.t_transfer_done >= 0 and r.t_first_token >= 0]
    if xfers:
        out["avg_transfer"] = float(np.mean(xfers))
    # fault-tolerance accounting — keys appear ONLY when a failure or a
    # recovery actually happened, so failure-free fixed-seed runs stay
    # byte-identical to the pre-fault-tolerance golden metrics
    if failed:
        out["failed"] = len(failed)
    recovered = [r for r in done if r.retries > 0]
    if recovered:
        out["recovered"] = len(recovered)
        out["avg_recovered_jct"] = float(np.mean([r.jct
                                                  for r in recovered]))
    # prefix-cache accounting — keys appear ONLY when at least one page
    # was actually deduped, so cache-off runs stay byte-identical to the
    # golden metrics
    pages_saved = sum(r.cached_prefix_pages for r in done)
    if pages_saved:
        out["pages_saved"] = pages_saved
        out["cache_hit_rate"] = float(
            sum(r.cached_prefix_tokens for r in done)
            / sum(r.prompt_len for r in done))
    return out
