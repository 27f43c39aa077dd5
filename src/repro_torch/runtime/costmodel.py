"""Analytic per-iteration latency model (roofline-shaped), the reference's
``repro.runtime.costmodel`` with the same arithmetic in the same order.

Encodes the phase characteristics of Fig. 2:
  * prefill — compute-bound: below the accelerator-saturate threshold the
    iteration time is pinned by the weight-read floor (latency ~flat,
    throughput rises); past it, time scales linearly with tokens
    (throughput flat, latency grows) -> mixing prefills past saturation
    slows everyone (§2.2.1).
  * decode — memory-bound: iteration time = weight-read floor + KV bytes
    streamed; throughput grows with batch until KV traffic saturates HBM
    (§2.2.3's contention).

``HardwareSpec.v100_tp2`` is the paper's testbed (OPT-13B, TP=2 V100,
saturate at 512 tokens) and ``tpu_v5e`` the reference's target; both
stay as the reference has them, since its golden metrics and the fleet
presets name them.  ``h100`` is the port's target: an H100 SXM's
data-sheet peaks.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # effective FLOP/s for the instance
    hbm_bw: float              # bytes/s
    saturate_tokens: int       # accelerator-saturate threshold (Fig 2)
    dtype_bytes: int = 2

    @classmethod
    def v100_tp2(cls) -> "HardwareSpec":
        return cls(name="2xV100-TP2", peak_flops=2 * 112e12,
                   hbm_bw=2 * 900e9, saturate_tokens=512)

    @classmethod
    def tpu_v5e(cls, chips: int = 1) -> "HardwareSpec":
        return cls(name=f"tpu-v5e-x{chips}", peak_flops=chips * 197e12,
                   hbm_bw=chips * 819e9, saturate_tokens=512)

    @classmethod
    def h100(cls, chips: int = 1) -> "HardwareSpec":
        """H100 SXM data sheet: 989 TFLOP/s dense bf16 and 3.35 TB/s of
        HBM3 a card.  ``saturate_tokens`` is the chunk of every served
        prefill (512), not yet measured on the card."""
        return cls(name=f"h100-x{chips}", peak_flops=chips * 989e12,
                   hbm_bw=chips * 3.35e12, saturate_tokens=512)


class CostModel:
    """All iteration costs are PURE functions of small-integer inputs on
    an immutable config/hardware pair, so every public entry point is
    memoized (the fleet harness calls them O(10^6) times per run).  The
    cached value is produced by the exact same arithmetic — bit-identical
    floats, computed once per distinct argument tuple — which keeps the
    fixed-seed golden metrics (tests/golden_sim_metrics.json)
    byte-identical."""

    def __init__(self, cfg: ModelConfig, hw: HardwareSpec,
                 n_params: int = 0, mfu: float = 0.45,
                 mbu: float = 0.6):
        self.cfg = cfg
        self.hw = hw
        self.n_params = n_params or _approx_params(cfg)
        self.mfu = mfu      # achievable fraction of peak compute
        self.mbu = mbu      # achievable fraction of peak bandwidth
        self.weight_bytes = self.n_params * hw.dtype_bytes
        # constants hoisted out of the per-iteration hot path (cfg and
        # hw are frozen dataclasses; mfu/mbu are set-once)
        self._kv_per_tok = cfg.kv_bytes_per_token(hw.dtype_bytes)
        self._attn_layers = sum(1 for k in cfg.layer_kinds
                                if k in ("attn", "local_attn",
                                         "cross_attn"))
        self._attn_coeff = (4 * cfg.n_heads * cfg.resolved_head_dim
                            * self._attn_layers)
        # memo tables (unbounded: key cardinality is one entry per
        # distinct iteration shape, small even for 10^6-event runs)
        self._prefill_memo: dict = {}
        self._decode_memo: dict = {}
        self._mixed_memo: dict = {}

    # -- primitives ----------------------------------------------------
    def _flops_per_token(self, ctx: int) -> float:
        """Forward FLOPs/token: 2N matmul + attention KV dot terms."""
        return 2.0 * self.n_params + self._attn_coeff * ctx

    def _weight_floor(self) -> float:
        return self.weight_bytes / (self.hw.hbm_bw * self.mbu)

    # -- iteration costs -------------------------------------------------
    def prefill_time(self, tokens: int, avg_ctx: int = 0) -> float:
        """One prefill iteration over ``tokens`` total batch tokens."""
        if tokens <= 0:
            return 0.0
        hit = self._prefill_memo.get((tokens, avg_ctx))
        if hit is not None:
            return hit
        ctx = avg_ctx or tokens
        compute = (tokens * self._flops_per_token(ctx // 2)
                   / (self.hw.peak_flops * self.mfu))
        out = max(compute, self._weight_floor())
        self._prefill_memo[(tokens, avg_ctx)] = out
        return out

    def decode_time(self, batch: int, ctx_sum: int) -> float:
        """One decode iteration: batch tokens, sum of context lengths."""
        if batch <= 0:
            return 0.0
        hit = self._decode_memo.get((batch, ctx_sum))
        if hit is not None:
            return hit
        kv_bytes = self._kv_per_tok * ctx_sum
        mem = (self.weight_bytes + kv_bytes) / (self.hw.hbm_bw * self.mbu)
        compute = (batch * self._flops_per_token(ctx_sum // max(1, batch))
                   / (self.hw.peak_flops * self.mfu))
        out = max(mem, compute)
        self._decode_memo[(batch, ctx_sum)] = out
        return out

    def mixed_time(self, prefill_tokens: int, decode_batch: int,
                   decode_ctx_sum: int) -> float:
        """Continuous-batching iteration mixing prefill + decode (§2.2.2).

        Compute and memory demands add on shared hardware: decodes pay the
        prefill's compute (their 5x slowdown), prefills pay the decodes'
        KV traffic (their 2.5x slowdown) — the paper's interference, as a
        roofline consequence rather than a fitted constant."""
        if prefill_tokens <= 0:
            return self.decode_time(decode_batch, decode_ctx_sum)
        if decode_batch <= 0:
            return self.prefill_time(prefill_tokens)
        key = (prefill_tokens, decode_batch, decode_ctx_sum)
        hit = self._mixed_memo.get(key)
        if hit is not None:
            return hit
        compute = ((prefill_tokens
                    * self._flops_per_token(prefill_tokens // 2)
                    + decode_batch * self._flops_per_token(
                        decode_ctx_sum // max(1, decode_batch)))
                   / (self.hw.peak_flops * self.mfu))
        kv_bytes = self._kv_per_tok * decode_ctx_sum
        mem = (self.weight_bytes + kv_bytes) / (self.hw.hbm_bw * self.mbu)
        out = max(compute, mem)
        self._mixed_memo[key] = out
        return out

    def predictor_overhead(self, co_run: bool) -> float:
        """Parallel-mode predictor slows main-LLM prefill ~10% under
        stress (Fig. 17); sequential mode would add its full latency."""
        return 1.10 if co_run else 1.0


def _approx_params(cfg: ModelConfig) -> int:
    """The exact count (``models.model.param_count``).  The reference
    falls back to a rough formula when its count fails (as it does
    without JAX); the port always has torch, so a failure here is a bug
    and raises."""
    from repro_torch.models.model import param_count
    return param_count(cfg)
