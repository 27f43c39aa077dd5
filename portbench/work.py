"""The yardstick's arithmetic: the operations and bytes that the served
requests need, counted from their lengths and the configuration's
widths, never from the program's calls.  So a later program that
does the same work with other kernels reads the same work.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 989e12 FLOP/s in
bf16 on the tensor cores, 3.35e12 B/s of HBM3.
"""
from __future__ import annotations

from typing import Iterable

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BYTES = 2                      # bf16 weights, activations and K/V


class Widths:
    def __init__(self, cfg: dict):
        self.layers = cfg["num_hidden_layers"]
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.kvh = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        self.ff = cfg.get("ffn_dim") or cfg["intermediate_size"]
        self.vocab = cfg["vocab_size"]
        self.glu = 2 if cfg["mlp_act"] == "swiglu" else 1

    @property
    def layer_matmul_params(self) -> int:
        """Weights a token multiplies in one layer."""
        d, h, kvh, hd = self.d, self.h, self.kvh, self.hd
        return (d * h * hd + 2 * d * kvh * hd + h * hd * d
                + d * self.glu * self.ff + self.ff * d)

    @property
    def weight_bytes(self) -> int:
        """Every weight a decode iteration reads once: the layers and
        the head's table (the embedding rows it looks up are few)."""
        return BYTES * (self.layers * (self.layer_matmul_params + 2 * self.d)
                        + self.d * self.vocab + self.d)

    @property
    def kv_token_bytes(self) -> int:
        """K and V of one token over every layer."""
        return BYTES * 2 * self.kvh * self.hd * self.layers


def _pairs(p: int) -> int:
    return p * (p + 1) // 2


def prefill_flops(w: Widths, prompts: Iterable[int], heads: int) -> float:
    """Matmul FLOPs of prefilling the first ``p`` tokens of each prompt:
    2 a weight a token, causal QK^T and PV (4 h hd a query-key pair),
    and the head on the last prompt token of ``heads`` requests."""
    total = 2.0 * w.d * w.vocab * heads
    for p in prompts:
        total += 2.0 * p * w.layers * w.layer_matmul_params
        total += 4.0 * w.h * w.hd * _pairs(p) * w.layers
    return total


def decode_flops(w: Widths, contexts: Iterable[int]) -> float:
    """FLOPs of decode steps, one a token, each at its context length
    (the keys it attends, its own included)."""
    total = 0.0
    for c in contexts:
        total += 2.0 * w.layers * w.layer_matmul_params
        total += 4.0 * w.h * w.hd * c * w.layers
        total += 2.0 * w.d * w.vocab
    return total


def decode_bytes(w: Widths, iterations: int, contexts: Iterable[int]
                 ) -> float:
    """The weights once an iteration, and for each token its live K/V
    read once and its new K/V written once."""
    total = float(iterations) * w.weight_bytes
    for c in contexts:
        total += (c + 1) * w.kv_token_bytes
    return total


def k1_work(w: Widths, prompts: Iterable[int], chunk: int):
    """(FLOPs, bytes) of the prefill attention that the first ``p``
    tokens of each prompt need: causal QK^T + PV; Q and O once; each
    request's live K/V once for each ``chunk`` tokens of its prompt."""
    flops = byts = 0.0
    qo = BYTES * 2 * w.h * w.hd * w.layers
    for p in prompts:
        flops += 4.0 * w.h * w.hd * _pairs(p) * w.layers
        byts += p * qo
        for end in range(chunk, p + chunk, chunk):
            byts += min(end, p) * w.kv_token_bytes
    return flops, byts


def k2_work(w: Widths, contexts: Iterable[int]):
    """(FLOPs, bytes) of decode attention: each token's live K/V (its
    own included) once, its query and output once."""
    flops = byts = 0.0
    qo = BYTES * 2 * w.h * w.hd * w.layers
    for c in contexts:
        flops += 4.0 * w.h * w.hd * c * w.layers
        byts += c * w.kv_token_bytes + qo
    return flops, byts


def bound_s(flops: float, byts: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(flops / PEAK_FLOPS, byts / PEAK_BYTES)


def decode_contexts(prompt_len: int, n_tokens: int):
    """Context lengths of the decode steps that produced tokens 2 ..
    ``n_tokens`` of a request (the first comes from its prefill): the
    step at position ``prompt_len + g`` attends ``prompt_len + g + 1``
    keys."""
    return range(prompt_len + 1, prompt_len + n_tokens)
