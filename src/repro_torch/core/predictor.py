"""Length predictor (paper §3.3.2, Fig. 8).

A small classification LLM (OPT-125M + cls head in the paper) speculates
the *length range bucket* of a request's decode, if served by the target
model.  Granularity trades accuracy for scheduling precision: the paper
reports 58.9% / 74.9% / 85% accuracy at granularity 100 / 200 / 400.

Two implementations share an interface:
  * ``ModelPredictor``  — runs the port's classifier (``model.classify``,
    fine-tuned by ``train/trainer.py``; see
    ``repro_torch.finetune_predictor``) on the params' device.
  * ``OraclePredictor`` — the stand-in with a configurable target
    accuracy (the paper's acc-200=74.9% and acc=100% ablations, Fig. 18)
    that the ``Cluster`` uses by default.  It draws from numpy's
    ``default_rng(seed)`` exactly as the reference does, so both predict
    the same buckets draw for draw.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DEFAULT_GRANULARITY = 200       # paper's operating point (74.9%)


def bucket_of(decode_len: int, granularity: int = DEFAULT_GRANULARITY) -> int:
    return decode_len // granularity


def bucket_range(bucket: int, granularity: int = DEFAULT_GRANULARITY
                 ) -> Tuple[int, int]:
    """(lo, hi] token range of a bucket; schedulers use hi as the upper
    bound for resource reservation and lo for runtime estimates."""
    return bucket * granularity, (bucket + 1) * granularity


class OraclePredictor:
    """Returns the true bucket with prob ``accuracy``, otherwise a nearby
    bucket (misprediction is rarely wild in practice — the classifier
    confuses adjacent ranges)."""

    def __init__(self, accuracy: float = 0.749,
                 granularity: int = DEFAULT_GRANULARITY,
                 n_buckets: int = 16, seed: int = 0):
        self.accuracy = accuracy
        self.granularity = granularity
        self.n_buckets = n_buckets
        self.rng = np.random.default_rng(seed)

    def predict(self, prompt_tokens, true_decode_len: int) -> int:
        true_b = min(bucket_of(true_decode_len, self.granularity),
                     self.n_buckets - 1)
        if self.rng.random() < self.accuracy:
            return true_b
        off = int(self.rng.choice([-2, -1, 1, 2]))
        return int(np.clip(true_b + off, 0, self.n_buckets - 1))

    def predict_range(self, prompt_tokens, true_decode_len: int
                      ) -> Tuple[int, int, int]:
        b = self.predict(prompt_tokens, true_decode_len)
        lo, hi = bucket_range(b, self.granularity)
        return b, lo, hi


class ModelPredictor:
    """The classifier predictor.  It runs the predict model in parallel
    with the main LLM (§3.3.2 'parallel mode'): one ``classify`` call a
    request, under ``torch.inference_mode()``, on the device the params
    live on (kernel 5's forward on the card).  Prompts are cut to
    ``max_len`` tokens (§5.2.2)."""

    def __init__(self, cfg, params, granularity: int = DEFAULT_GRANULARITY,
                 max_len: int = 512):
        from repro_torch.models import model as M
        self.cfg = cfg
        self.params = params
        self.granularity = granularity
        self.max_len = max_len        # padding cut limit (§5.2.2)
        self._classify = M.classify

    def predict(self, prompt_tokens, true_decode_len: int = 0) -> int:
        import torch
        dev = self.params["embed"].device
        toks = np.asarray(prompt_tokens)[: self.max_len]
        with torch.inference_mode():
            logits = self._classify(
                self.params, self.cfg,
                torch.as_tensor(toks[None, :].astype(np.int32), device=dev),
                torch.tensor([len(toks)], dtype=torch.int32, device=dev))
            return int(torch.argmax(logits[0]))

    def predict_range(self, prompt_tokens, true_decode_len: int = 0
                      ) -> Tuple[int, int, int]:
        b = self.predict(prompt_tokens, true_decode_len)
        lo, hi = bucket_range(b, self.granularity)
        return b, lo, hi

    def batch_accuracy(self, prompts: Sequence[np.ndarray],
                       decode_lens: Sequence[int]) -> float:
        hits = 0
        for p, d in zip(prompts, decode_lens):
            hits += int(self.predict(p) == min(
                bucket_of(d, self.granularity),
                self.cfg.n_classes - 1))
        return hits / max(1, len(prompts))
