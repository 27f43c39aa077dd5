"""Length predictor (paper §3.3.2, Fig. 8).

A small classification LLM (OPT-125M + cls head in the paper) speculates
the *length range bucket* of a request's decode, if served by the target
model.  Granularity trades accuracy for scheduling precision: the paper
reports 58.9% / 74.9% / 85% accuracy at granularity 100 / 200 / 400.

The port holds the bucket helpers and ``OraclePredictor``, the
stand-in with a configurable target accuracy (the paper's
acc-200=74.9% and acc=100% ablations, Fig. 18) that the ``Cluster``
uses by default.  It draws from numpy's ``default_rng(seed)`` exactly as
the reference does, so both predict the same buckets draw for draw.
The classifier-backed ``ModelPredictor`` needs ``model.classify`` and
comes with the training slice.
"""
from __future__ import annotations

from typing import Tuple

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
