"""Synthetic data pipelines (offline: no downloads), numpy only, as the
reference's ``train/data.py``: for the same seeds they yield the same
arrays.

* ``lm_batches``        — deterministic synthetic LM token stream with
                          enough structure to make loss fall (Zipf tokens
                          + copy patterns), for the train examples.
* ``predictor_dataset`` — the paper's Fig. 8 flow, synthesized: prompts
                          paired with the "target model's" generation
                          lengths, bucketed at a chosen granularity into
                          classification labels.  A planted statistical
                          relationship (prompt prefix codes the length
                          class) makes the task learnable offline.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from repro_torch.core.predictor import bucket_of
from repro_torch.runtime.workload import generate


def lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (tokens, labels) with labels = next token. Sequences are
    Zipf-ish with periodic copy structure so a model can learn."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    while True:
        base = rng.choice(vocab - 1, size=(batch, seq + 1), p=probs) + 1
        # plant copy structure: second half repeats the first half
        half = (seq + 1) // 2
        base[:, half:2 * half] = base[:, :half]
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        yield tokens, labels


def predictor_dataset(n: int, *, vocab: int, max_prompt: int = 256,
                      granularity: int = 200, n_classes: int = 16,
                      seed: int = 0):
    """(tokens (n, max_prompt), lengths (n,), labels (n,)) — synthetic
    ShareGPT-like prompts whose first tokens correlate with the decode
    length class (stand-in for the semantic signal a real predictor
    learns from prompt content)."""
    reqs = generate("Mixed", n, seed=seed, vocab_size=vocab,
                    max_prompt=max_prompt)
    rng = np.random.default_rng(seed + 1)
    tokens = np.zeros((n, max_prompt), np.int32)
    lengths = np.zeros((n,), np.int32)
    labels = np.zeros((n,), np.int32)
    for i, r in enumerate(reqs):
        ln = min(r.prompt_len, max_prompt)
        tokens[i, :ln] = r.prompt_tokens[:ln]
        cls = min(bucket_of(r.decode_len, granularity), n_classes - 1)
        # plant a NOISY signal (a real predictor reads imperfect semantic
        # cues): the marker token encodes the true class only ~80% of the
        # time, otherwise a neighbouring class — which caps achievable
        # accuracy near the paper's 74.9% @ granularity 200.
        if rng.random() < 0.80:
            marker = cls
        else:
            marker = int(np.clip(cls + rng.choice([-2, -1, 1, 2]), 0,
                                 n_classes - 1))
        tokens[i, 0] = 1 + marker
        lengths[i] = max(ln, 2)
        labels[i] = cls
    return tokens, lengths, labels


def batched(arrays, batch: int, *, seed: int = 0, epochs: int = 1000):
    n = arrays[0].shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            idx = order[i:i + batch]
            yield tuple(a[idx] for a in arrays)
