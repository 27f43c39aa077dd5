"""The one traffic generator: reads a mix's parameters from its file.

A frozen copy of the port's generators (``repro_torch.runtime.workload``'s
lognormal length classes, ``repro_torch.fleet.traces``' Poisson
arrivals), so a change to the program cannot move the
yardstick.  A mix file gives:

* ``classes``: {name: [prompt median, prompt sigma, output median,
  output sigma]} and ``weights``: {name: share};
* ``prompt_clip``, ``output_clip``: [low, high] token counts, and
  ``context_max``: prompt + output tokens at most (outputs are cut);
* ``arrivals``: {"process": "poisson", "rate": req/s};
* ``draw_seed``: the seed of the lengths and arrival instants;
* ``drain_s``: how long requests due in the window may take to finish
  after it closes;
* ``warmup``: [requests, output tokens each] served before the window.

Every run seed serves the same requests, with the same lengths at the
same instants (drawn from ``draw_seed``): a run seed draws the prompt
tokens (and, elsewhere, the weights), so two seeds differ in the
numbers served, not in the work or its timing.  An order that changed
with the seed would move the tails by where long prompts cluster.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Item:
    due: float          # seconds after the window opens
    prompt_len: int
    n_out: int          # output tokens, the prefill's first one included
    tokens: np.ndarray  # (prompt_len,) int32


def _lognormal(rng, median, sigma, size):
    return np.maximum(1, rng.lognormal(np.log(median), sigma,
                                       size).astype(np.int64))


def lengths(mix: dict, n: int, rng: np.random.Generator):
    """(prompt, output) lengths of ``n`` requests of the mix."""
    names = list(mix["classes"])
    w = np.array([mix["weights"][k] for k in names], np.float64)
    cls = rng.choice(len(names), size=n, p=w / w.sum())
    prompt = np.empty(n, np.int64)
    out = np.empty(n, np.int64)
    for i, name in enumerate(names):
        mask = cls == i
        k = int(mask.sum())
        if not k:
            continue
        pm, ps, om, os_ = mix["classes"][name]
        prompt[mask] = _lognormal(rng, pm, ps, k)
        out[mask] = _lognormal(rng, om, os_, k)
    prompt = np.clip(prompt, *mix["prompt_clip"])
    out = np.clip(out, *mix["output_clip"])
    out = np.minimum(out, mix["context_max"] - prompt)
    if (out < 1).any():
        raise ValueError("context_max leaves a prompt no output token")
    return prompt, out


def schedule(mix: dict, seconds: float, seed: int, vocab: int,
             rate: float = 0.0) -> List[Item]:
    """The requests due in a window of ``seconds`` for run ``seed``, in
    due order.  ``rate`` (req/s) replaces the file's rate (the sweep)."""
    arr = dict(mix["arrivals"])
    if rate:
        arr["rate"] = rate
    if arr["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    base = np.random.default_rng(mix["draw_seed"])
    # a Poisson process holding its mean count of arrivals in the
    # window: that many instants, uniform over it
    n = max(1, round(arr["rate"] * seconds))
    due = np.sort(base.uniform(0.0, seconds, n))
    prompt, out = lengths(mix, n, base)
    run = np.random.default_rng(seed_words(seed))
    return [Item(due=float(due[i]), prompt_len=int(prompt[i]),
                 n_out=int(out[i]),
                 tokens=run.integers(1, vocab, size=int(prompt[i]),
                                     dtype=np.int32))
            for i in range(n)]


def warmup(mix: dict, vocab: int) -> List[Item]:
    """The warm-up requests: the mix's own lengths (a fixed draw), each
    cut to a few output tokens, all due at once."""
    n, n_out = mix["warmup"]
    rng = np.random.default_rng([mix["draw_seed"], 1])
    prompt, _ = lengths(mix, n, rng)
    return [Item(due=0.0, prompt_len=int(p), n_out=n_out,
                 tokens=rng.integers(1, vocab, size=int(p), dtype=np.int32))
            for p in prompt]


def seed_words(seed: int) -> List[int]:
    """numpy's seed words for any whole number (negative ones too)."""
    return [abs(int(seed)) % 2 ** 64, int(seed < 0)]
