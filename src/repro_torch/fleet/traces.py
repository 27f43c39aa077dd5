"""Vectorized workload traces for fleet-scale sim runs, the reference's
``repro.fleet.traces`` on the port: the same draws in the same order, so
a trace generated by either package equals the other's, and a trace
file saved by either loads in the other.

``repro_torch.runtime.workload.generate`` draws lengths one request at
a time (its per-request RNG stream is pinned by
tests/golden_sim_metrics.json and MUST NOT change); at 10^5-10^6
requests that loop dominates the run.  This module generates the same
length distributions in bulk with numpy — one masked lognormal draw
per workload class — plus richer arrival processes and a replayable
on-disk trace format:

* arrivals — ``batch`` (all at t=0), homogeneous ``poisson``, square-
  wave ``bursty`` and sinusoidal ``diurnal``.  The inhomogeneous
  processes use time-rescaling: draw unit-rate exponential gaps, cumsum
  to unit-rate arrival points, then invert the cumulative intensity
  Lambda(t) with ``np.interp`` over a dense grid.  All are exact
  Poisson processes with the requested instantaneous rate.
* tenants  — zipf-popularity tenant ids (multi-tenant fairness studies).
* files    — ``Trace.save``/``load_trace`` round-trip through a single
  ``.npz`` (compressed arrays + JSON meta), so a fleet scenario can be
  re-run bit-identically without regenerating.

Draw order is part of the format: classes, then per-class prompt and
decode lengths (class order ``CLASS_NAMES``), then arrivals, then
tenants.  Changing it changes every downstream seed — the determinism
test pins it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

import numpy as np

from repro_torch.runtime.request import Request
from repro_torch.runtime.workload import _CLASSES, _MIX_WEIGHTS

TRACE_FORMAT_VERSION = 1
CLASS_NAMES = tuple(_MIX_WEIGHTS)            # ("LPLD", "LPHD", ...)
PROCESSES = ("batch", "poisson", "bursty", "diurnal")

_ARRAY_FIELDS = ("arrival", "prompt_len", "decode_len", "tenant", "cls")


@dataclasses.dataclass
class Trace:
    """Column-oriented request trace (one numpy array per field).

    ``cls`` indexes into ``CLASS_NAMES``; ``tenant`` is a zipf-popular
    tenant id (0 when single-tenant).  ``meta`` records the generation
    parameters so a saved trace is self-describing.
    """
    arrival: np.ndarray       # (n,) float64, non-decreasing seconds
    prompt_len: np.ndarray    # (n,) int64
    decode_len: np.ndarray    # (n,) int64
    tenant: np.ndarray        # (n,) int32
    cls: np.ndarray           # (n,) int8 index into CLASS_NAMES
    meta: Dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.arrival)

    def to_requests(self, rid_prefix: str = "r") -> List[Request]:
        """Materialize ``Request`` objects for ``Cluster.serve``."""
        arrival, plen, dlen = self.arrival, self.prompt_len, self.decode_len
        return [Request(rid=f"{rid_prefix}{i:06d}",
                        prompt_len=int(plen[i]), decode_len=int(dlen[i]),
                        arrival=float(arrival[i]))
                for i in range(len(arrival))]

    def summary(self) -> Dict:
        """Shape-of-the-trace stats for benchmark reports."""
        span = float(self.arrival[-1] - self.arrival[0]) if len(self) else 0.0
        return {
            "n": len(self),
            "span_s": span,
            "mean_rate": (len(self) / span) if span > 0 else None,
            "mean_prompt": float(self.prompt_len.mean()) if len(self) else 0,
            "mean_decode": float(self.decode_len.mean()) if len(self) else 0,
            "total_tokens": int(self.prompt_len.sum()
                                + self.decode_len.sum()),
            "n_tenants": int(self.tenant.max()) + 1 if len(self) else 0,
            "class_mix": {name: int((self.cls == i).sum())
                          for i, name in enumerate(CLASS_NAMES)},
        }

    def save(self, path: str) -> str:
        """Write the trace to ``path`` (.npz appended if missing).
        Returns the actual file path written."""
        if not str(path).endswith(".npz"):
            path = f"{path}.npz"
        meta = dict(self.meta)
        meta["version"] = TRACE_FORMAT_VERSION
        np.savez_compressed(
            path, meta=np.frombuffer(
                json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8),
            **{f: getattr(self, f) for f in _ARRAY_FIELDS})
        return path


def load_trace(path: str) -> Trace:
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        version = meta.pop("version", None)
        if version != TRACE_FORMAT_VERSION:
            raise ValueError(
                f"trace format version {version!r} != "
                f"{TRACE_FORMAT_VERSION} (regenerate the trace)")
        return Trace(**{f: z[f] for f in _ARRAY_FIELDS}, meta=meta)


# -- arrival processes -------------------------------------------------------

def _rate_profile(process: str, rate: float, t: np.ndarray, *,
                  period_s: float, diurnal_amplitude: float,
                  burst_factor: float, burst_fraction: float) -> np.ndarray:
    """Instantaneous rate lambda(t).  Both shaped processes keep the
    MEAN rate equal to ``rate`` so presets stay comparable."""
    if process == "diurnal":
        # one "day" per period, starting at the overnight trough
        phase = 2.0 * np.pi * t / period_s - np.pi / 2.0
        return rate * (1.0 + diurnal_amplitude * np.sin(phase))
    # bursty: square wave — a burst_fraction slice of each period runs
    # at burst_factor * rate, the rest at the compensating low rate
    lo = rate * (1.0 - burst_fraction * burst_factor) \
        / (1.0 - burst_fraction)
    frac = (t % period_s) / period_s
    return np.where(frac < burst_fraction, burst_factor * rate,
                    np.maximum(lo, 1e-9))


def _arrival_times(rng: np.random.Generator, n: int, process: str,
                   rate: float, **profile_kw) -> np.ndarray:
    if process == "batch":
        return np.zeros(n, dtype=np.float64)
    # time-rescaling: unit-rate Poisson points, then invert Lambda(t)
    unit = np.cumsum(rng.exponential(1.0, n))
    if process == "poisson":
        return unit / rate
    # dense grid over a horizon long enough that Lambda covers unit[-1];
    # trapezoid cumulative intensity, monotone => np.interp inverts it
    horizon = max(1.25 * n / rate + profile_kw["period_s"],
                  profile_kw["period_s"])
    while True:
        grid = np.linspace(0.0, horizon, 8192)
        lam = _rate_profile(process, rate, grid, **profile_kw)
        cum = np.concatenate([
            [0.0], np.cumsum(0.5 * (lam[1:] + lam[:-1]) * np.diff(grid))])
        if cum[-1] >= unit[-1]:
            return np.interp(unit, cum, grid)
        horizon *= 2.0


# -- generation --------------------------------------------------------------

def _vec_lognormal(rng: np.random.Generator, median: float, sigma: float,
                   size: int, cap: int) -> np.ndarray:
    draw = rng.lognormal(np.log(median), sigma, size).astype(np.int64)
    return np.minimum(np.maximum(1, draw), cap)


def generate_trace(workload: str = "Mixed", n: int = 100_000, *,
                   seed: int = 0, process: str = "poisson",
                   rate: float = 100.0, period_s: float = 3600.0,
                   diurnal_amplitude: float = 0.6,
                   burst_factor: float = 4.0, burst_fraction: float = 0.1,
                   n_tenants: int = 1, zipf_alpha: float = 1.1,
                   max_prompt: int = 2048,
                   max_decode: int = 2048) -> Trace:
    """Vectorized trace generation.

    ``workload`` in {LPLD, LPHD, HPLD, HPHD, Mixed} — same class
    medians/sigmas and mix weights as the legacy generator.  ``rate``
    is the MEAN arrival rate in req/s for every non-batch process;
    ``period_s`` is the day length (diurnal) or burst cycle (bursty).
    Deterministic per (all arguments): same inputs => identical trace.
    """
    assert process in PROCESSES, process
    assert workload == "Mixed" or workload in _CLASSES, workload
    if process == "bursty":
        assert burst_factor * burst_fraction < 1.0, \
            "bursty profile needs burst_factor * burst_fraction < 1"
    rng = np.random.default_rng(seed)

    if workload == "Mixed":
        weights = np.array([_MIX_WEIGHTS[k] for k in CLASS_NAMES])
        cls = rng.choice(len(CLASS_NAMES), size=n, p=weights).astype(np.int8)
    else:
        cls = np.full(n, CLASS_NAMES.index(workload), dtype=np.int8)

    prompt_len = np.empty(n, dtype=np.int64)
    decode_len = np.empty(n, dtype=np.int64)
    for ci, name in enumerate(CLASS_NAMES):
        mask = cls == ci
        k = int(mask.sum())
        if not k:
            continue
        pm, ps, dm, ds = _CLASSES[name]
        prompt_len[mask] = _vec_lognormal(rng, pm, ps, k, max_prompt)
        decode_len[mask] = _vec_lognormal(rng, dm, ds, k, max_decode)

    arrival = _arrival_times(
        rng, n, process, rate, period_s=period_s,
        diurnal_amplitude=diurnal_amplitude,
        burst_factor=burst_factor, burst_fraction=burst_fraction)

    if n_tenants > 1:
        pop = 1.0 / np.arange(1, n_tenants + 1) ** zipf_alpha
        tenant = rng.choice(n_tenants, size=n,
                            p=pop / pop.sum()).astype(np.int32)
    else:
        tenant = np.zeros(n, dtype=np.int32)

    meta = {
        "workload": workload, "n": n, "seed": seed, "process": process,
        "rate": rate, "period_s": period_s,
        "diurnal_amplitude": diurnal_amplitude,
        "burst_factor": burst_factor, "burst_fraction": burst_fraction,
        "n_tenants": n_tenants, "zipf_alpha": zipf_alpha,
        "max_prompt": max_prompt, "max_decode": max_decode,
    }
    return Trace(arrival=arrival, prompt_len=prompt_len,
                 decode_len=decode_len, tenant=tenant, cls=cls, meta=meta)


def generate_requests(workload: str = "Mixed", n: int = 100_000,
                      **kw) -> List[Request]:
    """``generate_trace(...).to_requests()`` in one call."""
    return generate_trace(workload, n, **kw).to_requests()
