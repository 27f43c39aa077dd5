"""Arrival processes of the reference's ``repro.fleet.traces``, copied
as they are: ``batch`` (all at t=0), homogeneous ``poisson``, square-wave
``bursty`` and sinusoidal ``diurnal``.  The inhomogeneous processes use
time-rescaling: draw unit-rate exponential gaps, cumsum to unit-rate
arrival points, then invert the cumulative intensity Lambda(t) with
``np.interp`` over a dense grid.  All are exact Poisson processes with
the requested instantaneous rate, and draw the same numbers as the
reference for the same generator.

Partial: the reference module's traces, tenants and trace files come
with the port's sim and fleet slice (ROADMAP A.12).
"""
from __future__ import annotations

import numpy as np

PROCESSES = ("batch", "poisson", "bursty", "diurnal")


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
