"""The port's recurrent mixers (``repro_torch.models.recurrent``) against
the JAX package's: the depthwise causal conv, the RG-LRU, sLSTM and mLSTM
cells (full-sequence forward with and without a carried state, one-step
decode, state init), on the same weights and inputs in f32 at smoke
widths, and the doubling scan that replaces ``lax.associative_scan``
against a sequential loop.

f32 differs by summation order only: outputs and states within 1e-5 of
the largest magnitude of the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import recurrent as RR  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402
from repro_torch.params import to_tensor  # noqa: E402

TOL = 1e-5            # of the largest reference magnitude
B, S = 2, 11


def _close(ref, got, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy().astype(np.float32)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = np.abs(ref - got).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), (what, err)


def _tree_close(ref, got, what):
    assert set(ref) == set(got), what
    for k in ref:
        _close(ref[k], got[k], f"{what}.{k}")


def _port(tree):
    return {k: to_tensor(np.asarray(v), "cpu") for k, v in tree.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    x, w = _x(0, B, S, 24), _x(1, 4, 24)
    st = _x(2, B, 3, 24) if with_state else None
    y_r, st_r = RR._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  None if st is None else jnp.asarray(st))
    y, st_p = R.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                              None if st is None else torch.from_numpy(st))
    _close(y_r, y, "y")
    _close(st_r, st_p, "state")


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
def test_linear_scan_matches_loop(s):
    """h_t = a_t h_{t-1} + b_t, with decays down to 1e-30 so running
    products underflow: the doubling scan never divides by them."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(np.exp(rng.uniform(-69, 0, (B, s, 5))).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((B, s, 5)).astype(np.float32))
    h = torch.zeros(B, 5)
    want = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = R.linear_scan(a, b)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=0,
                               atol=TOL * float(got.abs().max()))


CELLS = {
    "rglru": ("recurrentgemma_9b", RR.init_rglru, RR.rglru_forward,
              RR.rglru_decode, RR.rglru_init_state, R.rglru_forward,
              R.rglru_decode, R.rglru_init_state),
    "slstm": ("xlstm_1_3b", RR.init_slstm, RR.slstm_forward,
              RR.slstm_decode, RR.slstm_init_state, R.slstm_forward,
              R.slstm_decode, R.slstm_init_state),
    "mlstm": ("xlstm_1_3b", RR.init_mlstm, RR.mlstm_forward,
              RR.mlstm_decode, RR.mlstm_init_state, R.mlstm_forward,
              R.mlstm_decode, R.mlstm_init_state),
}


@pytest.fixture(scope="module", params=sorted(CELLS))
def cell(request):
    arch, init, fwd_r, dec_r, st_r, fwd, dec, st = CELLS[request.param]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    p_ref = init(jax.random.PRNGKey(0), cfg, jnp.float32)
    return (request.param, cfg, p_ref, _port(p_ref), (fwd_r, dec_r, st_r),
            (fwd, dec, st))


def test_init_state_matches(cell):
    name, cfg, _, _, (_, _, st_r), (_, _, st) = cell
    ref = st_r(cfg, 3, jnp.float32)
    got = st(cfg, 3, torch.float32, "cpu")
    _tree_close(ref, got, name)
    for k in ref:
        assert got[k].dtype == torch.float32


@pytest.mark.parametrize("carried", [False, True])
def test_forward_matches(cell, carried):
    """Full-sequence forward from no state, and from the state a first
    forward left (the chunked prefill's carry)."""
    name, cfg, p_ref, p, (fwd_r, _, _), (fwd, _, _) = cell
    x0, x1 = _x(3, B, 9, cfg.d_model), _x(4, B, S, cfg.d_model)
    y_r, s_r = fwd_r(p_ref, cfg, jnp.asarray(x0), None)
    y, s = fwd(p, cfg, torch.from_numpy(x0), None)
    if carried:
        y_r, s_r = fwd_r(p_ref, cfg, jnp.asarray(x1), s_r)
        y, s = fwd(p, cfg, torch.from_numpy(x1), s)
    _close(y_r, y, name)
    _tree_close(s_r, s, name)


def test_decode_matches(cell):
    """Three one-step decodes after a prefix forward."""
    name, cfg, p_ref, p, (fwd_r, dec_r, _), (fwd, dec, _) = cell
    x0 = _x(5, B, 6, cfg.d_model)
    _, s_r = fwd_r(p_ref, cfg, jnp.asarray(x0), None)
    _, s = fwd(p, cfg, torch.from_numpy(x0), None)
    for t in range(3):
        xt = _x(6 + t, B, 1, cfg.d_model)
        y_r, s_r = dec_r(p_ref, cfg, jnp.asarray(xt), s_r)
        y, s = dec(p, cfg, torch.from_numpy(xt), s)
        _close(y_r, y, f"{name} step {t}")
        _tree_close(s_r, s, f"{name} step {t}")
