"""Recurrent temporal-mixing blocks: RG-LRU (RecurrentGemma / Griffin)
and xLSTM's sLSTM and mLSTM cells, as torch ops.

The reference (``src/repro/models/recurrent.py``) writes these with
``jnp`` and ``lax``, not Pallas, so they have no kernel of their own
here either:

  * the RG-LRU's ``lax.associative_scan`` over time becomes
    ``linear_scan``, a log-depth doubling scan: log2(s) rounds of
    elementwise products and sums.  It never divides by a running
    product of decays, so a product that underflows to 0 costs nothing;
  * the sLSTM / mLSTM chunked ``lax.scan``s become a Python loop over
    the time steps.  The reference pads to chunks and masks the pad
    steps only for rematerialisation in training; the loop runs the
    real steps alone.

Every cell carries O(1) state: the prefilled "KV" of these layers is a
constant-size state (see ``core/kv_transfer.py``).

Initialisers take ``ini`` (``blocks.Init``): the reference's
distributions, drawn from the port's generator.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv. x: (b, s, c), w: (width, c); state: (b,
    width - 1, c) carries the last inputs for decode.  Returns (y,
    new_state)."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return y, xp[:, xp.shape[1] - (width - 1):].clone()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0: the
    doubling (Hillis-Steele) scan of the reference's associative
    combine (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2).  After the round
    of offset d, (a_t, b_t) compose the steps (t - 2d, t]; b_t is h_t
    once 2d >= s."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


# ---------------------------------------------------------------------------
# RG-LRU (Griffin recurrent block)
# ---------------------------------------------------------------------------
def init_rglru(ini, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    lru = cfg.lru_width or d
    return {
        "wx": ini.normal((d, lru), d ** -0.5),
        "wy": ini.normal((d, lru), d ** -0.5),
        "conv_w": ini.normal((cfg.rglru_conv_width, lru), 0.1),
        "w_a": ini.normal((lru, lru), lru ** -0.5),
        "b_a": ini.zeros(lru),
        "w_i": ini.normal((lru, lru), lru ** -0.5),
        "b_i": ini.zeros(lru),
        # decay in [0.9, 0.999] at r = 1 (Griffin appendix); f32 in any
        # model, as in the reference
        "a_param": ini.uniform((lru,), 2.0, 6.0),
        "w_out": ini.normal((lru, d), lru ** -0.5),
    }


def _rglru_gates(p, u):
    c = 8.0
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(uf @ p["w_i"].float() + p["b_i"].float())
    log_a = -c * F.softplus(p["a_param"]) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-12)) * (i * uf)
    return a, gated_in


def rglru_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, state=None):
    """Full-sequence RG-LRU block. x: (b, s, d); state: {"h", "conv"} or
    None.  Returns (out, new_state)."""
    u = x @ p["wx"]
    u, new_conv = causal_conv1d(u, p["conv_w"],
                                None if state is None else state["conv"])
    a, gin = _rglru_gates(p, u)                       # (b, s, lru) f32
    if state is not None:
        # the carried h enters the first step: h_0 = a_0 h_prev + gin_0
        gin = torch.cat([gin[:, :1] + a[:, :1] * state["h"][:, None],
                         gin[:, 1:]], dim=1)
    h = linear_scan(a, gin)
    y = h.to(x.dtype) * gelu(x @ p["wy"])
    return y @ p["w_out"], {"h": h[:, -1], "conv": new_conv}


def rglru_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """One-step RG-LRU. x: (b, 1, d)."""
    u = x @ p["wx"]
    u, new_conv = causal_conv1d(u, p["conv_w"], state["conv"])
    a, gin = _rglru_gates(p, u)
    h = a[:, 0] * state["h"] + gin[:, 0]
    y = h[:, None].to(x.dtype) * gelu(x @ p["wy"])
    return y @ p["w_out"], {"h": h, "conv": new_conv}


def rglru_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    lru = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, lru), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.rglru_conv_width - 1, lru),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar memory, exponential gating, recurrent connections
# ---------------------------------------------------------------------------
def init_slstm(ini, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    ff = int(d * 4 / 3 // 2 * 2)
    return {
        "w": ini.normal((d, 4 * d), d ** -0.5),
        "r": ini.normal((nh, dh, 4 * dh), dh ** -0.5),
        "b": ini.zeros(4 * d),
        # post-up projection (factor 4/3, GeLU)
        "up": ini.normal((d, 2 * ff), d ** -0.5),
        "down": ini.normal((ff, d), ff ** -0.5),
    }


def _slstm_step(p, cfg, wx_t, state):
    """wx_t: (b, 4d) precomputed W x_t + b; state: c, n, h, m, each (b,
    d) f32."""
    nh = cfg.n_heads
    b = wx_t.shape[0]
    d = wx_t.shape[1] // 4
    dh = d // nh
    h_prev = state["h"].reshape(b, nh, dh)
    rec = torch.einsum("bhd,hde->bhe", h_prev.to(p["r"].dtype), p["r"])
    gates = (wx_t.reshape(b, nh, 4 * dh) + rec).float()
    z_r, i_r, f_r, o_r = gates.chunk(4, dim=-1)          # (b, nh, dh)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    log_f = F.logsigmoid(f_r)
    m_prev = state["m"].reshape(b, nh, dh)
    m = torch.maximum(log_f + m_prev, i_r)
    i_g = torch.exp(i_r - m)
    f_g = torch.exp(log_f + m_prev - m)
    c = f_g * state["c"].reshape(b, nh, dh) + i_g * z
    n = f_g * state["n"].reshape(b, nh, dh) + i_g
    h = o * (c / torch.clamp(torch.abs(n), min=1.0))
    new = {"c": c.reshape(b, d), "n": n.reshape(b, d),
           "h": h.reshape(b, d), "m": m.reshape(b, d)}
    return h.reshape(b, d), new


def _slstm_out(p, h_seq):
    gate, val = (h_seq @ p["up"]).chunk(2, dim=-1)
    return (gelu(gate) * val) @ p["down"]


def slstm_scan(p, cfg, wx, state):
    """The sLSTM's loop over time: wx (b, s, 4d) -> (h (b, s, d) f32,
    state after the last step)."""
    hs = []
    for t in range(wx.shape[1]):
        h, state = _slstm_step(p, cfg, wx[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def slstm_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, state=None):
    b, s, _ = x.shape
    if state is None:
        state = slstm_init_state(cfg, b, x.dtype, x.device)
    wx = x @ p["w"] + p["b"]                          # (b, s, 4d)
    h_seq, state = slstm_scan(p, cfg, wx, state)
    return _slstm_out(p, h_seq.to(x.dtype)), state


def slstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: dict):
    wx = (x @ p["w"] + p["b"])[:, 0]
    h, new_state = _slstm_step(p, cfg, wx, state)
    return _slstm_out(p, h[:, None].to(x.dtype)), new_state


def slstm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device) for k in ("c", "n", "h", "m")}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix memory C, pre-up projection block
# ---------------------------------------------------------------------------
def init_mlstm(ini, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    ud = 2 * d                                        # pre-up factor 2
    nh = cfg.n_heads
    return {
        "w_up": ini.normal((d, 2 * ud), d ** -0.5),
        "conv_w": ini.normal((4, ud), 0.1),
        "wq": ini.normal((ud, ud), ud ** -0.5),
        "wk": ini.normal((ud, ud), ud ** -0.5),
        "wv": ini.normal((ud, ud), ud ** -0.5),
        "w_if": ini.normal((ud, 2 * nh), ud ** -0.5),
        "b_if": ini.zeros(2 * nh),
        "w_down": ini.normal((ud, d), ud ** -0.5),
    }


def _mlstm_step(q, k, v, i_r, f_r, state):
    """q, k, v: (b, nh, dh) and i_r, f_r: (b, nh) of one step; state: C
    (b, nh, dh, dh), n (b, nh, dh), m (b, nh), f32."""
    dh = q.shape[-1]
    log_f = F.logsigmoid(f_r.float())
    m = torch.maximum(log_f + state["m"], i_r.float())
    i_g = torch.exp(i_r.float() - m)[..., None]                   # (b,nh,1)
    f_g = torch.exp(log_f + state["m"] - m)[..., None]
    kf = k.float() * dh ** -0.5
    c_new = f_g[..., None] * state["C"] + i_g[..., None] * (
        v.float()[..., :, None] * kf[..., None, :])
    n_new = f_g * state["n"] + i_g * kf
    qf = q.float()
    num = torch.einsum("bhvk,bhk->bhv", c_new, qf)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n_new, qf)),
                      min=1.0)
    return num / den[..., None], {"C": c_new, "n": n_new, "m": m}


def _mlstm_qkvif(p, cfg, x, conv_state):
    b, s, d = x.shape
    ud = 2 * d
    nh = cfg.n_heads
    dh = ud // nh
    xin, gate = (x @ p["w_up"]).chunk(2, dim=-1)      # (b, s, ud)
    xc, new_conv = causal_conv1d(xin, p["conv_w"], conv_state)
    xc = F.silu(xc)
    q = (xc @ p["wq"]).reshape(b, s, nh, dh)
    k = (xc @ p["wk"]).reshape(b, s, nh, dh)
    v = (xin @ p["wv"]).reshape(b, s, nh, dh)
    i_r, f_r = (xc @ p["w_if"] + p["b_if"]).chunk(2, dim=-1)  # (b, s, nh)
    return (q, k, v, i_r, f_r), gate, new_conv


def mlstm_scan(qkvif, cell):
    """The mLSTM's loop over time: q, k, v (b, s, nh, dh) and i, f (b,
    s, nh) -> (h (b, s, nh, dh) f32, cell after the last step)."""
    hs = []
    for t in range(qkvif[0].shape[1]):
        h, cell = _mlstm_step(*(a[:, t] for a in qkvif), cell)
        hs.append(h)
    return torch.stack(hs, dim=1), cell


def mlstm_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, state=None):
    b, s, _ = x.shape
    if state is None:
        state = mlstm_init_state(cfg, b, x.dtype, x.device)
    qkvif, gate, new_conv = _mlstm_qkvif(p, cfg, x, state["conv"])
    cell = {"C": state["C"], "n": state["n"], "m": state["m"]}
    hs, cell = mlstm_scan(qkvif, cell)
    h_seq = hs.reshape(b, s, -1).to(x.dtype)
    out = (h_seq * F.silu(gate)) @ p["w_down"]
    return out, {**cell, "conv": new_conv}


def mlstm_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, state: dict):
    qkvif, gate, new_conv = _mlstm_qkvif(p, cfg, x, state["conv"])
    cell = {"C": state["C"], "n": state["n"], "m": state["m"]}
    h, cell = _mlstm_step(*(a[:, 0] for a in qkvif), cell)
    h = h.reshape(x.shape[0], 1, -1).to(x.dtype)
    return (h * F.silu(gate)) @ p["w_down"], {**cell, "conv": new_conv}


def mlstm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    ud = 2 * cfg.d_model
    nh = cfg.n_heads
    dh = ud // nh

    def z(*shape, dt=torch.float32):
        return torch.zeros((batch, *shape), dtype=dt, device=device)
    return {"C": z(nh, dh, dh), "n": z(nh, dh), "m": z(nh),
            "conv": z(3, ud, dt=dtype)}
