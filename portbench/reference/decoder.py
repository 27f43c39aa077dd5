"""One float32 decoder for both served architectures, in plain PyTorch.

Pre-norm decoder blocks, as the configuration file states them:

    h = x + Attn(RMSNorm(x));  x' = h + MLP(RMSNorm(h))

with RMSNorm(x) = x / sqrt(mean(x^2) + eps) * w; attention with
``num_attention_heads`` query heads sharing ``num_key_value_heads`` K/V
heads (head width ``head_dim``), scores scaled by head_dim ** -0.5 and
causal; RoPE (``rope_theta``, the two halves of each head rotated) when
the file gives a theta, else learned positions added to the embedding;
the MLP GeLU (tanh form) of x W_i, or SwiGLU with W_i = [gate | up];
logits of the final RMSNorm against the tied embedding or ``lm_head``.

Float32 throughout with TF32 off.  It runs layer by layer over all the
sequences, converting one layer's weights at a time, and attends in
blocks of query rows, so it fits beside the program's bf16 weights.

``fp8=True`` is the control: every matrix product's operands are first
rounded to float8 e4m3 (per output channel for weights, per row for
activations, queries, keys and values), the products summed in float32
as an FP8 tensor-core GEMM does.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch

E4M3_MAX = 448.0
Q_BLOCK = 1024


def q8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def no_tf32():
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


class Decoder:
    def __init__(self, cfg: dict, params, fp8: bool = False):
        self.cfg = cfg
        self.p = params
        self.fp8 = fp8
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.kvh = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        self.eps = cfg["norm_eps"]

    # -- pieces --------------------------------------------------------
    def _w(self, w: torch.Tensor) -> torch.Tensor:
        """A (in, out) weight in f32, rounded per output column in fp8
        mode."""
        w = w.float()
        return q8(w, dim=0) if self.fp8 else w

    def _x(self, x: torch.Tensor) -> torch.Tensor:
        return q8(x) if self.fp8 else x

    def _norm(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * w.float()

    def _rope(self, x, pos):
        """x (S, heads, hd), pos (S,): the halves of each head rotated."""
        hd = x.shape[-1]
        inv = 1.0 / (float(self.cfg["rope_theta"]) ** (
            torch.arange(0, hd, 2, device=x.device, dtype=torch.float32)
            / hd))
        ang = pos.float()[:, None] * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def _attend(self, q, k, v):
        """Causal GQA: q (S, h, hd), k/v (S, kvh, hd) -> (S, h * hd)."""
        s, rep = q.shape[0], self.h // self.kvh
        q = self._x(q).view(s, self.kvh, rep, self.hd)
        k, v = self._x(k), self._x(v)
        out = torch.empty(s, self.kvh, rep, self.hd, device=q.device)
        scale = self.hd ** -0.5
        keys = torch.arange(s, device=q.device)
        for i0 in range(0, s, Q_BLOCK):
            i1 = min(s, i0 + Q_BLOCK)
            sc = torch.einsum("qgrd,kgd->grqk", q[i0:i1], k[:i1]) * scale
            mask = keys[None, :i1] > torch.arange(i0, i1,
                                                  device=q.device)[:, None]
            sc = sc.masked_fill(mask, float("-inf")).softmax(-1)
            out[i0:i1] = torch.einsum("grqk,kgd->qgrd", self._x(sc), v[:i1])
        return out.reshape(s, self.h * self.hd)

    def _mlp(self, x, wi, wo):
        y = self._x(x) @ wi
        if self.cfg["mlp_act"] == "swiglu":
            gate, up = y.chunk(2, dim=-1)
            y = torch.nn.functional.silu(gate) * up
        else:
            y = torch.nn.functional.gelu(y, approximate="tanh")
        return self._x(y) @ wo

    def _weights(self, lp) -> dict:
        """One layer's weights in f32 (fp8-rounded in the control)."""
        a, m = lp["attn"], lp["mlp"]
        return {"wq": self._w(a["wq"]), "wk": self._w(a["wk"]),
                "wv": self._w(a["wv"]), "wo": self._w(a["wo"]),
                "wi": self._w(m["wi"]), "wo2": self._w(m["wo"]),
                "norm1": lp["norm1"], "norm2": lp["norm2"]}

    def _layer(self, w, x):
        s = x.shape[0]
        hn = self._x(self._norm(x, w["norm1"]))
        q = (hn @ w["wq"]).view(s, self.h, self.hd)
        k = (hn @ w["wk"]).view(s, self.kvh, self.hd)
        v = (hn @ w["wv"]).view(s, self.kvh, self.hd)
        if self.cfg.get("rope_theta"):
            pos = torch.arange(s, device=x.device)
            q, k = self._rope(q, pos), self._rope(k, pos)
        x = x + self._x(self._attend(q, k, v)) @ w["wo"]
        hn = self._norm(x, w["norm2"])
        return x + self._mlp(hn, w["wi"], w["wo2"])

    # -- entry ---------------------------------------------------------
    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor], starts: Sequence[int]
               ) -> List[torch.Tensor]:
        """For each token sequence (S,) the f32 logits (S - start, V) at
        positions ``start`` .. S - 1, each predicting the next token."""
        with no_tf32():
            xs = []
            for t in seqs:
                x = self.p["embed"][t.long()].float()
                if self.cfg.get("learned_positions"):
                    x = x + self.p["pos_embed"][:len(t)].float()
                xs.append(x)
            for lp in self.p["layers"]:
                w = self._weights(lp)
                xs = [self._layer(w, x) for x in xs]
                del w
            if self.cfg["tie_word_embeddings"]:
                head = self._w(self.p["embed"].t())
            else:
                head = self._w(self.p["lm_head"])
            out = []
            for x, st in zip(xs, starts):
                hn = self._norm(x[st:], self.p["final_norm"])
                out.append(self._x(hn) @ head)
            return out


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a token's reference logit lies below the
    reference's best at its position."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return float((best - got).max())
