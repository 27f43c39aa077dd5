"""Kernel 5, the dense chunked-prefill attention, against the JAX
package's (``ops.prefill_attention`` with ``block_table=None``).

On the CPU the port's wrapper runs its plain version; the JAX package
runs the Pallas kernel in interpret mode, as its own tests do.  Inputs
come from numpy with a seed and go to both.  Tolerances as in
tests/test_kernels.py: 2e-5 in f32 (summation order), 2e-2 in bf16 (a
rounding of the output).

Rows with no key they may attend (kv_len = 0, or a pad query more than
``window`` past kv_len) are compared with 0, not with the Pallas
kernel: it gives 0 there only when every kv block is skipped, and a
mean that depends on its tiling otherwise.  The port gives 0.

The module imports no JAX at the top: the GPU tests at the end (kernel
vs plain version) run on the machine with the card, which has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention)

F32_TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def jax_ops():
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    return jops


def _case(seed, b, sq, h, kvh, hd, skv, hd_v=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd_v or hd))
            .astype(np.float32))


def attendable(kv_len, q_off, sq, window, causal=True):
    """(b, sq) bool: whether row (request, query) has a key it may
    attend: k < kv_len, k <= q_pos if causal, k > q_pos - window."""
    q_pos = q_off + np.arange(sq)[None, :]
    hi = np.asarray(kv_len)[:, None]
    if causal:
        hi = np.minimum(hi, q_pos + 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else 0
    return np.broadcast_to(lo < hi, (len(kv_len), sq)).copy()


def _torch(x, dtype, device="cpu"):
    t = torch.from_numpy(x).to(device)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


# tests/test_kernels.py:23-65 as one parametrised test: the MHA / GQA /
# MQA hd 128 / single-block sweep in f32 and bf16 (q_offset = skv - sq,
# kv_len skv then skv // 2), windows 0/37/128, the mid-prompt chunk, and
# a V head dim apart from the K one
CASES = [
    # dtype, b, sq, h, kvh, hd, skv, bq, bk, window, q_off, kv_len, hd_v
    *[(dt, *shape, 0, None, None, None)
      for dt in ("float32", "bfloat16")
      for shape in ((1, 64, 4, 4, 64, 256, 32, 64),      # MHA
                    (2, 128, 8, 2, 64, 512, 64, 128),    # GQA
                    (2, 64, 4, 1, 128, 256, 64, 256),    # MQA, hd 128
                    (1, 128, 4, 2, 32, 128, 128, 128))],  # one kv block
    *[("float32", 2, 64, 4, 2, 64, 256, 32, 64, w, 192, [256, 200], None)
      for w in (0, 37, 128)],
    ("float32", 1, 32, 4, 4, 64, 128, 32, 64, 0, 64, [96], None),
    ("float32", 2, 32, 4, 2, 64, 128, 32, 64, 0, 96, [128, 110], 32),
]


@pytest.mark.parametrize(
    "dtype,b,sq,h,kvh,hd,skv,bq,bk,window,q_off,kv_len,hd_v", CASES)
def test_dense_prefill_matches_pallas(jax_ops, dtype, b, sq, h, kvh, hd, skv,
                                      bq, bk, window, q_off, kv_len, hd_v):
    import jax.numpy as jnp
    q, k, v = _case(1 + b + sq + (window or 0), b, sq, h, kvh, hd, skv,
                    hd_v)
    if q_off is None:
        q_off, kv_len = skv - sq, [skv] + [skv // 2] * (b - 1)
    kv_len = np.asarray(kv_len, np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    exp = jax_ops.prefill_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(kv_len), jnp.asarray([q_off], jnp.int32),
        window=window, block_q=bq, block_kv=bk)
    out = ops.prefill_attention(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(kv_len), np.array([q_off], np.int32),
        window=window, block_q=bq, block_kv=bk)
    a = out.float().numpy()
    e = np.asarray(exp).astype(np.float32)
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    assert a.shape == e.shape == (b, sq, h, v.shape[-1])
    assert not np.isnan(a).any()
    live = attendable(kv_len, q_off, sq, window)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert float(np.abs(a - e)[live].max()) < tol
    assert float(np.abs(a[~live]).max(initial=0.0)) == 0.0
    if window == 37:
        assert not live.all()          # the case reaches empty pad rows


def test_dense_prefill_matches_paged_prefill():
    """tests/test_kernels.py:122 with the port's ops on both sides: the
    paged form over pools that hold the dense caches' K/V agrees with
    the dense form, request by request (the dense form takes one shared
    q_offset)."""
    b, sq, h, kvh, hd, page, nslots = 2, 32, 4, 2, 64, 16, 4
    skv = nslots * page
    q, k, v = (torch.from_numpy(x) for x in
               _case(26, b, sq, h, kvh, hd, skv))
    kp = k.reshape(b * nslots, page, kvh, hd)
    vp = v.reshape(b * nslots, page, kvh, hd)
    bt = torch.arange(b * nslots, dtype=torch.int32).reshape(b, nslots)
    q_off = torch.tensor([skv - sq, 11], dtype=torch.int32)
    kv_len = q_off + sq
    out_paged = ops.prefill_attention(q, kp, vp, kv_len, q_off,
                                      block_table=bt, block_q=16)
    for i in range(b):
        out_dense = ops.prefill_attention(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_len[i:i + 1],
            q_off[i:i + 1], block_q=16, block_kv=page)
        assert float((out_paged[i] - out_dense[0]).abs().max()) < F32_TOL


def test_dense_prefill_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _case(3, 1, 8, 2, 1, 16, 16))
    kv_len = torch.tensor([16], dtype=torch.int32)
    with pytest.raises(ValueError):           # chunk past the cache
        chunked_prefill_attention(q, k, v, kv_len, 9)
    with pytest.raises(ValueError):           # not one shared start
        ops.prefill_attention(q, k, v, kv_len, [0, 8])
    meta = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError):
        chunked_prefill_attention(meta, meta, meta, meta, 0)
    # a CPU tensor runs the plain version and counts no launch
    before = chunked_prefill_attention.launches
    out = ops.prefill_attention(q, k, v, kv_len, [8])
    assert chunked_prefill_attention.launches == before
    torch.testing.assert_close(out, ref.chunked_prefill_attention(
        q, k, v, kv_len, 8), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,h,kvh,hd,hd_v,skv,q_off,kv_len,window", [
    # qwen2-0.5b's widths; skv not a multiple of the 64-token tile; a
    # kv_len = 0 request
    (3, 40, 14, 2, 64, 64, 100, 60, [100, 0, 70], 0),
    # Llama-3.2-Vision's hd 128 / rep 4, windowed
    (2, 64, 32, 8, 128, 128, 200, 0, [64, 20], 37),
    # MQA with a narrower V; windowed pad rows past kv_len give 0
    (2, 17, 4, 1, 64, 32, 77, 50, [67, 5], 5),
])
def test_cuda_dense_prefill_matches_plain_version(dtype, b, sq, h, kvh, hd,
                                                  hd_v, skv, q_off, kv_len,
                                                  window):
    """On the card: kernel 5 against its plain version on the same CUDA
    inputs, causal and not; rows without an attendable key exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    q, k, v = (_torch(x, dtype, dev) for x in
               _case(17, b, sq, h, kvh, hd, skv, hd_v))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    before = chunked_prefill_attention.launches
    for causal in (True, False):
        got = chunked_prefill_attention(q, k, v, lens, q_off,
                                        window=window, causal=causal)
        exp = ref.chunked_prefill_attention(q, k, v, lens, q_off,
                                            window=window, causal=causal)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype and got.shape == (b, sq, h, hd_v)
        assert bool(torch.isfinite(got).all())
        assert float((got.float() - exp.float()).abs().max()) < tol
        dead = ~torch.from_numpy(attendable(kv_len, q_off, sq, window,
                                            causal)).to(dev)
        assert float(got[dead].float().abs().sum()) == 0.0
        if causal:
            assert bool(dead.any())    # each case reaches an empty row
    assert chunked_prefill_attention.launches == before + 2
