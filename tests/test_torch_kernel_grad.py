"""Kernel 5's backward: ``ref.chunked_prefill_attention_bwd`` (the plain
version the CPU runs) against ``torch.autograd`` of the plain forward
and against ``jax.grad`` of the reference's ``flash_attn``, the
``ChunkedPrefillAttention`` function and its dispatch in
``ops.prefill_attention``; on the card, the CUDA backward against the
plain one.

Inputs come from numpy with a seed, f32.  Tolerances: 2e-5 absolute
(f32 summation order, gradients of order 1) against autograd of the
same plain forward, and 1e-4 against JAX, whose flash attention sums
its online softmax block by block in another order and whose
gradients at these shapes reach about 10.  The card's f32 backward is
held to 2e-5 and its bf16 one to 2e-2 of the plain version's largest
gradient (a rounding of each output); both run on the tensor cores (one
``tensor_core_launches`` a call), two calls give the same bits, and in
f32 the kernel is at most twice as far from an f64 autograd witness as
the f32 plain version (as phase 2h of chip_smoke.py holds it).

JAX's ``flash_attn`` takes one ``kv_len`` for the batch and gives the
mean of V to a query row with no key (the port gives 0), so the JAX
cases share kv_len and leave no query row without a key.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunked_prefill_attention import (
    ChunkedPrefillAttention, chunked_prefill_attention,
    chunked_prefill_attention_bwd)

F32_TOL = 2e-5
JAX_TOL = 1e-4
BF16_REL = 2e-2

# (b, sq, h, kvh, hd, hd_v, skv, q_offset, kv_len, window, causal)
CASES = {
    # the training form: q_offset 0, kv_len = the sequence
    "causal": (2, 24, 4, 2, 16, 16, 24, 0, [24, 24], 0, True),
    "window": (2, 40, 4, 1, 8, 8, 40, 0, [40, 40], 7, True),
    # MLA's widths in miniature: K wider than V
    "mla": (1, 20, 3, 3, 12, 8, 20, 0, [20], 0, True),
    # the cross read: non-causal, more queries than keys, and fewer
    "noncausal_sq_gt_skv": (2, 30, 4, 2, 8, 8, 11, 0, [11, 11], 0, False),
    "noncausal_sq_lt_skv": (2, 7, 4, 4, 8, 8, 19, 0, [19, 19], 0, False),
    # a chunk at an offset with kv_len < skv: key rows at or past kv_len
    # get 0, and one request with no key at all
    "kv_len_short": (3, 12, 4, 2, 8, 8, 32, 10, [22, 15, 0], 0, True),
    "window_past_kv_len": (2, 16, 2, 1, 8, 8, 40, 20, [36, 22], 5, True),
}
JAX_CASES = ("causal", "window", "mla", "noncausal_sq_gt_skv",
             "noncausal_sq_lt_skv", "kv_len_shared")
CASES["kv_len_shared"] = (2, 12, 4, 2, 8, 8, 32, 10, [17, 17], 0, True)


def _inputs(case, seed=0, device="cpu", dtype=torch.float32):
    b, sq, h, kvh, hd, hd_v, skv, q_off, kv_len, window, causal = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd_v),
        (b, sq, h, hd_v))]
    q, k, v, dout = (torch.from_numpy(a).to(device=device, dtype=dtype)
                     for a in arrs)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=device)
    return arrs, (q, k, v, dout, lens, q_off, window, causal)


def _autograd(q, k, v, dout, lens, q_off, window, causal):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.chunked_prefill_attention(*leaves, lens, q_off,
                                        window=window, causal=causal)
    return torch.autograd.grad(out, leaves, dout)


def _plain(q, k, v, dout, lens, q_off, window, causal):
    out = ref.chunked_prefill_attention(q, k, v, lens, q_off,
                                        window=window, causal=causal)
    return ref.chunked_prefill_attention_bwd(q, k, v, out, dout, lens,
                                             q_off, window=window,
                                             causal=causal)


def _dead_keys(case):
    """(b, skv) bool: key rows no query may attend."""
    b, sq, _, _, _, _, skv, q_off, kv_len, window, causal = case
    q_pos = q_off + np.arange(sq)[:, None]
    k_pos = np.arange(skv)[None, :]
    dead = np.ones((b, skv), bool)
    for i in range(b):
        m = k_pos < kv_len[i]
        if causal:
            m = m & (k_pos <= q_pos)
        if window:
            m = m & (k_pos > q_pos - window)
        dead[i] = ~m.any(0)
    return dead


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_equals_autograd_of_plain_forward(name):
    _, args = _inputs(CASES[name])
    got = _plain(*args)
    exp = _autograd(*args)
    for g, e in zip(got, exp):
        assert g.dtype == torch.float32 and g.shape == e.shape
        torch.testing.assert_close(g, e, rtol=0, atol=F32_TOL)
    # key rows no query reaches (at or past kv_len among them): exactly 0
    dead = torch.from_numpy(_dead_keys(CASES[name]))
    assert float(got[1][dead].abs().sum()) == 0.0
    assert float(got[2][dead].abs().sum()) == 0.0
    if name == "kv_len_short":
        assert bool(dead[:, 22:].all()) and float(got[0][2].abs().sum()) == 0


@pytest.fixture(scope="module")
def flash():
    pytest.importorskip("jax")
    from repro.models.attention import flash_attn
    return flash_attn


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_backward_equals_jax_grad_of_flash_attn(flash, name):
    import jax
    import jax.numpy as jnp
    case = CASES[name]
    (q, k, v, dout), args = _inputs(case, seed=1)
    _, sq, _, _, _, _, _, q_off, kv_len, window, causal = case

    def f(q, k, v):
        out = flash(q, k, v, causal=causal, q_offset=q_off, window=window,
                    kv_len=kv_len[0], block_kv=8)
        return jnp.sum(out * dout)
    exp = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    for g, e in zip(_plain(*args), exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0,
                                   atol=JAX_TOL)


def test_autograd_function_runs_the_backward_wrapper():
    """On CPU tensors the function's backward is the plain backward, the
    forward the plain forward; kv_len and the scalars take no gradient;
    the launch counters do not move (no kernel ran)."""
    case = CASES["kv_len_short"]
    _, (q, k, v, dout, lens, q_off, window, causal) = _inputs(case, seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (chunked_prefill_attention.launches,
              chunked_prefill_attention_bwd.launches,
              chunked_prefill_attention_bwd.tensor_core_launches)
    out = ChunkedPrefillAttention.apply(*leaves, lens, q_off, window,
                                        causal)
    torch.testing.assert_close(out, ref.chunked_prefill_attention(
        q, k, v, lens, q_off, window=window, causal=causal), rtol=0, atol=0)
    got = torch.autograd.grad(out, leaves, dout)
    exp = chunked_prefill_attention_bwd(q, k, v, out.detach(), dout, lens,
                                        q_off, window=window, causal=causal)
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
    assert (chunked_prefill_attention.launches,
            chunked_prefill_attention_bwd.launches,
            chunked_prefill_attention_bwd.tensor_core_launches) == before


def test_dense_prefill_attention_takes_the_function_only_with_grad():
    """``ops.prefill_attention``'s dense form goes through
    ``ChunkedPrefillAttention`` when grad is on and an input requires
    it; otherwise it returns the forward alone, as before."""
    _, (q, k, v, dout, lens, q_off, window, causal) = _inputs(
        CASES["causal"], seed=3)
    plain = ops.prefill_attention(q, k, v, lens, q_off)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = ops.prefill_attention(qg, k, v, lens, q_off)
    assert type(out.grad_fn).__name__ == "ChunkedPrefillAttentionBackward"
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    with torch.no_grad():
        assert ops.prefill_attention(qg, k, v, lens, q_off).grad_fn is None
    (dq,) = torch.autograd.grad(out, qg, dout)
    torch.testing.assert_close(dq, _plain(q, k, v, dout, lens, q_off,
                                          0, True)[0], rtol=0, atol=0)


def test_backward_refuses_a_chunk_outside_the_cache():
    _, (q, k, v, dout, lens, _, _, _) = _inputs(CASES["causal"])
    with pytest.raises(ValueError, match="outside a cache"):
        chunked_prefill_attention_bwd(q, k, v, dout, dout, lens, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # OPT-125M's widths (12/12 heads of 64), causal training form
    (4, 96, 12, 12, 64, 64, 96, 0, [96] * 4, 0, True),
    # the 100m preset's 12/4 heads, a chunk at an offset, ragged kv_len
    # with a 0 and key rows past kv_len
    (3, 70, 12, 4, 64, 64, 150, 60, [130, 0, 100], 0, True),
    # RecurrentGemma's 16/1 heads of 256, windowed
    (1, 150, 16, 1, 256, 256, 150, 0, [150], 40, True),
    # MLA's (192, 128)
    (1, 80, 8, 8, 192, 128, 80, 0, [80], 0, True),
    # the cross read: non-causal, more queries than keys (32/8 of 128)
    (2, 100, 32, 8, 128, 128, 45, 0, [45, 45], 0, False),
    # hd 32, and the DeepSeek-V2 smoke config's (80, 64)
    (2, 33, 4, 4, 32, 32, 33, 0, [33, 33], 0, True),
    (2, 33, 4, 4, 80, 64, 33, 0, [33, 33], 0, True),
])
def test_cuda_backward_matches_plain_version(dtype, case):
    """On the card: the CUDA backward against the plain one on the same
    CUDA inputs (the forward's output from kernel 5), key rows no query
    reaches exactly 0, one launch counted, in f32 and bf16 (the backward
    has a bf16 instantiation at every width it takes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _, (q, k, v, dout, lens, q_off, window, causal) = _inputs(
        case, seed=4, device=dev, dtype=dtype)
    # kernel 5 has no bf16 body at the smoke widths (80, 64): the plain
    # forward gives the output there
    fwd = (ref.chunked_prefill_attention
           if dtype == torch.bfloat16 and q.shape[3] == 80
           else chunked_prefill_attention)
    out = fwd(q, k, v, lens, q_off, window=window,
              causal=causal).contiguous()
    before = (chunked_prefill_attention_bwd.launches,
              chunked_prefill_attention_bwd.tensor_core_launches)
    got = chunked_prefill_attention_bwd(q, k, v, out, dout, lens, q_off,
                                        window=window, causal=causal)
    exp = ref.chunked_prefill_attention_bwd(q, k, v, out, dout, lens,
                                            q_off, window=window,
                                            causal=causal)
    torch.cuda.synchronize()
    assert (chunked_prefill_attention_bwd.launches,
            chunked_prefill_attention_bwd.tensor_core_launches) == (
                before[0] + 1, before[1] + 1)
    dead = torch.from_numpy(_dead_keys(case)).to(dev)
    for g, e in zip(got, exp):
        assert g.dtype == dtype and g.shape == e.shape
        assert bool(torch.isfinite(g).all())
        tol = (F32_TOL if dtype == torch.float32
               else BF16_REL * float(e.float().abs().max()))
        assert float((g.float() - e.float()).abs().max()) <= tol
    assert float(got[1][dead].float().abs().sum()) == 0.0
    assert float(got[2][dead].float().abs().sum()) == 0.0


def _f64_grads(q, k, v, dout, lens, q_off, window, causal):
    """Autograd of the masked softmax attention in float64: the exact
    gradients' witness, independent of the kernel and of the plain
    backward."""
    b, sq, h, hd = q.shape
    skv, kvh, hd_v = k.shape[1], k.shape[2], v.shape[3]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    s = torch.einsum("bqgrd,bkgd->bgrqk",
                     leaves[0].reshape(b, sq, kvh, h // kvh, hd),
                     leaves[1]) * hd ** -0.5
    q_pos = q_off + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    live = k_pos[None] < lens.long()[:, None, None]
    if causal:
        live = live & (k_pos <= q_pos)[None]
    if window:
        live = live & (k_pos > q_pos - window)[None]
    live = live[:, None, None]
    p = torch.where(live, torch.softmax(s.masked_fill(~live, -1e300), -1),
                    0.0)
    o64 = torch.einsum("bgrqk,bkgd->bqgrd", p, leaves[2])
    return torch.autograd.grad(o64.reshape(b, sq, h, hd_v), leaves,
                               dout.double())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # sq 65: a second query tile of one row
    (2, 65, 12, 12, 64, 64, 65, 0, [65, 65], 0, True),
    # sq 127, a kv_len that ends inside the second 64-key tile
    (2, 127, 12, 4, 64, 64, 127, 0, [127, 90], 0, True),
    # qwen2's rep 7 (14 / 2 heads), a ragged kv_len
    (2, 200, 14, 2, 64, 64, 200, 0, [200, 131], 0, True),
    # a window of 37 that ends inside a tile, hd 128
    (2, 190, 8, 2, 128, 128, 190, 0, [190, 170], 37, True),
])
def test_cuda_backward_tile_edges(dtype, case):
    """The tensor-core body's tile edges (64 rows a block) against the
    plain version, one tensor-core launch a call, key rows no query
    reaches exactly 0.  Gradients here reach 8-20, sums over up to 200
    keys or queries, so f32 is held as phase 2h holds it (``grad_limit``
    of chip_smoke.py): 2e-5 of the largest plain gradient past 1, and at
    most twice as far from the f64 witness as the f32 plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, kw = _cuda_case(case, dtype, seed=4)
    q, k, v, out, dout, lens, q_off = args
    before = (chunked_prefill_attention_bwd.launches,
              chunked_prefill_attention_bwd.tensor_core_launches)
    got = chunked_prefill_attention_bwd(*args, **kw)
    exp = ref.chunked_prefill_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert (chunked_prefill_attention_bwd.launches,
            chunked_prefill_attention_bwd.tensor_core_launches) == (
                before[0] + 1, before[1] + 1)
    dead = torch.from_numpy(_dead_keys(case)).to(q.device)
    exact = (_f64_grads(q, k, v, dout, lens, q_off, **kw)
             if dtype == torch.float32 else (None,) * 3)
    for g, e, x in zip(got, exp, exact):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        big = float(e.float().abs().max())
        tol = (F32_TOL * max(1.0, big) if dtype == torch.float32
               else BF16_REL * big)
        assert float((g.float() - e.float()).abs().max()) <= tol
        if x is not None:
            k64 = float((g.double() - x).abs().max())
            p64 = float((e.double() - x).abs().max())
            assert k64 <= max(2 * p64, F32_TOL), (k64, p64)
    assert float(got[1][dead].float().abs().sum()) == 0.0
    assert float(got[2][dead].float().abs().sum()) == 0.0


def _cuda_case(case, dtype, seed):
    torch.backends.cuda.matmul.allow_tf32 = False
    _, (q, k, v, dout, lens, q_off, window, causal) = _inputs(
        case, seed=seed, device=torch.device("cuda"), dtype=dtype)
    out = chunked_prefill_attention(q, k, v, lens, q_off, window=window,
                                    causal=causal)
    return (q, k, v, out, dout, lens, q_off), dict(window=window,
                                                   causal=causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_is_deterministic(dtype):
    """Two calls on the same inputs give the same bits (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, kw = _cuda_case((4, 256, 12, 12, 64, 64, 256, 0, [256, 200, 256,
                                                            77], 0, True),
                          dtype, seed=5)
    first = chunked_prefill_attention_bwd(*args, **kw)
    second = chunked_prefill_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_f32_backward_is_near_the_f64_witness():
    """In f32 (each operand as three bf16 terms on the tensor cores) each
    gradient is at most twice as far from autograd of the masked softmax
    in float64 as the f32 plain version is, or within the f32
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    case = (2, 300, 12, 4, 64, 64, 300, 0, [300, 211], 0, True)
    args, kw = _cuda_case(case, torch.float32, seed=6)
    q, k, v, out, dout, lens, q_off = args
    got = chunked_prefill_attention_bwd(*args, **kw)
    exp = ref.chunked_prefill_attention_bwd(*args, **kw)
    exact = _f64_grads(q, k, v, dout, lens, q_off, **kw)
    for g, e, x in zip(got, exp, exact):
        k64 = float((g.double() - x).abs().max())
        p64 = float((e.double() - x).abs().max())
        assert k64 <= max(2 * p64, F32_TOL), (k64, p64)


@pytest.mark.gpu
def test_cuda_backward_refuses_an_uninstantiated_width():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    case = (1, 8, 2, 2, 48, 48, 8, 0, [8], 0, True)
    _, (q, k, v, dout, lens, q_off, _, _) = _inputs(case, device="cuda")
    with pytest.raises(ValueError, match="hd=48"):
        chunked_prefill_attention_bwd(q, k, v, dout, dout, lens, q_off)
