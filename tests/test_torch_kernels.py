"""The port's paged-attention kernels against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; the
JAX package runs its Pallas kernels in interpret mode, as its own
tests do.  Inputs come from numpy with a seed and go to both.  The
f32 tolerance (2e-5, as in tests/test_kernels.py) covers summation
order; bf16 outputs may differ by one bf16 rounding (2e-2).

The module imports no JAX at the top: the machine with the card has
none, and the GPU test below (kernel vs plain version) runs there.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_plan import decode_plan, share_keys
from repro_torch.kernels.paged_cross_decode_attention import (
    paged_cross_decode_attention)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention)
from repro_torch.kernels.mla_plan import mla_plan
from repro_torch.kernels.paged_mla_decode_attention import (
    paged_mla_decode_attention)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention)

F32_TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def jax_ops():
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    return jops


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x, dtype):
    """The same values as a torch tensor and a jnp array of ``dtype``
    ("float32" or "bfloat16"; both round f32 to nearest even)."""
    import jax.numpy as jnp
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    return t, jnp.asarray(x)


def _close(t_out, j_out, tol):
    a = t_out.float().numpy()
    b = np.asarray(j_out).astype(np.float32)
    assert a.shape == b.shape
    assert not np.isnan(a).any()
    err = float(np.abs(a - b).max())
    assert err < tol, err


def _prefill_case(seed, b, sq, h, kvh, hd, npages, page, nslots,
                  q_off=None, kv_len=None, bt=None):
    rng = np.random.default_rng(seed)
    q = _rand(rng, (b, sq, h, hd))
    kp = _rand(rng, (npages, page, kvh, hd))
    vp = _rand(rng, (npages, page, kvh, hd))
    if bt is None:
        bt = rng.integers(0, npages, (b, nslots)).astype(np.int32)
    maxlen = nslots * page
    if q_off is None:
        q_off = rng.integers(0, maxlen - sq + 1, (b,)).astype(np.int32)
    if kv_len is None:
        kv_len = np.minimum(q_off + sq, maxlen).astype(np.int32)
    return q, kp, vp, np.asarray(bt, np.int32), np.asarray(
        kv_len, np.int32), np.asarray(q_off, np.int32)


def _run_prefill(jax_ops, case, dtype, **kw):
    q, kp, vp, bt, kv_len, q_off = case
    tq, jq = _pair(q, dtype)
    tk, jk = _pair(kp, dtype)
    tv, jv = _pair(vp, dtype)
    out = ops.prefill_attention(tq, tk, tv, torch.from_numpy(kv_len),
                                torch.from_numpy(q_off),
                                block_table=torch.from_numpy(bt), **kw)
    exp = jax_ops.prefill_attention(jq, jk, jv, kv_len, q_off,
                                    block_table=bt, **kw)
    return out, exp


# mirrors tests/test_kernels.py:99, plus the full config's GQA ratio
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,h,kvh,hd,npages,page,nslots", [
    (3, 32, 4, 2, 64, 10, 16, 4),     # rep 2, ragged offsets
    (1, 16, 4, 4, 32, 6, 16, 3),      # rep 1 (MHA)
    (2, 16, 14, 2, 64, 12, 16, 4),    # rep 7 (qwen2-0.5b), hd 64
])
def test_paged_prefill_matches_pallas(jax_ops, dtype, b, sq, h, kvh, hd,
                                      npages, page, nslots):
    case = _prefill_case(21, b, sq, h, kvh, hd, npages, page, nslots)
    out, exp = _run_prefill(jax_ops, case, dtype)
    _close(out, exp, BF16_TOL if dtype == "bfloat16" else F32_TOL)


@pytest.mark.parametrize("rep", [1, 2, 7])
def test_paged_prefill_engine_chunk_layout(jax_ops, rep):
    """A chunk as the prefill engine packs it: segments with q_offset > 0
    mid-prompt, ragged multi-page kv_len, a pow2 pad segment (kv_len 0,
    every slot on the scratch page) and pad slots on the scratch page."""
    kvh, page, npages, sq = 2, 4, 13, 8
    trash = npages - 1
    bt = np.full((4, 6), trash, np.int32)
    bt[0, :3] = [0, 1, 2]          # 3 pages, q_offset 4 (second chunk)
    bt[1, :2] = [5, 3]             # 2 pages, q_offset 0
    bt[2, :5] = [6, 7, 8, 9, 4]    # 5 pages, q_offset 13 (mid-page)
    q_off = np.array([4, 0, 13, 0], np.int32)
    kv_len = np.array([12, 7, 19, 0], np.int32)
    case = _prefill_case(5, 4, sq, kvh * rep, kvh, 32, npages, page, 6,
                         q_off=q_off, kv_len=kv_len, bt=bt)
    out, exp = _run_prefill(jax_ops, case, "float32")
    _close(out, exp, F32_TOL)
    assert float(out[3].abs().max()) == 0.0       # empty segment gives 0


@pytest.mark.parametrize("window", [3, 16, 21])
def test_paged_prefill_window_matches_pallas(jax_ops, window):
    """Mirrors tests/test_kernels.py:148: window edge cases smaller than
    a page, exactly a page, spanning pages, offsets mid-page."""
    case = _prefill_case(30, 3, 16, 4, 2, 32, 12, 16, 4,
                         q_off=[0, 17, 48], kv_len=[16, 33, 64])
    out, exp = _run_prefill(jax_ops, case, "float32", window=window)
    _close(out, exp, F32_TOL)


def test_paged_prefill_non_causal_matches_pallas(jax_ops):
    case = _prefill_case(31, 2, 16, 4, 2, 32, 12, 16, 4,
                         q_off=[0, 0], kv_len=[40, 9])
    out, exp = _run_prefill(jax_ops, case, "float32", causal=False)
    _close(out, exp, F32_TOL)


def _decode_case(seed, b, h, kvh, hd, npages, page, nslots, lens=None,
                 bt=None):
    rng = np.random.default_rng(seed)
    q = _rand(rng, (b, h, hd))
    kp = _rand(rng, (npages, page, kvh, hd))
    vp = _rand(rng, (npages, page, kvh, hd))
    if bt is None:
        bt = rng.integers(0, npages, (b, nslots)).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, nslots * page + 1, (b,)).astype(np.int32)
    return q, kp, vp, np.asarray(bt, np.int32), np.asarray(lens, np.int32)


def _run_decode(jax_ops, case, dtype, **kw):
    q, kp, vp, bt, lens = case
    tq, jq = _pair(q, dtype)
    tk, jk = _pair(kp, dtype)
    tv, jv = _pair(vp, dtype)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(bt),
                               torch.from_numpy(lens), **kw)
    exp = jax_ops.decode_attention(jq, jk, jv, bt, lens, **kw)
    return out, exp


# mirrors tests/test_kernels.py:75, plus the full config's GQA ratio
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,hd,npages,page,nslots", [
    (2, 4, 2, 64, 16, 64, 6),       # rep 2
    (1, 8, 8, 32, 8, 16, 8),        # rep 1, small pages
    (3, 14, 2, 64, 20, 16, 5),      # rep 7 (qwen2-0.5b)
])
def test_paged_decode_matches_pallas(jax_ops, dtype, b, h, kvh, hd, npages,
                                     page, nslots):
    case = _decode_case(10, b, h, kvh, hd, npages, page, nslots)
    out, exp = _run_decode(jax_ops, case, dtype)
    _close(out, exp, BF16_TOL if dtype == "bfloat16" else F32_TOL)


@pytest.mark.parametrize("rep", [1, 2, 7])
def test_paged_decode_engine_slot_layout(jax_ops, rep):
    """A slot batch as the decode engine packs it: ragged multi-page
    lens, empty slots (lens 0) whose whole row is the scratch page."""
    npages, page = 11, 4
    trash = npages - 1
    bt = np.full((4, 5), trash, np.int32)
    bt[0, :3] = [0, 1, 2]
    bt[2, :5] = [3, 4, 5, 6, 7]
    bt[3, :1] = [8]
    lens = np.array([11, 0, 17, 1], np.int32)
    case = _decode_case(12, 4, 2 * rep, 2, 32, npages, page, 5, lens=lens,
                        bt=bt)
    out, exp = _run_decode(jax_ops, case, "float32")
    _close(out, exp, F32_TOL)
    assert float(out[1].abs().max()) == 0.0       # empty slot gives 0


@pytest.mark.parametrize("window", [3, 16, 21])
def test_paged_decode_window_matches_pallas(jax_ops, window):
    """Mirrors tests/test_kernels.py:168."""
    case = _decode_case(34, 4, 4, 2, 32, 12, 16, 4, lens=[5, 16, 33, 64])
    out, exp = _run_decode(jax_ops, case, "float32", window=window)
    _close(out, exp, F32_TOL)


def test_paged_decode_window_ignores_slid_out_pages():
    """Mirrors tests/test_kernels.py:186: out-of-window table slots may
    point at a garbage scratch page that must never reach the softmax."""
    q, kp, vp, _, lens = _decode_case(38, 1, 4, 2, 32, 4, 8, 3, lens=[24],
                                      bt=[[0, 1, 2]])
    kp[3] = 1e4                                   # the scratch page
    vp[3] = -1e4
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp))
    out_live = ops.decode_attention(*args, torch.tensor([[0, 1, 2]]),
                                    torch.from_numpy(lens), window=8)
    out_trash = ops.decode_attention(*args, torch.tensor([[3, 3, 2]]),
                                     torch.from_numpy(lens), window=8)
    assert torch.equal(out_live, out_trash)


def test_paged_decode_single_token_cache(jax_ops):
    """Mirrors tests/test_kernels.py:228: lens=1 attends one token, so the
    output is that token's V, repeated over each KV head's rep rows."""
    q, kp, vp, bt, lens = case = _decode_case(15, 1, 4, 2, 64, 4, 16, 2,
                                              lens=[1], bt=[[2, 0]])
    out, exp = _run_decode(jax_ops, case, "float32")
    _close(out, exp, 1e-5)
    expand = np.repeat(vp[2, 0], 2, axis=0)
    assert np.abs(out[0].numpy() - expand).max() < 1e-5


def test_plain_versions_zero_rows_without_keys():
    """The plain versions follow the kernels: a row with no key it may
    attend gives 0 (the reference's oracles would give mean(V))."""
    q, kp, vp, bt, kv_len, q_off = _prefill_case(
        3, 2, 8, 4, 2, 16, 6, 4, 3, q_off=[0, 20], kv_len=[0, 6])
    out = ref.paged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(kv_len),
        torch.from_numpy(q_off), window=4)
    assert float(out[0].abs().max()) == 0.0       # kv_len 0
    # segment 1: queries at 20.. with window 4 see no key < 6
    assert float(out[1].abs().max()) == 0.0


def test_wrappers_refuse_unsupported_devices():
    q = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        paged_decode_attention(q, q, q, q, q)


def test_cross_wrapper_refuses_unsupported_devices_and_splits_evenly():
    q = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        paged_cross_decode_attention(q, q, q, q, q)
    # Llama-3.2-Vision's 8 slots x 8 KV heads x 100 cross slots, and
    # Whisper's 8 x 6 x 94, fill 132 SMs at least twice over; a full
    # cross table splits evenly into shares of at most 17 and 12 pages
    for (b, h, kvh, hd, n_slots), most in (((8, 32, 8, 128, 100), 17),
                                           ((8, 6, 6, 64, 94), 12),
                                           ((1, 2, 1, 64, 3), 1)):
        splits = decode_plan(torch.bfloat16, b, h, kvh, hd, hd, 16,
                             n_slots, 132).splits
        pages = [-(-e // 16) - s // 16 for s, e, _, _ in (
            share_keys(16 * n_slots, 0, 16, n_slots, i, splits)
            for i in range(splits))]
        assert b * kvh * splits >= min(264, b * kvh * n_slots)
        assert max(pages) == most and sum(pages) == n_slots
        assert max(pages) - min(pages) <= 1


def test_mla_wrapper_refuses_unsupported_devices_and_shapes():
    q = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        paged_mla_decode_attention(q, q, q, q, q, q, scale=1.0)
    # full width: blocks of 16 heads, 8 a slot, on the tensor cores for
    # a bf16 pool (f32 queries as three bf16 terms), 2 blocks an SM
    plan = mla_plan(torch.float32, torch.bfloat16, 8, 128, 512, 64, 16,
                    128)
    assert (plan.heads, plan.head_blocks, plan.body) == (16, 8,
                                                         "tensor_core")
    assert plan.q_terms == 3 and 2 * plan.smem < 232_448
    # any head count: 12 heads run as one zero-padded block
    assert mla_plan(torch.float32, torch.float32, 4, 12, 32, 16, 32,
                    20).head_blocks == 1
    with pytest.raises(ValueError, match="lora=128, rope=64"):
        mla_plan(torch.float32, torch.bfloat16, 8, 16, 128, 64, 16, 128)


def _decode_edges(h, kvh, hd, page, tdt, window):
    """Kernel 2 against its plain version on the decode body's edges, on
    the card: 40-slot tables over a pool whose scratch page holds
    garbage (1e4 / -1e4): a slot whose live pages span every split, one
    shorter than one share, an empty slot, one ending mid-page; every
    table slot past a slot's length or slid out of ``window`` on the
    scratch page.  Empty slots exactly 0."""
    dev = torch.device("cuda")
    b, n_slots = 4, 40
    npages = b * n_slots + 1
    trash = npages - 1
    rng = np.random.default_rng(17)
    q = torch.from_numpy(_rand(rng, (b, h, hd))).to(dev).to(tdt)
    kp, vp = (torch.from_numpy(_rand(rng, (npages, page, kvh, hd))).to(dev)
              for _ in range(2))
    kp[trash], vp[trash] = 1e4, -1e4
    kp, vp = kp.to(tdt), vp.to(tdt)
    lens = [n_slots * page, min(3, page), 0, n_slots * page // 2 + 1]
    bt = rng.permutation(trash)[:b * n_slots].reshape(b, n_slots)
    for i, n in enumerate(lens):
        bt[i, -(-n // page):] = trash
        if window:
            bt[i, :max(0, n - window) // page] = trash
    args = (q, kp, vp, torch.from_numpy(bt.astype(np.int32)).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))
    got = paged_decode_attention(*args, window=window)
    exp = ref.paged_decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert got.dtype == tdt and bool(torch.isfinite(got).all())
    assert float((got.float() - exp.float()).abs().max()) <= _limit(exp)
    assert float(got[2].float().abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh,hd,page", [
    (14, 2, 64, 16),      # qwen2-0.5b
    (4, 4, 32, 4),        # rep 1, small pages
    (4, 2, 128, 64),      # wide heads, one page per tile
    (32, 8, 128, 16),     # Llama-3.2-Vision self-attention: hd 128, rep 4
    (8, 8, 256, 16),      # hd 256, rep 1 (decode only: no prefill body)
    (24, 8, 64, 1),       # rep 3, one-token pages
    (16, 2, 128, 64),     # rep 8, pages of 64
    (8, 1, 256, 4),       # rep 8 at hd 256 (decode only)
])
def test_cuda_kernels_match_plain_versions(dtype, h, kvh, hd, page):
    """On the card: each CUDA kernel against its plain version on the
    same CUDA inputs (ragged kv_len, pad rows, pad segments and slots on
    the scratch page, lens=0 slots, a windowed case), and kernel 2 on
    its body's edges (``_decode_edges``).  The prefill kernel takes head
    widths up to 128 only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tdt = getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    dev = torch.device("cuda")
    npages, nslots = 40, 6
    trash, maxlen = npages - 1, nslots * page
    prefill = hd <= 128
    before = (paged_prefill_attention.launches,
              paged_decode_attention.launches,
              paged_prefill_attention.tensor_core_launches)
    for window in (0, 5):
        _decode_edges(h, kvh, hd, page, tdt, window)
        sq = 24
        q_off = [0, maxlen - sq, 7, 0]
        kv_len = [sq, maxlen, 20, 0]        # segment 2 has pad rows
        q, kp, vp, bt, kv_len, q_off = _prefill_case(
            7, 4, sq, h, kvh, hd, npages, page, nslots, q_off=q_off,
            kv_len=kv_len)
        bt[3] = trash
        args = [torch.from_numpy(x).to(dev).to(tdt) for x in (q, kp, vp)]
        args += [torch.from_numpy(x).to(dev) for x in (bt, kv_len, q_off)]
        if prefill:
            got = paged_prefill_attention(*args, window=window)
            exp = ref.paged_prefill_attention(*args, window=window)
            torch.cuda.synchronize()
            assert float((got.float() - exp.float()).abs().max()) < tol
            assert float(got[3].float().abs().max()) == 0.0
        q, kp, vp, bt, lens = _decode_case(8, 4, h, kvh, hd, npages, page,
                                           nslots, lens=[1, 0, maxlen, 37])
        bt[1] = trash
        args = [torch.from_numpy(x).to(dev).to(tdt) for x in (q, kp, vp)]
        args += [torch.from_numpy(x).to(dev) for x in (bt, lens)]
        got = paged_decode_attention(*args, window=window)
        exp = ref.paged_decode_attention(*args, window=window)
        torch.cuda.synchronize()
        assert float((got.float() - exp.float()).abs().max()) < tol
        assert float(got[1].float().abs().max()) == 0.0
    assert paged_prefill_attention.launches == before[0] + 2 * prefill
    assert paged_decode_attention.launches == before[1] + 4
    # bf16 runs the tensor-core body, f32 the CUDA-core one
    assert paged_prefill_attention.tensor_core_launches == before[2] + (
        2 * prefill if dtype == "bfloat16" else 0)


def _mla_edges(h, lora, rope, page, qdt, pdt, window, tol):
    """Kernel 3 against its plain version on its body's edges, on the
    card: 40-slot tables over pools whose scratch page holds garbage
    (1e4 / -1e4): a slot whose live pages span every split, one shorter
    than one share, an empty slot, one ending mid-page; every table slot
    past a slot's length or slid out of ``window`` on the scratch page.
    Empty slots exactly 0."""
    dev = torch.device("cuda")
    b, n_slots = 4, 40
    npages = b * n_slots + 1
    trash = npages - 1
    rng = np.random.default_rng(19)

    def t(shape, dt):
        return torch.from_numpy(_rand(rng, shape)).to(dev).to(dt)
    ql, qr = t((b, h, lora), qdt), t((b, h, rope), qdt)
    cp, kr = t((npages, page, lora), torch.float32), t((npages, page, rope),
                                                       torch.float32)
    cp[trash], kr[trash] = 1e4, -1e4
    cp, kr = cp.to(pdt), kr.to(pdt)
    lens = [n_slots * page, min(3, page), 0, n_slots * page // 2 + 1]
    bt = rng.permutation(trash)[:b * n_slots].reshape(b, n_slots)
    for i, n in enumerate(lens):
        bt[i, -(-n // page):] = trash
        if window:
            bt[i, :max(0, n - window) // page] = trash
    args = (ql, qr, cp, kr, torch.from_numpy(bt.astype(np.int32)).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))
    kw = dict(scale=(lora + rope) ** -0.5, window=window)
    got = paged_mla_decode_attention(*args, **kw)
    exp = ref.paged_mla_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == qdt and bool(torch.isfinite(got).all())
    assert float((got.float() - exp.float()).abs().max()) < tol
    assert float(got[2].float().abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,pool_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("h,lora,rope,page", [
    (128, 512, 64, 16),   # DeepSeek-V2 at full width
    (4, 64, 16, 4),       # the smoke config, small pages
    (12, 32, 16, 32),     # 12 heads: one zero-padded block, long pages
    (128, 512, 64, 1),    # one-token pages
    (128, 512, 64, 64),   # pages of 64
    (4, 64, 16, 16),      # the smoke config at the served page size
])
def test_cuda_mla_kernel_matches_plain_version(q_dtype, pool_dtype, h, lora,
                                               rope, page):
    """On the card: the paged MLA decode kernel against its plain version
    on the same CUDA inputs (f32 queries against an f32 or bf16 pool, as
    the model calls it, and all-bf16): ragged lens across splits, a
    lens = 0 slot on the scratch page, window 0 and 5, and its body's
    edges (``_mla_edges``); bf16 pools run the tensor-core body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    tol = BF16_TOL if q_dtype == "bfloat16" else F32_TOL
    npages, nslots, b = 60, 20, 4
    trash, maxlen = npages - 1, nslots * page
    rng = np.random.default_rng(9)
    qdt, pdt = getattr(torch, q_dtype), getattr(torch, pool_dtype)

    def t(shape, dt):
        return torch.from_numpy(_rand(rng, shape)).to(dev).to(dt)
    ql, qr = t((b, h, lora), qdt), t((b, h, rope), qdt)
    cp, kr = t((npages, page, lora), pdt), t((npages, page, rope), pdt)
    bt = rng.integers(0, trash, (b, nslots)).astype(np.int32)
    bt[1] = trash
    bt = torch.from_numpy(bt).to(dev)
    lens = torch.tensor([1, 0, maxlen, maxlen // 2 + 3], dtype=torch.int32,
                        device=dev)
    before = (paged_mla_decode_attention.launches,
              paged_mla_decode_attention.tensor_core_launches)
    for window in (0, 5):
        args = (ql, qr, cp, kr, bt, lens)
        kw = dict(scale=(lora + rope) ** -0.5, window=window)
        got = paged_mla_decode_attention(*args, **kw)
        exp = ref.paged_mla_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        assert got.dtype == qdt
        assert float((got.float() - exp.float()).abs().max()) < tol
        assert float(got[1].float().abs().max()) == 0.0
        _mla_edges(h, lora, rope, page, qdt, pdt, window, tol)
    assert paged_mla_decode_attention.launches == before[0] + 4
    assert paged_mla_decode_attention.tensor_core_launches == before[1] + (
        4 if pool_dtype == "bfloat16" else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,hd,page,enc_len", [
    (8, 32, 8, 128, 16, 1600),   # Llama-3.2-Vision at full width
    (8, 6, 6, 64, 16, 1500),     # Whisper-tiny: partly filled last page
    (3, 4, 2, 32, 4, 13),        # the smoke shapes, ctx 13
    (4, 8, 8, 256, 16, 300),     # hd 256, rep 1
    (5, 24, 8, 64, 1, 200),      # rep 3, one-token pages
    (3, 16, 2, 128, 64, 1000),   # rep 8, pages of 64
])
def test_cuda_cross_kernel_matches_plain_version(dtype, b, h, kvh, hd, page,
                                                 enc_len):
    """On the card: the paged cross decode kernel against its plain
    version on the same CUDA inputs: every live slot at enc_len through
    its own cross table (its pages spanning every split), the last one
    shorter than one share, pad slots and an empty slot (enc_len 0) on a
    scratch page of garbage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    n_slots = -(-enc_len // page) + 1          # one pad slot past the end
    npages = b * n_slots + 1
    trash = npages - 1
    rng = np.random.default_rng(13)
    q = torch.from_numpy(_rand(rng, (b, h, hd))).to(dev).to(tdt)
    kp, vp = (torch.from_numpy(_rand(rng, (npages, page, kvh, hd)))
              .to(dev).to(tdt) for _ in range(2))
    kp[trash], vp[trash] = 1e4, -1e4
    bt = rng.permutation(trash)[:b * n_slots].reshape(b, n_slots)
    bt[:, -1] = trash
    bt[1] = trash
    bt = torch.from_numpy(bt.astype(np.int32)).to(dev)
    short = min(enc_len, page + 1)             # at most two pages
    bt[-1, -(-short // page):] = trash
    lens = torch.full((b,), enc_len, dtype=torch.int32, device=dev)
    lens[1], lens[-1] = 0, short
    before = paged_cross_decode_attention.launches
    got = paged_cross_decode_attention(q, kp, vp, bt, lens)
    exp = ref.paged_cross_decode_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert paged_cross_decode_attention.launches == before + 1
    assert got.dtype == tdt
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - exp.float()).abs().max()) < tol
    assert float((got.float() - exp.float()).abs().max()) <= _limit(exp)
    assert float(got[1].float().abs().max()) == 0.0


def _attendable(kv_len, q_off, sq, window, causal):
    """(segs, sq) bool: whether row (segment, query) has a key it may
    attend."""
    q_pos = np.asarray(q_off)[:, None] + np.arange(sq)[None, :]
    hi = np.asarray(kv_len)[:, None]
    if causal:
        hi = np.minimum(hi, q_pos + 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else 0
    return np.broadcast_to(lo < hi, q_pos.shape).copy()


def _limit(exp):
    """chip_smoke.py's limit: f32 summation order; bf16 a rounding or two
    of the largest plain output, at most 2e-2."""
    if exp.dtype == torch.bfloat16:
        return min(BF16_TOL, 2.0 ** -6 * float(exp.float().abs().max()))
    return F32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "segs,sq,h,kvh,hd,hd_v,page,kv_len,q_off,causal,window", [
        # one-token pages, rep 7 (63-row blocks), kv_len off the 64-key
        # tile, an empty segment
        (3, 40, 14, 2, 64, 64, 1, [100, 0, 70], [60, 0, 30], True, 0),
        # hd 32 (two k16 steps), 16 pages of 4 a tile, windowed pad rows
        (2, 17, 4, 1, 32, 32, 4, [67, 5], [50, 0], True, 5),
        # hd_v < hd on pages of 16, windowed, an empty segment
        (4, 64, 8, 2, 64, 32, 16, [200, 64, 0, 150], [136, 0, 0, 100],
         True, 37),
        # one page a tile, hd 128 with hd_v 64
        (2, 33, 8, 8, 128, 64, 64, [161, 33], [128, 0], True, 0),
        # non-causal, hd_v > hd
        (2, 100, 4, 4, 32, 128, 16, [77, 300], [0, 0], False, 0),
        # 128-row blocks at rep 7 (126 rows), the diagonal inside them
        (4, 512, 14, 2, 64, 64, 16, [1024, 512, 700, 0], [512, 0, 188, 0],
         True, 0),
        # Llama-3.2-Vision's served cross read: 512 queries over 1600 keys
        (1, 512, 32, 8, 128, 128, 16, [1600], [0], False, 0),
        # grids too small for the card: each block's keys in shares
        # (splits), walked by blocks of their own and combined; with a
        # window, an empty segment and windowed pad rows
        (1, 64, 4, 4, 64, 64, 16, [1000], [936], True, 300),
        (2, 64, 8, 2, 128, 128, 16, [700, 0], [636, 0], True, 0),
        (2, 100, 4, 4, 32, 32, 4, [900, 30], [800, 0], True, 16),
    ])
def test_cuda_prefill_tensor_core_edges(dtype, segs, sq, h, kvh, hd, hd_v,
                                        page, kv_len, q_off, causal, window):
    """On the card: kernel 1 against its plain version on the edges of
    its tensor-core body (bf16) and of its CUDA-core body (f32); rows
    without an attendable key exactly 0; dead table slots on a scratch
    page of garbage that must never be read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(40)
    n_slots = -(-max(max(kv_len), max(o + sq for o in q_off)) // page) + 1
    npages = segs * n_slots + 1
    trash = npages - 1
    q = torch.from_numpy(_rand(rng, (segs, sq, h, hd))).to(dev).to(tdt)
    kp = torch.from_numpy(_rand(rng, (npages, page, kvh, hd))).to(dev)
    vp = torch.from_numpy(_rand(rng, (npages, page, kvh, hd_v))).to(dev)
    kp[trash], vp[trash] = 1e4, -1e4
    kp, vp = kp.to(tdt), vp.to(tdt)
    bt = rng.permutation(trash)[:segs * n_slots].reshape(segs, n_slots)
    for i, n in enumerate(kv_len):
        bt[i, -(-n // page):] = trash
    args = (q, kp, vp, torch.from_numpy(bt.astype(np.int32)).to(dev),
            torch.tensor(kv_len, dtype=torch.int32, device=dev),
            torch.tensor(q_off, dtype=torch.int32, device=dev))
    before = (paged_prefill_attention.launches,
              paged_prefill_attention.tensor_core_launches)
    got = paged_prefill_attention(*args, window=window, causal=causal)
    exp = ref.paged_prefill_attention(*args, window=window, causal=causal)
    torch.cuda.synchronize()
    assert paged_prefill_attention.launches == before[0] + 1
    assert paged_prefill_attention.tensor_core_launches == before[1] + (
        dtype == "bfloat16")
    assert got.dtype == tdt and got.shape == (segs, sq, h, hd_v)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - exp.float()).abs().max()) <= _limit(exp)
    dead = ~torch.from_numpy(_attendable(kv_len, q_off, sq, window,
                                         causal)).to(dev)
    assert float(got[dead].float().abs().sum()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,q_off,kv_len,window,split", [
    # RecurrentGemma's local attention (16 query heads over 1 KV head
    # of 256): a chunk at 0, one past the window with a short request
    # and an empty one, and ragged kv_len off the 64-key tile
    (2, 64, 256, 0, [64, 10], 48, False),
    (3, 64, 320, 200, [264, 0, 230], 48, False),
    (2, 40, 200, 100, [140, 120], 0, False),
    # its served chunks, one request a call in a cache of 4,096 with the
    # 2,048-token window: a full 512-query chunk past the window and a
    # short last one, whose bf16 plans split the keys and merge shares
    (1, 512, 4096, 3584, [4096], 2048, True),
    (1, 300, 4096, 2048, [2348], 2048, True),
])
def test_cuda_prefill_wide_heads(dtype, b, sq, skv, q_off, kv_len, window,
                                 split):
    """On the card: kernel 5 (dense caches) and kernel 1 (the same K/V
    as one-token pages) at hd = hd_v = 256, rep 16, causal and windowed,
    against their plain versions; bf16 on the tensor-core body's
    one-warpgroup instantiation (its keys split in shares where
    ``split``), f32 on the CUDA-core body's halved tiles; rows without
    an attendable key exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention)
    from repro_torch.kernels.prefill_plan import prefill_plan, sm_count
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    h, kvh, hd = 16, 1, 256
    plan = prefill_plan(tdt, b, sq, h, kvh, hd, hd, 1, skv, sm_count(dev))
    assert (plan.splits > 1) == (split and dtype == "bfloat16")
    rng = np.random.default_rng(44)
    q = torch.from_numpy(_rand(rng, (b, sq, h, hd))).to(dev).to(tdt)
    k, v = (torch.from_numpy(_rand(rng, (b, skv, kvh, hd))).to(dev).to(tdt)
            for _ in range(2))
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    before = (chunked_prefill_attention.launches,
              chunked_prefill_attention.tensor_core_launches)
    got = chunked_prefill_attention(q, k, v, lens, q_off, window=window)
    exp = ref.chunked_prefill_attention(q, k, v, lens, q_off, window=window)
    # kernel 1 on the same keys: request i's cache as pages i * skv ..
    bt = torch.arange(b * skv, dtype=torch.int32, device=dev).reshape(b,
                                                                      skv)
    offs = torch.full((b,), q_off, dtype=torch.int32, device=dev)
    got1 = paged_prefill_attention(q, k.reshape(b * skv, 1, kvh, hd),
                                   v.reshape(b * skv, 1, kvh, hd), bt, lens,
                                   offs, window=window)
    torch.cuda.synchronize()
    assert (chunked_prefill_attention.launches,
            chunked_prefill_attention.tensor_core_launches) == (
        before[0] + 1, before[1] + (dtype == "bfloat16"))
    dead = ~torch.from_numpy(_attendable(kv_len, [q_off] * b, sq, window,
                                         True)).to(dev)
    for out in (got, got1):
        assert out.dtype == tdt and out.shape == (b, sq, h, hd)
        assert bool(torch.isfinite(out).all())
        assert float((out.float() - exp.float()).abs().max()) <= _limit(exp)
        assert float(out[dead].float().abs().sum()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,h,skv,q_off,kv_len,causal,split", [
    # DeepSeek-V2's dense MLA prefill (hd 192 = 128 nope + 64 RoPE, hd_v
    # 128, rep 1): one request's chunk of 512 at 512 over its 128 heads
    # (one block an SM, no split), and a 16-head slice whose bf16 plan
    # splits the keys; ragged kv_len with a 0 and garbage past it
    (1, 512, 128, 2048, 512, [1024], True, False),
    (3, 64, 16, 320, 200, [264, 0, 230], True, False),
    (1, 512, 16, 2048, 1536, [2048], True, True),
    # the dense cross read, non-causal: more queries than encoder keys
    # (sq > skv), at MLA's widths and at Llama-3.2-Vision's below
    (2, 300, 16, 200, 0, [200, 37], False, False),
])
def test_cuda_dense_prefill_mla_widths(dtype, b, sq, h, skv, q_off, kv_len,
                                       causal, split):
    """On the card: kernel 5 at hd 192 / hd_v 128 against its plain
    version, bf16 on the tensor-core body's (192, 128) instantiation
    (its keys split in shares where ``split``), f32 on the CUDA-core
    body; cache positions at or past kv_len hold garbage that must not
    be read; rows without an attendable key exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention)
    from repro_torch.kernels.prefill_plan import prefill_plan, sm_count
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    plan = prefill_plan(tdt, b, sq, h, h, 192, 128, 1, skv, sm_count(dev))
    assert (plan.splits > 1) == (split and dtype == "bfloat16")
    rng = np.random.default_rng(46)
    q = torch.from_numpy(_rand(rng, (b, sq, h, 192))).to(dev)
    k = torch.from_numpy(_rand(rng, (b, skv, h, 192))).to(dev)
    v = torch.from_numpy(_rand(rng, (b, skv, h, 128))).to(dev)
    for i, n in enumerate(kv_len):
        k[i, n:], v[i, n:] = 1e4, -1e4
    q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    before = (chunked_prefill_attention.launches,
              chunked_prefill_attention.tensor_core_launches)
    got = chunked_prefill_attention(q, k, v, lens, q_off, causal=causal)
    exp = ref.chunked_prefill_attention(q, k, v, lens, q_off, causal=causal)
    torch.cuda.synchronize()
    assert (chunked_prefill_attention.launches,
            chunked_prefill_attention.tensor_core_launches) == (
        before[0] + 1, before[1] + (dtype == "bfloat16"))
    assert got.dtype == tdt and got.shape == (b, sq, h, 128)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - exp.float()).abs().max()) <= _limit(exp)
    dead = ~torch.from_numpy(_attendable(kv_len, [q_off] * b, sq, 0,
                                         causal)).to(dev)
    assert float(got[dead].float().abs().sum()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq", [(1, 2000), (8, 1)])
def test_cuda_dense_cross_read_more_queries_than_keys(dtype, b, sq):
    """On the card: kernel 5 non-causal at Llama-3.2-Vision's cross
    read (32 query heads over 8 KV heads of 128, 1,600 encoder keys):
    a whole prompt of 2,000 tokens (sq > skv, as the coupled engine's
    prefill gives it) and a decode step of 8 slots; a causal call of
    the same shape is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention)
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(47)
    q = torch.from_numpy(_rand(rng, (b, sq, 32, 128))).to(dev).to(tdt)
    k, v = (torch.from_numpy(_rand(rng, (b, 1600, 8, 128))).to(dev).to(tdt)
            for _ in range(2))
    lens = torch.full((b,), 1600, dtype=torch.int32, device=dev)
    got = chunked_prefill_attention(q, k, v, lens, 0, causal=False)
    exp = ref.chunked_prefill_attention(q, k, v, lens, 0, causal=False)
    torch.cuda.synchronize()
    assert got.shape == (b, sq, 32, 128) and bool(torch.isfinite(got).all())
    assert float((got.float() - exp.float()).abs().max()) <= _limit(exp)
    if sq > 1600:
        with pytest.raises(ValueError, match="outside a cache"):
            chunked_prefill_attention(q, k, v, lens, 0)


@pytest.mark.gpu
def test_cuda_prefill_refuses_bf16_widths_without_a_body():
    """On the card: a bf16 call at a head width with no tensor-core
    instantiation raises, naming the width, and launches nothing; f32 at
    that width runs the CUDA-core body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention)
    dev = torch.device("cuda")
    q, kp, vp, bt, kv_len, q_off = (
        torch.from_numpy(x).to(dev)
        for x in _prefill_case(42, 2, 8, 4, 2, 48, 6, 16, 3))
    bf = [t.to(torch.bfloat16) for t in (q, kp, vp)]
    before = (paged_prefill_attention.launches,
              chunked_prefill_attention.launches)
    with pytest.raises(ValueError, match="hd=48"):
        paged_prefill_attention(*bf, bt, kv_len, q_off)
    with pytest.raises(ValueError, match="hd=48"):   # caches (2, 16, 2, 48)
        chunked_prefill_attention(bf[0], bf[1][:2], bf[2][:2], kv_len, 0)
    assert (paged_prefill_attention.launches,
            chunked_prefill_attention.launches) == before
    got = paged_prefill_attention(q, kp, vp, bt, kv_len, q_off)
    exp = ref.paged_prefill_attention(q, kp, vp, bt, kv_len, q_off)
    torch.cuda.synchronize()
    assert float((got - exp).abs().max()) < F32_TOL


@pytest.mark.gpu
def test_cuda_sample_tokens_matches_cpu():
    """On the card: ``model.sample_tokens`` gives the CPU's tokens for the
    same logits, temperatures, top-k and seeds (the integer hash and the
    float64 Gumbel draw are the same on both devices), at qwen2-0.5b's
    vocabulary, greedy and sampled lanes mixed, f32 and bf16 logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models.model import sample_tokens
    rng = np.random.default_rng(9)
    n, vocab = 64, 151936
    temps = torch.from_numpy(np.where(np.arange(n) % 4 == 0, 0.0,
                                      rng.uniform(0.3, 1.5, n))
                             .astype(np.float32))
    tks = torch.from_numpy(rng.choice([0, 1, 20, 50], n).astype(np.int32))
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.int64))
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.from_numpy(_rand(rng, (n, vocab)) * 3).to(dtype)
        cpu = sample_tokens(logits, temps, tks, seeds)
        dev = torch.device("cuda")
        got = sample_tokens(logits.to(dev), temps.to(dev), tks.to(dev),
                            seeds.to(dev))
        assert torch.equal(got.cpu(), cpu)
        assert torch.equal(cpu[::4], torch.argmax(logits[::4], dim=-1)
                           .to(torch.int32))


def _load_from_threads(names, n_threads=4):
    """``build.load`` of every library from ``n_threads`` threads at once,
    each in its own order; returns {name: the libraries the threads got}."""
    import threading

    from repro_torch.kernels import build
    got, errors = {n: [] for n in names}, []

    def worker(w):
        try:
            for n in names[w % len(names):] + names[:w % len(names)]:
                got[n].append(build.load(n))
        except Exception as e:       # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return got


def _count_compiles(monkeypatch, tmp_path, popen):
    """Point the build at an empty directory and count compiler starts."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    started = []

    def counting(cmd, *a, **kw):
        started.append(cmd[cmd.index("-o") + 1])
        return popen(cmd, *a, **kw)
    monkeypatch.setattr(build.subprocess, "Popen", counting)
    return started


def test_build_load_from_threads_compiles_each_library_once(monkeypatch,
                                                            tmp_path):
    """Four threads' first uses of ``build.load`` on an empty build
    directory start the compiler once per library (a stand-in compiler
    that writes its output after a pause, and a stand-in loader)."""
    import ctypes
    import time

    from repro_torch.kernels import build

    class FakeCompiler:
        def __init__(self, cmd, *a, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)
            with open(self.out, "w") as f:
                f.write("built")
            return "ptxas info: 0 bytes spill", None

    started = _count_compiles(monkeypatch, tmp_path, FakeCompiler)
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(ctypes, "CDLL", lambda path: ("lib", path))
    got = _load_from_threads(list(build.NAMES))
    assert len(started) == len(set(started)) == len(build.NAMES)
    for name, libs in got.items():
        assert len(libs) == 4 and len(set(libs)) == 1, name
        assert libs[0][1] == str(build.library_path(name))


@pytest.mark.gpu
def test_cuda_build_load_from_four_threads(monkeypatch, tmp_path):
    """On the card's machine: four threads' first uses of ``build.load``
    on an empty build directory compile each library once with nvcc, and
    every thread gets the same loaded library."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess

    from repro_torch.kernels import build
    started = _count_compiles(monkeypatch, tmp_path, subprocess.Popen)
    got = _load_from_threads(list(build.NAMES))
    assert len(started) == len(set(started)) == len(build.NAMES)
    for name, libs in got.items():
        assert len(libs) == 4 and len({id(lib) for lib in libs}) == 1, name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_on_two_streams_at_once(dtype):
    """On the card: kernel 2 launched from two threads, each on a stream
    of its own, with no synchronisation between them, at a shape whose
    plan splits each slot (the in-launch merge's counters and partial
    states in play): every output equals its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading

    from repro_torch.kernels.prefill_plan import sm_count
    tdt = getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    dev = torch.device("cuda")
    b, h, kvh, hd, page, nslots, npages = 2, 14, 2, 64, 16, 64, 160
    assert decode_plan(tdt, b, h, kvh, hd, hd, page, nslots,
                       sm_count(dev)).splits > 1
    cases = []
    for w in range(2):
        q, kp, vp, bt, lens = _decode_case(
            20 + w, b, h, kvh, hd, npages, page, nslots,
            lens=[nslots * page, nslots * page - 37])
        args = [torch.from_numpy(x).to(dev).to(tdt) for x in (q, kp, vp)]
        args += [torch.from_numpy(x).to(dev) for x in (bt, lens)]
        cases.append(args)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs, errors, reps = [[], []], [], 200
    barrier = threading.Barrier(2)

    def worker(w):
        try:
            with torch.cuda.stream(streams[w]):
                streams[w].wait_stream(torch.cuda.default_stream(dev))
                barrier.wait(timeout=60)
                for _ in range(reps):
                    outs[w].append(paged_decode_attention(*cases[w]))
        except Exception as e:       # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    torch.cuda.synchronize()
    for w in range(2):
        exp = ref.paged_decode_attention(*cases[w])
        worst = max(float((o.float() - exp.float()).abs().max())
                    for o in outs[w])
        assert len(outs[w]) == reps and worst < tol, (w, worst)
