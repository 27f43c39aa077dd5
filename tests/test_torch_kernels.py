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
from repro_torch.kernels.paged_cross_decode_attention import (
    paged_cross_decode_attention, slots_per_split)
from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention)
from repro_torch.kernels.paged_mla_decode_attention import (
    head_group, paged_mla_decode_attention)
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
    # Whisper's 8 x 6 x 94, fill 132 SMs at least twice over
    assert slots_per_split(8, 8, 100, 132) == 20
    assert slots_per_split(8, 6, 94, 132) == 16
    assert slots_per_split(1, 1, 3, 132) == 1


def test_mla_wrapper_refuses_unsupported_devices_and_shapes():
    q = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        paged_mla_decode_attention(q, q, q, q, q, q, scale=1.0)
    # full width: 16 heads of 512 + 64 latent columns per block (75 KB)
    assert head_group(128, 512, 64, 16) == 16
    with pytest.raises(ValueError):           # one page alone is too wide
        head_group(128, 512, 64, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh,hd,page", [
    (14, 2, 64, 16),      # qwen2-0.5b
    (4, 4, 32, 4),        # rep 1, small pages
    (4, 2, 128, 64),      # wide heads, one page per tile
    (32, 8, 128, 16),     # Llama-3.2-Vision self-attention: hd 128, rep 4
])
def test_cuda_kernels_match_plain_versions(dtype, h, kvh, hd, page):
    """On the card: each CUDA kernel against its plain version on the
    same CUDA inputs (ragged kv_len, pad rows, pad segments and slots on
    the scratch page, lens=0 slots, a windowed case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tdt = getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    dev = torch.device("cuda")
    npages, nslots = 40, 6
    trash, maxlen = npages - 1, nslots * page
    before = (paged_prefill_attention.launches,
              paged_decode_attention.launches)
    for window in (0, 5):
        sq = 24
        q_off = [0, maxlen - sq, 7, 0]
        kv_len = [sq, maxlen, 20, 0]        # segment 2 has pad rows
        q, kp, vp, bt, kv_len, q_off = _prefill_case(
            7, 4, sq, h, kvh, hd, npages, page, nslots, q_off=q_off,
            kv_len=kv_len)
        bt[3] = trash
        args = [torch.from_numpy(x).to(dev).to(tdt) for x in (q, kp, vp)]
        args += [torch.from_numpy(x).to(dev) for x in (bt, kv_len, q_off)]
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
    assert paged_prefill_attention.launches == before[0] + 2
    assert paged_decode_attention.launches == before[1] + 2


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,pool_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("h,lora,rope,page", [
    (128, 512, 64, 16),   # DeepSeek-V2 at full width
    (4, 64, 16, 4),       # the smoke config, small pages
    (12, 32, 16, 32),     # head groups of 4, long pages
])
def test_cuda_mla_kernel_matches_plain_version(q_dtype, pool_dtype, h, lora,
                                               rope, page):
    """On the card: the paged MLA decode kernel against its plain version
    on the same CUDA inputs (f32 queries against an f32 or bf16 pool, as
    the model calls it, and all-bf16): ragged lens across splits, a
    lens = 0 slot on the scratch page, window 0 and 5."""
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
    before = paged_mla_decode_attention.launches
    for window in (0, 5):
        args = (ql, qr, cp, kr, bt, lens)
        kw = dict(scale=(lora + rope) ** -0.5, window=window)
        got = paged_mla_decode_attention(*args, **kw)
        exp = ref.paged_mla_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        assert got.dtype == qdt
        assert float((got.float() - exp.float()).abs().max()) < tol
        assert float(got[1].float().abs().max()) == 0.0
    assert paged_mla_decode_attention.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,hd,page,enc_len", [
    (8, 32, 8, 128, 16, 1600),   # Llama-3.2-Vision at full width
    (8, 6, 6, 64, 16, 1500),     # Whisper-tiny: partly filled last page
    (3, 4, 2, 32, 4, 13),        # the smoke shapes, ctx 13
])
def test_cuda_cross_kernel_matches_plain_version(dtype, b, h, kvh, hd, page,
                                                 enc_len):
    """On the card: the paged cross decode kernel against its plain
    version on the same CUDA inputs: every live slot at enc_len through
    its own cross table, pad slots and an empty slot (enc_len 0) on a
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
    lens = torch.full((b,), enc_len, dtype=torch.int32, device=dev)
    lens[1] = 0
    before = paged_cross_decode_attention.launches
    got = paged_cross_decode_attention(q, kp, vp, bt, lens)
    exp = ref.paged_cross_decode_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert paged_cross_decode_attention.launches == before + 1
    assert got.dtype == tdt
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - exp.float()).abs().max()) < tol
    assert float(got[1].float().abs().max()) == 0.0
