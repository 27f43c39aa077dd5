"""The launch plan of the paged decode kernels (kernels 2 and 4), held on
the CPU: ``decode_plan.decode_plan`` (splits, ring, threads, shared
memory, the refused shapes) and ``decode_plan.share_keys``, the mirror of
the device's cut of a slot's live pages into shares.  The kernels
themselves run only on the card (``tests/test_torch_kernels.py``, marked
``gpu``).
"""
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_plan import (MAX_REP, STAGE_BYTES, STAGES,
                                             WIDTHS, decode_plan,
                                             share_keys)

H100_SMS = 132


def _live_pages(length, window, page, n_slots):
    """Pages holding a key the slot's query may attend: [max(0, length -
    window), length), within the table's width."""
    lo = max(0, length - window) if window else 0
    hi = min(length, n_slots * page)
    return set(range(lo // page, -(-hi // page))) if hi > lo else set()


@settings(max_examples=300, deadline=None)
@given(length=st.integers(0, 3000), window=st.integers(0, 600),
       page=st.sampled_from([1, 2, 4, 16, 64]),
       n_slots=st.integers(1, 200), splits=st.integers(1, 40))
def test_shares_cover_every_live_page_once(length, window, page, n_slots,
                                           splits):
    """The shares of a slot cover every live page exactly once and no
    dead page; together their keys are exactly the keys the masks admit,
    in order, each share a run of whole pages (cut only by the window
    and the length)."""
    seen, keys, ranks = [], [], []
    for s in range(splits):
        begin, end, rank, active = share_keys(length, window, page, n_slots,
                                              s, splits)
        if end <= begin:
            continue
        seen += range(begin // page, -(-end // page))
        keys += range(begin, end)
        ranks.append(rank)
        assert begin % page == 0 or begin == length - window
        assert end % page == 0 or end == length
    # the live shares are numbered 0, 1, ... in order: the combine's
    # records
    assert ranks == list(range(len(ranks))) and active == len(ranks)
    assert sorted(seen) == seen and len(set(seen)) == len(seen)
    assert set(seen) == _live_pages(length, window, page, n_slots)
    lo = max(0, length - window) if window else 0
    assert keys == list(range(lo, min(length, n_slots * page)))


@pytest.mark.parametrize("length,window,page,n_slots,splits,sizes", [
    (1600, 0, 16, 100, 5, [20] * 5),          # Llama cross: even shares
    (1500, 0, 16, 94, 6, [15, 16, 16, 15, 16, 16]),   # Whisper cross
    (104, 0, 16, 128, 17, [0] * 10 + [1] * 7),  # shorter than one share
    (1332, 0, 16, 128, 17, [4] + [5] * 16),     # every share live
    (1000, 200, 16, 128, 4, [3, 3, 3, 4]),    # slid-out pages: none read
])
def test_share_sizes_in_pages(length, window, page, n_slots, splits, sizes):
    got = []
    for s in range(splits):
        begin, end, _, _ = share_keys(length, window, page, n_slots, s,
                                      splits)
        got.append(-(-end // page) - begin // page if end > begin else 0)
    assert sorted(got) == sorted(sizes)
    assert sum(got) == len(_live_pages(length, window, page, n_slots))


# served decode shapes: (b, h, kvh, hd, page, n_slots) -> splits
SERVED = [
    ((8, 14, 2, 64, 16, 128), 24),   # qwen2-0.5b self: 16 (slot, g) pairs
    ((8, 32, 8, 128, 16, 128), 6),   # Llama-3.2-Vision self
    ((8, 32, 8, 128, 16, 100), 6),   # Llama-3.2-Vision cross: 1600 keys
    ((8, 6, 6, 64, 16, 128), 8),     # Whisper-tiny self
    ((8, 6, 6, 64, 16, 94), 8),      # Whisper-tiny cross: 1500 keys
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,splits", SERVED)
def test_splits_fill_the_card_at_served_shapes(dtype, shape, splits):
    """At least 2 blocks an SM, and the most that fit on the card at once
    (3 blocks of 64 KB an SM)."""
    b, h, kvh, hd, page, n_slots = shape
    plan = decode_plan(dtype, b, h, kvh, hd, hd, page, n_slots, H100_SMS)
    assert plan.splits == splits
    assert b * kvh * plan.splits >= 2 * H100_SMS
    assert b * kvh * plan.splits <= 3 * H100_SMS
    assert b * kvh * (plan.splits + 1) > 3 * H100_SMS
    # an SM's shared memory: the rings, the flag and the 1 KB the runtime
    # keeps a block
    assert 3 * (plan.smem + 4 + 1024) <= 233_472


@pytest.mark.parametrize("b,kvh,n_slots,splits", [
    (1, 1, 3, 3),            # capped by the table's width
    (64, 8, 128, 1),         # the grid alone fills the card
    (33, 4, 128, 3),         # 396 blocks: three an SM
    (100, 2, 128, 2),        # 400: two an SM at the least
])
def test_splits_from_the_grid_alone(b, kvh, n_slots, splits):
    plan = decode_plan(torch.bfloat16, b, 4 * kvh, kvh, 64, 64, 16, n_slots,
                       H100_SMS)
    assert plan.splits == splits


@pytest.mark.parametrize("hd,hd_v,h,kvh", [
    (48, 48, 8, 2),          # no such width
    (512, 512, 8, 8),
    (64, 32, 8, 2),          # hd_v apart from hd
    (64, 64, 9, 1),          # rep 9
    (128, 128, 32, 2),       # rep 16
    (64, 64, 6, 4),          # h not a multiple of kvh
])
def test_uninstantiated_shapes_raise(hd, hd_v, h, kvh):
    with pytest.raises(ValueError, match=f"hd={hd}, hd_v={hd_v}"):
        decode_plan(torch.bfloat16, 8, h, kvh, hd, hd_v, 16, 64)


def test_unsupported_dtype_raises():
    with pytest.raises(TypeError):
        decode_plan(torch.float16, 8, 8, 2, 64, 64, 16, 64)


@pytest.mark.parametrize("dtype,size", [(torch.float32, 4),
                                        (torch.bfloat16, 2)])
@pytest.mark.parametrize("hd", WIDTHS)
@pytest.mark.parametrize("rep", range(1, MAX_REP + 1))
def test_shared_memory_fits_every_instantiation(dtype, size, hd, rep):
    """Every instantiation's ring fits a block, a tile fills its stage
    exactly (``Geometry`` in decode_attention.cuh), and a warp's merge
    record (m, l and rep rows of sums, f32) fits in its own ring."""
    plan = decode_plan(dtype, 8, 2 * rep, 2, hd, hd, 16, 64)
    assert plan.smem <= build.MAX_SMEM
    assert plan.smem == 4 * STAGES * STAGE_BYTES and plan.threads == 128
    vec = 16 // size
    lanes = min(hd // vec, 32)                      # lanes a key
    rounds = 4 // (hd // vec // lanes)
    assert plan.tile == rounds * (32 // lanes)
    assert plan.tile * 2 * hd * size == STAGE_BYTES
    assert 4 * rep * (hd + 2) <= STAGES * STAGE_BYTES


def _emulate(q, k_pool, v_pool, bt, lens, window, splits):
    """The decode body's arithmetic in float64 numpy: each (slot, KV
    head, split) with a live share walks its keys into a partial (m, l,
    sums) in log2 units, and the live splits combine as the last block
    does; a slot without keys gives zeros."""
    b, h, hd = q.shape
    _, page, kvh, _ = k_pool.shape
    rep, n_slots = h // kvh, bt.shape[1]
    out = np.zeros((b, h, hd))
    for i in range(b):
        for g in range(kvh):
            parts = []
            for s in range(splits):
                begin, end, _, _ = share_keys(int(lens[i]), window, page,
                                              n_slots, s, splits)
                if end <= begin:            # an empty share: no record
                    continue
                ks = np.arange(begin, end)
                rows = bt[i, ks // page] * page + ks % page
                kk = k_pool.reshape(-1, kvh, hd)[rows, g]
                vv = v_pool.reshape(-1, kvh, hd)[rows, g]
                sc = q[i, g * rep:(g + 1) * rep] @ kk.T * hd ** -0.5
                sc = sc * np.log2(np.e)
                m = sc.max(1)
                p = np.exp2(sc - m[:, None])
                parts.append((m, p.sum(1), p @ vv))
            if not parts:                   # a slot without keys
                continue
            m = np.max([pm for pm, _, _ in parts], axis=0)
            w = [np.exp2(pm - m) for pm, _, _ in parts]
            lsum = sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
            acc = sum(wi[:, None] * pa for wi, (_, _, pa) in zip(w, parts))
            out[i, g * rep:(g + 1) * rep] = acc / lsum[:, None]
    return out


@pytest.mark.parametrize("window", [0, 7, 40])
@pytest.mark.parametrize("splits", [1, 3, 17])
def test_split_combine_matches_plain_version(window, splits):
    """The body's split rule and combine, emulated, give the plain
    version's output: ragged lens, an empty slot, pages of 4, slid-out
    table slots on a scratch page of garbage."""
    rng = np.random.default_rng(3)
    b, h, kvh, hd, page, n_slots, n_pages = 4, 8, 2, 32, 4, 12, 50
    q = rng.standard_normal((b, h, hd))
    kp = rng.standard_normal((n_pages, page, kvh, hd))
    vp = rng.standard_normal((n_pages, page, kvh, hd))
    kp[-1], vp[-1] = 1e4, -1e4
    bt = rng.permutation(n_pages - 1)[:b * n_slots].reshape(b, n_slots)
    lens = np.array([45, 0, 13, 48])
    for i, n in enumerate(lens):
        bt[i, -(-n // page):] = n_pages - 1
        if window:
            bt[i, :max(0, n - window) // page] = n_pages - 1
    got = _emulate(q, kp, vp, bt, lens, window, splits)
    t = [torch.from_numpy(x) for x in (q, kp, vp)]
    exp = ref.paged_decode_attention(
        *t, torch.from_numpy(bt.astype(np.int32)),
        torch.from_numpy(lens.astype(np.int32)), window=window).numpy()
    assert np.abs(got - exp).max() < 1e-6      # the plain version's f32
    assert np.abs(got[1]).max() == 0.0
