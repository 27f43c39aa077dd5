"""The launch plan and the arithmetic of the paged MLA decode kernel
(kernel 3), held on the CPU: ``mla_plan.mla_plan`` (the body by dtype,
the head block, splits from the grid, threads, shared memory, the refused
shapes), the device's cut of a slot's live pages into shares
(``decode_plan.share_keys``) at the splits the plan gives, and a float
emulation of the tensor-core body's arithmetic against the plain version.
The kernel itself runs only on the card (``tests/test_torch_kernels.py``,
marked ``gpu``).
"""
import math

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro_torch.configs import get_smoke_config
from repro_torch.configs.deepseek_v2_236b import served
from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_plan import share_keys
from repro_torch.kernels.mla_plan import (LATENTS, MAX_SPLITS, TILE,
                                          mla_plan)
from repro_torch.kernels.prefill_plan import CUDA_CORE, TENSOR_CORE
from repro_torch.models.attention import mla_scale

H100_SMS = 132
F32_TOL = 2e-5              # the kernel's f32 output against the plain one
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("q_dtype,pool_dtype,body,terms,threads", [
    (F32, BF16, TENSOR_CORE, (3, 2), 256),   # the model's call: f32 queries
    (BF16, BF16, TENSOR_CORE, (1, 1), 256),  # bf16 queries: exact in bf16
    (F32, F32, CUDA_CORE, (1, 1), 128),      # f32 pools: the CUDA cores
    (BF16, F32, CUDA_CORE, (1, 1), 128),
])
def test_body_by_dtype(q_dtype, pool_dtype, body, terms, threads):
    plan = mla_plan(q_dtype, pool_dtype, 8, 128, 512, 64, 16, 128)
    assert plan.body == body
    assert (plan.q_terms, plan.p_terms) == terms
    assert plan.threads == threads and plan.heads == 16
    assert plan.head_blocks == 8


@pytest.mark.parametrize("b,h,n_slots,splits", [
    (8, 128, 128, 5),     # DeepSeek-V2's served batch: 64 (slot, heads)
    (8, 4, 128, 33),      # the smoke config: 8 pairs
    (8, 12, 20, 20),      # capped by the table's width
    (1, 4, 128, MAX_SPLITS),   # capped so the merge's weights fit
    (64, 128, 128, 1),    # the grid alone fills the card
    (3, 128, 128, 11),
])
def test_splits_from_the_grid_alone(b, h, n_slots, splits):
    """Slots x head blocks x splits reach at least 2 blocks an SM, at
    most the table's width and MAX_SPLITS; lengths play no part."""
    plan = mla_plan(F32, BF16, b, h, 512, 64, 16, n_slots, H100_SMS)
    assert plan.splits == splits
    pairs = b * plan.head_blocks
    if splits < min(n_slots, MAX_SPLITS):
        assert pairs * splits >= 2 * H100_SMS
        assert pairs * (splits - 1) < 2 * H100_SMS or splits == 1


@pytest.mark.parametrize("lora,rope", LATENTS)
@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (F32, BF16), (BF16, BF16), (F32, F32), (BF16, F32)])
def test_shared_memory_fits_every_instantiation(lora, rope, q_dtype,
                                                pool_dtype):
    """Every instantiation fits a block; the tensor-core one fits twice
    an SM (its registers are cut for 2 blocks), with the 1 KB the
    runtime keeps a block and its static bytes."""
    plan = mla_plan(q_dtype, pool_dtype, 8, 128, lora, rope, 16, 128)
    assert plan.smem <= build.MAX_SMEM
    if plan.body == TENSOR_CORE:
        assert 2 * (plan.smem + 1024 + 16) <= 233_472
    # the ring holds the merge's weights of MAX_SPLITS shares
    row = 16 * (((lora + rope) * pool_dtype.itemsize // 16) | 1)
    assert plan.stages * TILE * row >= MAX_SPLITS * plan.heads * 4


@pytest.mark.parametrize("lora,rope", [(128, 64), (512, 32), (256, 64),
                                       (48, 16)])
@pytest.mark.parametrize("pool_dtype", [BF16, F32])
def test_uninstantiated_latents_raise(lora, rope, pool_dtype):
    with pytest.raises(ValueError, match=f"lora={lora}, rope={rope}"):
        mla_plan(F32, pool_dtype, 8, 128, lora, rope, 16, 128)


def test_unsupported_dtypes_and_sizes_raise():
    with pytest.raises(TypeError):
        mla_plan(torch.float16, BF16, 8, 128, 512, 64, 16, 128)
    with pytest.raises(TypeError):
        mla_plan(F32, torch.float16, 8, 128, 512, 64, 16, 128)
    with pytest.raises(ValueError):
        mla_plan(F32, BF16, 0, 128, 512, 64, 16, 128)


def test_wrapper_counts_nothing_on_cpu_tensors():
    from repro_torch.kernels.paged_mla_decode_attention import (
        paged_mla_decode_attention)
    before = (paged_mla_decode_attention.launches,
              paged_mla_decode_attention.tensor_core_launches)
    q = torch.zeros(2, 4, 64)
    out = paged_mla_decode_attention(
        q, torch.zeros(2, 4, 16), torch.zeros(5, 4, 64),
        torch.zeros(5, 4, 16), torch.zeros(2, 3, dtype=torch.int32),
        torch.tensor([0, 5], dtype=torch.int32), scale=0.1)
    assert out.shape == (2, 4, 64) and float(out[0].abs().max()) == 0.0
    assert (paged_mla_decode_attention.launches,
            paged_mla_decode_attention.tensor_core_launches) == before


def _live_pages(length, window, page, n_slots):
    lo = max(0, length - window) if window else 0
    hi = min(length, n_slots * page)
    return set(range(lo // page, -(-hi // page))) if hi > lo else set()


@settings(max_examples=200, deadline=None)
@given(lens=st.lists(st.integers(0, 2048), min_size=1, max_size=8),
       window=st.sampled_from([0, 1, 200, 1000]),
       page=st.sampled_from([1, 4, 16, 64]),
       h=st.sampled_from([4, 12, 128]))
def test_shares_at_the_plans_splits_cover_each_slot(lens, window, page, h):
    """At the splits the plan gives a batch, every slot's shares read
    exactly its live pages, each once, and together hold exactly the
    keys the masks admit; the live shares are numbered densely, so the
    merge finds its records."""
    n_slots = -(-2048 // page)
    splits = mla_plan(F32, BF16, len(lens), h, 512, 64, page,
                      n_slots).splits
    for length in lens:
        keys, pages, ranks = [], [], []
        for s in range(splits):
            begin, end, rank, active = share_keys(length, window, page,
                                                  n_slots, s, splits)
            if end <= begin:
                continue
            keys += range(begin, end)
            pages += range(begin // page, -(-end // page))
            ranks.append(rank)
        lo = max(0, length - window) if window else 0
        assert keys == list(range(lo, min(length, n_slots * page)))
        assert len(set(pages)) == len(pages)
        assert set(pages) == _live_pages(length, window, page, n_slots)
        assert ranks == list(range(len(ranks)))
        assert active == len(ranks)


def _bf16_terms(x, n):
    """x (f32) as n bf16-valued f32 terms, each the bf16 rounding of what
    the earlier ones leave (the body's split of a query value or a
    softmax weight)."""
    terms = []
    for _ in range(n):
        t = x.to(BF16).float()
        terms.append(t)
        x = x - t
    return terms


def _emulate(q_lat, q_rope, ckv_pool, kr_pool, bt, lens, scale, window,
             splits):
    """The tensor-core body's arithmetic in f32 on the CPU: each (slot,
    split) with a live share walks its keys a tile of TILE at a time:
    scores as f32 sums of exact bf16 products (three query terms), the
    online softmax in log2 units, PV with the weights as two bf16 terms;
    then one share's state is normalised, or the live shares merged as
    the last block does.  The pools hold bf16 values."""
    b, h, lora = q_lat.shape
    page, n_slots = ckv_pool.shape[1], bt.shape[1]
    qt = _bf16_terms(torch.cat([q_lat, q_rope], -1), 3)
    sl2 = scale * math.log2(math.e)
    out = torch.zeros(b, h, lora)
    for i in range(b):
        parts = []
        for s in range(splits):
            begin, end, _, _ = share_keys(int(lens[i]), window, page,
                                          n_slots, s, splits)
            if end <= begin:
                continue
            m = torch.full((h,), ref.NEG_INF)
            l = torch.zeros(h)
            acc = torch.zeros(h, lora)
            for k0 in range(begin, end, TILE):
                ks = torch.arange(k0, min(k0 + TILE, end))
                rows = bt[i, ks // page].long() * page + ks % page
                kt = torch.cat([ckv_pool.reshape(-1, lora)[rows],
                                kr_pool.reshape(-1, kr_pool.shape[2])[rows]],
                               -1)
                sc = sum(t[i] @ kt.T for t in qt) * sl2
                mx = torch.maximum(m, sc.max(1).values)
                corr = torch.exp2(m - mx)
                p = torch.exp2(sc - mx[:, None])
                l = l * corr + p.sum(1)
                v = kt[:, :lora]
                acc = acc * corr[:, None] + sum(pt @ v
                                                for pt in _bf16_terms(p, 2))
                m = mx
            parts.append((m, l, acc))
        if len(parts) == 1:
            m, l, acc = parts[0]
            out[i] = acc / torch.clamp(l, min=1e-20)[:, None]
        elif parts:
            mm = torch.stack([pm for pm, _, _ in parts]).max(0).values
            w = [torch.exp2(pm - mm) for pm, _, _ in parts]
            lt = sum(wi * pl for wi, (_, pl, _) in zip(w, parts))
            out[i] = sum((wi / torch.clamp(lt, min=1e-20))[:, None] * pa
                         for wi, (_, _, pa) in zip(w, parts))
    return out


def _case(cfg, lens, n_slots, seed):
    """f32 queries and bf16-valued latent pools with a scratch page of
    garbage (index n_pages): slots in random pages, every table slot
    past a slot's length on the scratch page."""
    rng = np.random.default_rng(seed)
    b, h, m = len(lens), cfg.n_heads, cfg.mla
    page = 16
    n_pages = b * n_slots
    q_lat = torch.from_numpy(rng.standard_normal(
        (b, h, m.kv_lora_rank)).astype(np.float32))
    q_rope = torch.from_numpy(rng.standard_normal(
        (b, h, m.qk_rope_head_dim)).astype(np.float32))
    pools = [torch.from_numpy(rng.standard_normal(
        (n_pages + 1, page, w)).astype(np.float32)).to(BF16).float()
        for w in (m.kv_lora_rank, m.qk_rope_head_dim)]
    pools[0][n_pages], pools[1][n_pages] = 1e4, -1e4
    bt = rng.permutation(n_pages)[:b * n_slots].reshape(b, n_slots)
    for i, n in enumerate(lens):
        bt[i, -(-n // page):] = n_pages
    return (q_lat, q_rope, *pools, torch.from_numpy(bt.astype(np.int32)),
            torch.tensor(lens, dtype=torch.int32))


@pytest.mark.parametrize("window", [0, 200])
@pytest.mark.parametrize("shape", ["served", "smoke"])
def test_emulated_body_matches_plain_version(shape, window):
    """At DeepSeek-V2's served decode batch (128 heads, lora 512, the
    8 slots mid-run, one empty) and the smoke config's widths, the
    body's split-precision arithmetic, splits and merge stay within half
    the f32 limit of the plain version; empty slots give zeros."""
    if shape == "served":
        cfg, n_slots = served(), 128
        lens = [1332, 1018, 832, 477, 533, 140, 190, 0]
    else:
        cfg, n_slots = get_smoke_config("deepseek_v2_236b"), 20
        lens = [1, 0, 300, 171, 64, 240, 17, 320]
    args = _case(cfg, lens, n_slots, seed=5)
    scale = mla_scale(cfg)
    splits = mla_plan(F32, BF16, len(lens), cfg.n_heads,
                      cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim, 16,
                      n_slots).splits
    got = _emulate(*args, scale, window, splits)
    exp = ref.paged_mla_decode_attention(*args, scale=scale, window=window)
    err = float((got - exp).abs().max())
    assert err <= 0.5 * F32_TOL, err
    empty = torch.tensor(lens) == 0
    assert float(got[empty].abs().sum()) == 0.0
