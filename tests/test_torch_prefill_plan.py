"""The launch plan of the prefill-attention kernels (kernels 1 and 5):
which device body a call runs, how many query rows a block takes, and
its shared memory, held on the CPU (``prefill_plan.prefill_plan`` is
pure Python; the kernels themselves run only on the card).
"""
import hashlib
import itertools

import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention)
from repro_torch.kernels.prefill_plan import (CUDA_CORE, TC_WIDE,
                                              TC_WIDTHS, TENSOR_CORE,
                                              key_splits, prefill_plan,
                                              tc_smem)


@pytest.mark.parametrize("dtype,body", [
    (torch.float32, CUDA_CORE), ("torch.float32", CUDA_CORE),
    (torch.bfloat16, TENSOR_CORE), ("torch.bfloat16", TENSOR_CORE)])
def test_body_follows_the_dtype(dtype, body):
    plan = prefill_plan(dtype, 1, 512, 14, 2, 64, 64, 16, 2048)
    assert plan.body == body


# served shapes: (segs, sq, h, kvh, hd, hd_v, page, n_keys) -> (block_q,
# rows, threads, stages, splits) of the bf16 plan on an H100's 132 SMs;
# threads: 4 consumer warps a 64 rows, then the copy warp
SERVED = [
    # qwen2-0.5b, a single-segment chunk over a 2,048-token table:
    # 128-row blocks would leave 58 blocks, so 63-row ones (114 blocks),
    # their keys in 3 shares
    ((1, 512, 14, 2, 64, 64, 16, 2048), (9, 63, 160, 3, 3)),
    # qwen2-0.5b, four segments of a chunk: 232 blocks of 126 rows
    ((4, 512, 14, 2, 64, 64, 16, 2048), (18, 126, 288, 3, 1)),
    # Llama-3.2-Vision, a causal chunk or the cross read of 1,600
    # encoder keys at rep 4: 128 blocks of 32 positions
    ((1, 512, 32, 8, 128, 128, 16, 2048), (32, 128, 288, 2, 1)),
    ((1, 512, 32, 8, 128, 128, 16, 1600), (32, 128, 288, 2, 1)),
    # Whisper-tiny's cross read (1,500 keys, rep 1): a chunk of 4
    # segments of 256 in 96 blocks, and one segment of 256 in 24, its
    # 24 key tiles in 6 shares
    ((4, 256, 6, 6, 64, 64, 16, 1504), (64, 64, 160, 3, 3)),
    ((1, 256, 6, 6, 64, 64, 16, 1504), (64, 64, 160, 3, 6)),
    # kernel 5 in phase 2d: 8 requests of 512 queries in caches of 2048
    # at qwen2's widths and Llama-3.2-Vision's
    ((8, 512, 14, 2, 64, 64, 1, 2048), (18, 126, 288, 3, 1)),
    ((8, 512, 32, 8, 128, 128, 1, 2048), (32, 128, 288, 2, 1)),
]


@pytest.mark.parametrize("shape,expect", SERVED)
def test_rows_a_block_at_served_shapes(shape, expect):
    plan = prefill_plan(torch.bfloat16, *shape)
    assert (plan.block_q, plan.rows, plan.threads, plan.stages,
            plan.splits) == expect
    assert plan.smem == tc_smem(plan.threads // 32 - 1, shape[4], shape[5])
    assert plan.smem <= build.MAX_SMEM


@pytest.mark.parametrize("blocks,warps,n_keys,splits", [
    (132, 8, 2048, 1),         # a block an SM already
    (116, 8, 2048, 1),         # 7/8 of the SMs is enough
    (60, 8, 2048, 3),          # ceil(132 / 60)
    (24, 4, 1504, 6),          # 264 wanted, 24 tiles in shares of 4
    (24, 4, 100, 1),           # 2 tiles: nothing to split
    (1, 4, 1 << 20, 264),      # one block, a long cache
])
def test_key_splits(blocks, warps, n_keys, splits):
    assert key_splits(blocks, warps, n_keys, 132) == splits


@pytest.mark.parametrize("shape", [s for s, _ in SERVED])
def test_f32_keeps_the_cuda_core_blocks(shape):
    """f32 runs the CUDA-core body with its 64-row blocks and its
    shared memory (``build.attend_smem``), whatever the grid."""
    segs, sq, h, kvh, hd, hd_v, page, n_keys = shape
    plan = prefill_plan(torch.float32, *shape)
    rep = h // kvh
    assert (plan.block_q, plan.rows, plan.threads) == (
        64 // rep, 64 // rep * rep, 256)
    assert plan.tile_pages == max(1, 64 // page)
    assert plan.smem == build.attend_smem(plan.rows, hd, hd_v,
                                          plan.tile_pages, page)
    assert plan.smem <= build.MAX_SMEM and plan.splits == 1


@pytest.mark.parametrize("hd", TC_WIDTHS)
@pytest.mark.parametrize("hd_v", TC_WIDTHS)
def test_tensor_core_smem_fits_every_instantiation(hd, hd_v):
    """Every instantiated width pair, from one head a KV head to 128,
    in small and large grids, fits one block's shared memory; a 64-row
    block leaves room for a second on the SM (228 KB)."""
    for rep in (1, 4, 7, 16, 128):
        for segs in (1, 64):
            plan = prefill_plan(torch.bfloat16, segs, 512, rep, 1, hd,
                                hd_v, 16, 2048)
            assert plan.threads <= 288 and plan.rows <= 128
            assert plan.threads == 32 * (4 * -(-plan.rows // 64) + 1)
            assert plan.smem <= build.MAX_SMEM
            if plan.threads <= 160:
                assert 2 * (plan.smem + 1024) <= 233_472


@pytest.mark.parametrize("hd,hd_v", [(48, 48), (80, 80), (256, 128),
                                     (64, 96), (16, 64)])
def test_bf16_without_an_instantiation_raises(hd, hd_v):
    bad = hd if hd not in TC_WIDTHS else hd_v
    with pytest.raises(ValueError, match=f"={bad}"):
        prefill_plan(torch.bfloat16, 1, 64, 4, 2, hd, hd_v, 16, 64)
    # f32 at the same width runs the CUDA-core body where it fits
    if hd <= 128 and hd_v <= 128:
        assert prefill_plan(torch.float32, 1, 64, 4, 2, hd, hd_v, 16,
                            64).body == CUDA_CORE


def test_plan_refuses_what_no_body_takes():
    with pytest.raises(ValueError):            # more heads than 128 rows
        prefill_plan(torch.bfloat16, 1, 64, 256, 1, 64, 64, 16, 64)
    with pytest.raises(TypeError):
        prefill_plan(torch.float16, 1, 64, 4, 2, 64, 64, 16, 64)


def test_cpu_tensors_count_no_launch():
    """On CPU tensors both wrappers run their plain versions: neither
    counter moves, in bf16 as in f32, at any head width."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 4, 48, generator=gen).to(torch.bfloat16)
    kp = torch.randn(6, 16, 2, 48, generator=gen).to(torch.bfloat16)
    bt = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    kv_len = torch.tensor([40, 8], dtype=torch.int32)
    q_off = torch.tensor([32, 0], dtype=torch.int32)
    before = (paged_prefill_attention.launches,
              paged_prefill_attention.tensor_core_launches,
              chunked_prefill_attention.launches,
              chunked_prefill_attention.tensor_core_launches)
    out = ops.prefill_attention(q, kp, kp, kv_len, q_off, block_table=bt)
    torch.testing.assert_close(out, ref.paged_prefill_attention(
        q, kp, kp, bt, kv_len, q_off), rtol=0, atol=0)
    ops.prefill_attention(q, kp[:2], kp[:2], kv_len, [0])
    assert (paged_prefill_attention.launches,
            paged_prefill_attention.tensor_core_launches,
            chunked_prefill_attention.launches,
            chunked_prefill_attention.tensor_core_launches) == before


# served shapes of kernel 5 on the dense backend, as SERVED: RecurrentGemma's
# local attention (16 query heads over 1 KV head of 256) in 512-query
# chunks of caches of 4,096, and the coupled OPT-13B's whole prompts
# (40 / 40 heads of 128, up to 2,000 queries in caches of 2,048)
SERVED_DENSE = [
    # hd 256: 64-row blocks (4 positions x rep 16) of one warpgroup, two
    # stages; 128 blocks leave SMs idle, so 3 key shares
    ((1, 512, 16, 1, 256, 256, 1, 4096), (4, 64, 160, 2, 3)),
    # two requests' chunks at once: 256 blocks, no split
    ((2, 512, 16, 1, 256, 256, 1, 4096), (4, 64, 160, 2, 1)),
    # OPT-13B, one whole prompt of 2,000 at rep 1: 640 blocks of 128
    ((1, 2000, 40, 40, 128, 128, 1, 2048), (128, 128, 288, 2, 1)),
    # and a short one of 64: 40 blocks of 64 rows, the cache's 32 tiles
    # in 7 shares (those past the diagonal walk no key)
    ((1, 64, 40, 40, 128, 128, 1, 2048), (64, 64, 160, 2, 7)),
]


@pytest.mark.parametrize("shape,expect", SERVED_DENSE)
def test_rows_a_block_at_dense_served_shapes(shape, expect):
    plan = prefill_plan(torch.bfloat16, *shape)
    assert plan.body == TENSOR_CORE
    assert (plan.block_q, plan.rows, plan.threads, plan.stages,
            plan.splits) == expect
    assert plan.smem == tc_smem(plan.threads // 32 - 1, shape[4], shape[5])
    assert plan.smem <= build.MAX_SMEM


@pytest.mark.parametrize("rep", [1, 4, 16, 64])
@pytest.mark.parametrize("segs", [1, 64])
def test_wide_instantiation_keeps_one_warpgroup(rep, segs):
    """hd = hd_v = 256 blocks keep one consumer warpgroup of at most 64
    rows (160 threads, so a thread may hold 255 registers) and two
    stages: the Q rows (33 KB) and 2 x 64 keys x 512 bf16 (128 KB) in
    165,920 bytes."""
    plan = prefill_plan(torch.bfloat16, segs, 512, rep, 1, TC_WIDE,
                        TC_WIDE, 1, 4096)
    assert plan.body == TENSOR_CORE
    assert plan.threads == 160 and plan.rows <= 64
    assert plan.block_q == max(1, 64 // rep) and plan.stages == 2
    assert plan.smem == tc_smem(4, 256, 256) == 165_920
    assert plan.smem <= build.MAX_SMEM


def test_wide_instantiation_refuses_more_than_64_rows_a_head():
    with pytest.raises(ValueError, match="64 rows"):
        prefill_plan(torch.bfloat16, 1, 64, 128, 1, 256, 256, 1, 64)


@pytest.mark.parametrize("page,tile_pages", [(1, 32), (4, 8), (16, 2)])
@pytest.mark.parametrize("rep", [1, 16])
def test_f32_tile_halves_until_it_fits(page, tile_pages, rep):
    """The CUDA-core body at hd 256: 64 rows and a 64-token tile need
    280,320 bytes; the tile halves (32 tokens) until the block fits.
    Widths that already fit keep their 64-token tile."""
    plan = prefill_plan(torch.float32, 1, 512, rep, 1, 256, 256, page,
                        4096)
    assert plan.body == CUDA_CORE and plan.rows == 64
    assert build.attend_smem(64, 256, 256, max(1, 64 // page),
                             page) > build.MAX_SMEM
    assert plan.tile_pages == tile_pages
    assert plan.smem == build.attend_smem(64, 256, 256, tile_pages, page)
    assert plan.smem <= build.MAX_SMEM
    assert prefill_plan(torch.float32, 1, 512, rep, 1, 128, 128, page,
                        4096).tile_pages == max(1, 64 // page)


# DeepSeek-V2's dense MLA prefill: its 128 heads decompressed to K of
# 192 (128 nope + 64 RoPE) and V of 128, rep 1
SERVED_MLA = [
    # one request's chunk of 512 (as the engine gives it) or four at
    # once: 512 or 2,048 blocks of 128 rows, no split
    ((1, 512, 128, 128, 192, 128, 1, 2048), (128, 128, 288, 2, 1)),
    ((4, 512, 128, 128, 192, 128, 1, 2048), (128, 128, 288, 2, 1)),
    # a short last chunk of 100: 128 blocks, one an SM, no split
    ((1, 100, 128, 128, 192, 128, 1, 2048), (128, 128, 288, 2, 1)),
    # a 16-head slice of the same widths (one card of eight under head
    # sharding): 128 blocks of 64 rows leave SMs idle, so 3 key shares
    ((1, 512, 16, 16, 192, 128, 1, 2048), (64, 64, 160, 2, 3)),
]


@pytest.mark.parametrize("shape,expect", SERVED_MLA)
def test_rows_a_block_at_mla_widths(shape, expect):
    """The (192, 128) instantiation: 128-row blocks where the grid fills
    the card, two stages, and the shared memory of ``tc_smem``: at two
    warpgroups the Q rows 128 x 200 bf16 (51,200 B) and two stages of
    64 keys x 320 bf16 (81,920 B), 134,176 B in all."""
    plan = prefill_plan(torch.bfloat16, *shape)
    assert plan.body == TENSOR_CORE
    assert (plan.block_q, plan.rows, plan.threads, plan.stages,
            plan.splits) == expect
    assert plan.smem == tc_smem(plan.threads // 32 - 1, 192, 128)
    assert plan.smem <= build.MAX_SMEM
    assert tc_smem(8, 192, 128) == 134_176
    assert tc_smem(4, 192, 128) == 108_576


def test_mla_widths_f32_and_their_neighbours():
    """f32 at (192, 128) keeps the CUDA-core body with its 64-token
    tile (182,016 B); in bf16 only the pair (192, 128) is instantiated:
    192 with any other V width, or any K width with V 192, raises."""
    plan = prefill_plan(torch.float32, 1, 512, 128, 128, 192, 128, 1, 2048)
    assert (plan.body, plan.rows, plan.tile_pages) == (CUDA_CORE, 64, 64)
    assert plan.smem == build.attend_smem(64, 192, 128, 64, 1) == 182_016
    for hd, hd_v in ((192, 192), (192, 64), (128, 192), (192, 256)):
        with pytest.raises(ValueError, match="192 with 128"):
            prefill_plan(torch.bfloat16, 1, 64, 4, 4, hd, hd_v, 1, 64)


def test_earlier_shapes_plan_as_before():
    """Every shape of a grid over both dtypes, 1-8 segments, 1-2,000
    queries, the served head layouts, widths 32-256 each, pages of 1
    and 16, 1,600-4,096 keys and two SM counts plans as it did before
    the (192, 128) pair was added (the digest of the plans, or of the
    error each raised, over the 24,696 shapes other than bf16 at
    (192, 128), as the plan gave them then)."""
    widths = (32, 64, 128, 192, 256)
    rows = []
    for dtype, segs, sq, (h, kvh), hd, hd_v, page, n_keys in (
            itertools.product(
                (torch.float32, torch.bfloat16), (1, 4, 8),
                (1, 64, 512, 2000),
                ((4, 4), (14, 2), (16, 1), (32, 8), (40, 40), (128, 128),
                 (6, 6)), widths, widths, (1, 16), (1600, 2048, 4096))):
        if dtype == torch.bfloat16 and (hd, hd_v) == (192, 128):
            continue
        key = (str(dtype), segs, sq, h, kvh, hd, hd_v, page, n_keys, 132)
        try:
            got = tuple(vars(prefill_plan(dtype, *key[1:])).values())
        except (ValueError, TypeError) as e:
            got = type(e).__name__
        rows.append(repr(key + (got,)))
    assert len(rows) == 24_696
    assert hashlib.sha256("\n".join(rows).encode()).hexdigest() == DIGEST


DIGEST = ("cb4b3c68bd641a0f0835f2499cd87a968"
          "b2e7e6678556084b47dda2c70f43ecf")
