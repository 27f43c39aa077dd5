"""The launch plan of the prefill-attention kernels (kernels 1 and 5):
which device body a call runs, how many query rows a block takes, and
its shared memory, held on the CPU (``prefill_plan.prefill_plan`` is
pure Python; the kernels themselves run only on the card).
"""
import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.chunked_prefill_attention import (
    chunked_prefill_attention)
from repro_torch.kernels.paged_prefill_attention import (
    paged_prefill_attention)
from repro_torch.kernels.prefill_plan import (CUDA_CORE, TC_WIDTHS,
                                              TENSOR_CORE, key_splits,
                                              prefill_plan, tc_smem)


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


@pytest.mark.parametrize("hd,hd_v", [(48, 48), (80, 80), (256, 256),
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
