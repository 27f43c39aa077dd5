"""The launch plan of kernel 5's backward (``bwd_plan.bwd_plan``): the
body and the MMA route by dtype, the column shares and grids, the
shared memory of every instantiation, the pairs the source instantiates
and the refusal of any other, held on the CPU (the plan is pure Python;
the kernel runs only on the card, where its launch checks that the plan
is its own).
"""
import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.bwd_plan import (MMA_BF16, MMA_BF16X6, P_TERMS,
                                          ROWS, WARPS, WIDTHS, bwd_plan,
                                          peak_flops)
from repro_torch.kernels.prefill_plan import TENSOR_CORE

SOURCE = (build.CSRC / "chunked_prefill_attention_bwd.cu").read_text()

# (hd, hd_v) -> (one block sums dV and dK, dV and dK blocks a key tile,
# dQ blocks a query tile): one block up to hd + hd_v = 160, else one each
# and two halves of a sum wider than 128 columns
PARTS = {(32, 32): (True, 1, 1), (64, 64): (True, 1, 1),
         (80, 64): (True, 1, 1), (128, 128): (False, 2, 1),
         (192, 128): (False, 3, 2), (256, 256): (False, 4, 2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", WIDTHS)
def test_every_pair_has_a_tensor_core_plan_that_fits(dtype, widths):
    plan = bwd_plan(dtype, 64, 256, 12, 4, *widths, 256)
    f32 = dtype == torch.float32
    assert plan.body == TENSOR_CORE
    assert plan.mma == (MMA_BF16X6 if f32 else MMA_BF16)
    assert (plan.fused, plan.kv_parts, plan.q_parts) == PARTS[widths]
    assert plan.rows == ROWS == 16 * WARPS and plan.threads == 32 * WARPS
    # f32 tiles (beside their three bf16 planes) shrink to fit 227 KB;
    # bf16 ones to 32 rows only where that fits a second block an SM
    assert plan.tile == (32 if not f32 and widths == (192, 128) else 64
                         if not f32 else 16 if sum(widths) > 384 else 32)
    assert plan.stages == (1 if f32 and sum(widths) > 256 else 2)
    es = 4 if f32 else 2
    rows = sum(widths) + 16                  # 8 elements of pad a row
    landed = sum(widths) + 2 * 16 // es      # 16 bytes of pad a row
    planes = 3 * plan.tile * rows * 2 if f32 else 0
    assert plan.smem == (ROWS * rows * es + planes
                         + plan.stages * (plan.tile * landed * es
                                          + 12 * plan.tile))
    assert plan.smem <= build.MAX_SMEM == 232_448
    assert plan.dq_grid == (4 * plan.q_parts, 12, 64)
    assert plan.dkdv_grid == (4 * plan.kv_parts, 4, 64)
    assert peak_flops(plan) == (989e12 / 6 if f32 else 989e12)


def test_the_source_instantiates_exactly_the_planned_pairs():
    dispatched = {(int(a), int(b)) for a, b in re.findall(
        r"if \(hd == (\d+) && hd_v == (\d+)\)", SOURCE)}
    assert dispatched == set(WIDTHS)
    for a, b in WIDTHS:
        assert f"launch<E, {a}, {b}>" in SOURCE
    # the constants bwd_plan mirrors
    assert f"constexpr int WARPS = {WARPS};" in SOURCE
    assert f"constexpr int PT = {P_TERMS};" in SOURCE
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in SOURCE
    assert "tf32" not in SOURCE.split("#include")[1]   # one MMA route


@pytest.mark.parametrize("widths", [(48, 48), (64, 128), (256, 128),
                                    (96, 96)])
def test_an_uninstantiated_pair_raises(widths):
    with pytest.raises(ValueError, match=f"hd={widths[0]}, "
                                         f"hd_v={widths[1]}"):
        bwd_plan(torch.float32, 1, 64, 2, 2, *widths, 64)
    with pytest.raises(TypeError, match="dtype"):
        bwd_plan(torch.float16, 1, 64, 2, 2, 64, 64, 64)


def test_grids_cover_ragged_edges():
    """sq 65 and skv 127 take a second, one-row and 63-row tile (a dV
    and a dK block each at (128, 128))."""
    plan = bwd_plan(torch.bfloat16, 2, 65, 14, 2, 64, 64, 127)
    assert plan.dq_grid == (2, 14, 2) and plan.dkdv_grid == (2, 2, 2)
    plan = bwd_plan(torch.bfloat16, 2, 65, 14, 2, 128, 128, 127)
    assert plan.dkdv_grid == (4, 2, 2)

