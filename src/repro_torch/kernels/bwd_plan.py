"""Launch plan of kernel 5's backward (``chunked_prefill_attention_bwd``).

One pure function, ``bwd_plan``, gives the device body and the block
shape of both launches from the call's dtype and shapes, so the CPU
tests can hold it without a card.  It mirrors ``Cfg`` in
``csrc/chunked_prefill_attention_bwd.cu``, and the launch checks that
the two agree (it returns ``PLAN_MISMATCH`` otherwise).

Both dtypes run on the tensor cores (``mma.sync``, 4 warps a block of
64 rows, 16 a warp):

- bf16 inputs: Q, K, V and dO exactly (m16n8k16, f32 sums), the f32
  intermediates P and dS as three bf16 terms each (``MMA_BF16``);
- f32 inputs: every operand as three bf16 terms (24 bits), six bf16
  products a product (``MMA_BF16X6``: the tensor-core work of 3xTF32,
  with two more bits an operand).

Each step of 16 products of a long sum is summed by the tensor cores
from zero and added to its f32 accumulator on the CUDA cores, since the
tensor cores' own sums truncate.

Launch (a) computes dQ and each query row's statistics, one block per
(request, query head, tile of 64 positions, share of dQ's columns);
launch (b) dK and dV, one block per (request, KV head, tile of 64 keys,
share of their columns).  A block's accumulators are 16 rows a warp:
one block sums both dV and dK where hd + hd_v <= 160 (64 + 64 columns
at hd 64), else each has blocks of its own, and a sum wider than 128
columns (64 registers a thread) is split in halves over two.  Each
block walks tiles of ``tile`` rows (the keys in (a), the query
positions in (b)) through a ring of ``stages`` ``cp.async`` stages:
bf16 tiles of 64 rows in 2 stages (32 rows where 64 would leave one
block an SM and 32 fits two); f32 tiles of 32 rows (16 above hd + hd_v
= 384), in 2 stages up to hd + hd_v = 256 and 1 above, beside the
tile's three bf16 planes, to fit the H100's 227 KB a block.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.kernels import build
from repro_torch.kernels.prefill_plan import TENSOR_CORE

MMA_BF16, MMA_BF16X6 = "bf16", "bf16x6"
# the instantiated (hd, hd_v); any other pair raises
WIDTHS = ((32, 32), (64, 64), (80, 64), (128, 128), (192, 128), (256, 256))
WARPS = 4
ROWS = 16 * WARPS      # a block's own rows: query positions or keys
FUSE_MAX = 160         # hd + hd_v up to which one block sums dV and dK
MOST_COLUMNS = 128     # else a block's share of dK, dV or dQ at most
PAD = 8                # elements of pad a resident or operand row
SM_SMEM = 233_472      # shared memory of an H100 SM (1 KB more a block)
P_TERMS = 3            # bf16 terms of P and dS (bf16 inputs)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    body: str          # TENSOR_CORE
    mma: str           # MMA_BF16 or MMA_BF16X6
    rows: int          # a block's own rows (64)
    tile: int          # rows of a walked tile
    stages: int        # walked tiles in flight in shared memory
    threads: int
    q_parts: int       # blocks sharing one query tile's dQ columns
    kv_parts: int      # blocks sharing one key tile's dV and dK columns
    fused: bool        # one block sums both dV and dK
    dq_grid: tuple     # (x, y, z) of launch (a)
    dkdv_grid: tuple   # of launch (b)
    smem: int          # dynamic shared-memory bytes a block, either launch


def _parts(width: int) -> int:
    """Blocks a ``width``-column accumulator is split over."""
    return 1 if width <= MOST_COLUMNS else 2


@functools.lru_cache(maxsize=1024)
def bwd_plan(dtype, b: int, sq: int, h: int, kvh: int, hd: int, hd_v: int,
             skv: int) -> BwdPlan:
    """The launches of one backward of ``b`` requests of ``sq`` queries
    with ``h`` / ``kvh`` heads of ``hd`` (V: ``hd_v``) over caches of
    ``skv`` positions.  ``dtype``: torch.float32 or torch.bfloat16 (or
    its name)."""
    name = str(dtype)
    if name not in ("torch.float32", "torch.bfloat16"):
        raise TypeError(f"chunked prefill backward: no kernel for dtype "
                        f"{dtype}")
    if (hd, hd_v) not in WIDTHS:
        raise ValueError(
            f"chunked prefill backward: no instantiation for head widths "
            f"hd={hd}, hd_v={hd_v} (instantiated: "
            f"{', '.join(map(str, WIDTHS))})")
    f32 = name == "torch.float32"
    es = 4 if f32 else 2
    width = hd + hd_v
    stages = 1 if f32 and width > 256 else 2

    def smem_at(tile):
        return (ROWS * (width + 2 * PAD) * es
                + stages * (tile * (width + 2 * (16 // es)) * es + 12 * tile)
                + (P_TERMS * tile * (width + 2 * PAD) * 2 if f32 else 0))

    def blocks(tile):
        return SM_SMEM // (smem_at(tile) + 1024)
    if f32:
        tile = 16 if width > 384 else 32
    else:
        tile = 32 if blocks(64) == 1 and blocks(32) >= 2 else 64
    smem = smem_at(tile)
    fused = width <= FUSE_MAX
    kv_parts = 1 if fused else _parts(hd_v) + _parts(hd)
    q_parts = _parts(hd)
    if smem > build.MAX_SMEM:
        raise ValueError(f"chunked prefill backward: {smem} B of shared "
                         f"memory, {build.MAX_SMEM} B available")
    return BwdPlan(TENSOR_CORE, MMA_BF16X6 if f32 else MMA_BF16, ROWS, tile,
                   stages, 32 * WARPS, q_parts, kv_parts, fused,
                   (-(-sq // ROWS) * q_parts, h, b),
                   (-(-skv // ROWS) * kv_parts, kvh, b), smem)


def peak_flops(plan: BwdPlan) -> float:
    """The H100's dense rate for the five products on ``plan``'s route:
    989 TFLOP/s bf16, and 989 / 6 TFLOP/s for f32 as six bf16 products
    a product (the 495 / 3 of 3xTF32)."""
    return 989e12 if plan.mma == MMA_BF16 else 989e12 / 6
