"""Launch plan of the two prefill-attention kernels: kernel 1 (paged,
``paged_prefill_attention``) and kernel 5 (dense,
``chunked_prefill_attention``, a pool of one-token pages).

One pure function, ``prefill_plan``, picks the device body and the
block shape from the call's dtype and shapes, so the CPU tests can hold
it without a card:

- bf16 inputs run the tensor-core body (``csrc/prefill_attention_tc.cuh``:
  bf16 ``wgmma`` with f32 sums, a ``cp.async`` K/V ring).  It is
  instantiated for head widths hd and hd_v of 32, 64 and 128, for
  hd = hd_v = 256 (RecurrentGemma's local attention) and for hd = 192
  with hd_v = 128 (MLA decompressed for the dense prefill: 128 nope +
  64 RoPE key dims, 128 value dims); any other width raises
  ``ValueError`` naming it, with no fallback.
- f32 inputs keep the CUDA-core body (``csrc/paged_attention.cuh``):
  the tensor cores would take f32 as TF32, about three decimal digits,
  and the f32 served runs are held token-identical to the CPU.  Its K/V
  tile is 64 tokens, halved until the block's shared memory fits (32 at
  hd 256 with 64 rows).

The tensor-core body takes 128 query rows a block (two warpgroups of
64) where the grid then still holds about one block per SM, else 64 (at
hd_v 256 always 64: a thread's output tile alone is 128 registers), so
a block's rows (positions x rep heads) share each K/V tile it reads:
Llama-3.2-Vision's cross read (rep 4) gets 32 positions a block,
a single-segment qwen2 chunk (rep 7, 2 KV heads) 9 (63 rows, 114
blocks).  Where even then the grid leaves SMs idle, each block's keys
are split in up to ``splits`` shares walked by blocks of their own, and
a second launch combines their partial softmax states: Whisper's cross
read of one 256-query segment (24 blocks of 64 rows) walks its 1,500
keys in 6 shares of 4 tiles.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.kernels import build

CUDA_CORE, TENSOR_CORE = "cuda_core", "tensor_core"
TC_WIDTHS = (32, 64, 128)      # instantiated hd and hd_v of the bf16 body
TC_WIDE = 256                  # also instantiated, as hd = hd_v = 256
TC_MLA = (192, 128)            # and as (hd, hd_v): dense MLA prefill
TILE_TOKENS = 64               # keys a K/V tile (both bodies)
ROWS_SMALL, ROWS_BIG = 64, 128
SPLIT_TILES = 4                # key tiles a split walks at the least
H100_SMS = 132
PAD = 8                        # bf16 of padding a shared-memory Q row


@dataclasses.dataclass(frozen=True)
class Plan:
    body: str          # TENSOR_CORE or CUDA_CORE
    block_q: int       # query positions a block
    rows: int          # query rows a block: block_q x rep
    threads: int       # tensor-core body: 4 consumer warps a 64 rows + 1
    stages: int        # K/V tiles in flight in shared memory
    tile_pages: int    # pages a K/V tile (the CUDA-core body's)
    smem: int          # dynamic shared-memory bytes a block
    splits: int = 1    # shares of each block's keys (tensor-core body)


def tc_stages(hd: int, hd_v: int) -> int:
    """Ring depth of the tensor-core body (``Layout::STAGES``)."""
    return 2 if hd + hd_v >= 256 else 3


def tc_smem(warps: int, hd: int, hd_v: int) -> int:
    """Shared-memory bytes of one tensor-core block of ``warps`` consumer
    warps (mirrors ``Layout::smem_bytes``): 1 KB to align the start, the
    Q rows (bf16, padded by PAD) rounded up to 1 KB, the K/V ring, then
    two mbarriers a stage."""
    stages = tc_stages(hd, hd_v)
    q_bytes = -(-2 * warps * 16 * (hd + PAD) // 1024) * 1024
    return 1024 + q_bytes + stages * (TILE_TOKENS * 2 * (hd + hd_v) + 16)


def key_splits(blocks: int, warps: int, n_keys: int, n_sms: int) -> int:
    """Shares to split each block's keys in: enough for about 8
    consumer warps an SM when ``blocks`` of ``warps`` leave SMs idle,
    each share at least SPLIT_TILES tiles of the ``n_keys`` a block may
    walk."""
    target = n_sms * max(1, 8 // warps)
    if 8 * blocks >= 7 * target:
        return 1
    most = max(1, -(-n_keys // TILE_TOKENS) // SPLIT_TILES)
    return max(1, min(-(-target // blocks), most))


@functools.lru_cache(maxsize=4096)
def prefill_plan(dtype, segs: int, sq: int, h: int, kvh: int, hd: int,
                 hd_v: int, page: int, n_keys: int,
                 n_sms: int = H100_SMS) -> Plan:
    """The launch of a prefill call of ``segs`` segments (requests) of
    ``sq`` queries with ``h`` / ``kvh`` heads of ``hd`` (V: ``hd_v``)
    over pages of ``page`` tokens (1 for the dense kernel), each segment
    reading at most ``n_keys`` keys (its table's width times the page,
    or the cache length), on a card of ``n_sms`` SMs.  ``dtype``:
    torch.float32 or torch.bfloat16 (or its name)."""
    rep = h // kvh
    if str(dtype) == "torch.float32":
        block_q = max(1, ROWS_SMALL // rep)
        rows = block_q * rep
        tile_pages = max(1, TILE_TOKENS // page)
        smem = build.attend_smem(rows, hd, hd_v, tile_pages, page)
        while smem > build.MAX_SMEM and tile_pages > 1:
            tile_pages //= 2
            smem = build.attend_smem(rows, hd, hd_v, tile_pages, page)
        plan = Plan(CUDA_CORE, block_q, rows, 256, 1, tile_pages, smem)
    elif str(dtype) == "torch.bfloat16":
        wide = hd == hd_v == TC_WIDE
        if not wide and (hd, hd_v) != TC_MLA and (
                hd not in TC_WIDTHS or hd_v not in TC_WIDTHS):
            raise ValueError(
                f"prefill attention: no tensor-core body for bf16 head "
                f"width hd={hd}, hd_v={hd_v} (instantiated: "
                f"{', '.join(map(str, TC_WIDTHS))} each, both "
                f"{TC_WIDE}, or {TC_MLA[0]} with {TC_MLA[1]})")
        most = ROWS_SMALL if wide else ROWS_BIG
        if rep > most:
            raise ValueError(f"prefill attention: {rep} query heads a KV "
                             f"head exceed a block of {most} rows")
        big = max(1, most // rep)
        small = max(1, ROWS_SMALL // rep)
        blocks = segs * kvh * -(-sq // big)
        block_q = big if 8 * blocks >= 7 * n_sms else small
        rows = block_q * rep
        warps = 4 * -(-rows // 64)        # consumer warpgroups of 64 rows
        splits = key_splits(segs * kvh * -(-sq // block_q), warps, n_keys,
                            n_sms)
        plan = Plan(TENSOR_CORE, block_q, rows, 32 * (warps + 1),
                    tc_stages(hd, hd_v), 1, tc_smem(warps, hd, hd_v), splits)
    else:
        raise TypeError(f"prefill attention: no kernel for dtype {dtype}")
    if plan.smem > build.MAX_SMEM:
        raise ValueError(f"prefill attention: {plan.smem} B of shared "
                         f"memory needed, {build.MAX_SMEM} B available "
                         "(head dims too wide)")
    return plan


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count
