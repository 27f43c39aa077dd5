"""Launch plan of the paged MLA decode kernel (kernel 3,
``paged_mla_decode_attention``, ``csrc/paged_mla_decode_attention.cu``).

``mla_plan`` is a pure function of the call's dtypes and shapes, so the
CPU tests can hold it without a card.  It mirrors the kernel's ``Cfg``,
and the kernel refuses a launch whose shared memory or threads differ
from its own:

- bf16 latent pools run the tensor-core body: the 16 heads of a block
  as the M rows of ``mma.sync``, f32 queries split into three bf16 terms
  and the softmax weights into two (one each for bf16 queries).  f32
  pools run the CUDA-core body.
- (lora, rope) is instantiated at DeepSeek-V2's (512, 64) and at the
  widths of the smoke config and the tests, (64, 16) and (32, 16); any
  other pair raises ``ValueError`` naming it, with no fallback.
- The split rule is the decode body's (``decode_plan``): the number of
  splits comes from the grid alone, slots x head blocks x splits of at
  least BLOCKS_PER_SM blocks an SM, at most the table's width and
  MAX_SPLITS.  The host never reads the lengths; each block cuts its own
  slot's live pages into shares on the device (``decode_plan.share_keys``
  mirrors that cut).
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.kernels.prefill_plan import (CUDA_CORE, H100_SMS,
                                              TENSOR_CORE)

LATENTS = ((512, 64), (64, 16), (32, 16))   # instantiated (lora, rope)
TILE = 32             # keys a tile (``TK``)
HEADS = 16            # heads a block (``HB``)
STAGES = 2            # key tiles of the ring (``STAGES``)
TC_SPLIT_K = 8        # warps splitting QK^T's k on the tensor cores (``KQ``)
ROW_PAD = 8           # score and P rows: TILE + ROW_PAD (``SST``, ``PST``)
MAX_SPLITS = 64       # the merge's weights fit over the ring
BLOCKS_PER_SM = 2     # blocks the splits reach at least, per SM
_SIZES = {"torch.float32": 4, "torch.bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    body: str          # TENSOR_CORE (bf16 pools) or CUDA_CORE (f32 pools)
    heads: int         # heads a block (``HB``)
    head_blocks: int   # blocks across the heads of a slot
    splits: int        # shares of each slot's live pages
    threads: int       # threads a block
    stages: int        # key tiles of the ring
    smem: int          # dynamic shared-memory bytes a block
    q_terms: int       # bf16 terms a query value is split into
    p_terms: int       # bf16 terms a softmax weight is split into


def _size(dtype) -> int:
    size = _SIZES.get(str(dtype))
    if size is None:
        raise TypeError(f"paged MLA decode: no kernel for dtype {dtype}")
    return size


@functools.lru_cache(maxsize=4096)
def mla_plan(q_dtype, pool_dtype, b: int, h: int, lora: int, rope: int,
             page: int, n_slots: int, n_sm: int = H100_SMS) -> Plan:
    """The launch of a call of ``b`` slots of ``h`` heads, latent width
    ``lora`` + ``rope``, pages of ``page`` tokens and block tables of
    ``n_slots`` pages, on a card of ``n_sm`` SMs.  ``q_dtype`` (q_lat,
    q_rope and the output) and ``pool_dtype`` (both pools):
    torch.float32 or torch.bfloat16 (or their names)."""
    q_size, p_size = _size(q_dtype), _size(pool_dtype)
    if (lora, rope) not in LATENTS:
        raise ValueError(
            f"paged MLA decode: no instantiation for lora={lora}, "
            f"rope={rope} (instantiated (lora, rope): "
            f"{', '.join(map(str, LATENTS))})")
    if min(b, h, n_slots, page) < 1:
        raise ValueError(f"paged MLA decode: b={b}, h={h}, "
                         f"n_slots={n_slots}, page={page}")
    tc = p_size == 2
    terms = (3, 2) if tc and q_size == 4 else (1, 1)
    # 16 heads a block; on the tensor cores 8 warps splitting QK^T's k
    # dimension (8 partial scores a head), 2 blocks an SM
    heads, parts = HEADS, TC_SPLIT_K if tc else 1
    threads = 32 * (TC_SPLIT_K if tc else 4)
    w = lora + rope
    tile = TILE * 16 * ((w * p_size // 16) | 1)
    row = TILE + ROW_PAD
    p_bytes = (terms[1] * heads * row * 2 if tc
               else TILE * (heads + 4) * 4)
    # the query rows lie over the last stage, the scores and P on the
    # tensor cores, after them on the CUDA cores
    q_bytes = 0 if tc else heads * (w * q_size + 16)
    smem = (STAGES * tile + parts * heads * row * 4 + p_bytes + q_bytes
            + 3 * heads * 4)
    head_blocks = -(-h // heads)
    pairs = b * head_blocks
    splits = min(n_slots, MAX_SPLITS,
                 max(1, -(-BLOCKS_PER_SM * n_sm // pairs)))
    return Plan(body=TENSOR_CORE if tc else CUDA_CORE, heads=heads,
                head_blocks=head_blocks, splits=splits, threads=threads,
                stages=STAGES, smem=smem, q_terms=terms[0],
                p_terms=terms[1])
