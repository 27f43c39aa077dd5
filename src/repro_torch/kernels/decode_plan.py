"""Launch plan of the two paged decode kernels: kernel 2
(``paged_decode_attention``) and kernel 4
(``paged_cross_decode_attention``), which run one device body,
``csrc/decode_attention.cuh``.

``decode_plan`` is a pure function of the call's dtype and shapes, so the
CPU tests can hold it without a card; ``share_keys`` mirrors the
device's split of a slot's live pages.

- The body is instantiated for head widths hd = hd_v of 32, 64, 128 and
  256 and for 1 to 8 query heads a KV head, in f32 and bf16; any other
  shape raises ``ValueError`` naming it, with no fallback.
- The split rule, one for both kernels: the number of splits comes from
  the grid alone.  Slots x KV heads x splits reach at least
  BLOCKS_PER_SM blocks an SM, and as many as fit on the card at once
  (RESIDENT_PER_SM a SM, by shared memory) where that is more, at most
  the table's width.  The host never reads the lengths (the decode step
  stays free of device-to-host syncs); each block cuts its own slot's
  live pages into ``splits`` shares of whole pages on the device, so
  the longest slot of a batch sets the pace.
- A block is 4 warps, each with its own ring of STAGES tiles of
  STAGE_BYTES (K rows then V rows in the storage type): ``tile`` keys a
  stage, 64 KB of shared memory a block whatever the shape.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.kernels.prefill_plan import H100_SMS

WIDTHS = (32, 64, 128, 256)     # instantiated hd (= hd_v)
MAX_REP = 8                     # instantiated query heads a KV head: 1-8
WARPS = 4
STAGES = 4                      # ring depth a warp (``STAGES``)
STAGE_BYTES = 4096              # a ring stage (``STAGE_BYTES``)
BLOCKS_PER_SM = 2               # blocks the splits reach at least, per SM
RESIDENT_PER_SM = 3             # blocks of 64 KB of shared memory an SM
_SIZES = {"torch.float32": 4, "torch.bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    splits: int        # shares of each slot's live pages
    tile: int          # keys a ring stage (a warp's tile)
    stages: int        # ring stages a warp
    threads: int       # threads a block
    smem: int          # dynamic shared-memory bytes a block


@functools.lru_cache(maxsize=4096)
def decode_plan(dtype, b: int, h: int, kvh: int, hd: int, hd_v: int,
                page: int, n_slots: int, n_sm: int = H100_SMS) -> Plan:
    """The launch of a decode call of ``b`` slots, ``h`` / ``kvh`` heads of
    ``hd`` (V: ``hd_v``), pages of ``page`` tokens and block tables of
    ``n_slots`` pages, on a card of ``n_sm`` SMs.  ``dtype``:
    torch.float32 or torch.bfloat16 (or its name)."""
    size = _SIZES.get(str(dtype))
    if size is None:
        raise TypeError(f"decode attention: no kernel for dtype {dtype}")
    rep = h // kvh if kvh > 0 else 0
    if (hd != hd_v or hd not in WIDTHS or kvh < 1 or h % kvh
            or not 1 <= rep <= MAX_REP):
        raise ValueError(
            f"decode attention: no instantiation for hd={hd}, hd_v={hd_v}, "
            f"rep={h}/{kvh} (instantiated: hd = hd_v in "
            f"{', '.join(map(str, WIDTHS))}, rep 1-{MAX_REP})")
    if min(b, n_slots, page) < 1:
        raise ValueError(f"decode attention: b={b}, n_slots={n_slots}, "
                         f"page={page}")
    pairs = b * kvh
    splits = min(n_slots, max(1, -(-BLOCKS_PER_SM * n_sm // pairs),
                              RESIDENT_PER_SM * n_sm // pairs))
    return Plan(splits=splits, tile=STAGE_BYTES // ((hd + hd_v) * size),
                stages=STAGES, threads=32 * WARPS,
                smem=WARPS * STAGES * STAGE_BYTES)


def share_keys(length: int, window: int, page: int, n_slots: int,
               split: int, splits: int):
    """(begin, end, rank, active) for split ``split`` of ``splits`` of a
    slot of ``length`` tokens (``share_keys`` in
    ``csrc/paged_attention.cuh``, which the decode body and kernel 3
    share): it walks keys [begin, end), empty when
    end <= begin, its share of the live pages [p_lo, p_hi), those holding
    the keys in [max(0, length - window), length), capped at the table's
    width, cut in ``splits`` shares of whole pages.  ``active`` splits
    have a share that is not empty, and this one, if it has, is the
    ``rank``-th of them."""
    k_lo = length - window if 0 < window < length else 0
    p_lo = k_lo // page
    p_hi = min(n_slots, -(-length // page))
    n = max(0, p_hi - p_lo)
    s_lo = p_lo + split * n // splits
    s_hi = p_lo + (split + 1) * n // splits
    rank = s_lo - p_lo if n < splits else split
    return (max(k_lo, s_lo * page), min(length, s_hi * page), rank,
            min(splits, n))
