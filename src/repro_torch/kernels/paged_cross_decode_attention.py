"""Paged cross-attention decode (one query token per slot against the
read-only encoder pages): CUDA kernel wrapper.

Replaces ``src/repro/kernels/paged_cross_decode_attention.py``
(``paged_cross_decode_attention`` -> ``pl.pallas_call``).  Every decode
iteration of a VLM or encoder-decoder model runs the whole slot batch
through it in every cross layer; empty slots carry ``enc_lens = 0`` and
get zeros.

The kernel (``csrc/paged_cross_decode_attention.cu``) runs the decode
body of ``csrc/decode_attention.cuh`` with no window, launched by the
self-attention wrapper's ``launch`` under the same plan
(``decode_plan``): one block per (slot, KV head, split of the slot's
cross pages), the rep query heads of a KV head sharing each cross page
the block reads, the splits combined in the same launch.  The only mask
is ``tok < enc_len``.  On an H100 it is bound by the bytes of the cross
pages; see the sources.

On a CPU tensor the wrapper runs the plain version
(``ref.paged_cross_decode_attention``); on a CUDA tensor it launches the
kernel or raises.  ``paged_cross_decode_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

from repro_torch.kernels import build, ref
from repro_torch.kernels.paged_decode_attention import launch

NAME = "paged_cross_decode_attention"


def paged_cross_decode_attention(q, k_pool, v_pool, block_table, enc_lens):
    """q: (b, h, hd), contiguous; k_pool/v_pool: (n_pages, page, kvh, hd),
    the pool shared with the self-attention pages; block_table: (b,
    cross_slots) int32 physical ids of each slot's cross pages (pad slots
    may point at a scratch page — never read); enc_lens: (b,) int32
    encoder tokens per slot (0 for an empty slot).  Returns (b, h, hd_v)
    in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_cross_decode_attention(q, k_pool, v_pool,
                                                block_table, enc_lens)
    if q.device.type != "cuda":
        raise ValueError(f"{NAME}: no kernel for device {q.device}")
    out = launch(NAME, "paged_cross_decode_attention_launch", q, k_pool,
                 v_pool, block_table, enc_lens, 0)
    build.count(paged_cross_decode_attention, "launches")
    return out


paged_cross_decode_attention.launches = 0
