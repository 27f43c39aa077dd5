#!/usr/bin/env python3
"""Time the paged decode wrappers (kernels 2, 3 and 4) of a checkout at
the served decode shapes, on one card, without the rest of the smoke run.

    python3 tools/time_decode_wrappers.py [--src DIR] [--tag NAME]

``--src`` names the ``src/`` directory whose ``repro_torch`` is timed
(default: this repository's), so an older checkout's wrappers (a
``git archive`` unpacked elsewhere) can be timed beside this one's in
one call on one card.  The shapes and inputs are ``chip_smoke.py``'s
phase 5 decode rows (bf16, the 8-slot batch mid-run): qwen2-0.5b,
Llama-3.2-Vision and Whisper-tiny self-attention (kernel 2), the two
cross reads (kernel 4) and DeepSeek-V2's MLA decode (kernel 3: 128
heads, bf16 latent pools, f32 queries).  For each row it prints one
JSON line: ms a
launch by CUDA events over back-to-back calls, the wrapper's host µs a
call (``chip_smoke.host_us``), both before any profiler session, the
card's device µs a call by the profiler (``chip_smoke.profiler_us``, 0
when its session recorded no kernel) and by CUDA events behind a spin
kernel (``chip_smoke.queued_us``, the smoke run's fallback), the ms again
after them, the bound, and the card's name and power limit.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_decode_wrappers: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [a.src, str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.deepseek_v2_236b import served
    from repro_torch.kernels.paged_cross_decode_attention import (
        paged_cross_decode_attention)
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.paged_mla_decode_attention import (
        paged_mla_decode_attention)
    from repro_torch.models.attention import mla_scale
    dev, dtype = torch.device("cuda"), torch.bfloat16
    card = cs.card_line()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    kw = {k: cs.SERVE[k] for k in ("page_size", "max_seq", "n_pages")}
    qwen, vlm, wh = (get_config(n) for n in ("qwen2_0_5b", cs.VLM_ARCH,
                                             cs.WHISPER_ARCH))
    reqs = cs.make_requests(qwen.vocab_size)
    wh_reqs = cs.make_requests(wh.vocab_size, lo=cs.WHISPER_PROMPTS[0],
                               hi=cs.WHISPER_PROMPTS[1])
    # (name, kernel, its arguments, (bytes, FLOPs) of those arguments)
    dec_work = lambda a: cs.decode_work(a[0], a[1], *a[3:])  # noqa: E731
    rows = []
    for cfg, rq in ((qwen, reqs), (vlm, reqs), (wh, wh_reqs)):
        g = cs.decode_geometry(rq, max_slots=cs.SERVE["max_slots"], **kw)
        pools = cs.random_pools(cfg, cs.SERVE["n_pages"],
                                cs.SERVE["page_size"], dtype, dev, gen)
        rows.append((f"paged_decode_attention, {cfg.name} self",
                     paged_decode_attention,
                     cs.decode_args(cfg, g, pools, dtype, dev, gen),
                     dec_work))
    for cfg, rq in ((vlm, reqs), (wh, wh_reqs)):
        _, slots = cs.cross_geometry(rq, cfg.cross_ctx,
                                     cs.SERVE["chunk_size"],
                                     cs.SERVE["page_size"], cs.CROSS_PAGES,
                                     cs.SERVE["max_slots"])
        pools = cs.random_pools(cfg, cs.CROSS_PAGES, cs.SERVE["page_size"],
                                dtype, dev, gen)
        rows.append((f"paged_cross_decode_attention, {cfg.name}",
                     paged_cross_decode_attention,
                     cs.decode_args(cfg, slots[0], pools, dtype, dev, gen),
                     dec_work))
    ds = served()
    g = cs.decode_geometry(reqs, max_slots=cs.SERVE["max_slots"], **kw)
    lat = cs.random_latent_pools(ds, cs.SERVE["n_pages"],
                                 cs.SERVE["page_size"], dtype, dev, gen)
    rows.append((f"paged_mla_decode_attention, {ds.name}",
                 lambda *a, s=mla_scale(ds): paged_mla_decode_attention(
                     *a, scale=s),
                 cs.mla_args(ds, g, lat, dev, gen),
                 lambda a: cs.mla_work(*a)))
    # every row's CUDA-event ms and host µs first, then the profiler's
    # device µs, then the ms again: a profiler session can slow later
    # launches on the host
    first = [(cs.cuda_ms(lambda: kern(*args), reps=50),
              cs.host_us(lambda: kern(*args), reps=50))
             for _, kern, args, _ in rows]
    for (name, kern, args, work), (ms, host) in zip(rows, first):
        device = cs.profiler_us(lambda: kern(*args), reps=50)
        queued = cs.queued_us(lambda: kern(*args), reps=50)
        bound, _ = cs.bound(*work(args), dtype)
        print(json.dumps({"tag": a.tag, "row": name, "ms": ms,
                          "host_us": host, "device_us": device,
                          "queued_us": queued,
                          "ms_after_profiler": cs.cuda_ms(
                              lambda: kern(*args), reps=50),
                          "bound_ms": bound, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
