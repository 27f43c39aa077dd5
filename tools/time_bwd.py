#!/usr/bin/env python3
"""Time kernel 5's backward (``chunked_prefill_attention_bwd``) of a
checkout at phase 2h's shapes, f32 and bf16, on one card, without the
rest of the smoke run.

    python3 tools/time_bwd.py [--src DIR] [--tag NAME]

``--src`` names the ``src/`` directory whose ``repro_torch`` is timed
(default: this repository's), so an older checkout's backward (a ``git
archive`` unpacked elsewhere) can be timed beside this one's in one call
on one card: run parent, this, this, parent.  The shapes are
``chip_smoke.bwd_cases`` and the inputs ``chip_smoke.dense_case`` from
one seed, with the output from that checkout's kernel 5 forward.  Only
the two kernel-5 libraries are built.  For each case it prints one JSON
line: ms a call by CUDA events over back-to-back calls
(``chip_smoke.cuda_ms``), the card's device µs a call by the profiler
(``chip_smoke.device_us``), the calls the wrapper counted on the tensor
cores (absent before they were counted), and the card's name and power
limit.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL_5 = ("chunked_prefill_attention", "chunked_prefill_attention_bwd")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_bwd: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [a.src, str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention, chunked_prefill_attention_bwd)
    every = build.build
    build.build = lambda names=KERNEL_5: every(names)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 40)
    for what, widths, window, causal, *shape in cs.bwd_cases():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kv_len, q_off = cs.dense_case(widths, *shape, dtype,
                                                   dev, gen)
            kw = dict(window=window, causal=causal)
            out = chunked_prefill_attention(q, k, v, kv_len, q_off, **kw)
            dout = torch.randn(out.shape, generator=gen,
                               device=dev).to(dtype)
            args = (q, k, v, out, dout, kv_len, q_off)
            tc0 = getattr(chunked_prefill_attention_bwd,
                          "tensor_core_launches", None)
            chunked_prefill_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            row = dict(tag=a.tag, case=what, dtype=str(dtype)[6:],
                       card=card)
            if tc0 is not None:
                row["tensor_core_calls"] = (
                    chunked_prefill_attention_bwd.tensor_core_launches - tc0)

            def call(a=args, kw=kw):
                return chunked_prefill_attention_bwd(*a, **kw)
            row["ms"] = cs.cuda_ms(call)
            row["device_us"], row["device_by"] = cs.device_us(call)
            print(json.dumps(row), flush=True)
            del q, k, v, out, dout, args
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
