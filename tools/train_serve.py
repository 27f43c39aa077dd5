#!/usr/bin/env python3
"""Train, then serve, full-width qwen2-0.5b on one card: chip_smoke's
phase 3u without the rest of the smoke run.

    python3 tools/train_serve.py [--src DIR] [--tag NAME]

``--src`` names the ``src/`` directory whose ``repro_torch`` runs
(default: this repository's), so an older checkout (a ``git archive``
unpacked elsewhere) can run beside this one in one call on one card.
The work is ``chip_smoke.train_serve_run`` on bf16 weights from
``chip_smoke.SEED``: one ``make_train_step`` step, then phase 3e's
requests through ``Cluster`` 1 + 1 with the trained weights' clone and
with the trained weights, then through ``AsyncCluster`` 1 + 1.  It
prints one JSON line (``tag``, the card's name and power limit, the
step's ms and launches, the leaves that require grad after the step,
and for each serving run the kernel launches, the live tensors with a
``grad_fn``, the memory allocated above the runtime's start, the
requests finished and whether its tokens equal the clone's), unchecked,
so that a checkout whose runs record a graph still reports (chip_smoke's
phase 3u runs the same work with its checks).  Exits non-zero without a
card.
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
        print("train_serve: no CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(Path(a.src).resolve()), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention, chunked_prefill_attention_bwd)
    from repro_torch.kernels.paged_cross_decode_attention import (
        paged_cross_decode_attention)
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.paged_mla_decode_attention import (
        paged_mla_decode_attention)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention)
    from repro_torch.models import model as M
    kernels = {"paged_prefill_attention": paged_prefill_attention,
               "paged_decode_attention": paged_decode_attention,
               "paged_mla_decode_attention": paged_mla_decode_attention,
               "paged_cross_decode_attention": paged_cross_decode_attention,
               "chunked_prefill_attention": chunked_prefill_attention,
               "chunked_prefill_attention_bwd":
                   chunked_prefill_attention_bwd}
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cfg = get_config("qwen2_0_5b")
    params = M.init_params(cfg, torch.Generator(device=dev)
                           .manual_seed(cs.SEED), dev)
    st = cs.train_serve_run(cfg, params, dev, kernels)
    for k in ("trained", "async"):
        st[k]["same_as_clone"] = st[k]["tokens"] == st["clone"]["tokens"]
    for k in ("clone", "trained", "async"):
        del st[k]["tokens"]
        st[k]["launches"] = {n: v for n, v in st[k]["launches"].items()
                             if v}
    st["train_launches"] = {n: v for n, v in st["train_launches"].items()
                            if v}
    print(json.dumps({"tag": a.tag, "card": card, **st}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
