"""Quickstart: disaggregated serving of a small model through the port's
unified Cluster API, the reference's ``examples/quickstart.py`` on the
port.

Builds a cluster of prefill + decode instances (the TetriInfer pillars:
chunked prefill, length-predicted dispatch, working-set-aware decode
admission, emulated KV transfer), submits requests with user stop
criteria, STREAMS tokens from a handle as they are generated, cancels
one request mid-decode, and prints per-phase timestamps (virtual: one
step is ``step_dt`` on the event clock).

    PYTHONPATH=src python -m repro_torch.quickstart                # card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving import Cluster, SamplingParams


def main(device="cuda", params=None):
    """Run the quickstart on ``device``; ``params`` (on that device)
    default to random weights from seed 0.  Returns every request's
    ``RequestResult``."""
    cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                              dtype="float32")
    print(f"model: {cfg.name}  layers={cfg.n_layers} d={cfg.d_model}")
    if params is None:
        params = M.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
    cluster = Cluster(cfg, runtime="engine", params=params,
                      n_prefill=1, n_decode=1, chunk_size=16,
                      max_seq=128, max_batch=8, device=device)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=int(n)).astype(np.int32)
               for n in rng.integers(8, 48, size=6)]

    # submit everything up front; each handle streams independently —
    # the last one asks for a long generation (we cancel it below)
    handles = [cluster.submit(p, sampling=SamplingParams(max_new_tokens=8))
               for p in prompts[:-1]]
    handles.append(cluster.submit(
        prompts[-1], sampling=SamplingParams(max_new_tokens=64)))

    # stream the first request token by token (this lazily pumps the
    # cluster event loop: prefill chunks, KV transfer, decode batches)
    print(f"\nstreaming {handles[0].rid}:", end=" ", flush=True)
    stream = iter(handles[0])
    for tok in itertools.islice(stream, 3):
        print(tok, end=" ", flush=True)

    # cancel another request mid-decode — pages/slots freed immediately
    cancelled = handles[-1].cancel()
    for tok in stream:                  # rest of the first request
        print(tok, end=" ", flush=True)
    print(f"   (cancelled {handles[-1].rid}: {cancelled})")

    cluster.run()          # drain the rest
    print("\nresults:")
    for h in handles:
        res = h.result()
        ttft = f"{res.ttft*1e3:6.1f}ms" if res.t_first_token >= 0 else \
            "   --  "
        print(f"  {res.rid}  {res.phase.value:9s} tokens={len(res.tokens)}"
              f"  ttft={ttft}  {res.tokens[:6]}")
    done = [h for h in handles if h.result().phase.value == "finished"]
    assert len(done) == len(handles) - 1, "exactly one was cancelled"
    assert all(len(h.result().tokens) == 8 for h in done)
    print("OK")
    return [h.result() for h in handles]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    main(device=ap.parse_args().device)
