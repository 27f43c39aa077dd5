#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card with CUDA, ``nvcc`` and the repository's
``src/`` beside this file; without a card it exits non-zero at once.
Phases, in order (any failure exits non-zero):

1. Build the five CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc each, in parallel) and print the card's name and power
   limit.
2. Each kernel against its plain PyTorch version on the same CUDA
   inputs, at the shapes of the served runs (every prefill chunk, the
   decode slot batches), with ragged lengths, pad segments and empty
   slots on a scratch page full of garbage, and a windowed case, plus
   the decode body's edges (a slot spanning every split, one shorter
   than one share, slid-out pages on the scratch page): the GQA kernels in
   f32 and bf16 at qwen2's widths (2) and at the cross models' (2a:
   Llama-3.2-Vision's hd 128 with 4 query heads a KV head, Whisper's hd
   64 with 1, each at its own served prompts), the MLA decode kernel
   with f32 queries against f32 and bf16 latent pools, on the served
   slot batches and the edge batch, its own scratch page full of
   garbage (2b), and the cross reads at Llama-3.2-Vision's and
   Whisper's served shapes (2c):
   the cross decode kernel and the prefill kernel with
   ``causal=False``.  2d: the dense chunked-prefill kernel, driven
   through its entry (``ops.prefill_attention`` with no block table) and
   held against its plain version at qwen2's and Llama-3.2-Vision's
   widths (8 requests, a 512-query chunk at 512 in caches of 2048,
   ragged kv_len with a 0), causal and windowed, and against the paged
   prefill kernel on the same K/V laid out as pages.  2e: the paged
   prefill and decode kernels at the served shapes of OPT-13B (rep 1),
   Mistral-Nemo (rep 4, window 0 and its 4,096-token window on the
   windowed run's trimmed tables), Phi-4-mini and Granite (rep 3) and
   DeepSeek-67B (rep 8).  2f: kernel 5 at the dense backend's served
   shapes, f32 and bf16, on caches of garbage past kv_len:
   RecurrentGemma's 512-query chunks at 0, 2,048 and 3,584 in caches of
   4,096 (16 query heads over 1 KV head of 256, window 2,048): 4
   requests a call with ragged kv_len and a 0, and one a call as phase
   3m's engine gives them, whose bf16 plan splits the keys and merges
   the shares, which 2f asserts; and the coupled OPT-13B's whole prompts
   (up to 1,711 queries at 0).  2g: kernel 5 at the dense MLA prefill's
   widths (DeepSeek-V2's 128 / 128 heads decompressed to K of 192 and V
   of 128: chunks of 512 at 0, 512 and 1,536 in caches of 2,048, one
   request a call and four with ragged kv_len and a 0; a 16-head slice
   of the same widths, whose bf16 plan splits the keys) and at the dense
   cross reads, non-causal (Llama-3.2-Vision's 32 / 8 heads of 128 over
   1,600 patches and Whisper's 6 / 6 of 64 over 1,500 frames: a chunk of
   512, the 8 decode slots, and a whole prompt of 2,000 over the 1,600
   patches, sq > skv), f32 and bf16.  bf16 outputs are held to a limit
   scaled by the plain output's magnitude (``limit``).
   The prefill kernels (1 and 5) and the MLA decode kernel (3) run bf16
   on their tensor-core body and f32 on their CUDA-core body: 2d, 3-3i
   and 4-4e check it on the wrappers' ``tensor_core_launches``.
3. Serve: one PrefillEngine and one DecodeEngine driven through submit
   -> step -> receive -> admit -> step, 8 greedy requests (unless said
   otherwise), random weights from a seeded generator, bf16: full-width qwen2-0.5b (3),
   DeepSeek-V2 at full width and 4 layers (3b: MLA latent pages, routed
   MoE), Llama-3.2-Vision-11B at full width and depth (3c) and
   Whisper-tiny whole (3d), both with read-only cross pages and stub
   frontend embeddings.  3e: full-width qwen2-0.5b through the serving
   API, ``Cluster(runtime="engine")`` with 2 prefill and 2 decode
   instances: the 8 requests streamed, a ninth cancelled after its third
   streamed token.  3f: OPT-13B whole (40 layers, 12.9 G parameters);
   3g: Mistral-Nemo-12B whole with a 4,096-token window, prompts of
   4,608-8,192 (every payload and decoding slot within pages_for(window)
   + 1 pages, windowed wire bytes); 3h: Phi-4-mini and Granite-MoE whole
   and DeepSeek-67B at ``served()``'s depth, 4 requests of 16 tokens;
   3f-3h check launches and wire bytes.  3i: qwen2-0.5b with every
   second request sampled (temperature 0.8, top-k 20): two runs
   identical, greedy streams those of an all-greedy run.  3j: phase 3e's
   traffic through the wall-clock ``AsyncCluster`` (2 prefill + 2 decode
   instances, each worker on a CUDA stream of its own), submitted by
   ``OpenLoopClient`` at Poisson arrivals of 20 req/s, a ninth request
   cancelled after 3 tokens: all terminal, no page held, no worker
   error; wall TTFT / JCT p50 and p99, and the overlap share (summed
   ``busy`` over wall seconds).  3k: 16 shared-prefix requests (2
   prefixes of 1,024 tokens) through ``Cluster`` and ``AsyncCluster``
   with ``prefix_cache=True`` and without: hits, fewer fused calls and
   kernel-1 launches, fewer wire bytes, no leak.  3l: Whisper-tiny whole
   with the cache on, 8 requests of 2 encoder inputs: the encoder once
   per input, decode slots sharing cross pages under kernel 4.  3m:
   RecurrentGemma-9B whole on the dense backend (chunks of 512, max_seq
   4,096, prompts of 256-4,000, 3 past its 2,048-token window): kernel 5
   launched 12 local-attention layers x the dense prefill calls, every
   logit finite, the RG-LRU scan's share of the prefill seconds.  3n:
   xLSTM-1.3B whole (4 requests of 16 tokens, max_seq 512): no attention
   kernel, the time loops' shares.  3o: the coupled vLLM-style baseline
   (``CoupledEngine``) on OPT-13B whole with 3f's weights and requests:
   kernel 5 launched 40 layers x 8 whole prompts, the streams that equal
   3f's.  3p: DeepSeek-V2 at 4 layers on the dense backend with 3b's
   weights and requests (kernel 5 at hd 192 / hd_v 128: n_layers x the
   dense prefill calls, all on the tensor-core body; the dense MLA
   decode attention's share of the decode seconds), then
   ``CoupledEngine`` on them.  3q: Llama-3.2-Vision whole on the dense
   backend (the engines over 3c's requests, then ``CoupledEngine`` over
   prompts of 64-2,000, one past its 1,600 patches) and Whisper-tiny
   whole through ``Cluster(runtime="engine", backend="dense")`` over
   3l's requests: kernel 5's causal and non-causal launches, the first
   chunk's cross reads on f32 (the unrounded cross K/V), wire bytes with
   the encoder tokens counted.  3r: the cost-model runtime, host only
   (no kernel): ``param_count`` of OPT-13B equal to the parameters 3f
   held; ``CostModel(opt_13b, HardwareSpec.h100())``'s prediction for
   3f's fused prefill calls and decode iterations (each call's tokens,
   each iteration's slots and positions) beside 3f's measured seconds,
   every prediction finite and positive, the ratios printed; the
   ``serve_cluster`` comparison on the H100 spec at 128 requests a
   workload (every request terminal, no page held); the ``mixed64``
   scenario equal (``==``) to tests/golden_sim_metrics.json; and
   ``run_fleet`` over 5,000 Poisson Mixed requests on 8 + 4 H100
   instances (events/s, no page held).  Every kernel's launch counter is
   set to 0 just before each run and read just after it.
4. Device vs CPU in f32, once on the card (kernels) and once on the CPU
   (plain versions): qwen2-0.5b at 2 layers on the served requests (4),
   DeepSeek-V2 at 2 layers (dense prefix + 1 routed) on 2 short requests
   (4b), Whisper-tiny whole and Llama-3.2-Vision at one pattern period
   (5 layers) on 2 short requests (4c): same greedy tokens, first-chunk
   logits within tolerance.  4d: phase 3e's Cluster run at 2 layers in
   f32, on the card and on the CPU: the same token streams, virtual
   timestamps and instance assignment.  4e: phase 3i's mixed greedy /
   sampled batch (sampled lanes included), OPT-13B and Mistral-Nemo at a
   64-token window in 64-token chunks, at 2 layers: the same tokens.
   4f: phase 3j's traffic through ``AsyncCluster`` on the card against
   the sync ``Cluster`` on the CPU, phase 3k's with the cache on the
   card against cache-off on the CPU (and the cache-on payloads within
   f32 tolerance of cache-off's), and phase 3l's on Whisper whole with
   the cache on against off: the same tokens.  4g: qwen2-0.5b at 2
   layers through ``Cluster`` (2 + 2 instances) and ``CoupledEngine``,
   on the card and on the CPU, all four token-identical (the reference's
   output equivalence); RecurrentGemma at one pattern period (3 layers,
   full width, window 64 in 64-token chunks) and xLSTM at its smoke
   depth (full width, through ``Cluster``, and on the card also through
   ``AsyncCluster``, whose dense payloads cross streams): card and CPU
   token-identical, first-chunk logits within tolerance.  4h: 4b's and
   4c's weights and requests on the dense backend, on the card and on
   the CPU: the same tokens as each other and as the paged backend's on
   the card, and the dense ck / cv equal to the paged cross pages.
5. Numbers: prefill and decode tokens/s of the served runs, and each
   kernel's time at the served shapes beside its bound, its plain
   version and one PyTorch library call, measured with CUDA events
   (kernels 1 and 2 also at OPT-13B's and windowed Mistral-Nemo's
   shapes, kernel 5 at 3m's chunks and 3o's whole prompts, the library
   call then on the in-window K/V, at 3p's MLA chunks and at 3q's cross
   reads in prefill and decode),
   with its achieved TFLOP/s, the body it ran and the wrapper's host µs
   a call; then, every row timed, the card's device µs a call by the
   profiler, with the device TB/s and share of the bound.  Last, phase
   3j again under the profiler: the card's idle share over the run and
   the share of its busy time in which two or more streams ran at once.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
N_REQUESTS = 8
PROMPT_RANGE = (64, 1536)
NEW_TOKENS = 32
SERVE = dict(chunk_size=512, page_size=16, max_seq=2048, n_pages=1024,
             max_slots=8)
HBM_BPS = 3.35e12                          # H100 SXM device memory
PEAK_FLOPS = {"torch.bfloat16": 989e12,    # dense tensor-core peak
              "torch.float32": 67e12}      # outside the tensor cores
# queued_us's spin ahead of the timed calls: about 10 ms at the H100's
# 1.98 GHz, far more than the host takes to issue 50 calls
SPIN_CYCLES = 20_000_000
# max |kernel - plain| allowed: f32 differs only by summation order;
# bf16 outputs may land a rounding or two apart, and one rounding is at
# most 2^-7 of a value, so the bf16 limit is the smaller of 2e-2 and
# BF16_REL of the case's largest |plain| output (see limit())
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
BF16_REL = 2.0 ** -6
# device (cuBLAS, kernels) vs CPU (plain versions) f32 logits after two
# full-width layers and a 151,936-word head: summation order only
LOGIT_TOL = 1e-3
WINDOW = 200                               # the windowed kernel case
DS_ARCH = "deepseek_v2_236b"
DS_CHECK = dict(n=2, lo=16, hi=64, new=4)  # phase 4b requests
VLM_ARCH = "llama_3_2_vision_11b"
WHISPER_ARCH = "whisper_tiny"
# pages an engine of the cross-attention runs holds: a Llama-3.2-Vision
# request holds 100 read-only cross pages (1600 patches) and up to 98
# self pages, so 8 of them need at most 1,584
CROSS_PAGES = 2048
WHISPER_PROMPTS = (32, 400)    # + 32 new tokens stay within 448 positions
CROSS_CHECK = dict(n=2, lo=16, hi=64, new=4)   # phase 4c requests
VLM_CHECK_LAYERS = 5           # one pattern period, cross layer at 3
# phase 4b: a router probability gap (k-th minus (k+1)-th expert) below
# this may flip a top-k choice between the card's and the CPU's f32
# summation orders; a diverging token stream is then reported as such
NEAR_TIE = 1e-4
SOURCES = {"paged_prefill_attention":
           "src/repro/kernels/paged_prefill_attention.py:101",
           "paged_decode_attention":
           "src/repro/kernels/paged_decode_attention.py:91",
           "paged_mla_decode_attention":
           "src/repro/kernels/paged_mla_decode_attention.py:92",
           "paged_cross_decode_attention":
           "src/repro/kernels/paged_cross_decode_attention.py:87",
           "chunked_prefill_attention":
           "src/repro/kernels/chunked_prefill_attention.py:95"}
# phase 2d / 5: the dense chunked prefill of 8 requests, a served chunk
# of 512 queries at 512 in caches of max_seq; kv_len ragged: one empty
# request, some ending inside the chunk or before it
DENSE = dict(sq=512, skv=2048, q_offset=512,
             kv_len=(1024, 0, 1000, 777, 600, 513, 300, 1024))
# phase 5: the device body kernels 2 and 4 run (csrc/decode_attention.cuh)
DECODE_BODY = "decode_attention"
# phase 3e / 4d: the Cluster run's instances, and the request it cancels
CLUSTER = dict(n_prefill=2, n_decode=2)
CANCEL = dict(prompt=256, new=256, after=3)
# phases 2e, 3f-3i, 4e, 5: the full-attention configs beside qwen2.
# OPT-13B has 2,048 learned positions (positions past them would clamp),
# so its prompts + 32 new tokens stay below max_seq = 2,048
OPT_ARCH = "opt_13b"
OPT_PROMPTS = (64, 2000)
# Mistral-Nemo with the reference's 4,096-token window, prompts longer
# than it; n_pages holds every prompt of a prefill batch whole (prefill
# materializes a request's pages, then trims them as chunks pass)
NEMO_ARCH = "mistral_nemo_12b"
NEMO_PROMPTS = (4608, 8192)
NEMO_SERVE = dict(max_seq=8192 + 64, n_pages=4608)
# phase 3h: the smaller configs, and DeepSeek-67B at its served() depth
MORE_ARCHS = ("phi4_mini_3_8b", "granite_moe_3b_a800m", "deepseek_67b")
MORE_RUN = dict(n=4, new=16)
# phase 3i / 4e: every second request sampled, with a seed of its own
SAMPLED = dict(temperature=0.8, top_k=20)
# phase 4e: 2-layer f32 card-vs-CPU runs; Mistral-Nemo at a 64-token
# window in 64-token chunks, so tables are trimmed between chunks
SLICE8_CHECK = dict(n=2, lo=16, hi=64, new=4)
NEMO_CHECK = dict(window=64, n=2, lo=100, hi=300, new=8, chunk_size=64)
# phases 3j / 4f: the wall-clock AsyncCluster's instances (each worker on
# a stream of its own) and the open-loop arrivals of phase 3e's traffic
# (the reference serve's default rate); every wait gives up after DRAIN_S
ASYNC = dict(n_prefill=2, n_decode=2, rate=20.0, process="poisson")
DRAIN_S = 300.0
# phases 3k / 4f: shared-prefix traffic for the prefix cache, in waves of
# SCHED_BATCH (the cache serves committed entries only, so the sharing
# shows across waves), one prefill and one decode instance
PREFIX = dict(n=16, max_prompt=1536, max_decode=32, prefix_pool=2,
              prefix_len=1024, prefix_zipf=1.2)
PREFIX_CLUSTER = dict(n_prefill=1, n_decode=1, sched_batch=2)
# phases 3l / 4f: Whisper requests whose encoder inputs are byte-equal
# in GROUPS groups (several users sending one clip), prefilled one at a
# time, so each request not deduped runs the encoder once
DEDUPE = dict(n=8, groups=2)
# phases 2f, 3m, 3n, 3o, 4g, 5: the dense backend.  RecurrentGemma-9B
# whole: chunks of 512 in caches of 4,096; the seeded prompts of 256-4,000
# put 3 of the 8 past its 2,048-token local window.  Phase 2f's kernel-5
# chunks start at RG_CHUNKS.  xLSTM-1.3B whole: 4 slots, each holding
# about 0.7 GB of f32 mLSTM state.
RG_ARCH = "recurrentgemma_9b"
RG_RUN = dict(n=N_REQUESTS, lo=256, hi=4000, new=NEW_TOKENS)
RG_SERVE = dict(chunk_size=512, max_seq=4096, max_slots=8)
RG_CHUNKS = (0, 2048, 3584)
XLSTM_ARCH = "xlstm_1_3b"
XLSTM_RUN = dict(n=4, lo=64, hi=256, new=16)
XLSTM_SERVE = dict(max_seq=512, max_slots=4)
# phase 4g: RecurrentGemma at one pattern period with a 64-token window
# in 64-token chunks (the window bites), xLSTM at its smoke depth
RG_CHECK = dict(window=64, n=2, lo=100, hi=300, new=8, chunk_size=64)
XLSTM_CHECK = dict(n=2, lo=32, hi=96, new=8)
XLSTM_CHECK_CHUNK = 64
# phases 2g, 3p, 3q, 4h, 5: dense MLA and dense cross-attention.  Kernel
# 5's MLA chunks start at MLA_CHUNKS; the 16-head slice holds the split
# at MLA's widths; CoupledEngine's Llama-3.2-Vision prompts reach past
# its 1,600 patches (the longest of the seeded 64-2,000 is 1,711)
MLA_CHUNKS = (0, 512, 1536)
MLA_SLICE_HEADS = 16
COUPLED_PROMPTS = (64, 2000)
# phase 3r: the cost-model runtime's serve_cluster requests a workload,
# and the fleet run's trace and instances
SIM_REQUESTS = 128
FLEET_TRACE = 5000
FLEET_INSTANCES = dict(n_prefill=8, n_decode=4)
COUPLED_LONG = 2000
# phase 4h: f32 dense cross K/V against the paged cross pages (the same
# f32 products on the same card)
CROSS_KV_TOL = 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def limit(exp) -> float:
    """The tolerance of one kernel-vs-plain comparison whose plain output
    is ``exp`` (the kernel's output type)."""
    tol = TOL[str(exp.dtype)]
    if str(exp.dtype) == "torch.bfloat16":
        tol = min(tol, BF16_REL * float(exp.float().abs().max()))
    return tol


def compare(name, got, exp, worst):
    """max |got - exp|, checked against limit(exp); ``worst`` (a dict of
    [largest error, largest error / limit] by name) keeps the case's
    numbers."""
    err, tol = float((got.float() - exp.float()).abs().max()), limit(exp)
    check(err <= tol, f"{name} disagrees with its plain version in "
          f"{exp.dtype}: {err} > {tol}")
    w = worst.setdefault(name, [0.0, 0.0])
    w[0], w[1] = max(w[0], err), max(w[1], err / tol if tol else 0.0)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# requests and the geometry the served run gives the kernels
# ---------------------------------------------------------------------------
def make_requests(vocab: int, n: int = N_REQUESTS, lo: int = PROMPT_RANGE[0],
                  hi: int = PROMPT_RANGE[1], new: int = NEW_TOKENS,
                  enc=None):
    """``n`` greedy requests from SEED; ``enc`` (n, enc_ctx, d), when
    given, holds each request's frontend embeddings."""
    from repro_torch.runtime.request import Request, SamplingParams
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, n)
    return [Request(rid=f"r{i}", prompt_len=int(n_tok), decode_len=new,
                    prompt_tokens=rng.integers(0, vocab, int(n_tok))
                    .astype(np.int32),
                    enc_embeds=None if enc is None else enc[i],
                    sampling=SamplingParams(max_new_tokens=new))
            for i, n_tok in enumerate(lens)]


def prefill_geometry(reqs, chunk_size, page_size, max_seq, n_pages,
                     window=0):
    """The chunks the served prefill engine runs, packed as its
    ``_step_paged`` packs them: its scheduler's order, its allocator's
    tables (with ``window``, trimmed after every chunk: slid-out slots on
    the scratch page), its chunk partition.  Returns a list of numpy
    dicts."""
    from repro_torch.core import chunking
    from repro_torch.core.sched.prefill_scheduler import PrefillScheduler
    from repro_torch.kvcache.paged import PagedAllocator
    sched = PrefillScheduler()
    for r in reqs:
        sched.add(r)
    order = sched.next_batch(sched.sched_batch)
    alloc = PagedAllocator(n_pages=n_pages, page_size=page_size,
                           window=window)
    for r in order:
        alloc.alloc(r.rid, r.prompt_len, materialize_all=True)
    trash, width = n_pages, alloc.pages_for(max_seq)
    out = []
    for chunk in chunking.partition([(r.rid, r.prompt_len) for r in order],
                                    chunk_size):
        segs = chunk.segments
        ns = 1 << max(0, len(segs) - 1).bit_length()
        sq = 1 << max(0, max(s.length for s in segs) - 1).bit_length()
        g = dict(bt=np.full((ns, width), trash, np.int32),
                 kv_len=np.zeros(ns, np.int32), q_off=np.zeros(ns, np.int32),
                 sq=sq)
        for i, s in enumerate(segs):
            table = alloc.table_padded(s.rid, trash)
            g["bt"][i, :len(table)] = table
            g["q_off"][i] = s.req_start
            g["kv_len"][i] = s.req_start + s.length
        out.append(g)
        for s in segs:
            alloc.trim(s.rid, s.req_start + s.length)
    return out


def decode_geometry(reqs, page_size, max_seq, n_pages, max_slots,
                    generated=NEW_TOKENS // 2, empty=0, window=0):
    """The decode slot batch mid-run: every request ``generated`` tokens
    in, the last ``empty`` slots free (lens 0, rows on the scratch page);
    with ``window``, the slots that slid out of it on the scratch page as
    the decode engine's ``append_token`` leaves them."""
    from repro_torch.kvcache.paged import PagedAllocator
    alloc = PagedAllocator(n_pages=n_pages, page_size=page_size,
                           window=window)
    trash, width = n_pages, alloc.pages_for(max_seq)
    bt = np.full((max_slots, width), trash, np.int32)
    lens = np.zeros(max_slots, np.int32)
    for s, r in enumerate(reqs[:max_slots - empty]):
        n = r.prompt_len + generated
        alloc.alloc(r.rid, n - 1)
        alloc.append_token(r.rid)
        table = alloc.table_padded(r.rid, trash)
        bt[s, :len(table)] = table
        lens[s] = n
    return dict(bt=bt, lens=lens)


def edge_geometry(page_size, max_seq, n_pages, max_slots, window=0):
    """A decode slot batch on the edges of the decode body's split of a
    slot's live pages: slot 0 fills its whole table (its pages span
    every split), slot 1 holds 5 tokens (shorter than one share), slot 2
    1,500 (mid-page), slot 3 none (lens 0), the rest ragged.  Every table
    slot past a slot's length, and with ``window`` every slot wholly
    slid out of it, points at the scratch page."""
    rng = np.random.default_rng(SEED + 7)
    trash, width = n_pages, -(-max_seq // page_size)
    lens = np.concatenate([[max_seq, 5, 1500, 0], rng.integers(
        1, max_seq, max_slots - 4)]).astype(np.int32)
    bt = rng.integers(0, n_pages, (max_slots, width)).astype(np.int32)
    for i, n in enumerate(lens):
        bt[i, -(-n // page_size):] = trash
        if window:
            bt[i, :max(0, n - window) // page_size] = trash
    return dict(bt=bt, lens=lens)


def cross_geometry(reqs, cross_ctx, chunk_size, page_size, n_pages,
                   max_slots, empties=(0, 3)):
    """The cross reads of the served run.  Chunks: the prefill engine's
    chunks (its scheduler's order and partition), each segment reading
    its request's read-only cross table with kv_len = cross_ctx and
    q_offset 0; pad segments kv_len 0.  Slot batches: the decode slots,
    each live slot's cross table with lens = cross_ctx, the last ``e``
    slots free for each e in ``empties``.  Returns (chunk dicts, slot
    dicts), in the form of prefill_geometry's and decode_geometry's."""
    from repro_torch.core import chunking
    from repro_torch.core.sched.prefill_scheduler import PrefillScheduler
    from repro_torch.kvcache.paged import PagedAllocator
    sched = PrefillScheduler()
    for r in reqs:
        sched.add(r)
    order = sched.next_batch(sched.sched_batch)
    alloc = PagedAllocator(n_pages=n_pages, page_size=page_size,
                           cross_tokens=cross_ctx)
    for r in order:
        alloc.alloc(r.rid, r.prompt_len, materialize_all=True)
    trash, width = n_pages, alloc.cross_pages_per_request
    chunks = []
    for chunk in chunking.partition([(r.rid, r.prompt_len) for r in order],
                                    chunk_size):
        segs = chunk.segments
        ns = 1 << max(0, len(segs) - 1).bit_length()
        sq = 1 << max(0, max(s.length for s in segs) - 1).bit_length()
        g = dict(bt=np.full((ns, width), trash, np.int32),
                 kv_len=np.zeros(ns, np.int32), q_off=np.zeros(ns, np.int32),
                 sq=sq)
        for i, s in enumerate(segs):
            g["bt"][i] = alloc.cross_table(s.rid)
            g["kv_len"][i] = cross_ctx
        chunks.append(g)
    slots = []
    for e in empties:
        bt = np.full((max_slots, width), trash, np.int32)
        lens = np.zeros(max_slots, np.int32)
        for s, r in enumerate(reqs[:max_slots - e]):
            bt[s] = alloc.cross_table(r.rid)
            lens[s] = cross_ctx
        slots.append(dict(bt=bt, lens=lens))
    return chunks, slots


# ---------------------------------------------------------------------------
# kernel inputs, bounds and library yardsticks
# ---------------------------------------------------------------------------
def random_pools(cfg, n_pages, page, dtype, device, gen, garbage=False):
    """K and V pools of ``n_pages`` random pages and the scratch page
    (index n_pages); with ``garbage`` the scratch page holds 1e4 / -1e4,
    which no kernel may read."""
    import torch
    shape = (n_pages + 1, page, cfg.n_kv_heads, cfg.resolved_head_dim)
    pools = (torch.randn(shape, generator=gen, device=device),
             torch.randn(shape, generator=gen, device=device))
    if garbage:
        pools[0][n_pages], pools[1][n_pages] = 1e4, -1e4
    return tuple(p.to(dtype) for p in pools)


def prefill_args(cfg, g, pools, dtype, device, gen):
    import torch
    ns = g["bt"].shape[0]
    q = torch.randn((ns, g["sq"], cfg.n_heads, cfg.resolved_head_dim),
                    generator=gen, device=device).to(dtype)
    ints = [torch.from_numpy(g[k]).to(device)
            for k in ("bt", "kv_len", "q_off")]
    return (q, *pools, *ints)


def decode_args(cfg, g, pools, dtype, device, gen):
    import torch
    b = g["bt"].shape[0]
    q = torch.randn((b, cfg.n_heads, cfg.resolved_head_dim), generator=gen,
                    device=device).to(dtype)
    return (q, *pools, torch.from_numpy(g["bt"]).to(device),
            torch.from_numpy(g["lens"]).to(device))


def prefill_work(q, k_pool, bt, kv_len, q_off, causal=True, window=0):
    """(bytes, FLOPs) the function needs on these inputs: q read and out
    written once, each live page's K/V read once (with ``window``, from
    the page of the segment's first in-window key), and QK^T + PV for
    each (query head, key) the length mask (and the causal and window
    ones) admits."""
    es = q.element_size()
    segs, sq, h, hd = q.shape
    page, kvh = k_pool.shape[1], k_pool.shape[2]
    kv = kv_len.cpu().numpy().astype(np.int64)
    q0 = q_off.cpu().numpy().astype(np.int64)
    lo = np.maximum(q0 - window + 1, 0) // page if window else 0
    pages = np.maximum(np.minimum(-(-kv // page), bt.shape[1]) - lo,
                       0).sum()
    nbytes = (2 * q.numel() * es + pages * page * kvh * 2 * hd * es
              + 4 * (bt.numel() + 2 * segs))
    q_pos = q0[:, None] + np.arange(sq)[None, :]
    if causal:
        hi = np.minimum(kv[:, None], q_pos + 1)
        first = np.maximum(q_pos - window + 1, 0) if window else 0
        keys = np.maximum(hi - first, 0).sum()
    else:
        keys = (kv * sq).sum()
    return nbytes, int(keys) * h * 4 * hd


def decode_work(q, k_pool, bt, lens, window=0):
    """(bytes, FLOPs): q read and out written once, each live page's K/V
    read once (with ``window``, the pages of the in-window keys), and
    QK^T + PV for each (query head, attended key)."""
    es = q.element_size()
    b, h, hd = q.shape
    page, kvh = k_pool.shape[1], k_pool.shape[2]
    ln = lens.cpu().numpy().astype(np.int64)
    lo = np.maximum(ln - window, 0) if window else np.zeros_like(ln)
    pages = np.maximum(np.minimum(-(-ln // page), bt.shape[1])
                       - lo // page, 0).sum()
    nbytes = (2 * q.numel() * es + pages * page * kvh * 2 * hd * es
              + 4 * (bt.numel() + b))
    return nbytes, int((ln - lo).sum()) * h * 4 * hd


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (float(max(t_bytes, t_ops)),
            "bytes" if t_bytes >= t_ops else "operations")


def dense_kv(k_pool, v_pool, bt, n_keys, rep):
    """Gather each row's first n_keys keys densely, heads expanded to the
    query heads: (b, h, n_keys, hd) for scaled_dot_product_attention."""
    page = k_pool.shape[1]
    slots = bt[:, :-(-n_keys // page)].long()
    b = bt.shape[0]
    k = k_pool[slots].reshape(b, -1, *k_pool.shape[2:])[:, :n_keys]
    v = v_pool[slots].reshape(b, -1, *v_pool.shape[2:])[:, :n_keys]
    return (k.permute(0, 2, 1, 3).repeat_interleave(rep, 1).contiguous(),
            v.permute(0, 2, 1, 3).repeat_interleave(rep, 1).contiguous())


def window_kv(k_pool, v_pool, bt, lo, n_keys, rep):
    """Gather each row's keys lo[i] .. lo[i] + n_keys - 1 (clamped to its
    table) densely, heads expanded to the query heads: (b, h, n_keys,
    hd), and their positions (b, n_keys)."""
    import torch
    page = k_pool.shape[1]
    tok = lo.long()[:, None] + torch.arange(n_keys, device=bt.device)
    tok = tok.clamp(max=bt.shape[1] * page - 1)
    pages = torch.gather(bt.long(), 1, tok // page)
    k, v = k_pool[pages, tok % page], v_pool[pages, tok % page]
    return (k.permute(0, 2, 1, 3).repeat_interleave(rep, 1).contiguous(),
            v.permute(0, 2, 1, 3).repeat_interleave(rep, 1).contiguous(),
            tok)


def sdpa_prefill_call(q, k_pool, v_pool, bt, kv_len, q_off, causal=True,
                      window=0):
    """One library call computing the prefill function on pre-gathered
    dense K/V with an explicit mask (a yardstick: the port never uses
    it); with ``window``, each segment's K/V gathered from its first
    in-window key."""
    import torch
    import torch.nn.functional as F
    segs, sq, h, hd = q.shape
    rep = h // k_pool.shape[2]
    q_pos = q_off.long()[:, None] + torch.arange(sq, device=q.device)
    if window:
        lo = (q_off.long() - window + 1).clamp(min=0)
        n_keys = max(1, int((kv_len.long() - lo).max()))
        k, v, k_pos = window_kv(k_pool, v_pool, bt, lo, n_keys, rep)
        k_pos = k_pos[:, None, :]
    else:
        n_keys = max(1, int(kv_len.max()))
        k, v = dense_kv(k_pool, v_pool, bt, n_keys, rep)
        k_pos = torch.arange(n_keys, device=q.device)[None, None, :]
    mask = k_pos < kv_len.long()[:, None, None]
    if causal:
        mask = mask & (q_pos[:, :, None] >= k_pos)
    if window:
        mask = mask & (k_pos > q_pos[:, :, None] - window)
    mask = mask.expand(segs, sq, n_keys)[:, None]
    qt = q.permute(0, 2, 1, 3).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def sdpa_decode_call(q, k_pool, v_pool, bt, lens, window=0):
    """The decode function as one library call on pre-gathered K/V: each
    slot's first lens keys, or with ``window`` its in-window keys."""
    import torch
    import torch.nn.functional as F
    b, h, hd = q.shape
    rep = h // k_pool.shape[2]
    if window:
        lo = (lens.long() - window).clamp(min=0)
        n_keys = max(1, int((lens.long() - lo).max()))
        k, v, k_pos = window_kv(k_pool, v_pool, bt, lo, n_keys, rep)
        mask = ((k_pos < lens.long()[:, None])
                & (k_pos >= lo[:, None]))[:, None, None]
    else:
        n_keys = max(1, int(lens.max()))
        k, v = dense_kv(k_pool, v_pool, bt, n_keys, rep)
        mask = (torch.arange(n_keys, device=q.device)[None, :]
                < lens.long()[:, None])[:, None, None]
    qt = q[:, :, None]
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def random_latent_pools(cfg, n_pages, page, dtype, device, gen,
                        garbage=False):
    """ckv and kr pools of ``n_pages`` random pages and the scratch page
    (index n_pages); with ``garbage`` the scratch page holds 1e4 / -1e4,
    which the kernel may not read."""
    import torch
    m = cfg.mla
    pools = tuple(torch.randn((n_pages + 1, page, w), generator=gen,
                              device=device)
                  for w in (m.kv_lora_rank, m.qk_rope_head_dim))
    if garbage:
        pools[0][n_pages], pools[1][n_pages] = 1e4, -1e4
    return tuple(p.to(dtype) for p in pools)


def mla_args(cfg, g, pools, device, gen):
    """(q_lat, q_rope, ckv_pool, kr_pool, block_table, lens) as
    ``mla_decode_paged`` passes them: f32 queries (absorbed through
    W_uk), pools in the model's dtype."""
    import torch
    b, h, m = g["bt"].shape[0], cfg.n_heads, cfg.mla
    q_lat = torch.randn((b, h, m.kv_lora_rank), generator=gen, device=device)
    q_rope = torch.randn((b, h, m.qk_rope_head_dim), generator=gen,
                         device=device)
    return (q_lat, q_rope, *pools, torch.from_numpy(g["bt"]).to(device),
            torch.from_numpy(g["lens"]).to(device))


def mla_work(q_lat, q_rope, ckv_pool, kr_pool, bt, lens):
    """(bytes, FLOPs): the queries read and o_lat written once, each live
    latent page ([ckv | kr], 576 values a token at full width) read once,
    and 2 * h * (lora + rope + lora) FLOPs per live (slot, token)."""
    b, h, lora = q_lat.shape
    rope, page = q_rope.shape[2], ckv_pool.shape[1]
    ln = lens.cpu().numpy().astype(np.int64)
    pages = np.minimum(-(-ln // page), bt.shape[1]).sum()
    nbytes = (q_lat.numel() * q_lat.element_size() * 2
              + q_rope.numel() * q_rope.element_size()
              + pages * page * (lora * ckv_pool.element_size()
                                + rope * kr_pool.element_size())
              + 4 * (bt.numel() + b))
    return nbytes, int(ln.sum()) * 2 * h * (2 * lora + rope)


def sdpa_mla_call(q_lat, q_rope, ckv_pool, kr_pool, bt, lens, scale):
    """One library call computing the absorbed MLA decode on the latent
    gathered densely (f32): the h heads are the query rows of one shared
    latent head, k = [ckv | kr], v = ckv, with the length mask."""
    import torch
    import torch.nn.functional as F
    b, h, lora = q_lat.shape
    n_keys = max(1, int(lens.max()))
    page = ckv_pool.shape[1]
    slots = bt[:, :-(-n_keys // page)].long()
    ckv = ckv_pool[slots].reshape(b, -1, lora)[:, :n_keys].float()
    kr = kr_pool[slots].reshape(b, -1, kr_pool.shape[2])[:, :n_keys].float()
    k = torch.cat([ckv, kr], dim=-1)[:, None]            # (b, 1, S, 576)
    v = ckv[:, None].contiguous()                        # (b, 1, S, 512)
    q = torch.cat([q_lat, q_rope], dim=-1)[:, None]      # (b, 1, h, 576)
    mask = (torch.arange(n_keys, device=q.device)[None, :]
            < lens.long()[:, None])[:, None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=scale)


def dense_args(cfg, dtype, device, gen):
    """(q, k_cache, v_cache, kv_len, q_offset) of phase 2d at ``cfg``'s
    attention widths: DENSE's 8 requests, q_offset an int."""
    import torch
    b, sq, skv = len(DENSE["kv_len"]), DENSE["sq"], DENSE["skv"]
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return (randn(b, sq, cfg.n_heads, hd), randn(b, skv, kvh, hd),
            randn(b, skv, kvh, hd),
            torch.tensor(DENSE["kv_len"], dtype=torch.int32, device=device),
            DENSE["q_offset"])


def dense_keys(q, kv_len, q_off, window=0, causal=True):
    """(b, sq) int64 numpy: the keys each row may attend (causal unless
    ``causal`` is false, below kv_len, inside the window)."""
    sq = q.shape[1]
    q_pos = q_off + np.arange(sq)[None, :]
    hi = kv_len.cpu().numpy().astype(np.int64)[:, None]
    if causal:
        hi = np.minimum(hi, q_pos + 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else 0
    return np.broadcast_to(np.maximum(hi - lo, 0), (len(hi), sq))


def dense_work(q, k_cache, v_cache, kv_len, q_off, window=0, causal=True):
    """(bytes, FLOPs) the dense prefill needs on these inputs: q read and
    out written once, each request's K/V read once from the first key
    the chunk's first query may see (the window's start) up to
    min(kv_len, end of the chunk) (non-causal: up to kv_len), and QK^T +
    PV for each (query head, key) the masks admit."""
    es = q.element_size()
    b, sq, h, hd = q.shape
    kvh, hd_v = k_cache.shape[2], v_cache.shape[3]
    lo = max(0, q_off - window + 1) if window else 0
    hi = kv_len.cpu().numpy().astype(np.int64)
    if causal:
        hi = np.minimum(hi, q_off + sq)
    kv = np.maximum(hi - lo, 0)
    nbytes = (q.numel() * es + b * sq * h * hd_v * es
              + int(kv.sum()) * kvh * (hd + hd_v) * es + 4 * b)
    keys = int(dense_keys(q, kv_len, q_off, window, causal).sum())
    return nbytes, keys * h * 2 * (hd + hd_v)


def sdpa_dense_call(q, k_cache, v_cache, kv_len, q_off, window=0,
                    causal=True):
    """One library call computing the dense prefill on the dense caches
    (heads expanded to the query heads) with the boolean causal (unless
    ``causal`` is false) and length mask; with a window, on the keys
    from the first the chunk's first query may see, and the window in
    the mask (a yardstick: the port never uses it)."""
    import torch
    import torch.nn.functional as F
    b, sq, h, hd = q.shape
    lo = max(0, q_off - window + 1) if window else 0
    k_cache, v_cache = k_cache[:, lo:], v_cache[:, lo:]
    skv, rep = k_cache.shape[1], h // k_cache.shape[2]
    k = k_cache.permute(0, 2, 1, 3).repeat_interleave(rep, 1).contiguous()
    v = v_cache.permute(0, 2, 1, 3).repeat_interleave(rep, 1).contiguous()
    k_pos = lo + torch.arange(skv, device=q.device)
    q_pos = q_off + torch.arange(sq, device=q.device)
    mask = k_pos[None, None, :] < kv_len.long()[:, None, None]
    if causal:
        mask = mask & (q_pos[None, :, None] >= k_pos[None, None, :])
    if window:
        mask = mask & (k_pos[None, None, :] > q_pos[None, :, None] - window)
    mask = mask[:, None]
    qt = q.permute(0, 2, 1, 3).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def cuda_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 20) -> float:
    """The host's µs a call to issue ``reps`` calls of ``fn`` without
    waiting for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def profiler_us(fn, reps: int = 20) -> float:
    """The card's kernel µs a call of ``fn`` by the profiler (every launch
    of a call summed), 0 when the session recorded no kernel.  A profiler
    session can slow later launches on the host, so host times are taken
    before the first one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / reps


def queued_us(fn, reps: int = 20) -> float:
    """The card's µs a call of ``fn`` by CUDA events around ``reps`` calls
    queued behind a spin kernel: the card starts the first call only once
    the host has issued them all, so the host's launch gaps stay out."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def device_us(fn, reps: int = 20, tries: int = 3) -> tuple[float, str]:
    """The card's µs a call of ``fn`` and how it was read: by the profiler
    (``profiler_us``), whose session now and then records no kernel at
    all, so an empty one is taken again, up to ``tries`` sessions; after
    that by ``queued_us`` ("events")."""
    for _ in range(tries):
        us = profiler_us(fn, reps)
        if us > 0:
            return us, "profiler"
    return queued_us(fn, reps), "events"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def check_kernels(cfg, reqs, device, tag="2", windows=(0, WINDOW),
                  serve_kw=None, trimmed=False):
    """Phase 2 (2a, 2e): kernels 1 and 2 vs their plain versions on the
    served shapes at ``cfg``'s attention widths, the scratch page full of
    garbage; kernel 2 also on ``edge_geometry``'s batch for each window.
    ``serve_kw`` overrides SERVE's page size, max_seq, n_pages and
    chunk size.  With ``trimmed`` each window's shapes are its own served
    run's: the tables the windowed engines leave, slid-out slots on the
    scratch page.  Returns ({kernel: max abs error in bf16, the served
    dtype}, the prefill chunk geometries, the decode slot geometries; of
    the last window when ``trimmed``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention)
    opts = dict(SERVE, **(serve_kw or {}))
    kw = {k: opts[k] for k in ("page_size", "max_seq", "n_pages")}

    def geometry(window):
        return (prefill_geometry(reqs, opts["chunk_size"], window=window,
                                 **kw),
                [decode_geometry(reqs, max_slots=opts["max_slots"],
                                 empty=e, window=window, **kw)
                 for e in (0, 3)])
    geo = {w: geometry(w if trimmed else 0) for w in windows}
    chunks, slot_cases = geo[windows[-1]]
    gen = torch.Generator(device=device).manual_seed(SEED)
    pre, dec = "paged_prefill_attention", "paged_decode_attention"
    for dtype in (torch.float32, torch.bfloat16):
        pools = random_pools(cfg, opts["n_pages"], opts["page_size"],
                             dtype, device, gen, garbage=True)
        worst = {}
        for window in windows:
            chunks, slot_cases = geo[window]
            edge = edge_geometry(max_slots=opts["max_slots"],
                                 window=window, **kw)
            for g in chunks:
                args = prefill_args(cfg, g, pools, dtype, device, gen)
                got = paged_prefill_attention(*args, window=window)
                exp = ref.paged_prefill_attention(*args, window=window)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), "prefill: non-finite")
                compare(pre, got, exp, worst)
            for g in slot_cases + [edge]:
                args = decode_args(cfg, g, pools, dtype, device, gen)
                got = paged_decode_attention(*args, window=window)
                exp = ref.paged_decode_attention(*args, window=window)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), "decode: non-finite")
                empty = g["lens"] == 0
                check(float(got[torch.from_numpy(empty).to(device)]
                            .float().abs().sum()) == 0.0,
                      "decode: an empty slot did not give zeros")
                compare(dec, got, exp, worst)
        for name, (err, share) in worst.items():
            n = (f"{len(chunks)} served shapes" if name == pre else
                 f"{len(slot_cases)} served shapes + the edge batch")
            print(f"phase {tag}: {name} vs plain, {cfg.name}, {dtype}, "
                  f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                  f"{cfg.resolved_head_dim}, {n} x window "
                  f"{'/'.join(map(str, windows))}: max abs err {err:.3e}, "
                  f"at most {share:.3f} of a case's limit (limit())")
    return {k: v[0] for k, v in worst.items()}, chunks, slot_cases


def check_mla_kernel(cfg, reqs, device):
    """Phase 2b: the MLA decode kernel vs its plain version at the
    DeepSeek-V2 served decode shapes: f32 queries against f32 and bf16
    latent pools whose scratch page holds garbage, window 0 and WINDOW,
    the full and partly empty slot batches and ``edge_geometry``'s batch;
    each case's error and share of the limit printed.  Returns (max abs
    error of the bf16-pool cases, the served slot geometries)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_mla_decode_attention import (
        paged_mla_decode_attention)
    from repro_torch.models.attention import mla_scale
    kw = {k: SERVE[k] for k in ("page_size", "max_seq", "n_pages")}
    slot_cases = [decode_geometry(reqs, max_slots=SERVE["max_slots"],
                                  empty=e, **kw) for e in (0, 3)]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    tol = TOL["torch.float32"]               # o_lat takes q_lat's f32
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        pools = random_latent_pools(cfg, SERVE["n_pages"],
                                    SERVE["page_size"], dtype, device, gen,
                                    garbage=True)
        err = 0.0
        for window in (0, WINDOW):
            edge = edge_geometry(max_slots=SERVE["max_slots"],
                                 window=window, **kw)
            named = [("served", slot_cases[0]),
                     ("served, 3 empty", slot_cases[1]), ("edge", edge)]
            for case, g in named:
                args = mla_args(cfg, g, pools, device, gen)
                kwa = dict(scale=mla_scale(cfg), window=window)
                got = paged_mla_decode_attention(*args, **kwa)
                exp = ref.paged_mla_decode_attention(*args, **kwa)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), "mla: non-finite")
                empty = torch.from_numpy(g["lens"] == 0).to(device)
                check(float(got[empty].abs().sum()) == 0.0,
                      "mla: an empty slot did not give zeros")
                e = float((got - exp).abs().max())
                print(f"phase 2b: paged_mla_decode_attention vs plain, f32 "
                      f"queries, {dtype} pools, {case} slot batch, window "
                      f"{window}: max abs err {e:.3e}, {e / tol:.3f} of the "
                      f"limit {tol:g}")
                check(e <= tol, f"paged_mla_decode_attention disagrees "
                      f"with its plain version on {dtype} pools, {case} "
                      f"batch, window {window}: {e} > {tol}")
                err = max(err, e)
        worst = err
    return worst, slot_cases


def check_cross_kernels(cfg, reqs, device):
    """Phase 2c: the cross reads vs their plain versions at ``cfg``'s
    served shapes, f32 and bf16: the cross decode kernel on the decode
    slot batch (full, and with 3 empty slots, which must give exactly 0)
    and the prefill kernel with causal=False on every chunk's cross read
    (kv_len = enc_ctx, q_offset 0, pad segments at kv_len 0), the
    scratch page full of garbage; the cross decode kernel also on an edge
    batch: the full one with its last live slot cut to 5 tokens (shorter
    than one share, its other table slots on the scratch page) and slot 1
    empty.  Returns
    ({kernel: max abs error in bf16}, the cross chunk geometries, the
    cross slot geometries)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_cross_decode_attention import (
        paged_cross_decode_attention)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention)
    chunks, slot_cases = cross_geometry(
        reqs, cfg.cross_ctx, SERVE["chunk_size"], SERVE["page_size"],
        CROSS_PAGES, SERVE["max_slots"])
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    pre, dec = ("paged_prefill_attention (causal=False)",
                "paged_cross_decode_attention")
    for dtype in (torch.float32, torch.bfloat16):
        pools = random_pools(cfg, CROSS_PAGES, SERVE["page_size"], dtype,
                             device, gen, garbage=True)
        worst = {}
        for g in chunks:
            args = prefill_args(cfg, g, pools, dtype, device, gen)
            got = paged_prefill_attention(*args, causal=False)
            exp = ref.paged_prefill_attention(*args, causal=False)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "cross prefill: "
                  "non-finite")
            pad = torch.from_numpy(g["kv_len"] == 0).to(device)
            check(float(got[pad].float().abs().sum()) == 0.0,
                  "cross prefill: a pad segment did not give zeros")
            compare(pre, got, exp, worst)
        edge = {k: v.copy() for k, v in slot_cases[0].items()}
        edge["lens"][1] = 0
        edge["bt"][1] = CROSS_PAGES
        edge["lens"][-1] = 5
        edge["bt"][-1, 1:] = CROSS_PAGES
        for g in slot_cases + [edge]:
            args = decode_args(cfg, g, pools, dtype, device, gen)
            got = paged_cross_decode_attention(*args)
            exp = ref.paged_cross_decode_attention(*args)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "cross decode: "
                  "non-finite")
            empty = torch.from_numpy(g["lens"] == 0).to(device)
            check(float(got[empty].float().abs().sum()) == 0.0,
                  "cross decode: an empty slot did not give zeros")
            compare(dec, got, exp, worst)
        for name, (err, share) in worst.items():
            n = (f"{len(chunks)} served shapes" if name == pre else
                 f"{len(slot_cases)} served shapes + the edge batch")
            print(f"phase 2c: {name} vs plain, {cfg.name}, {dtype}, "
                  f"{cfg.cross_ctx} encoder tokens, {n}: max abs err "
                  f"{err:.3e}, at most {share:.3f} of a case's limit "
                  "(limit())")
    return {k: v[0] for k, v in worst.items()}, chunks, slot_cases


def check_dense_kernel(configs, device, kernels):
    """Phase 2d: kernel 5 at DENSE's shapes and each of ``configs``'
    attention widths, f32 and bf16, causal with window 0 and WINDOW.
    First its path: every launch counter at 0, the dense entry
    ``ops.prefill_attention`` (no block table) called once a case, the
    counters read.  Then each output against the plain version (rows
    without an attendable key exactly 0), and in f32 against kernel 1
    on the same K/V laid out as pages, request by request, in f32 and
    bf16 (bf16: within the bf16 limit).  Every bf16 launch of the path
    must run the tensor-core body and no f32 one.  Returns (launches of
    the path by kernel, max abs error in bf16)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    cases = [(cfg, dtype, window) for cfg in configs
             for dtype in (torch.float32, torch.bfloat16)
             for window in (0, WINDOW)]
    inputs = {(cfg.name, dtype): dense_args(cfg, dtype, device, gen)
              for cfg, dtype, _ in cases}
    zero_launches(kernels)
    outs = [ops.prefill_attention(
        *inputs[cfg.name, dtype][:4], torch.tensor([DENSE["q_offset"]]),
        window=window) for cfg, dtype, window in cases]
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    n_bf16 = sum(dtype == torch.bfloat16 for _, dtype, _ in cases)
    check(launches["chunked_prefill_attention"] == len(cases)
          and sum(launches[name] for name in kernels) == len(cases)
          and launches["chunked_prefill_attention (tensor cores)"]
          == n_bf16, f"phase 2d: the dense entry launched {launches}, "
          f"expected {len(cases)} launches of kernel 5 alone, the "
          f"{n_bf16} bf16 ones on the tensor-core body")
    name, page = "chunked_prefill_attention", SERVE["page_size"]
    bf16_err = 0.0
    for (cfg, dtype, window), got in zip(cases, outs):
        q, k, v, kv_len, q_off = args = inputs[cfg.name, dtype]
        exp = ref.chunked_prefill_attention(*args, window=window)
        check(bool(torch.isfinite(got).all()), "dense prefill: non-finite")
        dead = torch.from_numpy(dense_keys(q, kv_len, q_off, window)
                                == 0).to(device)
        check(bool(dead.any()) and float(got[dead].float().abs().sum())
              == 0.0, "dense prefill: a row without keys is not 0 (or "
              "the case has no such row)")
        worst = {}
        compare(name, got, exp, worst)
        err, share = worst[name]
        line = (f"phase 2d: {name} vs plain, {cfg.name}, {dtype}, "
                f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
                f"{cfg.resolved_head_dim}, window {window}: max abs err "
                f"{err:.3e}, {share:.3f} of the limit (limit()), "
                f"{int(dead.sum())} rows without keys exactly 0")
        if dtype == torch.bfloat16:
            bf16_err = max(bf16_err, err)
        # kernel 1 on the same K/V as pages: request i's cache is pages
        # [i * skv / page, (i + 1) * skv / page)
        b, skv = k.shape[:2]
        n_slots = skv // page
        bt = torch.arange(b * n_slots, dtype=torch.int32,
                          device=device).reshape(b, n_slots)
        paged = paged_prefill_attention(
            q, k.reshape(b * n_slots, page, *k.shape[2:]),
            v.reshape(b * n_slots, page, *v.shape[2:]), bt, kv_len,
            torch.full((b,), q_off, dtype=torch.int32, device=device),
            window=window)
        perr = float((paged.float() - got.float()).abs().max())
        check(perr <= limit(exp), f"phase 2d: kernel 5 and kernel 1 on "
              f"pages differ by {perr} in {dtype}")
        line += f"; vs kernel 1 on pages {perr:.3e}"
        print(line)
    return launches, bf16_err


class TieRecorder:
    """Records, per model call (prefill chunk or decode iteration), the
    smallest router margin (k-th minus (k+1)-th expert probability over
    every token the MoE routes, pad tokens and dead slots included: they
    take capacity too) and the smallest top-2 logit gap over the rows
    with tokens.  Wraps ``mlp.moe_forward``, ``model.prefill_paged`` and
    ``model.decode_logits_paged`` while active."""

    def __init__(self):
        self.calls = []
        self._router = []

    def __enter__(self):
        import torch
        from repro_torch.models import mlp as MLP
        from repro_torch.models import model as M
        self._saved = (MLP.moe_forward, M.prefill_paged,
                       M.decode_logits_paged)
        moe_forward, prefill_paged, decode_logits = self._saved

        def gap(logits, rows):
            top = torch.topk(logits[rows].float(), 2, dim=-1).values
            return float((top[:, 0] - top[:, 1]).min())

        def moe(p, cfg, x, *a, **kw):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p["router"].float(), dim=-1)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
            self._router.append(float((top[:, -2] - top[:, -1]).min()))
            return moe_forward(p, cfg, x, *a, **kw)

        def prefill(params, cfg, tokens, q_offset, kv_len, *a, **kw):
            nxt, logits = prefill_paged(params, cfg, tokens, q_offset,
                                        kv_len, *a, **kw)
            self._note(gap(logits, kv_len > 0))
            return nxt, logits

        def decode(params, cfg, tokens, pos, pages, offs, bt, lens, *a):
            logits = decode_logits(params, cfg, tokens, pos, pages, offs, bt,
                                   lens, *a)
            self._note(gap(logits, lens > 0))
            return logits
        MLP.moe_forward, M.prefill_paged, M.decode_logits_paged = (
            moe, prefill, decode)
        return self

    def _note(self, logit_gap):
        self.calls.append(dict(router=min(self._router, default=1.0),
                               logit=logit_gap))
        self._router = []

    def __exit__(self, *exc):
        from repro_torch.models import mlp as MLP
        from repro_torch.models import model as M
        MLP.moe_forward, M.prefill_paged, M.decode_logits_paged = self._saved


def serve(cfg, params, reqs, device, time_it=False, watch=None, **over):
    """Drive the port's engines over ``reqs`` with the SERVE settings
    (``over`` replaces any of them); ``watch(pk)`` sees each prefilled
    payload and ``watch(de)`` the decode engine after each admission.
    Returns (tokens by rid, prefill engine, decode engine, prefill
    seconds, decode seconds)."""
    import torch
    from repro_torch.core.decode_engine import DecodeEngine
    from repro_torch.core.prefill_engine import PrefillEngine
    from repro_torch.core.sched.prefill_scheduler import PrefillScheduler
    opts = dict(SERVE, prefix_cache=False, sched_batch=None, backend="auto")
    opts.update({k: v for k, v in over.items() if v is not None})
    # the default scheduler unless the caller sets its batch (sjf)
    pe = PrefillEngine("p0", cfg, params, device=device,
                       scheduler=None if opts["sched_batch"] is None
                       else PrefillScheduler("sjf", opts["sched_batch"]),
                       chunk_size=opts["chunk_size"],
                       max_seq=opts["max_seq"], n_pages=opts["n_pages"],
                       page_size=opts["page_size"],
                       prefix_cache=opts["prefix_cache"],
                       backend=opts["backend"])
    de = DecodeEngine("d0", cfg, params, device=device,
                      max_slots=opts["max_slots"], max_seq=opts["max_seq"],
                      n_pages=opts["n_pages"], page_size=opts["page_size"],
                      prefix_cache=opts["prefix_cache"],
                      backend=opts["backend"])
    for r in reqs:
        pe.submit(r)
    out, t, t_pre, t_dec = {}, 0.0, 0.0, 0.0
    sync = torch.cuda.synchronize if time_it else (lambda: None)
    for _ in range(100_000):
        sync()
        t0 = time.perf_counter()
        done = pe.step(t)
        sync()
        t1 = time.perf_counter()
        for pk in done:
            if watch is not None:
                watch(pk)
            de.receive(pk, now=t)
        de.admit(t)
        if watch is not None:
            watch(de)
        for f in de.step(t):
            out[f.req.rid] = f.tokens
        sync()
        t2 = time.perf_counter()
        t_pre += t1 - t0
        t_dec += t2 - t1
        t += 0.01
        if pe.idle() and de.idle():
            break
    return out, pe, de, t_pre, t_dec


class FirstLogits:
    """Records, while active, the logits of the first prefill call, on
    the CPU: ``model.prefill_paged``'s rows of segments with tokens, or
    the last position's of ``model.prefill`` (the dense backend)."""

    def __enter__(self):
        from repro_torch.models import model as M
        self._saved = M.prefill_paged, M.prefill
        self.logits = None
        paged, dense = self._saved

        def prefill(params, cfg, tokens, q_offset, kv_len, *a, **kw):
            nxt, logits = paged(params, cfg, tokens, q_offset, kv_len, *a,
                                **kw)
            if self.logits is None:
                self.logits = logits[kv_len > 0].float().cpu()
            return nxt, logits

        def prefill_dense(*a, **kw):
            logits, cache = dense(*a, **kw)
            if self.logits is None:
                self.logits = logits[:, -1].float().cpu()
            return logits, cache
        M.prefill_paged, M.prefill = prefill, prefill_dense
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        M.prefill_paged, M.prefill = self._saved


def to_device(tree, device):
    """A params dict (nested dicts and lists of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return tree.numel()


def zero_launches(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0
        for extra in ("noncausal_launches", "tensor_core_launches"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)


# the kernels with a tensor-core body for bf16 and a CUDA-core one for f32
# (kernel 3's dtype is its pools')
TC_KERNELS = ("paged_prefill_attention", "chunked_prefill_attention",
              "paged_mla_decode_attention")


def read_launches(kernels):
    """The launch counters by kernel; the non-causal launches of kernels
    1 and 5 under ``<name> (causal=False)`` and the tensor-core launches
    of kernels 1, 5 and 3 under ``<name> (tensor cores)``."""
    launches = {name: fn.launches for name, fn in kernels.items()}
    for name in ("paged_prefill_attention", "chunked_prefill_attention"):
        launches[f"{name} (causal=False)"] = kernels[name].noncausal_launches
    for name in TC_KERNELS:
        launches[f"{name} (tensor cores)"] = kernels[name].tensor_core_launches
    return launches


def check_bodies(tag, launches, dtype, f32_reads=0):
    """Every launch of kernels 1, 5 and 3 ran the tensor-core body in
    bf16 and the CUDA-core body in f32.  ``f32_reads``: launches of
    kernel 5 on f32 inputs in a bf16 run (the dense cross read of a
    request's first chunk attends the unrounded f32 cross K/V), which
    take the CUDA-core body."""
    for name in TC_KERNELS:
        tc = launches[f"{name} (tensor cores)"]
        want = launches[name] if dtype == "bfloat16" else 0
        if name == "chunked_prefill_attention" and dtype == "bfloat16":
            want -= f32_reads
        check(tc == want, f"phase {tag}: {name} launched {launches[name]} "
              f"times, {tc} on the tensor-core body, in {dtype}")


def serve_phase(tag, cfg, params, device, kernels, card,
                prompts=PROMPT_RANGE, enc=None, n=N_REQUESTS,
                new=NEW_TOKENS, watch=None, stats=None, hooks=(),
                f32_reads=0, **over):
    """Phase 3/3b-3d/3f-3h/3m/3n: warm up, then serve ``n`` requests of
    ``new`` tokens (tokens drawn in ``cfg``'s vocabulary, prompt lengths
    in ``prompts``, frontend embeddings ``enc``; ``over`` replaces SERVE
    settings, ``watch`` as in serve) with every launch counter set to 0
    (and every one of ``hooks`` reset) just before and read just after.
    Checks the run (every bf16 launch of kernels 1, 5 and 3 on the
    tensor-core body, but for ``f32_reads`` of kernel 5 as
    ``check_bodies`` says; no page held on the paged backend) and prints its
    numbers; ``stats``, a dict, takes the tokens by rid and the prefill
    and decode seconds.  Returns (launches by kernel as
    ``read_launches`` gives them, prefill engine, decode engine)."""
    reqs = make_requests(cfg.vocab_size, n=n, lo=prompts[0], hi=prompts[1],
                         new=new, enc=enc)
    warm = make_requests(cfg.vocab_size, n=1, lo=64, hi=64, new=2)
    # warm-up: libraries, cuBLAS
    serve(cfg, params, warm, device, **over)
    zero_launches(kernels)
    for hook in hooks:
        hook.reset()
    out, pe, de, t_pre, t_dec = serve(cfg, params, reqs, device,
                                      time_it=True, watch=watch, **over)
    launches = read_launches(kernels)
    check_bodies(tag, launches, cfg.dtype, f32_reads)
    check(len(out) == len(reqs), f"{len(out)} of {len(reqs)} finished")
    for rid, toks in out.items():
        check(len(toks) == new, f"{rid}: {len(toks)} tokens")
        check(all(0 <= x < cfg.vocab_size for x in toks), f"{rid}: token "
              "out of the vocabulary")
    dense = pe.backend == "dense"
    check(de.alloc.used_pages == 0 and (dense or pe.alloc.used_pages == 0),
          f"pages left: decode {de.alloc.used_pages}")
    n_prompt = sum(r.prompt_len for r in reqs)
    n_decoded = sum(len(t) - 1 for t in out.values())
    calls = (f"{pe.chunk_steps} dense prefill chunks" if dense
             else f"{pe.fused_calls} fused prefill calls")
    print(f"phase {tag}: served {len(out)} requests, {calls}, "
          f"{de.iterations} decode iterations, launches {launches}, "
          f"pages left 0/0")
    print(f"phase {tag}: prefill {n_prompt} tokens in {t_pre:.3f} s = "
          f"{n_prompt / t_pre:.1f} tokens/s; decode {n_decoded} tokens in "
          f"{t_dec:.3f} s = {n_decoded / t_dec:.1f} tokens/s ({card})")
    if stats is not None:
        stats.update(out=out, t_pre=t_pre, t_dec=t_dec, n_prompt=n_prompt,
                     n_decoded=n_decoded)
    return launches, pe, de


def deepseek_vs_cpu(device):
    """Phase 4b: DeepSeek-V2 at full width, 2 layers (dense prefix + 1
    routed), f32, weights drawn on the card and copied to the CPU; the
    same 2 short requests served on both; first-chunk logits within
    LOGIT_TOL, token streams identical unless a routing near-tie or a
    near-tied argmax explains the divergence (printed as such).  Then
    phase 4h on the same weights (``dense_vs_paged``)."""
    import torch
    from repro_torch.configs.deepseek_v2_236b import served
    from repro_torch.models import model as M
    cfg = dataclasses.replace(served(2), dtype="float32")
    t0 = time.perf_counter()
    gpu_params = M.init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED + 4), device)
    cpu_params = to_device(gpu_params, "cpu")
    reqs = make_requests(cfg.vocab_size, **DS_CHECK)
    runs = []
    for dev, params in ((device, gpu_params), ("cpu", cpu_params)):
        with TieRecorder() as rec, FirstLogits() as first:
            out, pe, _, _, _ = serve(cfg, params, make_requests(
                cfg.vocab_size, **DS_CHECK), dev)
        check(pe.fused_calls == 1, "phase 4b: the prompts took more than "
              "one chunk")
        runs.append((out, rec.calls, first.logits))
    (out_gpu, calls_gpu, lg_gpu), (out_cpu, calls_cpu, lg_cpu) = runs
    lerr = float((lg_gpu - lg_cpu).abs().max())
    check(lerr <= LOGIT_TOL, f"phase 4b: first-chunk logits differ by {lerr}")
    check(set(out_gpu) == set(out_cpu) == {r.rid for r in reqs},
          "phase 4b: not every request finished")
    # call j of a run emitted token j of every request (one prefill chunk,
    # then one token per decode iteration)
    diverge = [min(j for j, (a, b) in enumerate(zip(out_gpu[rid],
                                                    out_cpu[rid])) if a != b)
               for rid in out_gpu if out_gpu[rid] != out_cpu[rid]]
    router = min(c["router"] for c in calls_gpu + calls_cpu)
    print(f"phase 4b: smallest router margin {router:.3e}, smallest top-2 "
          f"logit gap {min(c['logit'] for c in calls_cpu):.3e}")
    if diverge:
        j = min(diverge)
        margin = min(c["router"] for c in calls_gpu[:j + 1]
                     + calls_cpu[:j + 1])
        gap = min(calls_gpu[j]["logit"], calls_cpu[j]["logit"])
        tie = margin < NEAR_TIE or gap < LOGIT_TOL
        print(f"phase 4b: token streams DIFFER from token {j} on: router "
              f"margin {margin:.3e} up to that call, top-2 logit gap "
              f"{gap:.3e} there: "
              + ("traced to a near-tie" if tie else "NOT a near-tie"))
        check(tie, "phase 4b: device and CPU streams differ without a "
              "near-tie")
    else:
        print(f"phase 4b: {len(out_gpu)} token streams identical")
    print(f"phase 4b: DeepSeek-V2 2-layer f32 device vs CPU: first-chunk "
          f"logits max abs err {lerr:.3e} (tolerance {LOGIT_TOL:g}), "
          f"{time.perf_counter() - t0:.1f} s")
    # phase 4h: the same weights and requests on the dense backend
    dense_vs_paged("DeepSeek-V2 at 2 layers", cfg, gpu_params, cpu_params,
                   lambda: make_requests(cfg.vocab_size, **DS_CHECK),
                   out_gpu, device, coupled=True)


def cross_serve_phase(tag, cfg, device, kernels, card, prompts):
    """Phase 3c/3d: ``cfg`` in bf16 with random weights from SEED and
    every request's stub frontend embeddings, served through the
    engines.  Besides serve_phase's checks: kernel 4 launched
    n_cross_layers x iterations times, kernel 1 non-causally
    n_cross_layers x fused calls times (and causally n_layers x fused
    calls), the encoder ran on some chunks and not all, and the wire
    carried the self pages plus each request's one-shot cross pages.
    Returns the launches by kernel."""
    import torch
    from repro_torch.core.backend import backend_for
    from repro_torch.core.kv_transfer import kv_page_bytes
    from repro_torch.models import model as M
    from repro_torch.models.frontends import fake_frontend
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(SEED), device)
    enc = fake_frontend(cfg, N_REQUESTS, torch.Generator(device=device)
                        .manual_seed(SEED + 1), device)
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"phase {tag}: {cfg.name}, {cfg.n_layers} layers "
          f"({cfg.n_cross_layers} with cross-attention), full width, "
          f"{n_params / 1e9:.2f} G parameters in bf16, {cfg.cross_ctx} "
          f"encoder tokens a request, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    launches, pe, de = serve_phase(tag, cfg, params, device, kernels, card,
                                   prompts=prompts, enc=enc,
                                   n_pages=CROSS_PAGES)
    nc, fused, iters = cfg.n_cross_layers, pe.fused_calls, de.iterations
    check(launches["paged_cross_decode_attention"] == nc * iters > 0,
          f"cross decode launches {launches} != {nc} x {iters} iterations")
    check(launches["paged_prefill_attention (causal=False)"] == nc * fused
          and launches["paged_prefill_attention"]
          == (cfg.n_layers + nc) * fused, f"prefill launches {launches}: "
          f"expected {nc} non-causal and {cfg.n_layers} causal x {fused} "
          "fused calls")
    check(launches["paged_decode_attention"] == cfg.n_layers * iters,
          f"decode launches {launches} != {cfg.n_layers} x {iters}")
    check(0 < pe.encoder_calls <= fused, f"{pe.encoder_calls} encoder "
          f"calls in {fused} fused calls")
    reqs = make_requests(cfg.vocab_size, lo=prompts[0], hi=prompts[1])
    ps = SERVE["page_size"]
    spec = backend_for(cfg)
    cross_wire = (kv_page_bytes(cfg, 1, ps, enc_len=cfg.cross_ctx)
                  - kv_page_bytes(cfg, 1, ps))
    self_wire = sum(kv_page_bytes(cfg, r.prompt_len, ps) for r in reqs)
    check(pe.network.bytes_sent == self_wire + len(reqs) * cross_wire,
          f"{pe.network.bytes_sent} wire bytes, expected {self_wire} + "
          f"{len(reqs)} x {cross_wire}")
    gathered = (cfg.n_layers * -(-cfg.cross_ctx // ps) * ps
                * spec.page_token_bytes)
    print(f"phase {tag}: {pe.encoder_calls} of {fused} fused calls ran the "
          f"encoder work; cross wire bytes a request {cross_wire} "
          f"({nc} cross layers), cross pages gathered on the device a "
          f"request {gathered} (all {cfg.n_layers} pool layers)")
    del params, pe, de
    torch.cuda.empty_cache()
    return launches


def cross_vs_cpu(cfg, device):
    """Phase 4c: ``cfg`` in f32, weights drawn on the card and copied to
    the CPU; the same CROSS_CHECK requests with the same frontend
    embeddings served on both; identical token streams and first-chunk
    logits within LOGIT_TOL.  Then phase 4h on the same weights and
    inputs (``dense_vs_paged``, the cross pages of the card's paged run
    against the dense ck / cv)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.frontends import fake_frontend
    cfg = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    gpu_params = M.init_params(
        cfg, torch.Generator(device=device).manual_seed(SEED + 6), device)
    cpu_params = to_device(gpu_params, "cpu")
    enc = fake_frontend(cfg, CROSS_CHECK["n"], torch.Generator(
        device=device).manual_seed(SEED + 7), device).cpu()
    runs, payloads = [], {}

    def watch(x):
        if hasattr(x, "first_token"):        # a prefilled payload
            payloads[x.req.rid] = x
    for i, (dev, params) in enumerate(((device, gpu_params),
                                       ("cpu", cpu_params))):
        with FirstLogits() as rec:
            out, pe, _, _, _ = serve(cfg, params, make_requests(
                cfg.vocab_size, enc=enc, **CROSS_CHECK), dev, n_pages=512,
                watch=None if i else watch)
        check(pe.fused_calls == 1 and pe.encoder_calls == 1,
              f"phase 4c: {pe.fused_calls} fused calls, "
              f"{pe.encoder_calls} with encoder work, expected 1 and 1")
        runs.append((out, rec.logits))
    (out_gpu, lg_gpu), (out_cpu, lg_cpu) = runs
    lerr = float((lg_gpu - lg_cpu).abs().max())
    check(len(out_gpu) == CROSS_CHECK["n"], "phase 4c: not every request "
          "finished")
    check(out_gpu == out_cpu, f"phase 4c: {cfg.name}: device and CPU runs "
          "emit different tokens")
    check(lerr <= LOGIT_TOL, f"phase 4c: {cfg.name}: first-chunk logits "
          f"differ by {lerr}")
    print(f"phase 4c: {cfg.name} ({cfg.n_layers} layers) f32 device vs "
          f"CPU: {len(out_gpu)} token streams identical, first-chunk "
          f"logits max abs err {lerr:.3e} (tolerance {LOGIT_TOL:g}), "
          f"{time.perf_counter() - t0:.1f} s")
    # phase 4h: the same weights, requests and embeddings, dense backend
    dense_vs_paged(f"{cfg.name} ({cfg.n_layers} layers)", cfg, gpu_params,
                   cpu_params, lambda: make_requests(
                       cfg.vocab_size, enc=enc, **CROSS_CHECK),
                   out_gpu, device, payloads)


def cluster_run(cfg, params, device, kernels=None):
    """Phases 3e / 4d: the N_REQUESTS requests (32 new tokens each)
    through ``Cluster(runtime="engine")`` with CLUSTER's instances and
    the SERVE settings, plus one request of CANCEL["new"] new tokens
    cancelled after its CANCEL["after"]th streamed token; every other
    handle streamed to its end.  Checks the run; returns (cluster, a
    record of what must not depend on the device: per request the
    phase, streamed and result tokens, virtual timestamps and its
    prefill / decode instance), and, with ``kernels``, the launches by
    kernel of the run (counters set to 0 just before it)."""
    from repro_torch.core.kv_transfer import kv_page_bytes
    from repro_torch.runtime.request import Phase
    from repro_torch.serving import Cluster, SamplingParams
    reqs = make_requests(cfg.vocab_size)
    rng = np.random.default_rng(SEED + 9)
    long_prompt = rng.integers(0, cfg.vocab_size,
                               CANCEL["prompt"]).astype(np.int32)
    cl = Cluster(cfg, runtime="engine", params=params, device=device,
                 chunk_size=SERVE["chunk_size"],
                 page_size=SERVE["page_size"], max_seq=SERVE["max_seq"],
                 n_pages=SERVE["n_pages"], max_batch=SERVE["max_slots"],
                 **CLUSTER)
    free0 = [(i.pe.alloc.free_pages, i.de.alloc.free_pages)
             for i in cl.instances]
    if kernels is not None:
        zero_launches(kernels)
    handles = [cl.submit(r.prompt_tokens, sampling=SamplingParams(
        max_new_tokens=NEW_TOKENS)) for r in reqs]
    long_h = cl.submit(long_prompt, sampling=SamplingParams(
        max_new_tokens=CANCEL["new"]))
    stream = iter(long_h)
    first = [next(stream) for _ in range(CANCEL["after"])]
    check(long_h.cancel(), "phase 3e: the long request was already done")
    streamed = {h.rid: list(h) for h in handles}
    cl.run()
    launches = None
    if kernels is not None:
        launches = read_launches(kernels)
    check(long_h.result().phase == Phase.CANCELLED
          and long_h.result().tokens == first and list(stream) == [],
          f"phase 3e: the cancelled request streamed "
          f"{long_h.result().tokens} after {first}")
    for h in handles:
        res = h.result()
        check(res.phase == Phase.FINISHED and len(res.tokens) == NEW_TOKENS,
              f"{h.rid}: {res.phase}, {len(res.tokens)} tokens")
        check(streamed[h.rid] == res.tokens, f"{h.rid}: streamed tokens "
              "differ from result().tokens")
    check([(i.pe.alloc.free_pages, i.de.alloc.free_pages)
           for i in cl.instances] == free0, "phase 3e: pages not freed")
    check(sum(1 for i in cl.instances if i.pe.chunk_steps) == 2
          and sum(1 for i in cl.instances if i.de.iterations) == 2,
          "phase 3e: the work did not spread over 2 prefill and 2 decode "
          "instances")
    ps = SERVE["page_size"]
    wire = sum(kv_page_bytes(cfg, len(h.request.prompt_tokens), ps)
               for h in handles + [long_h])
    check(cl.network.bytes_sent == wire, f"phase 3e: {cl.network.bytes_sent}"
          f" bytes sent, expected {wire}")
    record = {}
    for h in handles + [long_h]:
        r = h.result()
        e = cl.gsched.table[h.rid]
        record[h.rid] = (r.phase.value, streamed.get(h.rid, first), r.tokens,
                         r.arrival, r.t_prefill_start, r.t_first_token,
                         r.t_transfer_done, r.t_decode_start, r.t_finish,
                         e.prefill_iid, e.decode_iid)
    return cl, record, launches


def cluster_phase(cfg, params, device, kernels, card):
    """Phase 3e: cluster_run on the card with full-width ``cfg``;
    kernels 1 and 2 launched, 3, 4 and 5 not, every bf16 launch of
    kernel 1 on the tensor-core body.  Prints virtual mean TTFT / JCT,
    wall tokens/s over each role's ``busy`` and the wire bytes."""
    import torch
    cl, record, launches = cluster_run(cfg, params, device, kernels)
    check_bodies("3e", launches, cfg.dtype)
    check(launches["paged_prefill_attention"] > 0
          and launches["paged_decode_attention"] > 0
          and launches["paged_mla_decode_attention"] == 0
          and launches["paged_cross_decode_attention"] == 0
          and launches["chunked_prefill_attention"] == 0,
          f"phase 3e: launches {launches}")
    res = cl.result()
    m = res.metrics
    prompt = sum(len(h.prompt_tokens) for h in cl._reqs.values())
    decoded = sum(len(rec[2]) - 1 for rec in record.values())
    print(f"phase 3e: Cluster(runtime=\"engine\"), {cfg.name} "
          f"{cfg.dtype}, "
          f"{len(cl.instances)} instances "
          f"({CLUSTER['n_prefill']} prefill + {CLUSTER['n_decode']} "
          f"decode): {m['n']} finished with {NEW_TOKENS} tokens, 1 "
          f"cancelled after {CANCEL['after']}; launches {launches}; "
          f"chunks {[i.pe.chunk_steps for i in cl.instances]}, decode "
          f"iterations {[i.de.iterations for i in cl.instances]}; pages "
          f"all freed; {cl.network.bytes_sent} bytes sent")
    print(f"phase 3e: virtual mean TTFT {m['avg_ttft']:.3f} s, JCT "
          f"{m['avg_jct']:.3f} s; wall: prefill {prompt} tokens in "
          f"{res.prefill_busy:.3f} s busy = {prompt / res.prefill_busy:.1f} "
          f"tokens/s, decode {decoded} tokens in {res.decode_busy:.3f} s "
          f"busy = {decoded / res.decode_busy:.1f} tokens/s ({card})")
    del cl
    torch.cuda.empty_cache()
    return launches, record


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def async_run(cfg, params, device, kernels=None):
    """Phases 3j / 4f: phase 3e's N_REQUESTS requests through the
    wall-clock ``AsyncCluster`` with ASYNC's instances (SERVE settings),
    submitted by ``OpenLoopClient`` at ASYNC's Poisson arrivals from
    SEED, plus CANCEL's request, submitted first and cancelled after its
    CANCEL["after"]th streamed token.  Checks the run: every request
    terminal, the others' tokens, no page held, ``worker_errors`` empty,
    on the card four distinct non-default streams.  Returns (cluster,
    handles of the N_REQUESTS requests in order, wall seconds, and with
    ``kernels`` the launches by kernel, counters set to 0 just before)."""
    from repro_torch.runtime.request import Phase
    from repro_torch.serving import (ArrivalSchedule, AsyncCluster,
                                     OpenLoopClient, SamplingParams)
    reqs = make_requests(cfg.vocab_size)
    rng = np.random.default_rng(SEED + 9)
    long_prompt = rng.integers(0, cfg.vocab_size,
                               CANCEL["prompt"]).astype(np.int32)
    sched = ArrivalSchedule(process=ASYNC["process"], rate=ASYNC["rate"],
                            seed=SEED)
    ac = AsyncCluster(cfg, params=params, device=device,
                      n_prefill=ASYNC["n_prefill"],
                      n_decode=ASYNC["n_decode"],
                      chunk_size=SERVE["chunk_size"],
                      page_size=SERVE["page_size"],
                      max_seq=SERVE["max_seq"], n_pages=SERVE["n_pages"],
                      max_batch=SERVE["max_slots"])
    try:
        if ac.device.type == "cuda":
            raw = {i.stream.cuda_stream for i in ac.instances}
            check(len(raw) == len(ac.instances) and 0 not in raw,
                  f"async run: instance streams {raw} not distinct and "
                  "off the default stream")
        if kernels is not None:
            zero_launches(kernels)
        t0 = time.perf_counter()
        long_h = ac.submit(long_prompt, sampling=SamplingParams(
            max_new_tokens=CANCEL["new"]))
        client = OpenLoopClient(ac, reqs, sched).start()
        deadline = time.monotonic() + DRAIN_S
        while (len(long_h.tokens_so_far()) < CANCEL["after"]
               and not long_h.done() and time.monotonic() < deadline):
            time.sleep(0.0005)
        check(long_h.cancel(), "async run: the long request ended before "
              f"its cancel ({long_h.request.phase})")
        client.join(timeout=DRAIN_S)
        check(client.submitted == len(reqs), f"async run: the client "
              f"submitted {client.submitted} of {len(reqs)}")
        check(ac.drain(timeout=DRAIN_S), "async run: drain timed out")
        wall = time.perf_counter() - t0
        launches = read_launches(kernels) if kernels is not None else None
        check(ac.worker_errors == [], "async run: worker errors:\n"
              + "\n".join(ac.worker_errors))
        res = long_h.result(wait=False)
        n_cancel = len(res.tokens)
        check(res.phase == Phase.CANCELLED and n_cancel >= CANCEL["after"]
              and ac.drain(timeout=5)
              and len(long_h.tokens_so_far()) == n_cancel,
              f"async run: the cancelled request is {res.phase} with "
              f"{n_cancel} tokens")
        handles = client.handles
        for h in handles:
            r = h.result(wait=False)
            check(r.phase == Phase.FINISHED and len(r.tokens) == NEW_TOKENS,
                  f"async run: {h.rid}: {r.phase}, {len(r.tokens)} tokens")
        for i in ac.instances:
            for a in (i.pe.alloc, i.de.alloc):
                check(a.free_pages == a.n_pages, f"async run: {i.iid} "
                      f"holds {a.n_pages - a.free_pages} pages")
    finally:
        ac.close()
    return ac, handles, wall, launches


def async_phase(cfg, params, device, kernels, card, record):
    """Phase 3j: async_run on the card with full-width ``cfg`` (after a
    short warm-up run that readies each stream); kernels 1 and 2
    launched, 3, 4 and 5 not, every bf16 launch of kernel 1 on the
    tensor-core body.  Prints wall TTFT and JCT (p50, p99), the wall
    seconds, the overlap share (the instances' summed ``busy`` seconds
    over the wall seconds: above 1 where steps overlapped) and how many
    streams equal phase 3e's (``record``; printed, not checked: bf16
    chunk compositions differ)."""
    import torch
    from repro_torch.serving import AsyncCluster
    warm = make_requests(cfg.vocab_size, n=4, lo=64, hi=64, new=2)
    with AsyncCluster(cfg, params=params, device=device,
                      n_prefill=ASYNC["n_prefill"],
                      n_decode=ASYNC["n_decode"],
                      chunk_size=SERVE["chunk_size"],
                      page_size=SERVE["page_size"],
                      max_seq=SERVE["max_seq"], n_pages=SERVE["n_pages"],
                      max_batch=SERVE["max_slots"]) as ac:
        for r in warm:
            ac.submit(request=r)
        check(ac.drain(timeout=DRAIN_S) and ac.worker_errors == [],
              "phase 3j: the warm-up run failed")
    ac, handles, wall, launches = async_run(cfg, params, device, kernels)
    check_bodies("3j", launches, cfg.dtype)
    check(launches["paged_prefill_attention"] > 0
          and launches["paged_decode_attention"] > 0
          and launches["paged_mla_decode_attention"] == 0
          and launches["paged_cross_decode_attention"] == 0
          and launches["chunked_prefill_attention"] == 0,
          f"phase 3j: launches {launches}")
    rs = [h.result(wait=False) for h in handles]
    ttft = [r.t_first_token - r.arrival for r in rs]
    jct = [r.t_finish - r.arrival for r in rs]
    busy = {i.iid: i.busy for i in ac.instances}
    overlap = sum(busy.values()) / wall
    same = sum(r.tokens == record[f"req{i:05d}"][2]
               for i, r in enumerate(rs))
    print(f"phase 3j: AsyncCluster, {cfg.name} {cfg.dtype}, "
          f"{ASYNC['n_prefill']} prefill + {ASYNC['n_decode']} decode "
          f"instances on 4 streams, open-loop {ASYNC['process']} at "
          f"{ASYNC['rate']} req/s: {len(rs)} finished with {NEW_TOKENS} "
          f"tokens, 1 cancelled after {CANCEL['after']}; launches "
          f"{launches}; pages all freed; no worker error")
    print(f"phase 3j: wall TTFT p50 {percentile(ttft, 50):.4f} s p99 "
          f"{percentile(ttft, 99):.4f} s, JCT p50 {percentile(jct, 50):.4f}"
          f" s p99 {percentile(jct, 99):.4f} s; wall {wall:.3f} s; busy "
          f"{', '.join(f'{k} {v:.3f}' for k, v in busy.items())} s; "
          f"overlap share {overlap:.3f}; {same} of {len(rs)} streams equal "
          f"phase 3e's ({card})")
    del ac
    torch.cuda.empty_cache()
    return launches


def device_activity(prof):
    """The card's activity a profiler session recorded (kernels, copies,
    sets): {stream: [(start ns, end ns), ...]}."""
    from torch.autograd import DeviceType
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            by.setdefault(e.device_resource_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return by


def overlap_stats(by):
    """From device_activity: the span from the first start to the last
    end, the busy time (the union of the intervals), the time two or more
    intervals ran at once, and the summed interval time, in seconds."""
    evs = [iv for ivs in by.values() for iv in ivs]
    points = sorted([(a, 1) for a, _ in evs] + [(b, -1) for _, b in evs])
    active, last, busy, multi = 0, points[0][0], 0, 0
    for t, d in points:
        busy += (t - last) * (active > 0)
        multi += (t - last) * (active > 1)
        active, last = active + d, t
    span = max(b for _, b in evs) - min(a for a, _ in evs)
    return (span * 1e-9, busy * 1e-9, multi * 1e-9,
            sum(b - a for a, b in evs) * 1e-9)


def async_trace_phase(cfg, device, card):
    """Phase 3j's traced run, after phase 5's timings (a profiler session
    can slow later host launches): async_run again on fresh full-width
    weights under ``torch.profiler`` (CUDA activity only).  Prints the
    card's busy share of the traced span (its idle share is the rest),
    the share of the busy time in which two or more streams ran at once,
    and the busy time of each stream.  Not a check: a session may record
    nothing, and then says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(SEED), device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, wall, _ = async_run(cfg, params, device)
        torch.cuda.synchronize()
    by = device_activity(prof)
    if not by:
        print(f"phase 3j (traced): the profiler recorded no device "
              f"activity: device idle share not measured ({card})")
        return
    span, busy, multi, total = overlap_stats(by)
    streams = sorted(((sum(b - a for a, b in ivs) * 1e-9, sid)
                      for sid, ivs in by.items()), reverse=True)
    print(f"phase 3j (traced): wall {wall:.3f} s under the profiler; "
          f"device activity on {len(by)} streams over a span of "
          f"{span:.3f} s: busy {busy:.3f} s = {busy / span:.3f} of the "
          f"span (idle share {1 - busy / span:.3f}), two or more streams "
          f"at once {multi:.3f} s = {multi / busy:.3f} of the busy time, "
          f"summed activity {total:.3f} s; by stream "
          f"{', '.join(f'{sid}: {t:.3f}' for t, sid in streams)} s "
          f"({card})")
    del params
    torch.cuda.empty_cache()


def prefix_requests(vocab):
    from repro_torch.runtime.workload import generate
    return generate("Mixed", PREFIX["n"], seed=SEED,
                    max_prompt=PREFIX["max_prompt"],
                    max_decode=PREFIX["max_decode"], vocab_size=vocab,
                    prefix_pool=PREFIX["prefix_pool"],
                    prefix_len=PREFIX["prefix_len"],
                    prefix_zipf=PREFIX["prefix_zipf"])


def prefix_run(cfg, params, device, flag, wall_clock, kernels=None):
    """Phases 3k / 4f: PREFIX's traffic through ``Cluster`` (or, with
    ``wall_clock``, ``AsyncCluster``) with PREFIX_CLUSTER's instances,
    the SERVE settings and ``prefix_cache=flag``.  Checks that every
    request finished and that every page is free or held by a cache
    entry.  Returns (tokens by rid, stats, launches by kernel when
    ``kernels``)."""
    from repro_torch.runtime.request import Phase
    from repro_torch.serving import AsyncCluster, Cluster
    kw = dict(params=params, device=device, chunk_size=SERVE["chunk_size"],
              page_size=SERVE["page_size"], max_seq=SERVE["max_seq"],
              n_pages=SERVE["n_pages"], max_batch=SERVE["max_slots"],
              prefix_cache=flag, **PREFIX_CLUSTER)
    reqs = prefix_requests(cfg.vocab_size)
    tag = f"{'AsyncCluster' if wall_clock else 'Cluster'}, cache " \
          f"{'on' if flag else 'off'}"
    if kernels is not None:
        zero_launches(kernels)
    if wall_clock:
        c = AsyncCluster(cfg, **kw)
        try:
            hs = [c.submit(request=r) for r in reqs]
            check(c.drain(timeout=DRAIN_S), f"{tag}: drain timed out")
            check(c.worker_errors == [], f"{tag}: worker errors:\n"
                  + "\n".join(c.worker_errors))
        finally:
            c.close()
        results = [h.result(wait=False) for h in hs]
    else:
        c = Cluster(cfg, runtime="engine", **kw)
        hs = [c.submit(request=r) for r in reqs]
        c.run()
        results = [h.result() for h in hs]
    launches = read_launches(kernels) if kernels is not None else None
    check(all(r.phase == Phase.FINISHED for r in results),
          f"{tag}: not every request finished")
    for i in c.instances:
        for a in (i.pe.alloc, i.de.alloc):
            check(a.free_pages + len(a.cache_pages()) == a.n_pages
                  and not a._tables, f"{tag}: {i.iid} leaks pages")
    pes = [i.pe for i in c.instances]
    res = c.result()
    stats = dict(
        hits=sum(p.alloc.cache_hits for p in pes),
        lookups=sum(p.alloc.cache_lookups for p in pes),
        decode_hits=sum(i.de.alloc.cache_hits for i in c.instances),
        fused=sum(p.fused_calls for p in pes),
        sent=c.network.bytes_sent, saved=c.network.bytes_saved,
        prefill_s=res.prefill_busy, prompt=sum(r.prompt_len for r in reqs))
    return {r.rid: r.tokens for r in results}, stats, launches


def prefix_phase(cfg, params, device, kernels, card):
    """Phase 3k: prefix_run on the card with full-width ``cfg`` through
    both runtimes, the cache on and off: with it, cache hits, fewer fused
    calls and kernel-1 launches, bytes saved and fewer bytes sent.
    Prints the prefill wall seconds (the prefill instances' ``busy``)
    with and without the cache, the hit rate, and how many streams agree
    between cache on and off (printed, not checked: bf16)."""
    for wall_clock in (False, True):
        runs = {}
        for flag in (True, False):
            runs[flag] = prefix_run(cfg, params, device, flag, wall_clock,
                                    kernels)
        (t_on, on, l_on), (t_off, off, l_off) = runs[True], runs[False]
        name = "AsyncCluster" if wall_clock else "Cluster"
        check_bodies("3k", l_on, cfg.dtype)
        k1 = "paged_prefill_attention"
        check(on["hits"] > 0
              and on["fused"] < off["fused"] and l_on[k1] < l_off[k1]
              and on["saved"] > 0 and on["sent"] < off["sent"],
              f"phase 3k: {name}: cache on {on}, launches {l_on}; off "
              f"{off}, launches {l_off}")
        same = sum(t_on[r] == t_off[r] for r in t_on)
        print(f"phase 3k: {name}(prefix_cache=True), {cfg.name} "
              f"{cfg.dtype}, {PREFIX['n']} requests ({PREFIX['prefix_pool']}"
              f" shared prefixes of {PREFIX['prefix_len']}, waves of "
              f"{PREFIX_CLUSTER['sched_batch']}): hit rate {on['hits']}/"
              f"{on['lookups']} = {on['hits'] / on['lookups']:.3f} prefix "
              f"pages, {on['decode_hits']} decode-side hits; fused calls "
              f"{on['fused']} vs {off['fused']} off, kernel-1 launches "
              f"{l_on[k1]} vs {l_off[k1]}; wire {on['sent']} bytes vs "
              f"{off['sent']} ({on['saved']} saved); prefill busy "
              f"{on['prefill_s']:.3f} s vs {off['prefill_s']:.3f} s for "
              f"{on['prompt']} prompt tokens; {same} of {len(t_on)} "
              f"streams equal cache-off's ({card})")


def dedupe_requests(cfg, device):
    """DEDUPE's Whisper requests: stub frontend embeddings from SEED + 13,
    byte-equal within each of DEDUPE["groups"] groups, kept on the host
    (the cache hashes them)."""
    import torch
    from repro_torch.models.frontends import fake_frontend
    clips = fake_frontend(cfg, DEDUPE["groups"], torch.Generator(
        device=device).manual_seed(SEED + 13), device).float().cpu().numpy()
    enc = np.stack([clips[i % DEDUPE["groups"]]
                    for i in range(DEDUPE["n"])])
    return make_requests(cfg.vocab_size, n=DEDUPE["n"],
                         lo=WHISPER_PROMPTS[0], hi=WHISPER_PROMPTS[1],
                         enc=enc)


def dedupe_run(cfg, params, device, flag):
    """Phases 3l / 4f: DEDUPE's requests through the engines (prefilled
    one at a time, the cache ``flag``): checks every request finished and
    no page leaked; returns (tokens by rid, prefill engine, decode
    engine, the most decode slots that read one set of cross pages at
    once)."""
    shared = [0]

    def watch(x):
        if hasattr(x, "slots"):
            groups = {}
            for st in x.slots.values():
                key = tuple(x.alloc.cross_table(st.req.rid))
                groups[key] = groups.get(key, 0) + 1
            shared[0] = max([shared[0], *groups.values()])
    out, pe, de, _, _ = serve(cfg, params, dedupe_requests(cfg, device),
                              device, watch=watch, prefix_cache=flag,
                              sched_batch=1, n_pages=CROSS_PAGES)
    check(len(out) == DEDUPE["n"] and all(
        len(t) == NEW_TOKENS for t in out.values()),
        "dedupe run: not every request finished with its tokens")
    for a in (pe.alloc, de.alloc):
        check(a.free_pages + len(a.cache_pages()) == a.n_pages
              and not a._tables, "dedupe run: pages leaked")
    return out, pe, de, shared[0]


def dedupe_phase(cfg, device, kernels, card):
    """Phase 3l: Whisper-tiny whole in bf16, the prefix cache on:
    DEDUPE's requests run the encoder once per group, every other
    request aliases its group's cross pages, and at least two decode
    slots read the same cross pages through kernel 4."""
    import torch
    from repro_torch.models import model as M
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(SEED), device)
    zero_launches(kernels)
    out, pe, de, shared = dedupe_run(cfg, params, device, True)
    launches = read_launches(kernels)
    aliased = pe.alloc.cross_hits
    check(pe.encoder_calls < DEDUPE["n"]
          and pe.encoder_calls == DEDUPE["n"] - aliased,
          f"phase 3l: {pe.encoder_calls} encoder calls, {aliased} requests "
          "aliased their cross pages")
    check(shared >= 2 and launches["paged_cross_decode_attention"] > 0,
          f"phase 3l: at most {shared} decode slots shared cross pages; "
          f"launches {launches}")
    print(f"phase 3l: {cfg.name} bf16, prefix cache on, {DEDUPE['n']} "
          f"requests in {DEDUPE['groups']} groups of one encoder input: "
          f"{pe.encoder_calls} encoder calls, {aliased} requests aliased "
          f"their cross pages at prefill, {de.alloc.cross_hits} at decode, "
          f"up to {shared} decode slots on one set of cross pages; "
          f"{pe.network.bytes_saved} wire bytes saved; launches "
          f"{launches}; pages all back ({card})")
    del params, pe, de
    torch.cuda.empty_cache()


def async_vs_cpu(cfg2, gpu_params, device, cpu_record):
    """Phase 4f (i): async_run at 2 layers f32 on the card: every
    uncancelled request's stream equals the port's sync Cluster on the
    CPU (phase 4d's ``cpu_record``)."""
    t0 = time.perf_counter()
    _, handles, wall, _ = async_run(cfg2, gpu_params, device)
    for i, h in enumerate(handles):
        want = cpu_record[f"req{i:05d}"][2]
        check(h.result(wait=False).tokens == want, f"phase 4f: {h.rid}: "
              "the card's AsyncCluster and the CPU's Cluster differ")
    print(f"phase 4f (i): AsyncCluster on the card (4 streams, open-loop "
          f"arrivals) vs Cluster on the CPU, 2-layer f32: {len(handles)} "
          f"token streams identical, {time.perf_counter() - t0:.1f} s")


def prefix_vs_cpu(cfg2, gpu_params, cpu_params, device):
    """Phase 4f (ii): PREFIX's traffic at 2 layers f32: the Cluster with
    the cache on the card streams the tokens of the cache-off Cluster on
    the CPU, and the cache-on prefill payloads on the card agree with the
    cache-off ones within TOL on every prompt row."""
    import torch
    from repro_torch.core.prefill_engine import PrefillEngine
    from repro_torch.core.sched.prefill_scheduler import PrefillScheduler
    t0 = time.perf_counter()
    on, stats, _ = prefix_run(cfg2, gpu_params, device, True, False)
    off, _, _ = prefix_run(cfg2, cpu_params, "cpu", False, False)
    check(stats["hits"] > 0 and on == off, "phase 4f: the cache-on "
          "Cluster on the card and the cache-off one on the CPU differ")
    payloads = []
    for flag in (True, False):
        pe = PrefillEngine("p0", cfg2, gpu_params, device=device,
                           scheduler=PrefillScheduler(
                               "sjf", PREFIX_CLUSTER["sched_batch"]),
                           chunk_size=SERVE["chunk_size"],
                           max_seq=SERVE["max_seq"],
                           n_pages=SERVE["n_pages"],
                           page_size=SERVE["page_size"], prefix_cache=flag)
        for r in prefix_requests(cfg2.vocab_size):
            pe.submit(r)
        got = {}
        for _ in range(10_000):
            for pk in pe.step(0.0):
                got[pk.req.rid] = pk
            if pe.idle():
                break
        payloads.append(got)
    torch.cuda.synchronize()
    worst, cached = 0.0, 0
    for rid, pk in payloads[0].items():
        pk0 = payloads[1][rid]
        check(pk.first_token == pk0.first_token, f"phase 4f: {rid}: first "
              "token differs with the cache on")
        cached += pk.cached_tokens
        # the prompt's rows: a last page's rows past the prompt hold
        # whatever the page held before, and the two runs reuse pages in
        # different orders
        n = pk.req.prompt_len
        for a, b in ((pk.pages_k, pk0.pages_k), (pk.pages_v, pk0.pages_v)):
            d = a.flatten(1, 2)[:, :n] - b.flatten(1, 2)[:, :n]
            worst = max(worst, float(d.abs().max()))
    tol = TOL["torch.float32"]
    check(cached > 0 and worst <= tol, f"phase 4f: cache-on payloads "
          f"differ from cache-off by {worst} ({cached} cached tokens)")
    print(f"phase 4f (ii): {PREFIX['n']} shared-prefix requests, 2-layer "
          f"f32: Cluster with the cache on the card ({stats['hits']} hits) "
          f"and without it on the CPU: streams identical; cache-on "
          f"payloads on the card ({cached} cached tokens) within "
          f"{worst:.3e} of cache-off (tolerance {tol:g}), "
          f"{time.perf_counter() - t0:.1f} s")


def dedupe_vs_off(cfg, device):
    """Phase 4f (iii): DEDUPE's traffic on Whisper-tiny whole in f32 on
    the card, the cache on against the cache off: identical streams."""
    import torch
    from repro_torch.models import model as M
    cfg = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(SEED + 14), device)
    (on, pe, _, shared), (off, pe0, _, _) = (
        dedupe_run(cfg, params, device, flag) for flag in (True, False))
    check(on == off and pe.encoder_calls < pe0.encoder_calls,
          "phase 4f: Whisper with the cache on and off differ")
    print(f"phase 4f (iii): {cfg.name} whole, f32, cross pages deduped "
          f"({pe.encoder_calls} vs {pe0.encoder_calls} encoder calls, up "
          f"to {shared} slots on one set) vs not: {len(on)} streams "
          f"identical, {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()


def slice8_configs():
    """The runs of phases 2e and 3f-3h, each config as it is served
    (OPT-13B whole, Mistral-Nemo whole with its window, Phi-4-mini and
    Granite whole, DeepSeek-67B at ``served()``'s depth): dicts of the
    config, its requests' ``run`` (make_requests' n, lo, hi, new), the
    SERVE overrides ``over``, and the kernel check's ``windows`` and
    ``trimmed``."""
    from repro_torch.configs import get_config
    from repro_torch.configs import deepseek_67b, mistral_nemo_12b
    nemo = mistral_nemo_12b.windowed()
    full = dict(n=N_REQUESTS, new=NEW_TOKENS)
    out = [dict(cfg=get_config(OPT_ARCH), over={}, windows=(0, WINDOW),
                trimmed=False, run=dict(full, lo=OPT_PROMPTS[0],
                                        hi=OPT_PROMPTS[1])),
           dict(cfg=nemo, over=NEMO_SERVE, windows=(0, nemo.sliding_window),
                trimmed=True, run=dict(full, lo=NEMO_PROMPTS[0],
                                       hi=NEMO_PROMPTS[1]))]
    for arch in MORE_ARCHS:
        cfg = (deepseek_67b.served() if arch == "deepseek_67b"
               else get_config(arch))
        out.append(dict(cfg=cfg, over={}, windows=(0, WINDOW),
                        trimmed=False,
                        run=dict(MORE_RUN, lo=PROMPT_RANGE[0],
                                 hi=PROMPT_RANGE[1])))
    return out


def check_slice8_kernels(device):
    """Phase 2e: kernels 1 and 2 vs their plain versions, f32 and bf16,
    at the served shapes of OPT-13B (40/40 heads of 128, rep 1),
    Mistral-Nemo (32/8 of 128, rep 4, window 0 and its 4,096 on the
    windowed run's trimmed tables), Phi-4-mini (24/8 of 128, rep 3),
    Granite (24/8 of 64, rep 3) and DeepSeek-67B (64/8 of 128, rep 8),
    with the garbage scratch page and the edge slot batch.  Returns
    ({kernel: max abs error in bf16}, {config name: (prefill chunks,
    decode slot batches)})."""
    errs, geo = {}, {}
    for run in slice8_configs():
        cfg = run["cfg"]
        worst, *geo[cfg.name] = check_kernels(
            cfg, make_requests(cfg.vocab_size, **run["run"]), device,
            tag="2e", windows=run["windows"], serve_kw=run["over"],
            trimmed=run["trimmed"])
        for name, err in worst.items():
            errs[name] = max(errs.get(name, 0.0), err)
    return errs, geo


def full_attention_phase(tag, run, device, kernels, card, watch=None,
                         then=None, stats=None):
    """Phases 3f-3h: ``run["cfg"]`` (one of slice8_configs) in bf16 with
    random weights from SEED, served through the engines over its
    requests (SERVE overridden by its ``over``).  Besides serve_phase's
    checks: kernel 1
    launched n_layers x fused calls times, kernel 2 n_layers x
    iterations, kernels 3-5 never; the wire carried Σ kv_page_bytes of
    the prompts (windowed for a windowed config).  ``then(params,
    tokens by rid)`` runs once the engines are freed, before the
    weights are.  ``stats``, a dict, takes serve_phase's stats, the
    parameter count, the fused calls and the decode iterations.  Returns
    (launches, wire bytes)."""
    import torch
    from repro_torch.core.kv_transfer import kv_page_bytes
    from repro_torch.models import model as M
    cfg, rq = run["cfg"], run["run"]
    reqs = make_requests(cfg.vocab_size, **rq)
    max_seq = dict(SERVE, **run["over"])["max_seq"]
    check(rq["hi"] + rq["new"] < max_seq and (
        not cfg.n_positions or max_seq <= cfg.n_positions),
        f"phase {tag}: prompts up to {rq['hi']} + {rq['new']} new tokens "
        f"in max_seq {max_seq}, {cfg.n_positions} learned positions")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(SEED), device)
    torch.cuda.synchronize()
    lens = [r.prompt_len for r in reqs]
    print(f"phase {tag}: {cfg.name}, {cfg.n_layers} layers, full width "
          f"(d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, window "
          f"{cfg.sliding_window}), {count_params(params) / 1e9:.2f} G "
          f"parameters in bf16, drawn in {time.perf_counter() - t0:.1f} s; "
          f"{len(reqs)} requests of {reqs[0].decode_len} new tokens, "
          f"prompts {lens}")
    stats = {} if stats is None else stats
    launches, pe, de = serve_phase(
        tag, cfg, params, device, kernels, card,
        prompts=(rq["lo"], rq["hi"]), n=rq["n"], new=rq["new"],
        watch=watch, stats=stats, **run["over"])
    nl, fused, iters = cfg.n_layers, pe.fused_calls, de.iterations
    stats.update(n_params=count_params(params), fused=fused,
                 iterations=iters)
    check(launches["paged_prefill_attention"] == nl * fused > 0
          and launches["paged_decode_attention"] == nl * iters > 0
          and launches["paged_mla_decode_attention"] == 0
          and launches["paged_cross_decode_attention"] == 0
          and launches["chunked_prefill_attention"] == 0,
          f"phase {tag}: launches {launches}, {fused} fused calls, {iters} "
          "iterations")
    ps = SERVE["page_size"]
    wire = sum(kv_page_bytes(cfg, r.prompt_len, ps) for r in reqs)
    check(pe.network.bytes_sent == wire, f"phase {tag}: "
          f"{pe.network.bytes_sent} bytes sent, expected {wire}")
    del pe, de
    torch.cuda.empty_cache()
    if then is not None:
        then(params, stats["out"])
    del params
    torch.cuda.empty_cache()
    return launches, wire


def windowed_phase(run, device, kernels, card):
    """Phase 3g: Mistral-Nemo whole with its window: full_attention_phase
    plus the window's own checks: every payload and every decoding slot
    holds at most pages_for(window) + 1 pages, and the windowed wire
    bytes are below the unwindowed sum."""
    from repro_torch.core.decode_engine import DecodeEngine
    from repro_torch.core.kv_transfer import kv_page_bytes
    cfg = run["cfg"]
    reqs = make_requests(cfg.vocab_size, **run["run"])
    w, ps = cfg.sliding_window, SERVE["page_size"]
    bound = -(-w // ps) + 1
    held = {"payload": 0, "decoding": 0}

    def watch(x):
        if isinstance(x, DecodeEngine):
            for st in x.slots.values():
                held["decoding"] = max(held["decoding"],
                                       x.alloc.pages_held(st.req.rid))
        else:
            held["payload"] = max(held["payload"], x.pages_k.shape[1])
    _, wire = full_attention_phase("3g", run, device, kernels, card, watch)
    full = sum(kv_page_bytes(dataclasses.replace(cfg, sliding_window=0),
                             r.prompt_len, ps) for r in reqs)
    check(0 < held["payload"] <= bound and 0 < held["decoding"] <= bound,
          f"phase 3g: pages held {held}, bound pages_for({w}) + 1 = "
          f"{bound}")
    check(wire < full, f"phase 3g: windowed wire {wire} >= unwindowed "
          f"{full}")
    print(f"phase 3g: at most {held['payload']} pages shipped and "
          f"{held['decoding']} held by a decoding slot (bound {bound}); "
          f"wire {wire} bytes against {full} unwindowed "
          f"({wire / full:.3f})")


def sampled_requests(vocab, greedy_only=False):
    """make_requests' requests, every second one sampled (SAMPLED, seed
    SEED + 100 + i) unless ``greedy_only``."""
    from repro_torch.runtime.request import SamplingParams
    reqs = make_requests(vocab)
    if not greedy_only:
        for i, r in enumerate(reqs):
            if i % 2:
                r.sampling = SamplingParams(max_new_tokens=NEW_TOKENS,
                                            seed=SEED + 100 + i, **SAMPLED)
    return reqs


def sampling_phase(cfg, params, device, card):
    """Phase 3i: full-width ``cfg`` (bf16), the N_REQUESTS requests with
    every second one sampled: two mixed runs give the same streams, the
    greedy requests those of an all-greedy run of the same requests,
    and some sampled stream parts from greedy.  Mixed and all-greedy
    runs alternate, two each, for their decode seconds."""
    import torch
    from repro_torch.models.model import sample_tokens
    runs = []
    for greedy_only in (False, True, False, True):
        out, _, _, _, t_dec = serve(cfg, params, sampled_requests(
            cfg.vocab_size, greedy_only=greedy_only), device, time_it=True)
        check(len(out) == N_REQUESTS and all(
            len(t) == NEW_TOKENS for t in out.values()), "phase 3i: not "
            "every request finished with its tokens")
        runs.append((out, t_dec))
    (mixed, t_mixed), (pure, t_pure), (again, t_again), (pure2, t_pure2) = \
        runs
    check(pure == pure2, "phase 3i: two all-greedy runs differ")
    rids = sorted(mixed, key=lambda r: int(r[1:]))
    greedy = [r for i, r in enumerate(rids) if i % 2 == 0]
    sampled = [r for i, r in enumerate(rids) if i % 2]
    check(mixed == again, "phase 3i: two mixed runs differ")
    check(all(mixed[r] == pure[r] for r in greedy), "phase 3i: a greedy "
          "request's tokens changed beside sampled ones")
    parted = sum(mixed[r] != pure[r] for r in sampled)
    check(parted > 0, "phase 3i: no sampled stream parts from greedy")
    # one selection step alone, at the decode batch and the vocabulary:
    # sample_tokens on half-sampled lanes against the greedy argmax
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    ms = SERVE["max_slots"]
    logits = torch.randn((ms, cfg.vocab_size), generator=gen,
                         device=device).to(torch.bfloat16)
    lanes = torch.arange(ms, device=device) % 2 == 1
    temps = torch.where(lanes, SAMPLED["temperature"], 0.0)
    tks = torch.where(lanes, SAMPLED["top_k"], 0).to(torch.int32)
    seeds = torch.arange(ms, device=device, dtype=torch.int64) + 7

    def select():
        return sample_tokens(logits, temps, tks, seeds)

    def argmax():
        return torch.argmax(logits, dim=-1).to(torch.int32)
    # (no profiler here: a profiler session can slow phase 5's host
    # times, which come first)
    t_sel = [cuda_ms(select), host_us(select)]
    t_arg = [cuda_ms(argmax), host_us(argmax)]
    print(f"phase 3i: {cfg.name} bf16, {len(greedy)} greedy + "
          f"{len(sampled)} sampled requests (temperature "
          f"{SAMPLED['temperature']}, top_k {SAMPLED['top_k']}): two runs "
          f"identical, greedy streams equal the all-greedy run's, "
          f"{parted} of {len(sampled)} sampled streams part from greedy; "
          f"decode in turns: mixed {t_mixed:.3f} s, greedy {t_pure:.3f} s, "
          f"mixed {t_again:.3f} s, greedy {t_pure2:.3f} s ({card})")
    print(f"phase 3i: one selection step, {ms} slots x {cfg.vocab_size}: "
          f"sample_tokens {t_sel[0]:.4f} ms, host {t_sel[1]:.1f} µs a "
          f"call; argmax {t_arg[0]:.4f} ms, host {t_arg[1]:.1f} µs "
          f"({card})")


def vs_cpu(tag, cfg, device, reqs_fn, seed, phase="4e", **over):
    """Phase 4e: ``cfg`` (f32) with weights drawn on the card and copied
    to the CPU, the requests ``reqs_fn()`` gives served on both: the same
    token streams, first-chunk logits within LOGIT_TOL."""
    import torch
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    gpu_params = M.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    cpu_params = to_device(gpu_params, "cpu")
    runs = []
    for dev, params in ((device, gpu_params), ("cpu", cpu_params)):
        with FirstLogits() as first:
            out = serve(cfg, params, reqs_fn(), dev, **over)[0]
        runs.append((out, first.logits))
    (out_gpu, lg_gpu), (out_cpu, lg_cpu) = runs
    lerr = float((lg_gpu - lg_cpu).abs().max())
    check(len(out_gpu) == len(reqs_fn()), f"phase 4e: {cfg.name}: not "
          "every request finished")
    check(out_gpu == out_cpu, f"phase 4e: {cfg.name}: device and CPU runs "
          "emit different tokens")
    check(lerr <= LOGIT_TOL, f"phase 4e: {cfg.name}: first-chunk logits "
          f"differ by {lerr}")
    print(f"phase {phase}: {tag}: {cfg.n_layers}-layer f32 device vs CPU: "
          f"{len(out_gpu)} token streams identical, first-chunk logits "
          f"max abs err {lerr:.3e} (tolerance {LOGIT_TOL:g}), "
          f"{time.perf_counter() - t0:.1f} s")
    del gpu_params, cpu_params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# slice 10: the dense backend (RecurrentGemma, xLSTM) and CoupledEngine
# ---------------------------------------------------------------------------
class EventTimer:
    """Times every call of ``module.name`` with a pair of CUDA events
    while active (``reset`` drops what was recorded); ``ms()`` syncs and
    sums.  On the CPU it counts calls only."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls, self._events = 0, []

    def reset(self):
        self.calls, self._events = 0, []

    def __enter__(self):
        import torch
        self._saved = fn = getattr(self.module, self.name)

        def timed(*a, **kw):
            self.calls += 1
            if not torch.cuda.is_available():
                return fn(*a, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self._events.append((start, end))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._saved)

    def ms(self) -> float:
        import torch
        if not self._events:
            return 0.0
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self._events)


class FiniteLogits:
    """Checks, while active, that every dense ``model.prefill`` and
    ``model.decode_step`` call gives finite logits; ``prefill_calls``
    counts the prefill calls since ``reset``."""

    def reset(self):
        self.prefill_calls = 0

    def __enter__(self):
        from repro_torch.models import model as M
        self._saved = prefill, decode = M.prefill, M.decode_step
        self.reset()

        def checked(fn, what):
            def call(*a, **kw):
                logits, cache = fn(*a, **kw)
                check(bool(logits.isfinite().all()), f"{what}: NaN or inf "
                      "in the logits")
                if fn is prefill:
                    self.prefill_calls += 1
                return logits, cache
            return call
        M.prefill = checked(prefill, "dense prefill")
        M.decode_step = checked(decode, "dense decode")
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        M.prefill, M.decode_step = self._saved


def dense_case(widths, b, sq, q_off, skv, kv_len, dtype, device, gen):
    """(q, k_cache, v_cache, kv_len, q_off) at the attention widths (h,
    kvh, hd, hd_v), every cache position at or past a request's kv_len
    holding garbage (+1e4 in K, -1e4 in V) that must never be read."""
    import torch
    h, kvh, hd, hd_v = widths

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    k, v = randn(b, skv, kvh, hd), randn(b, skv, kvh, hd_v)
    for i, n in enumerate(kv_len):
        k[i, n:], v[i, n:] = 1e4, -1e4
    return (randn(b, sq, h, hd).to(dtype), k.to(dtype), v.to(dtype),
            torch.tensor(kv_len, dtype=torch.int32, device=device), q_off)


def gqa_widths(cfg):
    return (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.resolved_head_dim)


def dense_served_case(cfg, b, sq, q_off, skv, kv_len, dtype, device, gen):
    """``dense_case`` at ``cfg``'s GQA attention widths."""
    return dense_case(gqa_widths(cfg), b, sq, q_off, skv, kv_len, dtype,
                      device, gen)


def dense_served_shapes(rg_cfg, opt_cfg):
    """Phase 2f's kernel-5 cases, as ``check_dense_cases`` takes them:
    RecurrentGemma's 512-query chunks at each RG_CHUNKS start in caches
    of max_seq, its local window: 4 requests with ragged kv_len and a 0
    (no split), and the one request a call that phase 3m's prefill
    engine gives it, a full chunk at each start and a short last one of
    300 (split); the coupled OPT-13B's whole prompts (one request a
    call, q_offset 0, a cache of max_seq): the longest, a middle and the
    shortest of phase 3o's."""
    sq, skv, w = (RG_SERVE["chunk_size"], RG_SERVE["max_seq"],
                  rg_cfg.local_window)
    rg = (rg_cfg.name, gqa_widths(rg_cfg), w, True)
    out = [(*rg, False, 4, sq, q0, skv, [q0 + sq, q0 + 300, 0, q0 + 37])
           for q0 in RG_CHUNKS]
    out += [(*rg, True, 1, sq, q0, skv, [q0 + sq]) for q0 in RG_CHUNKS]
    out.append((*rg, True, 1, 300, RG_CHUNKS[1], skv, [RG_CHUNKS[1] + 300]))
    lens = sorted(r.prompt_len for r in make_requests(
        opt_cfg.vocab_size, lo=OPT_PROMPTS[0], hi=OPT_PROMPTS[1]))
    for n in (lens[-1], lens[len(lens) // 2], lens[0]):
        out.append((opt_cfg.name, gqa_widths(opt_cfg), 0, True, False, 1, n,
                    0, SERVE["max_seq"], [n]))
    return out


def check_dense_cases(tag, cases, device, kernels, seed):
    """Phases 2f / 2g: kernel 5 against its plain version on ``cases``
    ((what, widths (h, kvh, hd, hd_v), window, causal, split, b, sq,
    q_off, skv, kv_len) each), bf16 and f32, on caches of garbage past
    kv_len (``dense_case``, drawn from ``seed``): every row within
    ``limit``, rows without an attendable key exactly 0, every bf16
    launch on the tensor-core body and no f32 one, the non-causal ones
    counted as such, and the cases marked ``split`` planned in more
    than one share in bf16 (so the partial records and their merge are
    held too).  Returns the largest bf16 error."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention)
    from repro_torch.kernels.prefill_plan import prefill_plan, sm_count
    gen = torch.Generator(device=device).manual_seed(seed)
    name, bf16_err = "chunked_prefill_attention", 0.0
    for what, widths, window, causal, split, *shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = dense_case(widths, *shape, dtype, device, gen)
            q, k, v, kv_len, q_off = args
            splits = prefill_plan(dtype, *q.shape[:3], k.shape[2],
                                  q.shape[3], v.shape[3], 1, k.shape[1],
                                  sm_count(device)).splits
            if split and dtype == torch.bfloat16:
                check(splits > 1, f"phase {tag}: {what} {tuple(q.shape)} "
                      f"at {q_off} planned {splits} share, not a split")
            zero_launches(kernels)
            got = chunked_prefill_attention(*args, window=window,
                                            causal=causal)
            exp = ref.chunked_prefill_attention(*args, window=window,
                                                causal=causal)
            torch.cuda.synchronize()
            launches = read_launches(kernels)
            check(launches[name] == 1
                  and launches[f"{name} (tensor cores)"]
                  == int(dtype == torch.bfloat16)
                  and launches[f"{name} (causal=False)"] == int(not causal),
                  f"phase {tag}: {what}: launches {launches}")
            check(bool(torch.isfinite(got).all()), f"phase {tag}: "
                  "non-finite")
            dead = torch.from_numpy(dense_keys(q, kv_len, q_off, window,
                                               causal) == 0).to(device)
            check(float(got[dead].float().abs().sum()) == 0.0,
                  f"phase {tag}: a row without keys is not 0")
            worst = {}
            compare(name, got, exp, worst)
            err, share = worst[name]
            if dtype == torch.bfloat16:
                bf16_err = max(bf16_err, err)
            h, kvh, hd, hd_v = widths
            print(f"phase {tag}: {name} vs plain, {what}, {dtype}, "
                  f"{'causal' if causal else 'non-causal'}, "
                  f"{q.shape[0]} x {q.shape[1]} queries at {q_off} of "
                  f"{h}/{kvh} heads of {hd} (V {hd_v}), cache {shape[3]}, "
                  f"kv_len {shape[4]}, window {window}, {splits} share(s): "
                  f"max abs err {err:.3e}, {share:.3f} of the limit, "
                  f"{int(dead.sum())} rows without keys exactly 0")
            del args, q, k, v, got, exp
    torch.cuda.empty_cache()
    return bf16_err


def dense_phase(tag, cfg, device, kernels, card, run, over, timers):
    """Phases 3m / 3n: ``cfg`` whole in bf16 with random weights from
    SEED on the dense backend, one prefill and one decode engine over
    ``run``'s requests (``over`` replaces SERVE settings), every logit
    finite.  ``timers`` (name: EventTimer) time a part of the model
    during the served run; each one's share of the prefill seconds is
    printed.  Returns (launches, prefill calls, stats)."""
    import torch
    from repro_torch.core.backend import backend_for
    from repro_torch.models import model as M
    check(backend_for(cfg).backend == "dense", f"phase {tag}: {cfg.name} "
          "does not resolve to the dense backend")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(SEED), device)
    torch.cuda.synchronize()
    reqs = make_requests(cfg.vocab_size, **run)
    kinds = ", ".join(f"{k} x {cfg.layer_kinds.count(k)}"
                      for k in sorted(set(cfg.layer_kinds)))
    print(f"phase {tag}: {cfg.name}, {cfg.n_layers} layers "
          f"({kinds}), "
          f"full width (d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads, vocab {cfg.vocab_size}), {count_params(params) / 1e9:.2f}"
          f" G parameters in bf16, drawn in {time.perf_counter() - t0:.1f} "
          f"s; {len(reqs)} requests of {run['new']} new tokens, prompts "
          f"{[r.prompt_len for r in reqs]}")
    stats = {}
    with FiniteLogits() as finite, contextlib.ExitStack() as stack:
        for tm in timers.values():
            stack.enter_context(tm)
        launches, pe, de = serve_phase(
            tag, cfg, params, device, kernels, card, prompts=(run["lo"],
                                                              run["hi"]),
            n=run["n"], new=run["new"], stats=stats,
            hooks=(finite, *timers.values()), **over)
        calls = finite.prefill_calls
    for what, tm in timers.items():
        ms = tm.ms()
        print(f"phase {tag}: {what}: {tm.calls} calls, {ms:.1f} ms, "
              f"{100 * ms / 1e3 / stats['t_pre']:.1f}% of the prefill wall "
              f"seconds ({card})")
    del params, pe, de
    torch.cuda.empty_cache()
    return launches, calls, stats


def rg_phase(device, kernels, card):
    """Phase 3m: RecurrentGemma-9B whole (38 layers: 26 RG-LRU, 12 local
    attention with a 2,048-token window) over 8 requests with prompts of
    256-4,000 (3 past the window), chunks of 512, max_seq 4,096: kernel
    5 launched 12 x the dense prefill calls (one a segment), all on the
    tensor-core body; the RG-LRU scan's share of the prefill seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models import recurrent as R
    cfg = get_config(RG_ARCH)
    reqs = make_requests(cfg.vocab_size, **RG_RUN)
    check(sum(r.prompt_len > cfg.local_window for r in reqs) >= 3,
          "phase 3m: fewer than 3 prompts past the window")
    timers = {"RG-LRU scan (linear_scan)": EventTimer(R, "linear_scan")}
    launches, calls, stats = dense_phase("3m", cfg, device, kernels, card,
                                         RG_RUN, RG_SERVE, timers)
    n_local = cfg.layer_kinds.count("local_attn")
    name = "chunked_prefill_attention"
    check(launches[name] == n_local * calls > 0
          and sum(launches[k] for k in kernels) == launches[name],
          f"phase 3m: launches {launches}, {calls} prefill calls x "
          f"{n_local} local-attention layers")
    print(f"phase 3m: kernel 5 launched {launches[name]} = {n_local} "
          f"local-attention layers x {calls} dense prefill calls, "
          f"{launches[name + ' (tensor cores)']} on the tensor-core body")
    return launches


def xlstm_phase(device, kernels, card):
    """Phase 3n: xLSTM-1.3B whole (48 layers: 42 mLSTM, 6 sLSTM) on the
    dense backend, 4 requests of 64-256 prompt tokens and 16 new, max_seq
    512, 4 slots; no attention kernel launched (the model has none);
    the time loops' shares of the prefill seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import recurrent as R
    cfg = get_config(XLSTM_ARCH)
    state = sum(t.numel() * t.element_size() for layer in M.init_cache(
        cfg, 1, XLSTM_SERVE["max_seq"], device="meta") for t in layer.values())
    print(f"phase 3n: one slot's recurrent state {state / 1e9:.3f} GB; "
          f"{XLSTM_SERVE['max_slots']} decode slots "
          f"{XLSTM_SERVE['max_slots'] * state / 1e9:.2f} GB")
    timers = {"mLSTM time loop (mlstm_scan)": EventTimer(R, "mlstm_scan"),
              "sLSTM time loop (slstm_scan)": EventTimer(R, "slstm_scan")}
    launches, _, _ = dense_phase("3n", cfg, device, kernels, card,
                                 XLSTM_RUN, XLSTM_SERVE, timers)
    check(sum(launches[k] for k in kernels) == 0, f"phase 3n: launches "
          f"{launches}: xLSTM has no attention")
    return launches


def run_coupled(eng, reqs, sync=lambda: None):
    """Drive a CoupledEngine over ``reqs`` to the end; returns (tokens
    by rid, prefill seconds, decode seconds)."""
    for r in reqs:
        eng.submit(r)
    out, t, t_pre, t_dec = {}, 0.0, 0.0, 0.0
    for _ in range(100_000):
        prefill = bool(eng.waiting)
        sync()
        t0 = time.perf_counter()
        for f in eng.step(t):
            out[f.req.rid] = f.tokens
        sync()
        if prefill:
            t_pre += time.perf_counter() - t0
        else:
            t_dec += time.perf_counter() - t0
        t += 0.01
        if eng.done():
            break
    return out, t_pre, t_dec


class DecodeSteps:
    """A serve ``watch`` (phase 3f): each decode iteration's active
    slots and the sum of their positions (prompt plus generated tokens:
    what the iteration's queries attend), read after admission and
    before the step, into ``stats["decode_steps"]``."""

    def __init__(self, stats):
        from repro_torch.core.decode_engine import DecodeEngine
        self.engine = DecodeEngine
        self.steps = stats.setdefault("decode_steps", [])

    def __call__(self, x):
        if isinstance(x, self.engine) and x.slots:
            self.steps.append((len(x.slots), sum(
                st.req.prompt_len + st.req.generated
                for st in x.slots.values())))


def prefill_call_tokens(reqs, chunk_size):
    """The tokens of each fused prefill call of a served run: the
    engine's scheduler order and chunk partition, as prefill_geometry
    packs them."""
    from repro_torch.core import chunking
    from repro_torch.core.sched.prefill_scheduler import PrefillScheduler
    sched = PrefillScheduler()
    for r in reqs:
        sched.add(r)
    order = sched.next_batch(sched.sched_batch)
    return [sum(seg.length for seg in chunk.segments)
            for chunk in chunking.partition(
                [(r.rid, r.prompt_len) for r in order], chunk_size)]


def costmodel_phase(run, stats, card):
    """Phase 3r: the cost-model runtime, on the host.  (a) ``param_count``
    of 3f's config equals the parameters 3f held.  (b) ``CostModel(cfg,
    HardwareSpec.h100())``'s prediction for 3f's fused prefill calls
    (``prefill_time`` of each call's tokens) and decode iterations
    (``decode_time`` of each iteration's slots and summed positions),
    beside 3f's measured seconds; every prediction finite and positive,
    the ratios a record with no threshold.  (c) The ``serve_cluster``
    comparison on that cost model at SIM_REQUESTS a workload: every
    request terminal, no page held.  (d) The ``mixed64`` golden scenario
    equal (==) to tests/golden_sim_metrics.json.  (e) ``run_fleet`` over
    FLEET_TRACE on an H100 FleetSpec of FLEET_INSTANCES: events/s, every
    request terminal, no page held."""
    from repro_torch import serve_cluster
    from repro_torch.configs import get_config
    from repro_torch.fleet import (FleetSpec, generate_trace, page_leaks,
                                   run_fleet)
    from repro_torch.models.model import param_count
    from repro_torch.runtime.costmodel import CostModel, HardwareSpec
    from repro_torch.runtime.request import TERMINAL_PHASES
    from repro_torch.runtime.workload import generate
    from repro_torch.serving import Cluster
    t0 = time.perf_counter()
    cfg = run["cfg"]
    n = param_count(cfg)
    check(n == stats["n_params"], f"phase 3r: param_count {n} != "
          f"{stats['n_params']} parameters held by 3f")
    cost = CostModel(cfg, HardwareSpec.h100(), n_params=n)
    calls = prefill_call_tokens(make_requests(cfg.vocab_size, **run["run"]),
                                SERVE["chunk_size"])
    steps = stats["decode_steps"]
    check(len(calls) == stats["fused"] and len(steps) == stats["iterations"],
          f"phase 3r: {len(calls)} calls, {len(steps)} iterations against "
          f"3f's {stats['fused']} and {stats['iterations']}")
    pre = [cost.prefill_time(t) for t in calls]
    dec = [cost.decode_time(b, c) for b, c in steps]
    check(all(math.isfinite(x) and x > 0 for x in pre + dec),
          "phase 3r: a prediction is not finite and positive")
    p_pre, p_dec = sum(pre), sum(dec)
    print(f"phase 3r: {cfg.name} param_count {n} = 3f's; "
          f"CostModel(h100, mfu {cost.mfu}, mbu {cost.mbu}): prefill "
          f"{len(calls)} calls of {calls} tokens predicted "
          f"{p_pre:.4f} s, measured {stats['t_pre']:.4f} s, ratio "
          f"{p_pre / stats['t_pre']:.3f}; decode {len(steps)} iterations "
          f"of {min(b for b, _ in steps)}-{max(b for b, _ in steps)} "
          f"slots predicted "
          f"{p_dec:.4f} s, measured {stats['t_dec']:.4f} s, ratio "
          f"{p_dec / stats['t_dec']:.3f} ({card})")
    print(f"phase 3r: serve_cluster on {cost.hw.name}, {SIM_REQUESTS} "
          f"requests a workload")
    print(f"phase 3r: {serve_cluster.HEADER}")
    for wl, ra, cluster, rb in serve_cluster.compare(cost, SIM_REQUESTS):
        check(all(r.phase in TERMINAL_PHASES
                  for r in ra.requests + rb.requests)
              and page_leaks(cluster) == 0,
              f"phase 3r: {wl}: a request not terminal or a page held")
        print(f"phase 3r: {serve_cluster.row(wl, ra, rb)}")
    golden = json.loads((ROOT / "tests" / "golden_sim_metrics.json")
                        .read_text())["mixed64"]
    opt = get_config(OPT_ARCH)
    v100 = CostModel(opt, HardwareSpec.v100_tp2(), n_params=13_000_000_000)
    r = Cluster(opt, runtime="sim", cost=v100, n_prefill=1,
                n_decode=1).serve(generate("Mixed", 64, seed=1))
    got = dict(metrics={k: r.metrics[k] for k in golden["metrics"]},
               **{k: getattr(r, k) for k in golden if k != "metrics"})
    check(got == golden, f"phase 3r: mixed64 {got} != golden {golden}")
    print("phase 3r: mixed64 equal to tests/golden_sim_metrics.json "
          "(==)")
    trace = generate_trace("Mixed", FLEET_TRACE, process="poisson")
    rep = run_fleet(trace, FleetSpec(hardware="h100", **FLEET_INSTANCES))
    check(rep.finished + rep.failed == FLEET_TRACE,
          f"phase 3r: fleet {rep.finished} + {rep.failed} of "
          f"{FLEET_TRACE} terminal")
    print(f"phase 3r: run_fleet {FLEET_TRACE} Poisson Mixed requests on "
          f"{FLEET_INSTANCES['n_prefill']} + "
          f"{FLEET_INSTANCES['n_decode']} h100 instances: {rep.events} "
          f"events in {rep.wall_s} s = {rep.events_per_s} events/s, finished "
          f"{rep.finished}, failed {rep.failed}, sim mean TTFT "
          f"{rep.metrics['avg_ttft']:.4f} s, goodput {rep.goodput:.4f}, "
          f"0 pages held; phase 3r {time.perf_counter() - t0:.1f} s")


def coupled_phase(cfg, params, disagg, device, kernels, card):
    """Phase 3o: the coupled vLLM-style baseline (``CoupledEngine``) on
    OPT-13B whole with phase 3f's weights and requests: whole-prompt
    prefill through kernel 5 (40 layers x 8 prompts, all on the
    tensor-core body), dense decode, 8 slots of 2,048.  Prints tokens/s,
    the dense decode attention's share of the decode seconds, and how
    many streams equal phase 3f's disaggregated ones (``disagg``; the
    coupled engine stops on decode_len and emits one token more)."""
    from repro_torch.models import attention as A
    reqs = make_requests(cfg.vocab_size, lo=OPT_PROMPTS[0],
                         hi=OPT_PROMPTS[1])
    out, launches, _ = coupled_run_phase(
        "3o", cfg, params, reqs, device, kernels, card,
        {"dense decode attention": EventTimer(A, "decode_attn_batched")})
    name = "chunked_prefill_attention"
    check(launches[name] == cfg.n_layers * len(reqs), f"phase 3o: "
          f"launches {launches}")
    same = sum(out[rid][:len(toks)] == toks for rid, toks in disagg.items())
    print(f"phase 3o: kernel 5 launched {launches[name]} = {cfg.n_layers} "
          f"layers x {len(reqs)} whole prompts, "
          f"{launches[name + ' (tensor cores)']} on the tensor-core body; "
          f"{same} of {len(disagg)} streams equal phase 3f's disaggregated "
          "ones (bf16: near-tied top logits may part them)")
    return launches


def coupled_vs_cluster(cfg, params, device):
    """Phase 4g (i) on one device: the N_REQUESTS requests (no sampling
    params: both stop on decode_len) through the port's ``Cluster``
    (2 + 2 instances) and through its ``CoupledEngine``; returns both
    token dicts."""
    from repro_torch.runtime.baseline_vllm import CoupledEngine
    from repro_torch.serving import Cluster
    outs = []
    for coupled in (False, True):
        reqs = make_requests(cfg.vocab_size)
        for r in reqs:
            r.sampling = None
        if coupled:
            outs.append(run_coupled(CoupledEngine(
                cfg, params, max_slots=SERVE["max_slots"],
                max_seq=SERVE["max_seq"], n_pages=SERVE["n_pages"],
                page_size=SERVE["page_size"], device=device), reqs)[0])
            continue
        cl = Cluster(cfg, runtime="engine", params=params, device=device,
                     chunk_size=SERVE["chunk_size"],
                     page_size=SERVE["page_size"], max_seq=SERVE["max_seq"],
                     n_pages=SERVE["n_pages"], max_batch=SERVE["max_slots"],
                     **CLUSTER)
        handles = [cl.submit(request=r) for r in reqs]
        cl.run()
        outs.append({h.rid: h.result().tokens for h in handles})
    return outs


def dense_vs_cpu(cfg2, gpu_params, cpu_params, device):
    """Phase 4g: (i) qwen2 at 2 layers, f32: Cluster and CoupledEngine
    token-identical on the card and on the CPU; (ii) RecurrentGemma at
    one pattern period, full width, window 64 in 64-token chunks, and
    (iii) xLSTM at its smoke depth and full width through ``Cluster``:
    card and CPU token-identical, first-chunk logits within LOGIT_TOL;
    and through ``AsyncCluster`` on the card (2 + 2 instances on 4
    streams: the dense payloads cross streams), token-identical to the
    CPU's ``Cluster``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import MLSTM, SLSTM
    from repro_torch.serving import AsyncCluster, Cluster
    t0 = time.perf_counter()
    (cl_gpu, co_gpu), (cl_cpu, co_cpu) = (
        coupled_vs_cluster(cfg2, params, dev)
        for dev, params in ((device, gpu_params), ("cpu", cpu_params)))
    check(len(cl_gpu) == N_REQUESTS and cl_gpu == co_gpu == cl_cpu
          == co_cpu, "phase 4g (i): Cluster and CoupledEngine streams "
          "differ between them or between the card and the CPU")
    print(f"phase 4g (i): {cfg2.name} 2-layer f32: Cluster 2+2 and "
          f"CoupledEngine give the same {len(cl_gpu)} token streams, on "
          f"the card and on the CPU, {time.perf_counter() - t0:.1f} s")
    c = dict(RG_CHECK)
    rg = dataclasses.replace(get_config(RG_ARCH), n_layers=3, suffix=(),
                             dtype="float32", local_window=c.pop("window"))
    vs_cpu(f"RecurrentGemma, one pattern period, window "
           f"{rg.local_window}, chunks of {c['chunk_size']}", rg,
           device, lambda: make_requests(rg.vocab_size, n=c["n"],
                                         lo=c["lo"], hi=c["hi"],
                                         new=c["new"]),
           SEED + 21, phase="4g (ii)", chunk_size=c["chunk_size"])
    x = dataclasses.replace(get_config(XLSTM_ARCH), n_layers=2,
                            pattern=(MLSTM, SLSTM), dtype="float32")
    t0 = time.perf_counter()
    gpu_x = M.init_params(x, torch.Generator(device=device)
                          .manual_seed(SEED + 22), device)
    runs = []
    for dev, params in ((device, gpu_x), ("cpu", to_device(gpu_x, "cpu"))):
        reqs = make_requests(x.vocab_size, **XLSTM_CHECK)
        for r in reqs:
            r.sampling = None
        cl = Cluster(x, runtime="engine", params=params, device=dev,
                     chunk_size=XLSTM_CHECK_CHUNK, max_seq=256,
                     max_batch=4, n_prefill=1, n_decode=1)
        with FirstLogits() as first:
            handles = [cl.submit(request=r) for r in reqs]
            cl.run()
        runs.append(({h.rid: h.result().tokens for h in handles},
                     first.logits))
    (out_gpu, lg_gpu), (out_cpu, lg_cpu) = runs
    lerr = float((lg_gpu - lg_cpu).abs().max())
    check(len(out_gpu) == XLSTM_CHECK["n"] and out_gpu == out_cpu,
          "phase 4g (iii): xLSTM card and CPU streams differ")
    check(lerr <= LOGIT_TOL, f"phase 4g (iii): first-chunk logits differ "
          f"by {lerr}")
    reqs = make_requests(x.vocab_size, **XLSTM_CHECK)
    for r in reqs:
        r.sampling = None
    ac = AsyncCluster(x, params=gpu_x, device=device, n_prefill=2,
                      n_decode=2, chunk_size=XLSTM_CHECK_CHUNK, max_seq=256,
                      max_batch=4)
    try:
        handles = [ac.submit(request=r) for r in reqs]
        check(ac.drain(timeout=DRAIN_S), "phase 4g (iii): drain timed out")
        check(ac.worker_errors == [], "phase 4g (iii): worker errors:\n"
              + "\n".join(ac.worker_errors))
        out_async = {h.rid: h.result(wait=False).tokens for h in handles}
    finally:
        ac.close()
    check(out_async == out_cpu, "phase 4g (iii): xLSTM through "
          "AsyncCluster on the card differs from Cluster on the CPU")
    print(f"phase 4g (iii): xLSTM, {x.n_layers} layers (mLSTM, sLSTM) at "
          f"full width, f32, Cluster 1+1 and AsyncCluster 2+2 on the card "
          f"vs Cluster on the CPU: {len(out_gpu)} token streams identical, "
          f"first-chunk logits max abs err {lerr:.3e} (tolerance "
          f"{LOGIT_TOL:g}), {time.perf_counter() - t0:.1f} s")
    del gpu_x
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# dense MLA and dense cross-attention (phases 2g, 3p, 3q, 4h)
# ---------------------------------------------------------------------------
def mla_widths(cfg, heads=None):
    """Kernel 5's widths on the dense MLA prefill: every head its own
    KV head after decompression, K of qk_nope + qk_rope, V of v_head."""
    m, h = cfg.mla, heads or cfg.n_heads
    return (h, h, m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim)


def mla_cross_shapes(ds_cfg, vlm_cfg, wh_cfg):
    """Phase 2g's kernel-5 cases, as ``check_dense_cases`` takes them.
    DeepSeek-V2's dense MLA prefill (128 / 128 heads, hd 192,
    hd_v 128): chunks of 512 at MLA_CHUNKS in caches of max_seq, one
    request a call as the engine gives them and four with ragged kv_len
    and a 0; its 128 KV heads fill the card without a split, so a
    16-head slice of the same widths (one card of eight under head
    sharding) holds the split at these widths.  The cross reads,
    non-causal, over each cross model's encoder tokens: a chunk of 512
    queries of one request, the 8 decode slots' single queries, and
    Llama-3.2-Vision's whole prompt of 2,000 in the coupled engine (sq
    > skv)."""
    sq, skv = SERVE["chunk_size"], SERVE["max_seq"]
    mla = ("MLA", mla_widths(ds_cfg), 0, True)
    out = [(*mla, False, 1, sq, q0, skv, [q0 + sq]) for q0 in MLA_CHUNKS]
    out += [(*mla, False, 4, sq, q0, skv, [q0 + sq, q0 + 300, 0, q0 + 37])
            for q0 in MLA_CHUNKS]
    q0 = MLA_CHUNKS[-1]
    out.append((f"MLA, a {MLA_SLICE_HEADS}-head slice",
                mla_widths(ds_cfg, MLA_SLICE_HEADS), 0, True, True, 1, sq,
                q0, skv, [q0 + sq]))
    for cfg in (vlm_cfg, wh_cfg):
        ec, slots = cfg.cross_ctx, SERVE["max_slots"]
        cross = (gqa_widths(cfg), 0, False, False)
        out.append((f"{cfg.name} cross read", *cross, 1, sq, 0, ec, [ec]))
        out.append((f"{cfg.name} cross read, decode", *cross, slots, 1, 0,
                    ec, [ec] * slots))
    out.append((f"{vlm_cfg.name} cross read, a whole prompt",
                gqa_widths(vlm_cfg), 0, False, False, 1, COUPLED_LONG, 0,
                vlm_cfg.cross_ctx, [vlm_cfg.cross_ctx]))
    return out


def kernel5_calls(launches):
    name = "chunked_prefill_attention"
    return (launches[name], launches[f"{name} (causal=False)"],
            launches[f"{name} (tensor cores)"])


def only_kernel5(tag, launches, kernels):
    check(sum(launches[k] for k in kernels)
          == launches["chunked_prefill_attention"],
          f"phase {tag}: a paged kernel launched on the dense backend: "
          f"{launches}")


def coupled_run_phase(tag, cfg, params, reqs, device, kernels, card,
                      timers=()):
    """Phases 3o / 3p / 3q: ``reqs`` through ``CoupledEngine`` (SERVE's
    slots, max_seq and pages) on ``params`` after a warm-up, launch
    counters set to 0 just before and read just after, every bf16 launch
    of kernel 5 on the tensor-core body and no other kernel, every
    request finished.  Prints the slot cache's size, tokens/s and each of
    ``timers``' (name: EventTimer) share of the decode seconds.  Returns
    (tokens by rid, launches, decode iterations)."""
    import torch
    from repro_torch.runtime.baseline_vllm import CoupledEngine
    kw = dict(max_slots=SERVE["max_slots"], max_seq=SERVE["max_seq"],
              n_pages=SERVE["n_pages"], page_size=SERVE["page_size"],
              device=device)
    run_coupled(CoupledEngine(cfg, params, **dict(kw, max_slots=1)),
                make_requests(cfg.vocab_size, n=1, lo=64, hi=64,
                              new=2))                      # warm-up
    eng = CoupledEngine(cfg, params, **kw)
    cache_gb = sum(t.numel() * t.element_size() for layer in eng.cache
                   for t in layer.values()) / 1e9
    zero_launches(kernels)
    timers = dict(timers)
    with contextlib.ExitStack() as stack:
        for tm in timers.values():
            stack.enter_context(tm)
        out, t_pre, t_dec = run_coupled(eng, reqs, torch.cuda.synchronize)
    launches = read_launches(kernels)
    check_bodies(tag, launches, cfg.dtype)
    only_kernel5(tag, launches, kernels)
    check(len(out) == len(reqs), f"phase {tag}: {len(out)} of {len(reqs)} "
          "finished in CoupledEngine")
    n_prompt = sum(r.prompt_len for r in reqs)
    n_decoded = sum(len(t) - 1 for t in out.values())
    shares = "".join(f", {what} {tm.ms():.1f} ms = "
                     f"{100 * tm.ms() / 1e3 / t_dec:.1f}% of it"
                     for what, tm in timers.items())
    print(f"phase {tag}: CoupledEngine, {cfg.name}, dense slot cache "
          f"{cache_gb:.1f} GB: {eng.iterations} iterations "
          f"({eng.prefill_iterations} prefill); prefill {n_prompt} tokens "
          f"in {t_pre:.3f} s = {n_prompt / t_pre:.1f} tokens/s; decode "
          f"{n_decoded} tokens in {t_dec:.3f} s = {n_decoded / t_dec:.1f} "
          f"tokens/s{shares} ({card})")
    iters = eng.iterations - eng.prefill_iterations
    del eng
    torch.cuda.empty_cache()
    return out, launches, iters


def mla_dense_phase(cfg, params, device, kernels, card):
    """Phase 3p: DeepSeek-V2 at ``served()``'s depth (full width) in bf16
    on the dense backend, on phase 3b's weights: one prefill and one
    decode engine sharing that one copy over phase 3b's requests, kernel
    5 launched n_layers x the dense prefill calls (one a segment), all on the
    tensor-core body at hd 192 / hd_v 128, no other kernel; the dense
    MLA decode attention's share of the decode seconds (CUDA events);
    wire bytes those of the latent (``kv_bytes``).  Then CoupledEngine
    on the same weights and requests (kernel 5: n_layers x 8 whole
    prompts).  Returns the engines' launches."""
    import torch
    from repro_torch.core.backend import backend_for
    from repro_torch.core.kv_transfer import kv_bytes
    from repro_torch.models import attention as A
    spec = backend_for(cfg, "dense")
    check((spec.layout, spec.cross) == ("dense", "none"), f"phase 3p: "
          f"{spec}")
    print(f"phase 3p: {cfg.name} at {cfg.n_layers} layers, full width, "
          f"phase 3b's {count_params(params) / 1e9:.2f} G parameters in "
          f"bf16; dense backend, kernel 5 at "
          f"{'/'.join(map(str, mla_widths(cfg)))} (heads / KV heads / hd / "
          f"hd_v)")
    stats = {}
    timer = EventTimer(A, "mla_decode_attn")
    with FiniteLogits() as finite, timer:
        launches, pe, de = serve_phase("3p", cfg, params, device, kernels,
                                       card, stats=stats,
                                       hooks=(finite, timer),
                                       backend="dense")
        calls = finite.prefill_calls
    n, nc, tc = kernel5_calls(launches)
    only_kernel5("3p", launches, kernels)
    check(pe.backend == de.backend == "dense" and n == cfg.n_layers * calls
          > 0 and nc == 0 and tc == n, f"phase 3p: launches {launches}, "
          f"{calls} prefill calls x {cfg.n_layers} layers")
    reqs = make_requests(cfg.vocab_size)
    wire = sum(kv_bytes(cfg, r.prompt_len) for r in reqs)
    check(pe.network.bytes_sent == wire, f"phase 3p: {pe.network.bytes_sent} "
          f"wire bytes, expected {wire}")
    ms = timer.ms()
    print(f"phase 3p: kernel 5 launched {n} = {cfg.n_layers} layers x "
          f"{calls} dense prefill calls, {tc} on the tensor-core body; "
          f"dense MLA decode attention (mla_decode_attn) {timer.calls} "
          f"calls, {ms:.1f} ms = {100 * ms / 1e3 / stats['t_dec']:.1f}% of "
          f"the decode wall seconds; {wire} wire bytes (the latent, "
          f"{cfg.kv_bytes_per_token(2)} a token) ({card})")
    disagg = stats["out"]
    del pe, de
    out, c_launches, _ = coupled_run_phase(
        "3p", cfg, params, reqs, device, kernels, card,
        {"dense MLA decode attention": EventTimer(A, "mla_decode_attn")})
    check(kernel5_calls(c_launches)[0] == cfg.n_layers * len(reqs),
          f"phase 3p: CoupledEngine launches {c_launches}")
    same = sum(out[rid][:len(t)] == t for rid, t in disagg.items())
    print(f"phase 3p: CoupledEngine kernel 5 launches "
          f"{c_launches['chunked_prefill_attention']} = {cfg.n_layers} "
          f"layers x {len(reqs)} whole prompts; {same} of {len(disagg)} "
          "streams equal the engines' (bf16: near-tied top logits may "
          "part them)")
    return launches


def cross_dense_phase(vlm_cfg, wh_cfg, device, kernels, card):
    """Phase 3q: Llama-3.2-Vision whole and Whisper-tiny whole in bf16 on
    the dense backend (``cross="dense"``).  Llama: the engines over phase
    3c's requests with their frontend embeddings, then CoupledEngine on
    the same weights over prompts of 64-2,000 (one past the 1,600
    patches: a cross read with sq > skv).  Whisper: ``Cluster(runtime=
    "engine", backend="dense")`` with 1 + 1 instances over phase 3l's
    requests.  Kernel 5 launched causally n_layers x the dense prefill
    calls and non-causally n_cross_layers x (prefill calls + decode
    iterations); every bf16 launch on the tensor-core body, the first
    chunk's cross reads on f32 (the unrounded cross K/V); wire bytes
    ``kv_bytes`` with enc_len counted.  Returns (the Llama engines'
    launches, CoupledEngine's, the Whisper Cluster's)."""
    import torch
    from repro_torch.core.backend import backend_for
    from repro_torch.core.kv_transfer import kv_bytes
    from repro_torch.models import model as M
    from repro_torch.models.frontends import fake_frontend
    from repro_torch.serving import Cluster
    runs = []
    cfg = vlm_cfg
    spec = backend_for(cfg, "dense")
    check((spec.cross, spec.cross_ctx, spec.n_cross_layers)
          == ("dense", cfg.cross_ctx, cfg.n_cross_layers), f"phase 3q: "
          f"{spec}")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(SEED), device)
    enc = fake_frontend(cfg, N_REQUESTS, torch.Generator(device=device)
                        .manual_seed(SEED + 1), device)
    torch.cuda.synchronize()
    L, nc = cfg.n_layers, cfg.n_cross_layers
    print(f"phase 3q: {cfg.name}, {L} layers ({nc} with cross-attention "
          f"over {cfg.cross_ctx} patches), full width, "
          f"{count_params(params) / 1e9:.2f} G parameters in bf16, drawn in "
          f"{time.perf_counter() - t0:.1f} s; dense backend")
    with FiniteLogits() as finite:
        launches, pe, de = serve_phase(
            "3q", cfg, params, device, kernels, card, enc=enc,
            hooks=(finite,), f32_reads=nc * N_REQUESTS, backend="dense",
            n_pages=CROSS_PAGES)
        calls = finite.prefill_calls
    runs.append(launches)
    n, n_nc, tc = kernel5_calls(launches)
    only_kernel5("3q", launches, kernels)
    check(n == (L + nc) * calls + nc * de.iterations
          and n_nc == nc * (calls + de.iterations)
          and tc == n - nc * N_REQUESTS, f"phase 3q: launches {launches}, "
          f"{calls} prefill calls, {de.iterations} decode iterations")
    reqs = make_requests(cfg.vocab_size)
    wire = sum(kv_bytes(cfg, r.prompt_len, enc_len=cfg.cross_ctx)
               for r in reqs)
    check(pe.network.bytes_sent == wire, f"phase 3q: {pe.network.bytes_sent}"
          f" wire bytes, expected {wire}")
    print(f"phase 3q: {cfg.name} engines: kernel 5 launched {n}: causal "
          f"{n - n_nc} = {L} x {calls} prefill calls, non-causal {n_nc} = "
          f"{nc} x ({calls} + {de.iterations} decode iterations); {tc} on "
          f"the tensor-core body, {n - tc} first-chunk cross reads in f32; "
          f"{wire} wire bytes ({cfg.cross_ctx} encoder tokens a request "
          f"counted)")
    del pe, de
    creqs = make_requests(cfg.vocab_size, lo=COUPLED_PROMPTS[0],
                          hi=COUPLED_PROMPTS[1])
    longest = max(r.prompt_len for r in creqs)
    check(cfg.cross_ctx < longest <= SERVE["max_seq"] - NEW_TOKENS,
          f"phase 3q: the longest prompt {longest} does not pass the "
          f"{cfg.cross_ctx} patches inside max_seq")
    _, c_launches, iters = coupled_run_phase("3q", cfg, params, creqs,
                                             device, kernels, card)
    runs.append(c_launches)
    n, n_nc, tc = kernel5_calls(c_launches)
    check(n == (L + nc) * len(creqs) + nc * iters
          and n_nc == nc * (len(creqs) + iters), f"phase 3q: CoupledEngine "
          f"launches {c_launches}, {iters} decode iterations")
    print(f"phase 3q: CoupledEngine on {cfg.name}, prompts "
          f"{sorted(r.prompt_len for r in creqs)} (the longest {longest} "
          f"over {cfg.cross_ctx} encoder keys): kernel 5 causal {n - n_nc},"
          f" non-causal {n_nc}, {tc} on the tensor-core body")
    del params
    torch.cuda.empty_cache()

    cfg = wh_cfg
    L, nc = cfg.n_layers, cfg.n_cross_layers
    params = M.init_params(cfg, torch.Generator(device=device)
                           .manual_seed(SEED), device)
    wreqs = dedupe_requests(cfg, device)
    cl = Cluster(cfg, runtime="engine", params=params, device=device,
                 backend="dense", chunk_size=SERVE["chunk_size"],
                 page_size=SERVE["page_size"], max_seq=SERVE["max_seq"],
                 n_pages=CROSS_PAGES, max_batch=SERVE["max_slots"],
                 n_prefill=1, n_decode=1)
    zero_launches(kernels)
    with FiniteLogits() as finite:
        handles = [cl.submit(request=r) for r in wreqs]
        cl.run()
        calls = finite.prefill_calls
    launches = read_launches(kernels)
    runs.append(launches)
    check_bodies("3q", launches, cfg.dtype, nc * len(wreqs))
    only_kernel5("3q", launches, kernels)
    iters = sum(i.de.iterations for i in cl.instances)
    res = cl.result()
    check(all(h.result().tokens and len(h.result().tokens) == NEW_TOKENS
              for h in handles), "phase 3q: Whisper through Cluster: not "
          "every request finished with its tokens")
    check(all(i.pe.backend == i.de.backend == "dense"
              for i in cl.instances), "phase 3q: not on the dense backend")
    n, n_nc, tc = kernel5_calls(launches)
    check(n == (L + nc) * calls + nc * iters and n_nc == nc * (calls + iters),
          f"phase 3q: Whisper launches {launches}, {calls} prefill calls, "
          f"{iters} decode iterations")
    wire = sum(kv_bytes(cfg, r.prompt_len, enc_len=cfg.cross_ctx)
               for r in wreqs)
    check(cl.network.bytes_sent == wire, f"phase 3q: Whisper "
          f"{cl.network.bytes_sent} wire bytes, expected {wire}")
    prompt = sum(r.prompt_len for r in wreqs)
    decoded = sum(len(h.result().tokens) - 1 for h in handles)
    print(f"phase 3q: {cfg.name} whole through Cluster(runtime=\"engine\", "
          f"backend=\"dense\"), 1 + 1 instances, {len(wreqs)} requests: "
          f"kernel 5 causal {n - n_nc} = {L} x {calls} prefill calls, "
          f"non-causal {n_nc} = {nc} x ({calls} + {iters}), {tc} on the "
          f"tensor-core body; {wire} wire bytes; wall: prefill {prompt} "
          f"tokens in {res.prefill_busy:.3f} s busy = "
          f"{prompt / res.prefill_busy:.1f} tokens/s, decode {decoded} in "
          f"{res.decode_busy:.3f} s busy = {decoded / res.decode_busy:.1f} "
          f"tokens/s ({card})")
    del cl, params
    torch.cuda.empty_cache()
    return runs


def dense_vs_paged(tag, cfg, gpu_params, cpu_params, reqs_fn, paged_gpu,
                   device, paged_payloads=None, coupled=False):
    """Phase 4h: ``cfg`` (f32) on the dense backend, on the card and on
    the CPU, over ``reqs_fn()``'s requests: the two runs' greedy streams
    identical, and identical to the paged backend's on the card
    (``paged_gpu``); with the paged run's payloads (``paged_payloads``,
    by rid) the dense payloads' ck / cv equal the paged cross pages
    within CROSS_KV_TOL; with ``coupled``, ``CoupledEngine`` on the card
    gives the same streams (it stops on decode_len and emits one token
    more: its first len(stream) tokens are compared)."""
    t0 = time.perf_counter()
    payloads = {}

    def watch(x):
        if hasattr(x, "first_token"):        # a prefilled payload
            payloads[x.req.rid] = x
    outs = [serve(cfg, params, reqs_fn(), dev, backend="dense",
                  watch=None if i else watch)[0]
            for i, (dev, params) in enumerate(((device, gpu_params),
                                               ("cpu", cpu_params)))]
    check(len(outs[0]) == len(paged_gpu) and outs[0] == outs[1],
          f"phase 4h: {cfg.name}: dense card and CPU streams differ")
    check(outs[0] == paged_gpu, f"phase 4h: {cfg.name}: dense and paged "
          "streams differ on the card")
    if coupled:
        from repro_torch.runtime.baseline_vllm import CoupledEngine
        out_c = run_coupled(CoupledEngine(
            cfg, gpu_params, max_slots=SERVE["max_slots"],
            max_seq=SERVE["max_seq"], n_pages=SERVE["n_pages"],
            page_size=SERVE["page_size"], device=device), reqs_fn())[0]
        check(set(out_c) == set(outs[0]) and all(
            out_c[rid][:len(t)] == t for rid, t in outs[0].items()),
            f"phase 4h: {cfg.name}: CoupledEngine's streams differ from "
            "the engines'")
    err = 0.0
    if paged_payloads:
        kvh, hd, ec = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.cross_ctx
        for rid, pkd in payloads.items():
            pkp = paged_payloads[rid]
            for name, pages in (("ck", pkp.cross_k), ("cv", pkp.cross_v)):
                paged = pages.reshape(cfg.n_layers, -1, kvh, hd)
                for i, layer in enumerate(pkd.cache):
                    if name in layer:
                        err = max(err, float((paged[i, :ec] - layer[name][0])
                                             .abs().max()))
        check(len(payloads) == len(paged_payloads) and err <= CROSS_KV_TOL,
              f"phase 4h: {cfg.name}: dense ck / cv differ from the paged "
              f"cross pages by {err}")
    print(f"phase 4h: {tag} f32, dense backend: card and CPU {len(outs[0])} "
          f"token streams identical, and identical to the paged backend's "
          f"on the card" + (", and CoupledEngine's" if coupled else "")
          + (f"; dense ck / cv vs paged cross pages max abs err {err:.3e}"
             if paged_payloads else "")
          + f", {time.perf_counter() - t0:.1f} s")


# phase 5's rows, timed on the card by profile_rows once every row's
# CUDA-event and host times are taken
TIMED = []


def time_kernel(name, cases, kern, plain, lib, work, dtype, card,
                wrapper=None, body="cuda_core"):
    """Phase 5: mean ms per launch over ``cases`` (tuples of arguments)
    of the kernel, its plain version and the library call (CUDA events),
    the bound, the achieved TFLOP/s (the FLOPs ``work`` counts over the
    kernel's time), the wrapper's host µs a call (``host_us``: the ms is
    the larger of host and device time where calls run back to back),
    and the body the kernel ran: ``body``, or for kernels 1, 5 and 3 (their
    ``wrapper`` given) ``tensor_core`` where the wrapper's
    ``tensor_core_launches`` rose while it was timed, which bf16
    requires.  The row joins TIMED for its device time."""
    ms = plain_ms = lib_ms = bnd = flops = nbytes = host = 0.0
    by_bytes = 0
    tc0 = getattr(wrapper, "tensor_core_launches", 0)
    for a in cases:
        ms += cuda_ms(lambda: kern(*a))
        host += host_us(lambda: kern(*a))
        plain_ms += cuda_ms(lambda: plain(*a))
        lib_ms += cuda_ms(lib(*a))
        nb, fl = work(a)
        b, by = bound(nb, fl, dtype)
        bnd += b
        flops += fl
        nbytes += nb
        by_bytes += by == "bytes"
    n = len(cases)
    if wrapper is not None:
        body = ("tensor_core" if wrapper.tensor_core_launches > tc0
                else "cuda_core")
    tm = dict(ms=ms / n, plain_ms=plain_ms / n, library_ms=lib_ms / n,
              bound_ms=bnd / n,
              bound_by="bytes" if by_bytes * 2 >= n else "operations",
              body=body, tflops=flops / (ms * 1e9), host_us=host / n)
    print(f"phase 5: {name}, bf16, mean over {n} served shape(s): kernel "
          f"{tm['ms']:.4f} ms ({tm['tflops']:.1f} TFLOP/s, {body} body), "
          f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}), plain "
          f"{tm['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{tm['library_ms']:.4f} ms; host {tm['host_us']:.1f} µs a "
          f"call ({card})")
    if wrapper is not None and str(dtype) == "torch.bfloat16":
        check(body == "tensor_core", f"phase 5: {name} did not run the "
              "tensor-core body in bf16")
    TIMED.append((name, tm, cases, kern, nbytes / n))
    return tm


def profile_rows(card):
    """Phase 5's second pass: each TIMED row's kernel µs a call on the
    card (``device_us``), its device TB/s and share of its bound."""
    for name, tm, cases, kern, nbytes in TIMED:
        reads = [device_us(lambda: kern(*a)) for a in cases]
        dev = sum(us for us, _ in reads) / len(cases)
        via = "+".join(sorted({how for _, how in reads}))
        check(all(us > 0 for us, _ in reads),
              f"phase 5: {name}: no device time ({via})")
        tm["device_us"], tm["device_by"] = dev, via
        print(f"phase 5: {name}: device {dev:.1f} µs a call ({via}), "
              f"{nbytes / (dev * 1e6):.3f} TB/s, "
              f"{100 * tm['bound_ms'] * 1e3 / dev:.1f}% of the bound; "
              f"host {tm['host_us']:.1f} µs ({card})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke test "
              "runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.deepseek_v2_236b import served
    from repro_torch.core.backend import backend_for
    from repro_torch.kernels import build
    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill_attention import (
        chunked_prefill_attention)
    from repro_torch.kernels.paged_cross_decode_attention import (
        paged_cross_decode_attention)
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.paged_mla_decode_attention import (
        paged_mla_decode_attention)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention)
    from repro_torch.models import model as M
    from repro_torch.models.attention import mla_scale

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    kernels = {"paged_prefill_attention": paged_prefill_attention,
               "paged_decode_attention": paged_decode_attention,
               "paged_mla_decode_attention": paged_mla_decode_attention,
               "paged_cross_decode_attention": paged_cross_decode_attention,
               "chunked_prefill_attention": chunked_prefill_attention}
    check(tuple(kernels) == build.NAMES, f"kernels {build.NAMES}")

    # -- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build()
    for name in build.NAMES:
        check(build.library_path(name).exists(), f"{name}: no library")
        build.load(name)
        info = [ln.strip() for ln in reports.get(name, "").splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"phase 1: built {name} ({'; '.join(info[:4])})")
    print(f"phase 1: build {time.perf_counter() - t0:.1f} s")

    cfg = get_config("qwen2_0_5b")
    ds_cfg = served()
    reqs = make_requests(cfg.vocab_size)
    print(f"requests: prompt lengths {[r.prompt_len for r in reqs]}, "
          f"{NEW_TOKENS} new tokens each")

    # -- phase 2: kernels vs plain versions at the served shapes ---------
    errs, chunks, slot_cases = check_kernels(cfg, reqs, device)
    errs["paged_mla_decode_attention"], mla_slots = check_mla_kernel(
        ds_cfg, reqs, device)
    vlm_cfg, wh_cfg = get_config(VLM_ARCH), get_config(WHISPER_ARCH)
    wh_reqs = make_requests(wh_cfg.vocab_size, lo=WHISPER_PROMPTS[0],
                            hi=WHISPER_PROMPTS[1])
    # 2a: kernels 1 and 2 at the cross models' self-attention widths and
    # served shapes: Llama-3.2-Vision (hd 128, rep 4), Whisper (hd 64,
    # rep 1, prompts of 32-400 tokens)
    self_geo = {}
    for c, rq in ((vlm_cfg, reqs), (wh_cfg, wh_reqs)):
        worst, *self_geo[c.name] = check_kernels(c, rq, device, tag="2a")
        for name, err in worst.items():
            errs[name] = max(errs[name], err)
    # 2c: the cross reads at both cross models' served shapes
    cross_geo = {}
    errs["paged_cross_decode_attention"] = 0.0
    for c, rq in ((vlm_cfg, reqs), (wh_cfg, wh_reqs)):
        worst, cchunks, cslots = check_cross_kernels(c, rq, device)
        cross_geo[c.name] = (cchunks, cslots)
        for name, err in worst.items():
            key = name.split(" ")[0]
            errs[key] = max(errs[key], err)
    # 2d: the dense chunked prefill through its entry, qwen2's and
    # Llama-3.2-Vision's widths
    _, errs["chunked_prefill_attention"] = check_dense_kernel(
        [cfg, vlm_cfg], device, kernels)
    # 2e: kernels 1 and 2 at the served shapes of the slice-8 configs
    slice8_errs, slice8_geo = check_slice8_kernels(device)
    for name, err in slice8_errs.items():
        errs[name] = max(errs[name], err)
    # 2f: kernel 5 at the dense backend's served shapes (RecurrentGemma's
    # hd 256 / rep 16 windowed chunks, the coupled OPT-13B's prompts)
    errs["chunked_prefill_attention"] = max(
        errs["chunked_prefill_attention"], check_dense_cases(
            "2f", dense_served_shapes(get_config(RG_ARCH),
                                      get_config(OPT_ARCH)),
            device, kernels, SEED + 20))
    # 2g: kernel 5 at the dense MLA prefill's widths (hd 192 / hd_v 128)
    # and at the dense cross reads (non-causal, sq > skv included)
    errs["chunked_prefill_attention"] = max(
        errs["chunked_prefill_attention"], check_dense_cases(
            "2g", mla_cross_shapes(ds_cfg, vlm_cfg, wh_cfg), device,
            kernels, SEED + 23))

    # -- phase 3: serve full-width qwen2-0.5b in bf16 --------------------
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = M.init_params(cfg, gen, device)
    launches, pe, de = serve_phase("3", cfg, params, device, kernels, card)
    check(launches["paged_prefill_attention"]
          >= cfg.n_layers * pe.fused_calls > 0, f"prefill launches "
          f"{launches} < {cfg.n_layers} x {pe.fused_calls} fused calls")
    check(launches["paged_decode_attention"]
          >= cfg.n_layers * de.iterations > 0, f"decode launches "
          f"{launches} < {cfg.n_layers} x {de.iterations} iterations")
    del pe, de
    # -- phase 3e: the same weights through the serving API -------------
    _, record3e = cluster_phase(cfg, params, device, kernels, card)
    # -- phase 3i: the same weights, every second request sampled --------
    sampling_phase(cfg, params, device, card)
    # -- phase 3j: the wall-clock AsyncCluster, 4 instances on 4 streams --
    async_phase(cfg, params, device, kernels, card, record3e)
    # -- phase 3k: the prefix cache through both runtimes ----------------
    prefix_phase(cfg, params, device, kernels, card)
    del params
    torch.cuda.empty_cache()

    # -- phase 3b: serve full-width DeepSeek-V2, 4 layers, bf16 ----------
    t0 = time.perf_counter()
    params = M.init_params(ds_cfg, torch.Generator(device=device)
                           .manual_seed(SEED), device)
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"phase 3b: {ds_cfg.name} at {ds_cfg.n_layers} of 60 layers, "
          f"full width, {n_params / 1e9:.2f} G parameters in bf16, drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    ds_launches, pe, de = serve_phase("3b", ds_cfg, params, device,
                                      kernels, card)
    check(ds_launches["paged_mla_decode_attention"]
          >= ds_cfg.n_layers * de.iterations > 0, f"MLA decode launches "
          f"{ds_launches} < {ds_cfg.n_layers} x {de.iterations} iterations")
    spec, ps = backend_for(ds_cfg), SERVE["page_size"]
    shipped = sum(-(-r.prompt_len // ps) * ps for r in reqs)
    check(spec.layout == "latent" and spec.token_width == 576
          and pe.network.bytes_sent
          == shipped * ds_cfg.n_layers * spec.page_token_bytes,
          f"backend {spec}, {pe.network.bytes_sent} bytes sent")
    print(f"phase 3b: latent wire bytes per token per layer "
          f"{spec.page_token_bytes} ({spec.token_width} bf16 scalars); "
          f"{pe.network.bytes_sent} bytes for {shipped} page-aligned "
          f"prompt tokens x {ds_cfg.n_layers} layers")
    del pe, de
    torch.cuda.empty_cache()
    # -- phase 3p: the same weights on the dense backend, and coupled ----
    mla_launches = mla_dense_phase(ds_cfg, params, device, kernels, card)
    del params
    torch.cuda.empty_cache()

    # -- phase 3c: serve Llama-3.2-Vision-11B, full width and depth, bf16 -
    vlm_launches = cross_serve_phase("3c", vlm_cfg, device, kernels, card,
                                     PROMPT_RANGE)
    # -- phase 3d: serve Whisper-tiny whole, bf16 -------------------------
    cross_serve_phase("3d", wh_cfg, device, kernels, card, WHISPER_PROMPTS)
    # -- phase 3l: Whisper's cross pages deduped by the prefix cache ------
    dedupe_phase(wh_cfg, device, kernels, card)
    # -- phase 3q: Llama-3.2-Vision and Whisper on the dense backend -----
    cross_launches = cross_dense_phase(vlm_cfg, wh_cfg, device, kernels,
                                       card)

    # -- phases 3f-3h: the full-attention configs, bf16 -------------------
    opt_run, nemo_run, *more_runs = slice8_configs()
    # -- phase 3o: CoupledEngine on 3f's weights, once 3f's pools are freed
    coupled_launches, opt_stats = {}, {}
    full_attention_phase(
        "3f", opt_run, device, kernels, card,
        watch=DecodeSteps(opt_stats), stats=opt_stats,
        then=lambda p, out: coupled_launches.update(coupled_phase(
            opt_run["cfg"], p, out, device, kernels, card)))
    windowed_phase(nemo_run, device, kernels, card)
    for run in more_runs:
        full_attention_phase("3h", run, device, kernels, card)
    # -- phase 3r: the cost-model runtime against 3f, and at fleet scale --
    costmodel_phase(opt_run, opt_stats, card)
    # -- phases 3m, 3n: RecurrentGemma-9B and xLSTM-1.3B whole, dense ----
    rg_launches = rg_phase(device, kernels, card)
    xlstm_phase(device, kernels, card)

    # -- phase 4: device vs CPU, 2 layers, f32 ---------------------------
    # (phases 4-4f run kernels 1, 5 and 3 in f32 only: their counters,
    # set to 0 here, must show no launch on the tensor-core body)
    zero_launches(kernels)
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_params = M.init_params(cfg2, torch.Generator().manual_seed(SEED + 1),
                               "cpu")
    gpu_params = to_device(cpu_params, device)
    t0 = time.perf_counter()
    runs = []
    for dev, params in ((device, gpu_params), ("cpu", cpu_params)):
        with FirstLogits() as first:
            out = serve(cfg2, params, make_requests(cfg.vocab_size), dev)[0]
        runs.append((out, first.logits))
    (out_gpu, lg_gpu), (out_cpu, lg_cpu) = runs
    check(out_gpu == out_cpu, "device and CPU runs emit different tokens")
    lerr = float((lg_gpu - lg_cpu).abs().max())
    check(lerr <= LOGIT_TOL, f"first-chunk logits differ by {lerr}")
    print(f"phase 4: 2-layer f32 device vs CPU: {len(out_gpu)} token "
          f"streams identical, first-chunk logits max abs err {lerr:.3e} "
          f"(tolerance {LOGIT_TOL:g}), {time.perf_counter() - t0:.1f} s")
    # -- phase 4d: phase 3e's Cluster run, 2 layers, f32, card vs CPU -----
    t0 = time.perf_counter()
    records = [cluster_run(cfg2, params, dev)[1]
               for dev, params in ((device, gpu_params), ("cpu", cpu_params))]
    for rid in set(records[0]) | set(records[1]):
        check(records[0].get(rid) == records[1].get(rid), f"phase 4d: "
              f"{rid} differs: card {records[0].get(rid)}, CPU "
              f"{records[1].get(rid)}")
    print(f"phase 4d: Cluster 2+2, 2-layer f32, card vs CPU: "
          f"{len(records[0])} requests with identical token streams, "
          f"virtual timestamps and instance assignment, "
          f"{time.perf_counter() - t0:.1f} s")
    # -- phase 4f: the async runtime and the prefix cache, card vs CPU ----
    async_vs_cpu(cfg2, gpu_params, device, records[1])
    prefix_vs_cpu(cfg2, gpu_params, cpu_params, device)
    # -- phase 4e: phase 3i's mixed batch, 2 layers, f32, card vs CPU -----
    t0 = time.perf_counter()
    outs = [serve(cfg2, params, sampled_requests(cfg.vocab_size), dev)[0]
            for dev, params in ((device, gpu_params), ("cpu", cpu_params))]
    check(outs[0] == outs[1], "phase 4e: the mixed greedy / sampled batch "
          "differs between the card and the CPU")
    print(f"phase 4e: {cfg.name} 2-layer f32, {N_REQUESTS // 2} greedy + "
          f"{N_REQUESTS // 2} sampled requests: card and CPU streams "
          f"identical, sampled lanes included, "
          f"{time.perf_counter() - t0:.1f} s")
    # -- phase 4g: the dense backend and CoupledEngine, card vs CPU -------
    dense_vs_cpu(cfg2, gpu_params, cpu_params, device)
    del gpu_params, cpu_params

    # -- phase 4b: DeepSeek-V2 device vs CPU, 2 layers, f32 --------------
    deepseek_vs_cpu(device)
    torch.cuda.empty_cache()

    # -- phase 4c: the cross models device vs CPU, f32 --------------------
    cross_vs_cpu(wh_cfg, device)
    cross_vs_cpu(dataclasses.replace(vlm_cfg, n_layers=VLM_CHECK_LAYERS),
                 device)
    torch.cuda.empty_cache()
    # -- phase 4f (iii): Whisper's cross dedupe against none, f32 ---------
    dedupe_vs_off(wh_cfg, device)
    # -- phase 4e: OPT-13B and windowed Mistral-Nemo, 2 layers, f32 -------
    opt2 = dataclasses.replace(opt_run["cfg"], n_layers=2, dtype="float32")
    vs_cpu("OPT-13B", opt2, device, lambda: make_requests(
        opt2.vocab_size, **SLICE8_CHECK), SEED + 10)
    nc = dict(NEMO_CHECK)
    nemo2 = dataclasses.replace(nemo_run["cfg"], n_layers=2,
                                dtype="float32",
                                sliding_window=nc.pop("window"))
    vs_cpu(f"Mistral-Nemo, window {nemo2.sliding_window}, chunks of "
           f"{nc['chunk_size']}", nemo2, device,
           lambda: make_requests(nemo2.vocab_size, n=nc["n"], lo=nc["lo"],
                                 hi=nc["hi"], new=nc["new"]),
           SEED + 11, chunk_size=nc["chunk_size"])
    f32_launches = read_launches(kernels)
    check_bodies("4-4f", f32_launches, "float32")
    check(f32_launches["paged_prefill_attention"] > 0, "phases 4-4f: "
          f"kernel 1 never launched: {f32_launches}")
    print(f"phases 4-4f: launches {f32_launches}: every f32 launch of "
          "kernels 1 and 3 on the CUDA-core body")

    # -- phase 5: kernel times at the served shapes (bf16) ---------------
    dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    pools = random_pools(cfg, SERVE["n_pages"], SERVE["page_size"], dtype,
                         device, gen)
    lat = random_latent_pools(ds_cfg, SERVE["n_pages"], SERVE["page_size"],
                              dtype, device, gen)
    scale = mla_scale(ds_cfg)
    timing = {
        "paged_prefill_attention": time_kernel(
            "paged_prefill_attention",
            [prefill_args(cfg, g, pools, dtype, device, gen)
             for g in chunks],
            paged_prefill_attention, ref.paged_prefill_attention,
            sdpa_prefill_call, lambda a: prefill_work(a[0], a[1], *a[3:]),
            dtype, card, paged_prefill_attention),
        "paged_decode_attention": time_kernel(
            "paged_decode_attention",
            [decode_args(cfg, g, pools, dtype, device, gen)
             for g in slot_cases[:1]],
            paged_decode_attention, ref.paged_decode_attention,
            sdpa_decode_call, lambda a: decode_work(a[0], a[1], *a[3:]),
            dtype, card, body=DECODE_BODY),
        "paged_mla_decode_attention": time_kernel(
            "paged_mla_decode_attention",
            [mla_args(ds_cfg, g, lat, device, gen) for g in mla_slots[:1]],
            lambda *a: paged_mla_decode_attention(*a, scale=scale),
            lambda *a: ref.paged_mla_decode_attention(*a, scale=scale),
            lambda *a: sdpa_mla_call(*a, scale), lambda a: mla_work(*a),
            dtype, card, paged_mla_decode_attention)}
    vlm_pools = random_pools(vlm_cfg, CROSS_PAGES, SERVE["page_size"],
                             dtype, device, gen)
    wh_pools = random_pools(wh_cfg, CROSS_PAGES, SERVE["page_size"], dtype,
                            device, gen)
    (v_chunks, v_slots), (_, w_slots) = (cross_geo[vlm_cfg.name],
                                         cross_geo[wh_cfg.name])
    dec_work = lambda a: decode_work(a[0], a[1], *a[3:])  # noqa: E731
    timing["paged_cross_decode_attention"] = time_kernel(
        f"paged_cross_decode_attention, {vlm_cfg.name}",
        [decode_args(vlm_cfg, g, vlm_pools, dtype, device, gen)
         for g in v_slots[:1]],
        paged_cross_decode_attention, ref.paged_cross_decode_attention,
        sdpa_decode_call, dec_work, dtype, card, body=DECODE_BODY)
    time_kernel(f"paged_cross_decode_attention, {wh_cfg.name}",
                [decode_args(wh_cfg, g, wh_pools, dtype, device, gen)
                 for g in w_slots[:1]],
                paged_cross_decode_attention,
                ref.paged_cross_decode_attention, sdpa_decode_call,
                dec_work, dtype, card, body=DECODE_BODY)
    time_kernel(
        f"paged_prefill_attention causal=False, {vlm_cfg.name} cross read",
        [prefill_args(vlm_cfg, g, vlm_pools, dtype, device, gen)
         for g in v_chunks],
        lambda *a: paged_prefill_attention(*a, causal=False),
        lambda *a: ref.paged_prefill_attention(*a, causal=False),
        lambda *a: sdpa_prefill_call(*a, causal=False),
        lambda a: prefill_work(a[0], a[1], *a[3:], causal=False),
        dtype, card, paged_prefill_attention)
    time_kernel(f"paged_prefill_attention, {vlm_cfg.name} self-attention",
                [prefill_args(vlm_cfg, g, vlm_pools, dtype, device, gen)
                 for g in chunks],
                paged_prefill_attention, ref.paged_prefill_attention,
                sdpa_prefill_call,
                lambda a: prefill_work(a[0], a[1], *a[3:]), dtype, card,
                paged_prefill_attention)
    time_kernel(f"paged_decode_attention, {vlm_cfg.name} self-attention",
                [decode_args(vlm_cfg, g, vlm_pools, dtype, device, gen)
                 for g in slot_cases[:1]],
                paged_decode_attention, ref.paged_decode_attention,
                sdpa_decode_call, dec_work, dtype, card, body=DECODE_BODY)
    _, wh_slots = self_geo[wh_cfg.name]
    time_kernel(f"paged_decode_attention, {wh_cfg.name} self-attention",
                [decode_args(wh_cfg, g, wh_pools, dtype, device, gen)
                 for g in wh_slots[:1]],
                paged_decode_attention, ref.paged_decode_attention,
                sdpa_decode_call, dec_work, dtype, card, body=DECODE_BODY)
    time_kernel(
        f"paged_prefill_attention causal=False, {wh_cfg.name} cross read",
        [prefill_args(wh_cfg, g, wh_pools, dtype, device, gen)
         for g in cross_geo[wh_cfg.name][0]],
        lambda *a: paged_prefill_attention(*a, causal=False),
        lambda *a: ref.paged_prefill_attention(*a, causal=False),
        lambda *a: sdpa_prefill_call(*a, causal=False),
        lambda a: prefill_work(a[0], a[1], *a[3:], causal=False),
        dtype, card, paged_prefill_attention)
    del vlm_pools, wh_pools
    time_kernel(
        "chunked_prefill_attention, phase 2d", [dense_args(cfg, dtype,
                                                           device, gen)],
        chunked_prefill_attention, ref.chunked_prefill_attention,
        sdpa_dense_call, lambda a: dense_work(*a), dtype, card,
        chunked_prefill_attention)
    time_kernel(f"chunked_prefill_attention, {vlm_cfg.name} widths",
                [dense_args(vlm_cfg, dtype, device, gen)],
                chunked_prefill_attention, ref.chunked_prefill_attention,
                sdpa_dense_call, lambda a: dense_work(*a), dtype, card,
                chunked_prefill_attention)
    # kernel 5 on its served paths: RecurrentGemma's chunks of 512 at
    # RG_CHUNKS (window 2,048; the library call on the in-window keys)
    # and the coupled OPT-13B's whole prompts of phase 3o
    rg_cfg, opt_cfg = get_config(RG_ARCH), get_config(OPT_ARCH)
    w, sq, skv = (rg_cfg.local_window, RG_SERVE["chunk_size"],
                  RG_SERVE["max_seq"])
    timing["chunked_prefill_attention"] = time_kernel(
        f"chunked_prefill_attention, {rg_cfg.name} served chunks (3m)",
        [dense_served_case(rg_cfg, 1, sq, q0, skv, [q0 + sq], dtype,
                           device, gen) for q0 in RG_CHUNKS],
        lambda *a: chunked_prefill_attention(*a, window=w),
        lambda *a: ref.chunked_prefill_attention(*a, window=w),
        lambda *a: sdpa_dense_call(*a, window=w),
        lambda a: dense_work(*a, window=w), dtype, card,
        chunked_prefill_attention)
    print(f"phase 5: chunked_prefill_attention, {rg_cfg.name} served chunks "
          f"(3m): {rg_launches['chunked_prefill_attention']} launches in "
          "phase 3m's served run")
    time_kernel(
        f"chunked_prefill_attention, {opt_cfg.name} whole prompts (3o)",
        [dense_served_case(opt_cfg, 1, r.prompt_len, 0, SERVE["max_seq"],
                           [r.prompt_len], dtype, device, gen)
         for r in make_requests(opt_cfg.vocab_size, lo=OPT_PROMPTS[0],
                                hi=OPT_PROMPTS[1])],
        chunked_prefill_attention, ref.chunked_prefill_attention,
        sdpa_dense_call, lambda a: dense_work(*a), dtype, card,
        chunked_prefill_attention)
    print(f"phase 5: chunked_prefill_attention, {opt_cfg.name} whole "
          f"prompts (3o): {coupled_launches['chunked_prefill_attention']} "
          "launches in phase 3o's served run")
    # kernel 5 on the dense MLA prefill (3p's chunks of 512 at
    # MLA_CHUNKS, one request a call) and on the dense cross reads of 3q
    # (Llama-3.2-Vision: a chunk of 512 and the 8 decode slots over
    # 1,600 patches; Whisper: the same over 1,500 frames); the library
    # call on the same dense K/V
    sq, skv = SERVE["chunk_size"], SERVE["max_seq"]
    time_kernel(
        f"chunked_prefill_attention, {ds_cfg.name} dense MLA chunks (3p)",
        [dense_case(mla_widths(ds_cfg), 1, sq, q0, skv, [q0 + sq], dtype,
                    device, gen) for q0 in MLA_CHUNKS],
        chunked_prefill_attention, ref.chunked_prefill_attention,
        sdpa_dense_call, lambda a: dense_work(*a), dtype, card,
        chunked_prefill_attention)
    print(f"phase 5: chunked_prefill_attention, {ds_cfg.name} dense MLA "
          f"chunks (3p): {mla_launches['chunked_prefill_attention']} "
          "launches in phase 3p's served run (engines)")
    engines, coupled, whisper = cross_launches
    for c, served, how in ((vlm_cfg, engines, "engines"),
                           (wh_cfg, whisper, "Cluster")):
        ec = c.cross_ctx
        for what, b, n_q in (("prefill", 1, sq),
                             ("decode", SERVE["max_slots"], 1)):
            time_kernel(
                f"chunked_prefill_attention causal=False, {c.name} cross "
                f"read, {what} (3q)",
                [dense_case(gqa_widths(c), b, n_q, 0, ec, [ec] * b, dtype,
                            device, gen)],
                lambda *a: chunked_prefill_attention(*a, causal=False),
                lambda *a: ref.chunked_prefill_attention(*a, causal=False),
                lambda *a: sdpa_dense_call(*a, causal=False),
                lambda a: dense_work(*a, causal=False), dtype, card,
                chunked_prefill_attention)
        print(f"phase 5: chunked_prefill_attention causal=False, {c.name}: "
              f"{served['chunked_prefill_attention (causal=False)']} "
              f"non-causal launches in phase 3q's served run ({how})"
              + (f", {coupled['chunked_prefill_attention (causal=False)']} "
                 "in its CoupledEngine run" if c is vlm_cfg else ""))
    # kernels 1 and 2 at OPT-13B's served shapes (rep 1) and windowed
    # Mistral-Nemo's (rep 4, the window's trimmed tables; its library
    # calls read the pre-gathered in-window K/V)
    for run in (opt_run, nemo_run):
        c, w = run["cfg"], run["cfg"].sliding_window
        pools8 = random_pools(c, dict(SERVE, **run["over"])["n_pages"],
                              SERVE["page_size"], dtype, device, gen)
        g_chunks, g_slots = slice8_geo[c.name]
        # at most 8 of the chunks, evenly spaced over the run
        g_chunks = g_chunks[::max(1, len(g_chunks) // 8)][:8]
        tag = f"{c.name}" + (f", window {w}" if w else "")
        time_kernel(
            f"paged_prefill_attention, {tag}",
            [prefill_args(c, g, pools8, dtype, device, gen)
             for g in g_chunks],
            lambda *a, w=w: paged_prefill_attention(*a, window=w),
            lambda *a, w=w: ref.paged_prefill_attention(*a, window=w),
            lambda *a, w=w: sdpa_prefill_call(*a, window=w),
            lambda a, w=w: prefill_work(a[0], a[1], *a[3:], window=w),
            dtype, card, paged_prefill_attention)
        time_kernel(
            f"paged_decode_attention, {tag}",
            [decode_args(c, g, pools8, dtype, device, gen)
             for g in g_slots[:1]],
            lambda *a, w=w: paged_decode_attention(*a, window=w),
            lambda *a, w=w: ref.paged_decode_attention(*a, window=w),
            lambda *a, w=w: sdpa_decode_call(*a, window=w),
            lambda a, w=w: decode_work(a[0], a[1], *a[3:], window=w),
            dtype, card, body=DECODE_BODY)
        del pools8
    profile_rows(card)
    # -- phase 3j's traced run: the card's idle and overlap shares --------
    async_trace_phase(cfg, device, card)
    launches["paged_mla_decode_attention"] = ds_launches[
        "paged_mla_decode_attention"]
    launches["paged_cross_decode_attention"] = vlm_launches[
        "paged_cross_decode_attention"]
    # kernel 5's main path: RecurrentGemma's served run (3m), the path
    # its row's times were taken at (3o's launches print beside its row)
    launches["chunked_prefill_attention"] = rg_launches[
        "chunked_prefill_attention"]
    rows = []
    for name in build.NAMES:
        tm = timing[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": SOURCES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
            "body": tm["body"], "tflops": tm["tflops"],
            "host_us": tm["host_us"], "device_us": tm["device_us"],
            "device_by": tm["device_by"]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
