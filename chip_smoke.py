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
   with f32 queries against f32 and bf16 latent pools (2b), and the
   cross reads at Llama-3.2-Vision's and Whisper's served shapes (2c):
   the cross decode kernel and the prefill kernel with
   ``causal=False``.  2d: the dense chunked-prefill kernel, driven
   through its entry (``ops.prefill_attention`` with no block table) and
   held against its plain version at qwen2's and Llama-3.2-Vision's
   widths (8 requests, a 512-query chunk at 512 in caches of 2048,
   ragged kv_len with a 0), causal and windowed, and against the paged
   prefill kernel on the same K/V laid out as pages.  bf16 outputs are
   held to a limit scaled by the plain output's magnitude (``limit``).
   The prefill kernels (1 and 5) run bf16 on their tensor-core body and
   f32 on their CUDA-core body: 2d, 3-3e and 4-4d check it on the
   wrappers' ``tensor_core_launches``.
3. Serve: one PrefillEngine and one DecodeEngine driven through submit
   -> step -> receive -> admit -> step, 8 greedy requests, random
   weights from a seeded generator, bf16: full-width qwen2-0.5b (3),
   DeepSeek-V2 at full width and 4 layers (3b: MLA latent pages, routed
   MoE), Llama-3.2-Vision-11B at full width and depth (3c) and
   Whisper-tiny whole (3d), both with read-only cross pages and stub
   frontend embeddings.  3e: full-width qwen2-0.5b through the serving
   API, ``Cluster(runtime="engine")`` with 2 prefill and 2 decode
   instances: the 8 requests streamed, a ninth cancelled after its third
   streamed token.  Every kernel's launch counter is set to 0 just
   before each run and read just after it.
4. Device vs CPU in f32, once on the card (kernels) and once on the CPU
   (plain versions): qwen2-0.5b at 2 layers on the served requests (4),
   DeepSeek-V2 at 2 layers (dense prefix + 1 routed) on 2 short requests
   (4b), Whisper-tiny whole and Llama-3.2-Vision at one pattern period
   (5 layers) on 2 short requests (4c): same greedy tokens, first-chunk
   logits within tolerance.  4d: phase 3e's Cluster run at 2 layers in
   f32, on the card and on the CPU: the same token streams, virtual
   timestamps and instance assignment.
5. Numbers: prefill and decode tokens/s of the served runs, and each
   kernel's time at the served shapes beside its bound, its plain
   version and one PyTorch library call, measured with CUDA events,
   with its achieved TFLOP/s, the body it ran and the wrapper's host µs
   a call; then, every row timed, the card's device µs a call by the
   profiler, with the device TB/s and share of the bound.

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
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


def prefill_geometry(reqs, chunk_size, page_size, max_seq, n_pages):
    """The chunks the served prefill engine runs, packed as its
    ``_step_paged`` packs them: its scheduler's order, its allocator's
    tables, its chunk partition.  Returns a list of numpy dicts."""
    from repro_torch.core import chunking
    from repro_torch.core.sched.prefill_scheduler import PrefillScheduler
    from repro_torch.kvcache.paged import PagedAllocator
    sched = PrefillScheduler()
    for r in reqs:
        sched.add(r)
    order = sched.next_batch(sched.sched_batch)
    alloc = PagedAllocator(n_pages=n_pages, page_size=page_size)
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
    return out


def decode_geometry(reqs, page_size, max_seq, n_pages, max_slots,
                    generated=NEW_TOKENS // 2, empty=0):
    """The decode slot batch mid-run: every request ``generated`` tokens
    in, the last ``empty`` slots free (lens 0, rows on the scratch page)."""
    from repro_torch.kvcache.paged import PagedAllocator
    alloc = PagedAllocator(n_pages=n_pages, page_size=page_size)
    trash, width = n_pages, alloc.pages_for(max_seq)
    bt = np.full((max_slots, width), trash, np.int32)
    lens = np.zeros(max_slots, np.int32)
    for s, r in enumerate(reqs[:max_slots - empty]):
        n = r.prompt_len + generated
        alloc.alloc(r.rid, n)
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


def prefill_work(q, k_pool, bt, kv_len, q_off, causal=True):
    """(bytes, FLOPs) the function needs on these inputs: q read and out
    written once, each live page's K/V read once, and QK^T + PV for each
    (query head, key) the length mask (and the causal one) admits."""
    es = q.element_size()
    segs, sq, h, hd = q.shape
    page, kvh = k_pool.shape[1], k_pool.shape[2]
    kv = kv_len.cpu().numpy().astype(np.int64)
    q0 = q_off.cpu().numpy().astype(np.int64)
    pages = np.minimum(-(-kv // page), bt.shape[1]).sum()
    nbytes = (2 * q.numel() * es + pages * page * kvh * 2 * hd * es
              + 4 * (bt.numel() + 2 * segs))
    q_pos = q0[:, None] + np.arange(sq)[None, :]
    if causal:
        keys = np.minimum(kv[:, None], q_pos + 1).clip(min=0).sum()
    else:
        keys = (kv * sq).sum()
    return nbytes, int(keys) * h * 4 * hd


def decode_work(q, k_pool, bt, lens):
    es = q.element_size()
    b, h, hd = q.shape
    page, kvh = k_pool.shape[1], k_pool.shape[2]
    ln = lens.cpu().numpy().astype(np.int64)
    pages = np.minimum(-(-ln // page), bt.shape[1]).sum()
    nbytes = (2 * q.numel() * es + pages * page * kvh * 2 * hd * es
              + 4 * (bt.numel() + b))
    return nbytes, int(ln.sum()) * h * 4 * hd


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


def sdpa_prefill_call(q, k_pool, v_pool, bt, kv_len, q_off, causal=True):
    """One library call computing the prefill function on pre-gathered
    dense K/V with an explicit mask (a yardstick: the port never uses
    it)."""
    import torch
    import torch.nn.functional as F
    segs, sq, h, hd = q.shape
    n_keys = max(1, int(kv_len.max()))
    k, v = dense_kv(k_pool, v_pool, bt, n_keys, h // k_pool.shape[2])
    k_pos = torch.arange(n_keys, device=q.device)
    q_pos = q_off.long()[:, None] + torch.arange(sq, device=q.device)
    mask = k_pos[None, None, :] < kv_len.long()[:, None, None]
    if causal:
        mask = mask & (q_pos[:, :, None] >= k_pos[None, None, :])
    mask = mask.expand(segs, sq, n_keys)[:, None]
    qt = q.permute(0, 2, 1, 3).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def sdpa_decode_call(q, k_pool, v_pool, bt, lens):
    import torch
    import torch.nn.functional as F
    b, h, hd = q.shape
    n_keys = max(1, int(lens.max()))
    k, v = dense_kv(k_pool, v_pool, bt, n_keys, h // k_pool.shape[2])
    mask = (torch.arange(n_keys, device=q.device)[None, :]
            < lens.long()[:, None])[:, None, None]
    qt = q[:, :, None]
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def random_latent_pools(cfg, n_pages, page, dtype, device, gen):
    import torch
    m = cfg.mla
    return tuple(torch.randn((n_pages + 1, page, w), generator=gen,
                             device=device).to(dtype)
                 for w in (m.kv_lora_rank, m.qk_rope_head_dim))


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


def dense_keys(q, kv_len, q_off, window=0):
    """(b, sq) int64 numpy: the keys each row may attend (causal, below
    kv_len, inside the window)."""
    sq = q.shape[1]
    q_pos = q_off + np.arange(sq)[None, :]
    hi = np.minimum(kv_len.cpu().numpy().astype(np.int64)[:, None],
                    q_pos + 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else 0
    return np.maximum(hi - lo, 0)


def dense_work(q, k_cache, v_cache, kv_len, q_off, window=0):
    """(bytes, FLOPs) the dense prefill needs on these inputs: q read and
    out written once, each request's K/V read once up to min(kv_len,
    end of the chunk), and QK^T + PV for each (query head, key) the
    masks admit."""
    es = q.element_size()
    b, sq, h, hd = q.shape
    kvh, hd_v = k_cache.shape[2], v_cache.shape[3]
    kv = np.minimum(kv_len.cpu().numpy().astype(np.int64), q_off + sq)
    nbytes = (q.numel() * es + b * sq * h * hd_v * es
              + int(kv.sum()) * kvh * (hd + hd_v) * es + 4 * b)
    keys = int(dense_keys(q, kv_len, q_off, window).sum())
    return nbytes, keys * h * 2 * (hd + hd_v)


def sdpa_dense_call(q, k_cache, v_cache, kv_len, q_off):
    """One library call computing the dense prefill on the dense caches
    (heads expanded to the query heads) with the boolean causal and
    length mask (a yardstick: the port never uses it)."""
    import torch
    import torch.nn.functional as F
    b, sq, h, hd = q.shape
    skv, rep = k_cache.shape[1], h // k_cache.shape[2]
    k = k_cache.permute(0, 2, 1, 3).repeat_interleave(rep, 1).contiguous()
    v = v_cache.permute(0, 2, 1, 3).repeat_interleave(rep, 1).contiguous()
    k_pos = torch.arange(skv, device=q.device)
    q_pos = q_off + torch.arange(sq, device=q.device)
    mask = ((k_pos[None, None, :] < kv_len.long()[:, None, None])
            & (q_pos[None, :, None] >= k_pos[None, None, :]))[:, None]
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


def device_us(fn, reps: int = 20) -> float:
    """The card's kernel µs a call of ``fn`` by the profiler (every launch
    of a call summed).  A profiler session can slow later launches on the
    host, so host times are taken before the first one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def check_kernels(cfg, reqs, device, tag="2"):
    """Phase 2 (2a): kernels 1 and 2 vs their plain versions on the
    served shapes at ``cfg``'s attention widths, the scratch page full of
    garbage; kernel 2 also on ``edge_geometry``'s batch for each window.
    Returns ({kernel: max abs error in bf16, the served dtype}, the
    prefill chunk geometries, the decode slot geometries)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention)
    kw = {k: SERVE[k] for k in ("page_size", "max_seq", "n_pages")}
    chunks = prefill_geometry(reqs, SERVE["chunk_size"], **kw)
    slot_cases = [decode_geometry(reqs, max_slots=SERVE["max_slots"],
                                  empty=e, **kw) for e in (0, 3)]
    gen = torch.Generator(device=device).manual_seed(SEED)
    pre, dec = "paged_prefill_attention", "paged_decode_attention"
    for dtype in (torch.float32, torch.bfloat16):
        pools = random_pools(cfg, SERVE["n_pages"], SERVE["page_size"],
                             dtype, device, gen, garbage=True)
        worst = {}
        for window in (0, WINDOW):
            edge = edge_geometry(max_slots=SERVE["max_slots"],
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
                  f"{cfg.resolved_head_dim}, {n} x window 0/{WINDOW}: max "
                  f"abs err {err:.3e}, at most {share:.3f} of a case's "
                  "limit (limit())")
    return {k: v[0] for k, v in worst.items()}, chunks, slot_cases


def check_mla_kernel(cfg, reqs, device):
    """Phase 2b: the MLA decode kernel vs its plain version at the
    DeepSeek-V2 served decode shapes: f32 queries against f32 and bf16
    latent pools, window 0 and WINDOW, full and partly empty slot
    batches.  Returns (max abs error of the bf16-pool case, the slot
    geometries)."""
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
                                    SERVE["page_size"], dtype, device, gen)
        err = 0.0
        for window in (0, WINDOW):
            for g in slot_cases:
                args = mla_args(cfg, g, pools, device, gen)
                kwa = dict(scale=mla_scale(cfg), window=window)
                got = paged_mla_decode_attention(*args, **kwa)
                exp = ref.paged_mla_decode_attention(*args, **kwa)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), "mla: non-finite")
                empty = torch.from_numpy(g["lens"] == 0).to(device)
                check(float(got[empty].abs().sum()) == 0.0,
                      "mla: an empty slot did not give zeros")
                err = max(err, float((got - exp).abs().max()))
        print(f"phase 2b: paged_mla_decode_attention vs plain, f32 queries, "
              f"{dtype} pools, {len(slot_cases)} served slot batches x "
              f"window 0/{WINDOW}: max abs err {err:.3e} (tolerance "
              f"{tol:g})")
        check(err <= tol, f"paged_mla_decode_attention disagrees with its "
              f"plain version on {dtype} pools: {err} > {tol}")
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


def serve(cfg, params, reqs, device, time_it=False, n_pages=None):
    """Drive the port's engines over ``reqs`` (``n_pages`` a pool, the
    SERVE value unless given); returns (tokens by rid, prefill engine,
    decode engine, prefill seconds, decode seconds)."""
    import torch
    from repro_torch.core.decode_engine import DecodeEngine
    from repro_torch.core.prefill_engine import PrefillEngine
    n_pages = n_pages or SERVE["n_pages"]
    pe = PrefillEngine("p0", cfg, params, device=device,
                       chunk_size=SERVE["chunk_size"],
                       max_seq=SERVE["max_seq"], n_pages=n_pages,
                       page_size=SERVE["page_size"])
    de = DecodeEngine("d0", cfg, params, device=device,
                      max_slots=SERVE["max_slots"], max_seq=SERVE["max_seq"],
                      n_pages=n_pages, page_size=SERVE["page_size"])
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
            de.receive(pk, now=t)
        de.admit(t)
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
    """Records, while active, the logits of the first
    ``model.prefill_paged`` call (rows of segments with tokens), on the
    CPU."""

    def __enter__(self):
        from repro_torch.models import model as M
        self._saved = M.prefill_paged
        self.logits = None

        def prefill(params, cfg, tokens, q_offset, kv_len, *a, **kw):
            nxt, logits = self._saved(params, cfg, tokens, q_offset, kv_len,
                                      *a, **kw)
            if self.logits is None:
                self.logits = logits[kv_len > 0].float().cpu()
            return nxt, logits
        M.prefill_paged = prefill
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as M
        M.prefill_paged = self._saved


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


PREFILL_KERNELS = ("paged_prefill_attention", "chunked_prefill_attention")


def read_launches(kernels):
    """The launch counters by kernel; kernel 1's non-causal launches
    under ``paged_prefill_attention (causal=False)`` and the prefill
    kernels' tensor-core launches under ``<name> (tensor cores)``."""
    launches = {name: fn.launches for name, fn in kernels.items()}
    launches["paged_prefill_attention (causal=False)"] = kernels[
        "paged_prefill_attention"].noncausal_launches
    for name in PREFILL_KERNELS:
        launches[f"{name} (tensor cores)"] = kernels[name].tensor_core_launches
    return launches


def check_bodies(tag, launches, dtype):
    """Every launch of the prefill kernels ran the tensor-core body in
    bf16 and the CUDA-core body in f32."""
    for name in PREFILL_KERNELS:
        tc = launches[f"{name} (tensor cores)"]
        want = launches[name] if dtype == "bfloat16" else 0
        check(tc == want, f"phase {tag}: {name} launched {launches[name]} "
              f"times, {tc} on the tensor-core body, in {dtype}")


def serve_phase(tag, cfg, params, device, kernels, card,
                prompts=PROMPT_RANGE, enc=None, n_pages=None):
    """Phase 3/3b/3c/3d: warm up, then serve the N_REQUESTS requests
    (tokens drawn in ``cfg``'s vocabulary, prompt lengths in
    ``prompts``, frontend embeddings ``enc``) with every launch counter
    set to 0 just before and read just after.  Checks the run (every
    bf16 launch of kernels 1 and 5 on the tensor-core body) and prints
    its numbers; returns (launches by kernel as ``read_launches`` gives
    them, prefill engine, decode engine)."""
    reqs = make_requests(cfg.vocab_size, lo=prompts[0], hi=prompts[1],
                         enc=enc)
    warm = make_requests(cfg.vocab_size, n=1, lo=64, hi=64, new=2)
    # warm-up: libraries, cuBLAS
    serve(cfg, params, warm, device, n_pages=n_pages)
    zero_launches(kernels)
    out, pe, de, t_pre, t_dec = serve(cfg, params, reqs, device,
                                      time_it=True, n_pages=n_pages)
    launches = read_launches(kernels)
    check_bodies(tag, launches, cfg.dtype)
    check(len(out) == len(reqs), f"{len(out)} of {len(reqs)} finished")
    for rid, toks in out.items():
        check(len(toks) == NEW_TOKENS, f"{rid}: {len(toks)} tokens")
        check(all(0 <= x < cfg.vocab_size for x in toks), f"{rid}: token "
              "out of the vocabulary")
    check(pe.alloc.used_pages == 0 and de.alloc.used_pages == 0,
          f"pages left: prefill {pe.alloc.used_pages}, decode "
          f"{de.alloc.used_pages}")
    n_prompt = sum(r.prompt_len for r in reqs)
    n_decoded = sum(len(t) - 1 for t in out.values())
    print(f"phase {tag}: served {len(out)} requests, {pe.fused_calls} fused "
          f"prefill calls, {de.iterations} decode iterations, launches "
          f"{launches}, pages left 0/0")
    print(f"phase {tag}: prefill {n_prompt} tokens in {t_pre:.3f} s = "
          f"{n_prompt / t_pre:.1f} tokens/s; decode {n_decoded} tokens in "
          f"{t_dec:.3f} s = {n_decoded / t_dec:.1f} tokens/s ({card})")
    return launches, pe, de


def deepseek_vs_cpu(device):
    """Phase 4b: DeepSeek-V2 at full width, 2 layers (dense prefix + 1
    routed), f32, weights drawn on the card and copied to the CPU; the
    same 2 short requests served on both; first-chunk logits within
    LOGIT_TOL, token streams identical unless a routing near-tie or a
    near-tied argmax explains the divergence (printed as such)."""
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
    logits within LOGIT_TOL."""
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
    runs = []
    for dev, params in ((device, gpu_params), ("cpu", cpu_params)):
        with FirstLogits() as rec:
            out, pe, _, _, _ = serve(cfg, params, make_requests(
                cfg.vocab_size, enc=enc, **CROSS_CHECK), dev, n_pages=512)
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
    return launches


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
    and the body the kernel ran: ``body``, or for a prefill kernel (its
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
        dev = sum(device_us(lambda: kern(*a)) for a in cases) / len(cases)
        check(dev > 0, f"phase 5: {name}: the profiler saw no kernel")
        tm["device_us"] = dev
        print(f"phase 5: {name}: device {dev:.1f} µs a call (profiler), "
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
    dense_launches, errs["chunked_prefill_attention"] = check_dense_kernel(
        [cfg, vlm_cfg], device, kernels)

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
    cluster_phase(cfg, params, device, kernels, card)
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
    del params, pe, de
    torch.cuda.empty_cache()

    # -- phase 3c: serve Llama-3.2-Vision-11B, full width and depth, bf16 -
    vlm_launches = cross_serve_phase("3c", vlm_cfg, device, kernels, card,
                                     PROMPT_RANGE)
    # -- phase 3d: serve Whisper-tiny whole, bf16 -------------------------
    cross_serve_phase("3d", wh_cfg, device, kernels, card, WHISPER_PROMPTS)

    # -- phase 4: device vs CPU, 2 layers, f32 ---------------------------
    # (phases 4-4d run the prefill kernels in f32 only: their counters,
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
    del gpu_params, cpu_params

    # -- phase 4b: DeepSeek-V2 device vs CPU, 2 layers, f32 --------------
    deepseek_vs_cpu(device)
    torch.cuda.empty_cache()

    # -- phase 4c: the cross models device vs CPU, f32 --------------------
    cross_vs_cpu(wh_cfg, device)
    cross_vs_cpu(dataclasses.replace(vlm_cfg, n_layers=VLM_CHECK_LAYERS),
                 device)
    torch.cuda.empty_cache()
    f32_launches = read_launches(kernels)
    check_bodies("4-4d", f32_launches, "float32")
    check(f32_launches["paged_prefill_attention"] > 0, "phases 4-4d: "
          f"kernel 1 never launched: {f32_launches}")
    print(f"phases 4-4d: launches {f32_launches}: every f32 prefill launch "
          "on the CUDA-core body")

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
            dtype, card)}
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
    timing["chunked_prefill_attention"] = time_kernel(
        "chunked_prefill_attention", [dense_args(cfg, dtype, device, gen)],
        chunked_prefill_attention, ref.chunked_prefill_attention,
        sdpa_dense_call, lambda a: dense_work(*a), dtype, card,
        chunked_prefill_attention)
    time_kernel(f"chunked_prefill_attention, {vlm_cfg.name} widths",
                [dense_args(vlm_cfg, dtype, device, gen)],
                chunked_prefill_attention, ref.chunked_prefill_attention,
                sdpa_dense_call, lambda a: dense_work(*a), dtype, card,
                chunked_prefill_attention)
    profile_rows(card)
    launches["paged_mla_decode_attention"] = ds_launches[
        "paged_mla_decode_attention"]
    launches["paged_cross_decode_attention"] = vlm_launches[
        "paged_cross_decode_attention"]
    launches["chunked_prefill_attention"] = dense_launches[
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
            "host_us": tm["host_us"], "device_us": tm["device_us"]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
