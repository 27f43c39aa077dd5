#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card with CUDA, ``nvcc`` and the repository's
``src/`` beside this file; without a card it exits non-zero at once.
Phases, in order (any failure exits non-zero):

1. Build both CUDA kernels from ``src/repro_torch/kernels/csrc`` and
   print the card's name and power limit.
2. Each kernel against its plain PyTorch version on the same CUDA
   inputs, at the shapes of the served run (every prefill chunk, the
   decode slot batch), f32 and bf16, with ragged lengths, pad segments
   and empty slots on the scratch page, and a windowed case.
3. Serve: full-width qwen2-0.5b in bf16, random weights from a seeded
   generator, one PrefillEngine and one DecodeEngine driven through
   submit -> step -> receive -> admit -> step, 8 greedy requests.  The
   kernels' launch counters are read around this run.
4. Device vs CPU: the same requests at full width, 2 layers, f32, once
   on the card (kernels) and once on the CPU (plain versions): same
   greedy tokens, first-chunk logits within tolerance.
5. Numbers: prefill and decode tokens/s of the served run, and each
   kernel's time at the served shapes beside its bound, its plain
   version and one PyTorch library call, measured with CUDA events.

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
# bf16 outputs may land one bf16 rounding apart (2^-8 of values ~1)
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
# device (cuBLAS, kernels) vs CPU (plain versions) f32 logits after two
# full-width layers and a 151,936-word head: summation order only
LOGIT_TOL = 1e-3
WINDOW = 200                               # the windowed kernel case


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# requests and the geometry the served run gives the kernels
# ---------------------------------------------------------------------------
def make_requests(vocab: int, n: int = N_REQUESTS, lo: int = PROMPT_RANGE[0],
                  hi: int = PROMPT_RANGE[1], new: int = NEW_TOKENS):
    from repro_torch.runtime.request import Request, SamplingParams
    rng = np.random.default_rng(SEED)
    lens = rng.integers(lo, hi + 1, n)
    return [Request(rid=f"r{i}", prompt_len=int(n_tok), decode_len=new,
                    prompt_tokens=rng.integers(0, vocab, int(n_tok))
                    .astype(np.int32),
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
                 length=np.zeros(ns, np.int32), sq=sq)
        for i, s in enumerate(segs):
            table = alloc.table_padded(s.rid, trash)
            g["bt"][i, :len(table)] = table
            g["q_off"][i] = s.req_start
            g["kv_len"][i] = s.req_start + s.length
            g["length"][i] = s.length
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


# ---------------------------------------------------------------------------
# kernel inputs, bounds and library yardsticks
# ---------------------------------------------------------------------------
def random_pools(cfg, n_pages, page, dtype, device, gen):
    import torch
    shape = (n_pages + 1, page, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (torch.randn(shape, generator=gen, device=device).to(dtype),
            torch.randn(shape, generator=gen, device=device).to(dtype))


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


def prefill_work(q, k_pool, bt, kv_len, q_off):
    """(bytes, FLOPs) the function needs on these inputs: q read and out
    written once, each live page's K/V read once, and QK^T + PV for each
    (query head, key) the causal length mask admits."""
    es = q.element_size()
    segs, sq, h, hd = q.shape
    page, kvh = k_pool.shape[1], k_pool.shape[2]
    kv = kv_len.cpu().numpy().astype(np.int64)
    q0 = q_off.cpu().numpy().astype(np.int64)
    pages = np.minimum(-(-kv // page), bt.shape[1]).sum()
    nbytes = (2 * q.numel() * es + pages * page * kvh * 2 * hd * es
              + 4 * (bt.numel() + 2 * segs))
    q_pos = q0[:, None] + np.arange(sq)[None, :]
    keys = np.minimum(kv[:, None], q_pos + 1).clip(min=0).sum()
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


def sdpa_prefill_call(q, k_pool, v_pool, bt, kv_len, q_off):
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
    mask = ((k_pos[None, None, :] < kv_len.long()[:, None, None])
            & (q_pos[:, :, None] >= k_pos[None, None, :]))[:, None]
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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def check_kernels(cfg, reqs, device):
    """Phase 2: kernel vs plain version on the served shapes.  Returns
    ({kernel: max abs error in bf16, the served dtype}, the prefill
    chunk geometries, the decode slot geometries)."""
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
        tol = TOL[str(dtype)]
        pools = random_pools(cfg, SERVE["n_pages"], SERVE["page_size"],
                             dtype, device, gen)
        worst = {pre: 0.0, dec: 0.0}
        for window in (0, WINDOW):
            for g in chunks:
                args = prefill_args(cfg, g, pools, dtype, device, gen)
                got = paged_prefill_attention(*args, window=window)
                exp = ref.paged_prefill_attention(*args, window=window)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(got).all()), "prefill: non-finite")
                worst[pre] = max(worst[pre], float(
                    (got.float() - exp.float()).abs().max()))
            for g in slot_cases:
                args = decode_args(cfg, g, pools, dtype, device, gen)
                got = paged_decode_attention(*args, window=window)
                exp = ref.paged_decode_attention(*args, window=window)
                torch.cuda.synchronize()
                empty = g["lens"] == 0
                check(float(got[torch.from_numpy(empty).to(device)]
                            .float().abs().sum()) == 0.0,
                      "decode: an empty slot did not give zeros")
                worst[dec] = max(worst[dec], float(
                    (got.float() - exp.float()).abs().max()))
        for name, err in worst.items():
            n = len(chunks) if name == pre else len(slot_cases)
            print(f"phase 2: {name} vs plain, {dtype}, {n} served shapes x "
                  f"window 0/{WINDOW}: max abs err {err:.3e} (tolerance "
                  f"{tol:g})")
            check(err <= tol, f"{name} disagrees with its plain version "
                  f"in {dtype}: {err} > {tol}")
    return worst, chunks, slot_cases


def serve(cfg, params, reqs, device, time_it=False):
    """Drive the port's engines over ``reqs``; returns (tokens by rid,
    prefill engine, decode engine, prefill seconds, decode seconds)."""
    import torch
    from repro_torch.core.decode_engine import DecodeEngine
    from repro_torch.core.prefill_engine import PrefillEngine
    pe = PrefillEngine("p0", cfg, params, device=device,
                       chunk_size=SERVE["chunk_size"],
                       max_seq=SERVE["max_seq"], n_pages=SERVE["n_pages"],
                       page_size=SERVE["page_size"])
    de = DecodeEngine("d0", cfg, params, device=device,
                      max_slots=SERVE["max_slots"], max_seq=SERVE["max_seq"],
                      n_pages=SERVE["n_pages"],
                      page_size=SERVE["page_size"])
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


def first_chunk_logits(cfg, params, g, reqs, device):
    """Logits of the first served chunk through ``model.prefill_paged``
    on ``device`` (a fresh pool; the chunk's segments start at 0)."""
    import torch
    from repro_torch.core.prefill_engine import make_page_pool
    from repro_torch.models import model as M
    pool, trash = make_page_pool(cfg, SERVE["n_pages"], SERVE["page_size"],
                                 device)
    ps, sq = SERVE["page_size"], g["sq"]
    by_len = sorted(reqs, key=lambda r: r.prompt_len)
    ns = g["bt"].shape[0]
    toks = np.zeros((ns, sq), np.int32)
    pg = np.full((ns, sq), trash, np.int32)
    off = np.tile(np.arange(sq, dtype=np.int32) % ps, (ns, 1))
    last = np.maximum(g["length"] - 1, 0).astype(np.int32)
    for i in range(ns):
        n, q0 = int(g["length"][i]), int(g["q_off"][i])
        check(q0 == 0, "first chunk segment does not start its request")
        if n:
            toks[i, :n] = by_len[i].prompt_tokens[:n]
            pos = np.arange(n)
            pg[i, :n] = g["bt"][i][pos // ps]
            off[i, :n] = pos % ps

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    nxt, logits = M.prefill_paged(params, cfg, t(toks), t(g["q_off"]),
                                  t(g["kv_len"]), t(last), t(g["bt"]),
                                  t(pg), t(off), pool.k, pool.v)
    n_real = int((g["length"] > 0).sum())
    return logits[:n_real].float().cpu()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke test "
              "runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.paged_prefill_attention import (
        paged_prefill_attention)
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

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
    reqs = make_requests(cfg.vocab_size)
    print(f"requests: prompt lengths {[r.prompt_len for r in reqs]}, "
          f"{NEW_TOKENS} new tokens each")

    # -- phase 2: kernels vs plain versions at the served shapes ---------
    errs, chunks, slot_cases = check_kernels(cfg, reqs, device)

    # -- phase 3: serve full-width qwen2-0.5b in bf16 --------------------
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = M.init_params(cfg, gen, device)
    warm = make_requests(cfg.vocab_size, n=1, lo=64, hi=64, new=2)
    serve(cfg, params, warm, device)            # warm-up: libraries, cuBLAS
    paged_prefill_attention.launches = 0
    paged_decode_attention.launches = 0
    out, pe, de, t_pre, t_dec = serve(cfg, params,
                                      make_requests(cfg.vocab_size), device,
                                      time_it=True)
    launches = {"paged_prefill_attention": paged_prefill_attention.launches,
                "paged_decode_attention": paged_decode_attention.launches}
    check(len(out) == N_REQUESTS, f"{len(out)} of {N_REQUESTS} finished")
    for rid, toks in out.items():
        check(len(toks) == NEW_TOKENS, f"{rid}: {len(toks)} tokens")
        check(all(0 <= x < cfg.vocab_size for x in toks), f"{rid}: token "
              "out of the vocabulary")
    check(pe.alloc.used_pages == 0 and de.alloc.used_pages == 0,
          f"pages left: prefill {pe.alloc.used_pages}, decode "
          f"{de.alloc.used_pages}")
    check(launches["paged_prefill_attention"]
          >= cfg.n_layers * pe.fused_calls > 0, f"prefill launches "
          f"{launches} < {cfg.n_layers} x {pe.fused_calls} fused calls")
    check(launches["paged_decode_attention"]
          >= cfg.n_layers * de.iterations > 0, f"decode launches "
          f"{launches} < {cfg.n_layers} x {de.iterations} iterations")
    n_prompt = sum(r.prompt_len for r in reqs)
    n_decoded = sum(len(t) - 1 for t in out.values())
    print(f"phase 3: served {len(out)} requests, {pe.fused_calls} fused "
          f"prefill calls, {de.iterations} decode iterations, launches "
          f"{launches}, pages left 0/0")
    print(f"phase 3: prefill {n_prompt} tokens in {t_pre:.3f} s = "
          f"{n_prompt / t_pre:.1f} tokens/s; decode {n_decoded} tokens in "
          f"{t_dec:.3f} s = {n_decoded / t_dec:.1f} tokens/s ({card})")
    del params, pe, de
    torch.cuda.empty_cache()

    # -- phase 4: device vs CPU, 2 layers, f32 ---------------------------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_params = M.init_params(cfg2, torch.Generator().manual_seed(SEED + 1),
                               "cpu")
    gpu_params = {k: v.to(device) for k, v in cpu_params.items()
                  if k != "layers"}
    gpu_params["layers"] = [
        {k: ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict)
             else v.to(device)) for k, v in layer.items()}
        for layer in cpu_params["layers"]]
    t0 = time.perf_counter()
    out_gpu = serve(cfg2, gpu_params, make_requests(cfg.vocab_size),
                    device)[0]
    out_cpu = serve(cfg2, cpu_params, make_requests(cfg.vocab_size),
                    "cpu")[0]
    check(out_gpu == out_cpu, "device and CPU runs emit different tokens")
    lg_gpu = first_chunk_logits(cfg2, gpu_params, chunks[0], reqs, device)
    lg_cpu = first_chunk_logits(cfg2, cpu_params, chunks[0], reqs, "cpu")
    lerr = float((lg_gpu - lg_cpu).abs().max())
    check(lerr <= LOGIT_TOL, f"first-chunk logits differ by {lerr}")
    print(f"phase 4: 2-layer f32 device vs CPU: {len(out_gpu)} token "
          f"streams identical, first-chunk logits max abs err {lerr:.3e} "
          f"(tolerance {LOGIT_TOL:g}), {time.perf_counter() - t0:.1f} s")
    del gpu_params, cpu_params

    # -- phase 5: kernel times at the served shapes (bf16) ---------------
    dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    pools = random_pools(cfg, SERVE["n_pages"], SERVE["page_size"], dtype,
                         device, gen)
    rows = []
    timing = {}
    pre = [prefill_args(cfg, g, pools, dtype, device, gen) for g in chunks]
    dec = [decode_args(cfg, g, pools, dtype, device, gen)
           for g in slot_cases[:1]]
    for name, cases, kern, plain, lib, work in (
            ("paged_prefill_attention", pre, paged_prefill_attention,
             ref.paged_prefill_attention, sdpa_prefill_call,
             lambda a: prefill_work(a[0], a[1], *a[3:])),
            ("paged_decode_attention", dec, paged_decode_attention,
             ref.paged_decode_attention, sdpa_decode_call,
             lambda a: decode_work(a[0], a[1], *a[3:]))):
        ms = plain_ms = lib_ms = bnd = 0.0
        by_bytes = 0
        for a in cases:
            ms += cuda_ms(lambda: kern(*a))
            plain_ms += cuda_ms(lambda: plain(*a))
            lib_ms += cuda_ms(lib(*a))
            b, by = bound(*work(a), dtype)
            bnd += b
            by_bytes += by == "bytes"
        n = len(cases)
        timing[name] = dict(ms=ms / n, plain_ms=plain_ms / n,
                            library_ms=lib_ms / n, bound_ms=bnd / n,
                            bound_by="bytes" if by_bytes * 2 >= n
                            else "operations")
        print(f"phase 5: {name}, bf16, mean over {n} served shape(s): "
              f"kernel {ms / n:.4f} ms, bound {bnd / n:.4f} ms "
              f"({timing[name]['bound_by']}), plain {plain_ms / n:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms / n:.4f} ms ({card})")
    sources = {"paged_prefill_attention":
               "src/repro/kernels/paged_prefill_attention.py:101",
               "paged_decode_attention":
               "src/repro/kernels/paged_decode_attention.py:91"}
    for name in build.NAMES:
        tm = timing[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"]})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
