"""One run of a cell: the program serves the cell's traffic through
``repro_torch.serving.AsyncCluster`` (one prefill and one decode
instance, each on its own CUDA stream), the benchmark's own open-loop
client submits each request when it is due, and the reference then
judges a sample of what was served.

Every request due in the window is measured from the instant it was
due until it finishes or the mix's drain time runs out.  The per-layer
metrics read the window itself: the
engines' counters and the device trace from its opening to its close,
and the work served in it (the prompt tokens prefilled and the tokens
streamed by the close).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import List, Optional

import numpy as np
import torch

from portbench import spec as S
from portbench import trace as TR
from portbench import traffic as T
from portbench import weights as W
from portbench import work
from portbench.reference.decoder import Decoder, widest_gap

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAN = float("nan")


@dataclasses.dataclass
class Rec:
    """One request of the window, its instants in host monotonic
    seconds."""
    rid: str
    due: float
    submit: float
    prompt_len: int
    n_out: int
    prompt: np.ndarray
    handle: object = None
    finished: bool = False
    failed: bool = False
    prefill_start: float = NAN
    first: float = NAN
    decode_start: float = NAN
    finish: float = NAN
    n_tokens: int = 0          # tokens streamed by the end of the run
    n_window: int = 0          # tokens streamed before the window closed
    prefilled_window: int = 0  # prompt tokens prefilled by then
    tokens: Optional[list] = None


@dataclasses.dataclass
class RunData:
    """What the metric readers read (``metrics/<name>.py``)."""
    cfg: dict
    widths: work.Widths
    chunk: int
    requests: List[Rec]
    window_s: float            # the window the requests were due in
    setup_s: float
    prefill_busy_s: float
    prefill_chunks: int
    decode_busy_s: float
    decode_iterations: int
    trace: Optional[TR.Trace] = None
    trace_s: float = 0.0       # seconds spent reading the trace
    t_open: float = 0.0
    t_close: float = 0.0
    pool_peak: float = 0.0     # the decode pool's fullest share seen
    c0: float = 0.0            # the cluster's clock origin, host seconds


def collect(run: RunData) -> None:
    """Fill each request's outcome from its handle, once the cluster's
    workers have stopped: a worker marks a request finished before it
    streams the last token, so a handle read while they run can be a
    token short."""
    for r in run.requests:
        res = r.handle.result(wait=False)
        req = r.handle.request
        r.tokens = list(res.tokens)
        r.n_tokens = len(r.tokens)
        r.finished = res.phase.value == "finished"
        r.failed = not r.finished
        if req.t_prefill_start >= 0:
            r.prefill_start = run.c0 + req.t_prefill_start
        if res.t_first_token >= 0:
            r.first = run.c0 + res.t_first_token
        if req.t_decode_start >= 0:
            r.decode_start = run.c0 + req.t_decode_start
        if r.finished:
            r.finish = run.c0 + res.t_finish
        r.handle = None            # the handle holds the cluster alive


def write_records(run: RunData, path) -> None:
    """One JSON line a request of the window, its instants in seconds
    after the window opened (None where it never got there)."""
    import json

    def rel(t):
        return round(t - run.t_open, 6) if math.isfinite(t) else None
    with open(path, "w") as f:
        for r in run.requests:
            f.write(json.dumps({
                "rid": r.rid, "due": rel(r.due), "submit": rel(r.submit),
                "prefill_start": rel(r.prefill_start),
                "first": rel(r.first), "decode_start": rel(r.decode_start),
                "finish": rel(r.finish), "prompt_len": r.prompt_len,
                "n_out": r.n_out, "n_tokens": r.n_tokens,
                "n_window": r.n_window,
                "prefilled_window": r.prefilled_window,
                "failed": r.failed}) + "\n")


def registry_config(cfg: dict):
    """The port's registry config the file names (``<arch>`` or
    ``<arch>.smoke`` for the CPU tests' widths)."""
    from repro_torch.configs import get_config, get_smoke_config
    arch, _, variant = cfg["registry"].partition(".")
    return get_smoke_config(arch) if variant == "smoke" else get_config(arch)


class Cell:
    """A cell's files, and its model's weights drawn from one seed."""

    def __init__(self, spec: S.Spec, name: str, seed: int, device):
        self.name = name
        self.entry = spec.cell(name)
        self.cfg = spec.config(self.entry["config"])
        self.mix = spec.traffic(self.entry["traffic"])
        self.settings = spec.cell_settings(name)
        self.registry = registry_config(self.cfg)
        S.check_registry(self.cfg, self.registry)
        self.device = torch.device(device)
        self.seed = seed
        self.params = W.make(self.cfg, seed, self.device)

    def cluster(self):
        from repro_torch.core.predictor import OraclePredictor
        from repro_torch.serving.async_runtime import AsyncCluster
        sv = self.cfg["serving"]
        return AsyncCluster(
            self.registry, params=self.params,
            n_prefill=1, n_decode=1,
            prefill_policy=sv["prefill_policy"],
            sched_batch=sv["sched_batch"], chunk_size=sv["chunk_size"],
            decode_policy=sv["decode_policy"],
            dispatch_policy=sv["dispatch_policy"],
            predictor=OraclePredictor(
                accuracy=sv["predictor_accuracy"],
                seed=T.seed_words(self.seed)),
            n_pages=sv["n_pages"], page_size=sv["page_size"],
            max_batch=sv["max_batch"], max_seq=sv["max_seq"],
            device=self.device)


def _request(rid: str, item: T.Item):
    from repro_torch.runtime.request import Request, SamplingParams
    return Request(rid=rid, prompt_len=item.prompt_len,
                   decode_len=item.n_out, prompt_tokens=item.tokens,
                   sampling=SamplingParams(max_new_tokens=item.n_out,
                                           ignore_eos=True))


def warm(cluster, cell: Cell) -> None:
    """Serve the mix's warm-up requests to completion: builds the
    kernels on a checkout's first run and runs the step shapes the mix
    uses before the window."""
    items = T.warmup(cell.mix, cell.cfg["vocab_size"])
    handles = [cluster.submit(request=_request(f"warm{i}", it))
               for i, it in enumerate(items)]
    if not cluster.drain(timeout=1200):
        raise RuntimeError("warm-up did not finish in 1200 s")
    bad = [h.rid for h in handles if h.result(wait=False).phase.value
           != "finished"]
    if bad or cluster.worker_errors:
        raise RuntimeError(f"warm-up failed: {bad} "
                           f"{cluster.worker_errors[:1]}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_window(cluster, cell: Cell, items: List[T.Item], seconds: float,
                 t_process0: float, traced: bool) -> RunData:
    """Open the window, submit each request when it is due, and close
    the measured interval; returns what the readers read."""
    pre, dec = cluster.instances[0], cluster.instances[1]
    _sync(cell.device)
    prof = TR.start(cell.device) if traced else None
    t_open = time.monotonic()
    setup_s = t_open - t_process0
    c0 = t_open - cluster.now()        # the cluster's clock origin
    b0 = (pre.busy, pre.pe.chunk_steps, dec.busy, dec.de.iterations)
    recs: List[Rec] = []
    pool = dec.de.alloc
    peak = 0

    def sleep_until(t):
        # watch the decode pool while waiting: its fullest share is a
        # diagnostic of the run (printed), not a metric
        nonlocal peak
        while True:
            peak = max(peak, pool.used_pages)
            left = t - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(left, 0.05))

    for i, it in enumerate(items):
        due = t_open + it.due
        sleep_until(due)
        sub = time.monotonic()
        h = cluster.submit(request=_request(f"r{i:05d}", it))
        recs.append(Rec(rid=h.rid, due=due, submit=sub,
                        prompt_len=it.prompt_len, n_out=it.n_out,
                        prompt=it.tokens, handle=h))
    # the measured interval is the window: what it served, and the
    # device trace, are read when it closes
    sleep_until(t_open + seconds)
    t_close = time.monotonic()
    b1 = (pre.busy, pre.pe.chunk_steps, dec.busy, dec.de.iterations)
    for r in recs:
        r.n_window = len(r.handle.tokens_so_far())
        r.prefilled_window = r.handle.request.prefilled
    tr = (TR.stop(prof, t_close - t_open, cell.device) if traced
          else None)
    trace_s = time.monotonic() - t_close
    # reading the trace holds the interpreter lock, so the drain's time
    # starts after it
    deadline = time.monotonic() + cell.mix["drain_s"]
    while (not cluster.drain(timeout=0.05)
           and time.monotonic() < deadline):
        peak = max(peak, pool.used_pages)
    for r in recs:
        if not r.handle.done():
            cluster.cancel(r.rid)
    return RunData(
        cfg=cell.cfg, widths=work.Widths(cell.cfg),
        chunk=cell.cfg["serving"]["chunk_size"],
        requests=recs, window_s=seconds, t_close=t_close,
        setup_s=setup_s, prefill_busy_s=b1[0] - b0[0],
        prefill_chunks=b1[1] - b0[1], decode_busy_s=b1[2] - b0[2],
        decode_iterations=b1[3] - b0[3], trace=tr, trace_s=trace_s,
        t_open=t_open, pool_peak=peak / pool.n_pages, c0=c0)


def sample(recs: List[Rec], settings: dict, seed: int) -> List[Rec]:
    """The finished requests the reference judges: the one with the
    most served tokens and the one with the longest prompt (its prefill
    spans the most chunks), then others in an order drawn from the
    seed, until the sample holds ``sample_tokens`` served tokens and
    ``sample_requests`` requests."""
    done = [r for r in recs if r.finished and r.n_tokens > 0]
    if not done:
        return []
    picked = [max(done, key=lambda r: (r.n_tokens, r.prompt_len))]
    widest = max(done, key=lambda r: (r.prompt_len, r.n_tokens))
    if widest is not picked[0]:
        picked.append(widest)
    rest = [r for r in done if all(r is not q for q in picked)]
    rng = np.random.default_rng(T.seed_words(seed) + [2])
    for i in rng.permutation(len(rest)):
        if (sum(r.n_tokens for r in picked) >= settings["sample_tokens"]
                and len(picked) >= settings["sample_requests"]):
            break
        picked.append(rest[int(i)])
    return picked


def gaps(cell: Cell, picked: List[Rec], fp8: bool = False) -> List[float]:
    """The reference's widest gap for each sampled request: over the
    positions where a served token was chosen, how far that token's
    float32 logit lies below the best.  With ``fp8`` the tokens judged
    are those the float8 control puts first (the control's reading)."""
    dev = cell.device
    seqs, starts, served = [], [], []
    for r in picked:
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
        seqs.append(torch.as_tensor(toks, device=dev))
        starts.append(r.prompt_len - 1)
        served.append(torch.as_tensor(np.asarray(r.tokens, np.int64),
                                      device=dev))
    ref = Decoder(cell.cfg, cell.params).logits(seqs, starts)
    if fp8:
        low = Decoder(cell.cfg, cell.params, fp8=True).logits(seqs, starts)
        served = [lg.argmax(-1) for lg in low]
    return [widest_gap(lg, t) for lg, t in zip(ref, served)]


def serve(cell: Cell, items: List[T.Item], seconds: float,
          t_process0: float, traced: bool):
    """A fresh cluster on the cell's weights: warm-up, the window, then
    its workers stopped and its pools handed back to the card.  Returns
    (what the readers read, the workers' errors, the peak of allocated
    device memory before the pools were freed)."""
    cluster = cell.cluster()
    try:
        cluster.start()
        warm(cluster, cell)
        run = serve_window(cluster, cell, items, seconds, t_process0,
                           traced)
        errors = list(cluster.worker_errors)
    finally:
        cluster.close()
    collect(run)
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    del cluster
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    return run, errors, peak


def loaded_forbidden(modules) -> List[str]:
    """Top-level module names, compared whole, that the run may not
    load: JAX, its libraries and the JAX package ``repro``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def finite(x) -> bool:
    return x is not None and math.isfinite(x)
