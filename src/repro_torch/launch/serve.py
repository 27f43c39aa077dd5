"""Serving launcher of the port, the reference's
``src/repro/launch/serve.py``: the cost-model runtime at paper scale
(the default), or the real engines on a small model, through the port's
serving API.

  PYTHONPATH=src python -m repro_torch.launch.serve --workload Mixed \
      --requests 128                        # cost model, host only
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --no-flip
  PYTHONPATH=src python -m repro_torch.launch.serve --real   # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --real --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --real \
      --arch recurrentgemma_9b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --real --wall-clock \
      --arrival-rate 20 --arrival-process poisson --requests 12

The default run serves ``--arch`` (OPT-13B unless asked) on
``Cluster(runtime="sim")`` priced by ``CostModel(cfg, v100_tp2())``, on
a virtual clock, and prints what the reference prints.  ``--real``
serves the small f32 config of ``--arch`` (qwen2 unless asked) on the
engines.  ``--wall-clock`` runs the wall-clock ``AsyncCluster`` (each
instance on its own worker thread and, on the card, its own CUDA
stream; overlapped KV transfer) driven open-loop from an arrival
process, and reports TTFT/JCT in wall seconds.

Observability (docs/observability.md): ``--trace-out t.json`` writes a
Perfetto-loadable trace, ``--trace-jsonl t.jsonl`` the raw records,
``--metrics-out m.json`` a metrics-registry snapshot, and
``--slo-ttft``/``--slo-tbt`` add SLO attainment to the summary.
"""
from __future__ import annotations

import argparse
import copy
import json


def _print_result(args, r):
    m = r.metrics
    print(f"workload={args.workload} n={m['n']}")
    print(f"avg TTFT {m['avg_ttft']:.3f}s  p90 {m['p90_ttft']:.3f}s")
    print(f"avg JCT  {m['avg_jct']:.3f}s  p90 {m['p90_jct']:.3f}s")
    if "avg_transfer" in m:
        print(f"avg KV transfer {m['avg_transfer']*1e3:.3f}ms")
    if "goodput" in m:
        print(f"SLO goodput {m['goodput']:.3f} "
              f"({m['slo_good']} in-SLO; ttft<={m['slo_ttft_s']}s "
              f"tbt<={m['slo_tbt_s']}s)")
    print(f"resource time {r.resource_time:.1f}s "
          f"(prefill {r.prefill_busy:.1f} decode {r.decode_busy:.1f})  "
          f"perf/$ {r.perf_per_dollar:.3f} req/inst-s  flips={r.flips} "
          f"swaps={r.swap_events}")


def _obs_from_args(args, clock):
    """Build the (tracer, metrics, slo) triple the CLI flags ask for."""
    from repro_torch.obs import MetricsRegistry, SLOSpec, Tracer
    tracer = Tracer(clock=clock) \
        if (args.trace_out or args.trace_jsonl) else None
    metrics = MetricsRegistry() if args.metrics_out else None
    slo = None
    if args.slo_ttft is not None or args.slo_tbt is not None:
        kw = {}
        if args.slo_ttft is not None:
            kw["ttft_target_s"] = args.slo_ttft
        if args.slo_tbt is not None:
            kw["tbt_target_s"] = args.slo_tbt
        slo = SLOSpec(**kw)
    return tracer, metrics, slo


def _dump_obs(args, tracer, metrics):
    if tracer is not None:
        if args.trace_out:
            tracer.write_perfetto(args.trace_out)
            print(f"wrote Perfetto trace ({len(tracer)} events) -> "
                  f"{args.trace_out}")
        if args.trace_jsonl:
            tracer.write_jsonl(args.trace_jsonl)
            print(f"wrote JSONL trace -> {args.trace_jsonl}")
    if metrics is not None and args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics.snapshot(), f, indent=2, default=str)
        print(f"wrote metrics snapshot -> {args.metrics_out}")


def _run_real(args):
    """The port's engines on the small f32 config of ``args.arch``
    (qwen2 unless asked; the recurrent archs run on the dense backend),
    on ``args.device``, with random weights from seed 0."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.runtime.workload import generate
    from repro_torch.serving import Cluster

    cfg = dataclasses.replace(get_smoke_config(args.arch or "qwen2_0_5b"),
                              dtype="float32")
    print(f"model: {cfg.name}  layers={cfg.n_layers} d={cfg.d_model}")
    params = M.init_params(
        cfg, torch.Generator(device=args.device).manual_seed(0),
        args.device)
    reqs = generate(args.workload, min(args.requests, 16), seed=0,
                    max_prompt=48, max_decode=12,
                    vocab_size=cfg.vocab_size)
    tracer, metrics, slo = _obs_from_args(args, clock="virtual")
    cluster = Cluster(cfg, runtime="engine", params=params,
                      n_prefill=args.n_prefill, n_decode=args.n_decode,
                      prefill_policy=args.prefill_policy,
                      decode_policy=args.decode_policy,
                      dispatch_policy=args.dispatch,
                      chunk_size=16, max_seq=128,
                      enable_flip=args.flip, flip_idle_s=1.0,
                      tracer=tracer, metrics=metrics, device=args.device)
    handles = [cluster.submit(request=r) for r in reqs]
    cluster.run()
    for h in handles[:4]:
        res = h.result()
        print(f"  {res.rid}: {len(res.tokens)} tokens "
              f"{res.tokens[:8]}{'...' if len(res.tokens) > 8 else ''}")
    _print_result(args, cluster.result(slo=slo))
    _dump_obs(args, tracer, metrics)


def _run_wall_clock(args):
    """The wall-clock async runtime: concurrent instances and overlapped
    KV transfer, driven open-loop from an arrival process; the small f32
    config of ``args.arch`` on ``args.device``, random weights from seed
    0."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.runtime.workload import generate
    from repro_torch.serving import (ArrivalSchedule, AsyncCluster,
                                     OpenLoopClient)

    cfg = dataclasses.replace(get_smoke_config(args.arch or "qwen2_0_5b"),
                              dtype="float32")
    print(f"model: {cfg.name}  layers={cfg.n_layers} d={cfg.d_model}")
    params = M.init_params(
        cfg, torch.Generator(device=args.device).manual_seed(0),
        args.device)
    reqs = generate(args.workload, min(args.requests, 32), seed=0,
                    max_prompt=48, max_decode=12,
                    vocab_size=cfg.vocab_size)
    sched = ArrivalSchedule(process=args.arrival_process,
                            rate=args.arrival_rate, seed=0,
                            period_s=args.arrival_period)
    tracer, metrics, slo = _obs_from_args(args, clock="wall")
    with AsyncCluster(cfg, params=params,
                      n_prefill=args.n_prefill, n_decode=args.n_decode,
                      prefill_policy=args.prefill_policy,
                      decode_policy=args.decode_policy,
                      dispatch_policy=args.dispatch,
                      chunk_size=16, max_seq=128,
                      overlap_transfer=args.overlap,
                      tracer=tracer, metrics=metrics,
                      device=args.device) as cluster:
        client = OpenLoopClient(cluster, reqs, sched).start()
        client.join()
        if not cluster.drain(timeout=600):
            raise TimeoutError("wall-clock run wedged (drain timed out)")
        if cluster.worker_errors:
            raise RuntimeError("worker errors:\n"
                               + "\n".join(cluster.worker_errors))
        for h in client.handles[:4]:
            res = h.result(wait=False)
            print(f"  {res.rid}: {len(res.tokens)} tokens "
                  f"ttft={res.ttft:.3f}s jct={res.jct:.3f}s")
        r = cluster.result(reqs, slo=slo)
    m = r.metrics
    print(f"open-loop {args.arrival_process} @ {args.arrival_rate} req/s"
          f"  overlap_transfer={args.overlap}")
    print(f"n={m['n']}  avg TTFT {m['avg_ttft']:.3f}s  "
          f"avg JCT {m['avg_jct']:.3f}s  (wall seconds)")
    print(f"makespan {m['makespan']:.2f}s  "
          f"throughput {m['n'] / m['makespan']:.2f} req/s")
    if "goodput" in m:
        print(f"SLO goodput {m['goodput']:.3f} ({m['slo_good']} in-SLO)")
    _dump_obs(args, tracer, metrics)


def _run_sim(args):
    """The cost-model runtime at full size: ``args.arch`` priced on the
    paper's testbed, with no ``n_params`` (the exact count), as the
    reference's default run.  Host only."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.costmodel import CostModel, HardwareSpec
    from repro_torch.runtime.workload import generate
    from repro_torch.serving import Cluster

    cfg = get_config(args.arch or "opt_13b")
    cost = CostModel(cfg, HardwareSpec.v100_tp2())
    reqs = generate(args.workload, args.requests, seed=0)
    tracer, metrics, slo = _obs_from_args(args, clock="virtual")
    r = Cluster(
        cfg, runtime="sim", cost=cost,
        n_prefill=args.n_prefill, n_decode=args.n_decode,
        prefill_policy=args.prefill_policy,
        decode_policy=args.decode_policy, dispatch_policy=args.dispatch,
        max_batch=64, enable_flip=args.flip, flip_idle_s=1.0,
        tracer=tracer, metrics=metrics,
    ).serve(copy.deepcopy(reqs), slo=slo)
    _print_result(args, r)
    _dump_obs(args, tracer, metrics)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="Mixed",
                    choices=["LPLD", "LPHD", "HPLD", "HPHD", "Mixed"])
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--arch", default=None,
                    help="the model: full size on the cost model "
                         "(default opt_13b); its small f32 config with "
                         "--real and --wall-clock (default qwen2_0_5b; "
                         "e.g. recurrentgemma_9b, xlstm_1_3b on the "
                         "dense backend)")
    ap.add_argument("--prefill-policy", default="sjf",
                    choices=["fcfs", "sjf", "ljf"])
    ap.add_argument("--decode-policy", default="reserve-dynamic",
                    choices=["greedy", "reserve-static", "reserve-dynamic"])
    ap.add_argument("--dispatch", default="power2",
                    choices=["power2", "random", "imbalance"])
    ap.add_argument("--n-prefill", type=int, default=1)
    ap.add_argument("--n-decode", type=int, default=1)
    ap.add_argument("--flip", action=argparse.BooleanOptionalAction,
                    default=True, help="enable instance flip (§3.5)")
    ap.add_argument("--real", action="store_true",
                    help="run the real engines on a small model")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (the default) or "
                         "cpu")
    ap.add_argument("--wall-clock", action="store_true",
                    help="wall-clock async runtime: concurrent "
                         "instances, overlapped KV transfer, open-loop "
                         "arrivals (implies the small real model)")
    ap.add_argument("--arrival-rate", type=float, default=20.0,
                    help="open-loop mean arrival rate, req/s")
    ap.add_argument("--arrival-process", default="poisson",
                    choices=["batch", "poisson", "bursty", "diurnal"])
    ap.add_argument("--arrival-period", type=float, default=10.0,
                    help="burst cycle / day length in seconds")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="overlap KV transfer with the next prefill "
                         "chunk (--no-overlap serializes, the ablation)")
    # -- observability (docs/observability.md) --------------------------
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON "
                         "(open at https://ui.perfetto.dev)")
    ap.add_argument("--trace-jsonl", default=None, metavar="PATH",
                    help="write the raw trace records as JSONL")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics-registry snapshot JSON "
                         "(counters, histograms, per-instance probes)")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="TTFT SLO target in seconds (adds goodput "
                         "to the summary)")
    ap.add_argument("--slo-tbt", type=float, default=None,
                    help="avg time-between-tokens SLO target in seconds")
    args = ap.parse_args(argv)

    if args.wall_clock:
        _run_wall_clock(args)
        return
    if args.real:
        _run_real(args)
        return
    _run_sim(args)


if __name__ == "__main__":
    main()
