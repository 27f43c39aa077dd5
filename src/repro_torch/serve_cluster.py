"""Cluster-scale serving study (the paper's §5 experiment), the
reference's ``examples/serve_cluster.py`` on the port.

Runs the five workloads through the serving ``Cluster`` on its
cost-model runtime — the scheduler, dispatcher, allocator and
orchestration loop the engines use — comparing TetriInfer
(disaggregated, chunked prefill, two-level scheduling, flip) against
vanilla vLLM (coupled continuous batching).  Host only: no device.

    PYTHONPATH=src python -m repro_torch.serve_cluster [--requests 128]
"""
from __future__ import annotations

import argparse
import copy

from repro_torch.configs import get_config
from repro_torch.core.kv_transfer import NetworkStack
from repro_torch.fleet.harness import LINKS
from repro_torch.runtime.costmodel import CostModel, HardwareSpec
from repro_torch.runtime.simulator import CoupledSimulator
from repro_torch.runtime.workload import generate
from repro_torch.serving import Cluster

WORKLOADS = ("LPLD", "LPHD", "HPLD", "HPHD", "Mixed")


def compare(cost: CostModel, requests: int = 128, seed: int = 0,
            link: str = "nvlink"):
    """Yield (workload, vLLM result, TetriInfer cluster, its result) for
    each workload: ``CoupledSimulator`` on 2 instances against a 1 + 1
    sim ``Cluster`` with flips, on the same requests."""
    cfg = cost.cfg
    for wl in WORKLOADS:
        reqs = generate(wl, requests, seed=seed)
        ra = CoupledSimulator(cfg, cost, n_instances=2, prefill_batch=16,
                              max_batch=16).run(copy.deepcopy(reqs))
        cluster = Cluster(
            cfg, runtime="sim", cost=cost, n_prefill=1, n_decode=1,
            max_batch=64, network=NetworkStack(LINKS[link]),
            enable_flip=True, flip_idle_s=1.0)
        rb = cluster.serve(copy.deepcopy(reqs))
        yield wl, ra, cluster, rb


def row(wl, ra, rb) -> str:
    ma, mb = ra.metrics, rb.metrics
    return (f"{wl:8s} {ma['avg_ttft']:9.2f}s {mb['avg_ttft']:9.2f}s "
            f"{100*(1-mb['avg_ttft']/ma['avg_ttft']):+5.0f}% "
            f"{100*(1-mb['avg_jct']/ma['avg_jct']):+5.0f}% "
            f"x{rb.perf_per_dollar/ra.perf_per_dollar:5.2f} "
            f"{rb.flips:5d}")


HEADER = (f"{'workload':8s} {'vLLM TTFT':>10s} {'tetri TTFT':>10s} "
          f"{'dTTFT':>6s} {'dJCT':>6s} {'perf/$':>7s} {'flips':>5s}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--link", choices=["nvlink", "roce", "socket"],
                    default="nvlink")
    args = ap.parse_args(argv)

    cfg = get_config("opt_13b")
    cost = CostModel(cfg, HardwareSpec.v100_tp2(),
                     n_params=13_000_000_000)
    print(HEADER)
    for wl, ra, _, rb in compare(cost, args.requests, args.seed, args.link):
        print(row(wl, ra, rb))


if __name__ == "__main__":
    main()
