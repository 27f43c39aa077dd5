"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
what the timed path served is correct, the requests attempted and
failed, the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics read from a device trace (``--trace 1``), and the device.  Each
number compared for ``correct`` is printed beside its limit as the last
lines of standard error and under ``checks``, the line's last key.

Exits non-zero, printing no result, without a CUDA card, or when the
port (``src/repro_torch``) is missing, or when JAX or the JAX package
was loaded.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]


def run_cell(spec, name: str, seed: int, seconds: float, traced: bool,
             device, t_process0: float):
    """Serve the cell once and judge it; returns (result, checks)."""
    import torch

    from portbench import serve as SV
    from portbench import traffic as T

    cell = SV.Cell(spec, name, seed, device)
    items = T.schedule(cell.mix, seconds, seed, cell.cfg["vocab_size"])
    run, errors, peak = SV.serve(cell, items, seconds, t_process0, traced)

    metrics = {}
    for m in spec.metrics(name, traced):
        v = spec.reader(m["name"])(run)
        if SV.finite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(run.requests),
              "failed": sum(r.failed for r in run.requests),
              "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
        run.trace = None

    picked = SV.sample(run.requests, cell.settings, seed)
    t_ref = time.monotonic()
    gaps = SV.gaps(cell, picked) if picked else []
    print(f"portbench: setup {run.setup_s:.1f} s, window {seconds} s, "
          f"trace read {run.trace_s:.1f} "
          f"s, reference {time.monotonic() - t_ref:.1f} s, decode pool "
          f"peak {run.pool_peak:.3f}, in all "
          f"{time.monotonic() - t_process0:.1f} s", file=sys.stderr)
    out = spec.base / "portbench_out"
    out.mkdir(exist_ok=True)
    SV.write_records(run, out / f"{name}.{seed}.{int(traced)}.jsonl")
    limits = cell.settings["limits"]
    checks = {
        "logit_gap": {"value": max(gaps) if gaps else None,
                      "limit": limits["logit_gap"]},
        "unfinished": {"value": result["failed"], "limit": 0},
        "wrong_length": {"value": sum(r.finished and r.n_tokens != r.n_out
                                      for r in run.requests), "limit": 0},
        "worker_errors": {"value": len(errors), "limit": 0},
        "tokens_judged": {"value": sum(r.n_tokens for r in picked),
                          "limit": None},
    }
    result["correct"] = bool(gaps) and all(
        c["limit"] is None or (c["value"] is not None
                               and c["value"] <= c["limit"])
        for c in checks.values())
    result["checks"] = checks
    for e in errors[:1]:
        print(e, file=sys.stderr)
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import repro_torch  # noqa: F401  (the program: src/ of the checkout)
    import torch

    from portbench import serve as SV
    from portbench.spec import Spec

    spec = Spec()
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T0)
    bad = SV.loaded_forbidden(sys.modules)
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
