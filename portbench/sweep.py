"""Find a fixed-rate cell's knee: serve its mix at each of a list of
rates, one fresh cluster a rate on the same weights, and print for
each the requests due, finished and failed and whether the backlog
grew; then the knee (the highest rate whose backlog did not grow) and
the rate chosen, 0.8 x the knee.

    python3 portbench/sweep.py --workload <cell> --rates 1,1.5,2 \
        --seed <n> --seconds <s> [--drain <s>]

One JSON line a rate and one for the knee, on standard output.  It
needs the card, as ``run.py`` does.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]


def in_flight(recs, t: float) -> int:
    """Requests submitted by ``t`` (seconds after the window opened) and
    not finished by then."""
    t0 = min(r.due for r in recs) if recs else 0.0
    return sum(1 for r in recs if r.due - t0 <= t
               and not (r.finished and r.finish - t0 <= t))


def _median(values) -> float:
    values = [v if math.isfinite(v) else math.inf for v in values]
    return statistics.median(values) if values else 0.0


def verdict(recs, seconds: float) -> dict:
    """Counts, the backlog at the window's middle and end, and the
    medians of the TTFT and of the wait for a decode slot over the
    window's first and last thirds.  The backlog grew when the requests
    in flight grew by half, or either wait doubled (plus 0.5 s)."""
    n = len(recs)
    thirds = [recs[:n // 3], recs[n - n // 3:]]
    ttft = [_median([r.first - r.due for r in part]) for part in thirds]
    slot = [_median([r.decode_start - r.first for r in part])
            for part in thirds]
    mid, end = in_flight(recs, seconds / 2), in_flight(recs, seconds)
    grew = (end > 1.5 * mid + 2 or ttft[1] > 2 * ttft[0] + 0.5
            or slot[1] > 2 * slot[0] + 0.5)
    return {"due": n, "finished": sum(r.finished for r in recs),
            "failed": sum(r.failed for r in recs), "in_flight_mid": mid,
            "in_flight_end": end, "ttft_median_thirds_s": ttft,
            "decode_wait_median_thirds_s": slot, "grew": grew}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--drain", type=float, default=30.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import serve as SV
    from portbench import traffic as T
    from portbench.spec import Spec

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec()
    cell = SV.Cell(spec, args.workload, args.seed, "cuda:0")
    cell.mix = dict(cell.mix, drain_s=args.drain)
    card = torch.cuda.get_device_name(0)
    knee = 0.0
    for rate in [float(r) for r in args.rates.split(",")]:
        items = T.schedule(cell.mix, args.seconds, args.seed,
                           cell.cfg["vocab_size"], rate=rate)
        run, errors, _ = SV.serve(cell, items, args.seconds,
                                  time.monotonic(), False)
        errors = len(errors)
        v = verdict(run.requests, args.seconds)
        v.update({m: spec.reader(m)(run) for m in
                  ("ttft_p75_s", "tpot_p75_ms", "jct_mean_s",
                   "prefill_chunk_ms")})
        v.update(rate=rate, worker_errors=errors, card=card,
                 decode_pool_peak=run.pool_peak,
                 decode_step_ms=1e3 * run.decode_busy_s
                 / max(1, run.decode_iterations),
                 decode_batch_mean=sum(max(0, r.n_tokens - 1)
                                       for r in run.requests)
                 / max(1, run.decode_iterations))
        print(json.dumps(v), flush=True)
        if not v["grew"] and not errors:
            knee = max(knee, rate)
    print(json.dumps({"workload": args.workload, "knee": knee,
                      "chosen": round(0.8 * knee, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
