"""Readings that set a cell's ``logit_gap`` limit, on the card at the
cell's own size and load: for each seed, the program serves a short
window of the cell's mix, the reference judges the same sample a run
judges (the program's reading), and for the control seeds the float8
reference, put in the program's place, is judged by the same float32
reference at the same prompts and tokens (the control's reading).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds <s>

One JSON line a seed on standard output.  The benchmark's runs never
run the control.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]


def readings(spec, name: str, seed: int, seconds: float, control: bool,
             device) -> dict:
    from portbench import serve as SV
    from portbench import traffic as T

    cell = SV.Cell(spec, name, seed, device)
    items = T.schedule(cell.mix, seconds, seed, cell.cfg["vocab_size"])
    run, errors, _ = SV.serve(cell, items, seconds, time.monotonic(),
                              False)
    errors = len(errors)
    picked = SV.sample(run.requests, cell.settings, seed)
    t0 = time.monotonic()
    prog = SV.gaps(cell, picked)
    out = {"seed": seed, "due": len(run.requests),
           "failed": sum(r.failed for r in run.requests),
           "worker_errors": errors, "requests_judged": len(picked),
           "tokens_judged": sum(r.n_tokens for r in picked),
           "program_gap": max(prog), "program_gaps": prog,
           "reference_s": time.monotonic() - t0}
    if control:
        ctl = SV.gaps(cell, picked, fp8=True)
        out.update(control_gap=max(ctl), control_gaps=ctl)
    del cell
    gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench.spec import Spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec()
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in [int(s) for s in args.seeds.split(",")]:
        r = readings(spec, args.workload, s, args.seconds, s in ctl,
                     "cuda:0")
        r["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
