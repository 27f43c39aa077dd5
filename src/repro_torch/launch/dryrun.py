"""Multi-pod dry run: run every (arch x input shape x mesh) step on meta
tensors (no allocation) over a fake process group of 512 ranks, and
record per-device flops, bytes, collectives and memory for the roofline
(the reference's ``launch/dryrun.py``).

``main`` starts the fake group (``launch.mesh.start_fake_group``) before
any mesh, in place of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=512``.  This process
is rank 0: it runs rank 0's share of the step (pod 0, data 0, model 0)
on its local shards, every collective returns at once, and
``launch/op_cost.py`` counts what the rank computes, moves and sends.

Every time in a record is a DATA-SHEET PREDICTION for an H100 SXM
(``HardwareSpec.h100()``: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3; the
link is NVLink 4 at 450 GB/s each way, the data sheet's 900 GB/s
bidirectional), not a measurement.  A 16-wide model axis spans two
8-card hosts, whose InfiniBand hops this figure does not model.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_0_5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh, start_fake_group
from repro_torch.launch.specs import SHAPES, input_specs, resolve_config
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.runtime.costmodel import HardwareSpec
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

_H100 = HardwareSpec.h100()
PEAK_FLOPS = _H100.peak_flops      # bf16 dense, a card (data sheet)
HBM_BW = _H100.hbm_bw              # bytes/s, a card (data sheet)
LINK_BW = 450e9                    # NVLink 4, each way (data sheet)
CHUNK_SIZE = 512                   # chunked-prefill unit (the paper's)
FSDP_SERVE_BYTES = 12e9            # 2D-shard serve weights above this
WORLD = 512


def collective_stats(summary: op_cost.CostSummary) -> dict:
    """{kind: {"count", "bytes"}} of a step's collectives (per device)."""
    return {k: {"count": int(summary.collective_counts.get(k, 0)),
                "bytes": int(v)}
            for k, v in summary.collective_bytes.items()}


def build_step(cfg, shape_name, mesh, batch_axes, opts=()):
    """Returns (fn, example_args, in_shardings, out_shardings,
    batch_axes): meta-tensor arguments and their placement trees."""
    kind = SHAPES[shape_name]["kind"]
    specs = input_specs(cfg, shape_name)
    params_abs = M.abstract_params(cfg)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    model_size = sizes.get("model", 1)
    repl = S.replicated(mesh)
    # batch must divide the data axes (long_500k has batch=1: replicate)
    batch = SHAPES[shape_name]["batch"]
    dsize = 1
    for ax in batch_axes:
        dsize *= sizes.get(ax, 1)
    if batch % dsize != 0:
        batch_axes = ()

    def data_sh(nd):
        return S.data_sharding(mesh, batch_axes, nd) if batch_axes \
            else repl

    def constrained(fn):
        def step(*a):
            with S.activation_sharding(mesh, batch_axes=batch_axes,
                                       opts=opts):
                return fn(*a)
        return step

    if kind == "train":
        p_sh = S.param_shardings(params_abs, mesh, fsdp=True)
        opt_abs = opt.init(params_abs)
        o_sh = opt.AdamWState(step=None, m=p_sh, v=p_sh)
        has_enc = "enc_embeds" in specs
        micro = 1
        for o in opts:
            if o.startswith("mb"):
                micro = int(o[2:])
        step = trainer.make_train_step(cfg, has_encoder=has_enc,
                                       microbatch=micro)
        args = [params_abs, opt_abs, specs["tokens"], specs["labels"]]
        in_sh = [p_sh, o_sh, data_sh(1), data_sh(1)]
        if has_enc:
            args.append(specs["enc_embeds"])
            in_sh.append(data_sh(2))
        return (constrained(step), args, tuple(in_sh), (p_sh, o_sh, repl),
                batch_axes)

    # serving: weights replicated over data unless they would not fit;
    # over-budget models use 2D tensor parallelism (expert dim x ff dim)
    per_chip = sum(p.numel() * p.element_size()
                   for p in S.leaves(params_abs)) / model_size
    big = per_chip > FSDP_SERVE_BYTES
    p_sh = S.param_shardings(params_abs, mesh, serve2d=big)
    c_sh = S.cache_shardings(specs["cache"], mesh, batch_axes=batch_axes)

    if kind == "prefill":
        has_enc = "enc_embeds" in specs

        def prefill(params, tokens, cache, enc=None):
            return M.prefill_chunked(params, cfg, tokens, cache,
                                     chunk_size=CHUNK_SIZE, enc_embeds=enc)
        args = [params_abs, specs["tokens"], specs["cache"]]
        in_sh = [p_sh, data_sh(1), c_sh]
        if has_enc:
            args.append(specs["enc_embeds"])
            in_sh.append(data_sh(2))
        return (constrained(prefill), args, tuple(in_sh),
                (data_sh(2), c_sh), batch_axes)

    def decode(params, tokens, cache, pos):
        return M.decode_step(params, cfg, tokens, cache, pos)
    args = [params_abs, specs["tokens"], specs["cache"], specs["pos"]]
    in_sh = [p_sh, data_sh(1), c_sh, data_sh(0)]
    return (constrained(decode), args, tuple(in_sh), (data_sh(2), c_sh),
            batch_axes)


def _place(arg, sh, mesh):
    """An argument of ``build_step`` as this rank's DTensor shards."""
    if isinstance(arg, opt.AdamWState):
        st = S.shard({"m": arg.m, "v": arg.v}, mesh, {"m": sh.m, "v": sh.v})
        return opt.AdamWState(step=0, m=st["m"], v=st["v"])
    if isinstance(arg, torch.Tensor):
        return S.shard({"x": arg}, mesh, {"x": sh})["x"]
    return S.shard(arg, mesh, sh)


def _local_bytes(tree) -> int:
    seen, total = set(), 0
    for x in S.leaves(tree):
        if isinstance(x, torch.Tensor):
            t = S.local(x)
            if id(x) not in seen:
                seen.add(id(x))
                total += t.numel() * t.element_size()
    return total


def model_flops(cfg, shape_name) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (inference)."""
    n_active = M.active_param_count(cfg)
    shape = SHAPES[shape_name]
    kind = shape["kind"]
    tokens = shape["batch"] * (shape["seq"] if kind in ("train", "prefill")
                               else 1)
    return (6.0 if kind == "train" else 2.0) * n_active * tokens


def _record(rec, summary, args_bytes, out_bytes, cfg, shape_name, chips):
    flops = summary.flops
    link = summary.link_bytes()
    temp = summary.peak_live_bytes
    rec["memory"] = {"argument_bytes": args_bytes,
                     "output_bytes": out_bytes, "temp_bytes": temp,
                     "generated_code_bytes": 0}
    # eager counts every pass, so the unweighted and weighted agree
    rec["xla_cost_analysis"] = {"flops_unweighted": flops,
                                "bytes_unweighted": summary.hbm_bytes}
    rec["unknown_trip_loops"] = summary.unknown_trip_loops
    resident = args_bytes + out_bytes + temp
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": resident / HBM_BW,
             "collective_s": link / LINK_BW}
    mf = model_flops(cfg, shape_name)
    rec.update({
        "status": "ok",
        "chips": chips,
        "hlo_flops_per_chip": flops,
        "hbm_resident_bytes_per_chip": resident,
        "hbm_bytes_kernel_est": summary.hbm_bytes,
        "collectives": collective_stats(summary),
        "collective_link_bytes_per_chip": link,
        "roofline": terms,
        "bottleneck": max(terms, key=terms.get).replace("_s", ""),
        "model_flops": mf,
        "useful_flops_ratio": mf / (flops * chips) if flops else 0.0,
        "prediction": "H100 SXM data sheet (not measured)",
    })
    return rec


def run_one(arch: str, shape_name: str, multi_pod: bool,
            verbose: bool = True, opts=()) -> dict:
    """One (arch, shape, mesh) step on rank 0 of the fake group; the
    reference's record keys (``compile_s`` is the seconds the meta run
    took; the ``xla_cost_analysis`` and ``hlo_*`` keys carry
    ``op_cost``'s counts under the reference's names)."""
    cfg = get_config(arch)
    cfg = resolve_config(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "opts": sorted(opts),
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if cfg is None:
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch at 500k ctx (whisper's " \
            "448-position decoder)"
        return rec
    start_fake_group(WORLD)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh.mesh.numel()
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    t0 = time.time()
    step, args, in_sh, _, batch_axes = build_step(
        cfg, shape_name, mesh, batch_axes, opts=opts)
    placed = [_place(a, sh, mesh) for a, sh in zip(args, in_sh)]
    with torch.no_grad() if SHAPES[shape_name]["kind"] != "train" \
            else torch.enable_grad():
        summary = op_cost.analyze(step, *placed)
    rec["compile_s"] = round(time.time() - t0, 1)
    arg_ids = {id(x) for x in S.leaves(
        [[a.m, a.v] if isinstance(a, opt.AdamWState) else a
         for a in placed])}
    outs = [x for x in S.leaves(
        [[o.m, o.v] if isinstance(o, opt.AdamWState) else o
         for o in summary.output])
            if isinstance(x, torch.Tensor) and id(x) not in arg_ids]
    args_bytes = sum(_local_bytes(a.m) + _local_bytes(a.v)
                     if isinstance(a, opt.AdamWState) else _local_bytes(a)
                     for a in placed)
    _record(rec, summary, args_bytes, _local_bytes(outs), cfg, shape_name,
            chips)
    if verbose:
        t = rec["roofline"]
        print(f"[{arch} x {shape_name} x {rec['mesh']}] {rec['compile_s']}s"
              f"  flops={summary.flops:.3e} bytes={summary.hbm_bytes:.3e}"
              f" link={summary.link_bytes():.3e}"
              f"  bottleneck={rec['bottleneck']}")
        print(f"  memory: {rec['memory']}")
        print(f"  roofline (H100 data sheet): compute="
              f"{t['compute_s'] * 1e3:.2f}ms memory="
              f"{t['memory_s'] * 1e3:.2f}ms collective="
              f"{t['collective_s'] * 1e3:.2f}ms useful-flops="
              f"{rec['useful_flops_ratio']:.2f}")
    return rec


def run_disagg(arch: str = "qwen2_0_5b", verbose: bool = True) -> dict:
    """The disaggregated prefill -> handoff -> decode step on the
    multi-pod mesh (16 x 4,096 tokens, the reference's prefill wave), on
    rank 0 of the fake group: pod 0's share, i.e. the chunked prefill and
    the sending side of the pod 0 -> pod 1 KV handoff (one broadcast a
    cache leaf, and one of the last-position logits)."""
    from repro_torch.core.disagg import make_disagg_step
    start_fake_group(WORLD)
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    b, s_len = 16, 4096
    step = make_disagg_step(cfg, mesh, chunk_size=CHUNK_SIZE,
                            batch_axes=("data",))
    params_abs = M.abstract_params(cfg)
    params = S.shard(params_abs, mesh, S.param_shardings(params_abs, mesh))
    cache_abs = M.abstract_cache(cfg, b, s_len + 8)
    cache = S.shard(cache_abs, mesh,
                    S.cache_shardings(cache_abs, mesh, ("data",)))
    tokens = _place(torch.empty((b, s_len), dtype=torch.int32,
                                device="meta"),
                    S.data_sharding(mesh, ("data",)), mesh)
    t0 = time.time()
    summary = op_cost.analyze(step, params, tokens, cache)
    stats = collective_stats(summary)
    rec = {"arch": arch, "mode": "disagg_step", "mesh": "2x16x16",
           "status": "ok", "compile_s": round(time.time() - t0, 1),
           "collectives": stats, "flops_per_chip": summary.flops,
           "link_bytes_per_chip": summary.link_bytes(),
           "prediction": "H100 SXM data sheet (not measured)"}
    if verbose:
        print(f"[disagg_step {arch} x 2x16x16] {rec['compile_s']}s")
        print(f"  broadcast count: "
              f"{stats.get('broadcast', {}).get('count', 0)} "
              f"(the pod0->pod1 KV handoff)")
        print(f"  all kinds: { {k: v['count'] for k, v in stats.items()} }")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma list: seqkv,attn2d,seqact,mbN")
    ap.add_argument("--disagg", action="store_true",
                    help="also run the disaggregated step (run_disagg)")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)
    start_fake_group(WORLD)

    os.makedirs(args.out, exist_ok=True)
    archs = ASSIGNED_ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch.replace('-', '_')}__{shape}__" \
                      f"{'2x16x16' if mp else '16x16'}"
                if opts:
                    tag += "__" + "_".join(sorted(opts))
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip existing] {tag}")
                    continue
                try:
                    rec = run_one(arch, shape, mp, opts=opts)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error", "error": str(e),
                           "trace": traceback.format_exc()[-2000:]}
                    failures.append(tag)
                    print(f"[FAIL] {tag}: {e}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
    if args.disagg:
        rec = run_disagg(archs[0])
        with open(os.path.join(args.out, "disagg_step.json"), "w") as f:
            json.dump(rec, f, indent=2)
    if failures:
        print(f"{len(failures)} failures: {failures}")
        sys.exit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
