"""The port's launch layer against the reference's: input shapes and
counts (``abstract_params``, ``abstract_cache``, ``frontend_spec``,
``input_specs``, ``resolve_config``, ``active_param_count``,
``model_flops``), the meshes, ``op_cost`` on the reference's
``hlo_cost`` toy, and one dry-run record on the fake group of 512
ranks.  Exact equality throughout (shapes, dtypes, integer counts).

The fake group and the reference's dry-run module (which sets XLA_FLAGS
at import) live in subprocesses, so this process never joins a group
and its JAX keeps one device.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as REF_ASSIGNED
from repro.configs import get_config as ref_get_config
from repro.launch import specs as RSP
from repro.models import frontends as RF
from repro.models import model as RM
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import specs as SP
from repro_torch.models import frontends as F
from repro_torch.models import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
      "int32": torch.int32}


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _same(ref_leaf, port_leaf, drop_lead=False):
    shape = tuple(ref_leaf.shape)[1:] if drop_lead else tuple(ref_leaf.shape)
    assert shape == tuple(port_leaf.shape)
    assert DT[str(ref_leaf.dtype)] == port_leaf.dtype
    assert port_leaf.device.type == "meta"


def _ref_layer_leaves(tree, cfg):
    """The reference's prefix / stacked body / suffix leaves in the port's
    layer order: (stacked, {leaf path within the layer: leaf})."""
    def rel(node):
        return {tuple(str(getattr(e, "key", getattr(e, "idx", e)))
                      for e in p): leaf
                for p, leaf in jax.tree_util.tree_flatten_with_path(node)[0]}
    out = [(False, rel(b)) for b in tree["prefix"]]
    for _ in range(cfg.n_repeats):
        out.extend((True, rel(tree["body"][j]))
                   for j in range(len(cfg.pattern)))
    out.extend((False, rel(b)) for b in tree["suffix"])
    return out


def _port_leaves(node, path=()):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_port_leaves(v, path + (str(k),)))
        return out
    if isinstance(node, (list, tuple)):
        out = {}
        for i, v in enumerate(node):
            out.update(_port_leaves(v, path + (str(i),)))
        return out
    return {path: node}


def _check_cache(ref_tree, port, cfg):
    ref_layers = _ref_layer_leaves(ref_tree, cfg)
    assert len(ref_layers) == len(port)
    for (stacked, rl), pl in zip(ref_layers, port):
        assert sorted(p[-1] for p in rl) == sorted(pl)
        for p, leaf in rl.items():
            _same(leaf, pl[p[-1]], drop_lead=stacked)


def test_assigned_archs_are_the_references():
    assert tuple(ASSIGNED_ARCHS) == tuple(REF_ASSIGNED)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_abstract_params_and_counts_equal_reference(arch):
    rcfg, pcfg = ref_get_config(arch), get_config(arch)
    ref = RM.abstract_params(rcfg)
    port = M.abstract_params(pcfg)
    top = {k: v for k, v in ref.items() if k not in ("prefix", "body",
                                                     "suffix")}
    rt = {p: leaf for p, leaf in _port_leaves(
        jax.tree.map(lambda x: x, top,
                     is_leaf=lambda x: hasattr(x, "shape"))).items()}
    pt = _port_leaves({k: v for k, v in port.items() if k != "layers"})
    assert sorted(rt) == sorted(pt)
    for p in rt:
        _same(rt[p], pt[p])
    for (stacked, rl), pl in zip(_ref_layer_leaves(ref, rcfg),
                                 port["layers"]):
        got = _port_leaves(pl)
        assert sorted(rl) == sorted(got)
        for p, leaf in rl.items():
            _same(leaf, got[p], drop_lead=stacked)
    assert M.active_param_count(pcfg) == RM.active_param_count(rcfg)
    spec, rspec = F.frontend_spec(pcfg, 3), RF.frontend_spec(rcfg, 3)
    if rspec is None:
        assert spec is None
    else:
        _same(rspec, spec)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("shape", list(RSP.SHAPES))
def test_input_specs_equal_reference(arch, shape):
    assert SP.SHAPES == RSP.SHAPES
    assert SP.SLIDING_WINDOW_500K == RSP.SLIDING_WINDOW_500K
    rcfg = RSP.resolve_config(ref_get_config(arch), shape)
    pcfg = SP.resolve_config(get_config(arch), shape)
    if rcfg is None:
        assert pcfg is None
        return
    assert pcfg.sliding_window == rcfg.sliding_window
    ref = RSP.input_specs(rcfg, shape)
    port = SP.input_specs(pcfg, shape)
    assert sorted(ref) == sorted(port)
    for k, v in ref.items():
        if k == "cache":
            _check_cache(v, port[k], rcfg)
        else:
            _same(v, port[k])


REF_FLOPS = textwrap.dedent("""
    import json
    from repro.configs import ASSIGNED_ARCHS, get_config
    from repro.launch import dryrun as D
    from repro.launch.specs import SHAPES, resolve_config
    out = {}
    for a in ASSIGNED_ARCHS:
        for s in SHAPES:
            cfg = resolve_config(get_config(a), s)
            if cfg is not None:
                out[a + "/" + s] = D.model_flops(cfg, s)
    print(json.dumps(out))
""")


def test_model_flops_equal_reference():
    from repro_torch.launch import dryrun as D
    r = subprocess.run([sys.executable, "-c", REF_FLOPS], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    got = {}
    for a in ASSIGNED_ARCHS:
        for s in SP.SHAPES:
            cfg = SP.resolve_config(get_config(a), s)
            if cfg is not None:
                got[a + "/" + s] = D.model_flops(cfg, s)
    assert got == ref


def test_meshes_need_a_group_and_import_touches_nothing():
    import torch.distributed as dist
    from repro_torch.launch import mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="start_fake_group"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_debug_mesh(2, 2, device_type="cpu")
    assert not dist.is_initialized()


FAKE = textwrap.dedent("""
    import json, torch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import op_cost as H
    from repro_torch.launch.mesh import (make_debug_mesh,
                                         make_production_mesh,
                                         start_fake_group)
    from repro_torch.models import sharding as S
    start_fake_group(512)
    # the reference's hlo_cost toy: an 8x8 f32 matmul and an all-reduce
    # of it, ten times over
    mesh = make_debug_mesh(1, 2, device_type="cpu")
    def step(x, w):
        with S.activation_sharding(mesh):
            for _ in range(10):
                x = S.all_reduce(x @ w)
        return x
    s = H.analyze(step, torch.ones(8, 8), torch.ones(8, 8))
    toy = dict(flops=s.flops, ar_bytes=s.collective_bytes["all-reduce"],
               ar_count=s.collective_counts["all-reduce"],
               link=s.link_bytes(), unknown=s.unknown_trip_loops)
    pm = make_production_mesh(multi_pod=True, device_type="cpu")
    rec = D.run_one("qwen2_0_5b", "decode_32k", False, verbose=False)
    train = D.run_one("qwen2_0_5b", "train_4k", False, verbose=False)
    print(json.dumps(dict(toy=toy, rec=rec, train=train,
                          mesh=[list(pm.mesh_dim_names),
                                list(pm.mesh.shape)])))
""")

REF_RECORD_KEYS = {
    "arch", "shape", "opts", "mesh", "compile_s", "memory",
    "xla_cost_analysis", "unknown_trip_loops", "status", "chips",
    "hlo_flops_per_chip", "hbm_resident_bytes_per_chip",
    "hbm_bytes_kernel_est", "collectives",
    "collective_link_bytes_per_chip", "roofline", "bottleneck",
    "model_flops", "useful_flops_ratio"}


@pytest.fixture(scope="module")
def fake_run():
    r = subprocess.run([sys.executable, "-c", FAKE], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_op_cost_counts_every_trip(fake_run):
    toy = fake_run["toy"]
    assert toy["flops"] == 10 * 2 * 8 * 8 * 8
    assert toy["ar_bytes"] == 10 * 256
    assert toy["ar_count"] == 10
    assert toy["link"] == 2 * 10 * 256
    assert toy["unknown"] == 0


def test_production_mesh_shape(fake_run):
    assert fake_run["mesh"] == [["pod", "data", "model"], [2, 16, 16]]


def test_dryrun_record_on_the_fake_group(fake_run):
    rec = fake_run["rec"]
    assert rec["status"] == "ok"
    assert REF_RECORD_KEYS <= set(rec)
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["unknown_trip_loops"] == 0
    assert rec["hlo_flops_per_chip"] > 0
    # qwen2's 2 KV heads do not divide 16: the decode cache shards its
    # sequence and the softmax statistics are all-reduced; the vocab and
    # FFN shard, so the head and MLP all-reduce too
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert rec["model_flops"] == 2.0 * M.active_param_count(
        get_config("qwen2_0_5b")) * 128
    assert np.isfinite(rec["useful_flops_ratio"])


def test_dryrun_train_record_on_the_fake_group(fake_run):
    """The train kind is ``trainer.make_train_step`` under the mesh: FSDP
    weights gathered in the forward and their gradients reduce-scattered,
    the replicated ones' gradients all-reduced over the data axis."""
    rec = fake_run["train"]
    assert rec["status"] == "ok" and REF_RECORD_KEYS <= set(rec)
    assert rec["unknown_trip_loops"] == 0
    coll = rec["collectives"]
    assert coll["all-gather"]["count"] > 0
    assert coll["reduce-scatter"]["count"] > 0
    assert coll["all-reduce"]["count"] > 0
    shape = SP.SHAPES["train_4k"]
    assert rec["model_flops"] == 6.0 * M.active_param_count(
        get_config("qwen2_0_5b")) * shape["batch"] * shape["seq"]
    assert 0 < rec["useful_flops_ratio"] <= 1
