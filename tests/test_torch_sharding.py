"""The port's multi-device layer against the reference's: the sharding
rules (placements against the reference's PartitionSpecs, for every
registry config at full size on meta), ``seq_sharded_attn`` and
``_mla_absorbed_attn`` on the same numpy inputs, and the sharded forward
(``prefill_chunked`` + ``decode_step`` on a gloo data 2 x model 2 group
in four processes) against the reference's logits; ``forward_train``
there too, and the sharded loss's gradients against unsharded autograd.

f32 throughout.  Tolerances: attention functions 1e-5 absolute (f32
sums in another order); sharded logits 2e-5 absolute (all-reduced
partial sums of O(1) logits); gradients 1e-5 of each leaf's largest.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import attention as RA
from repro.models import model as RM
from repro.models import sharding as RS
from repro_torch import params as PP
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
ATOL_ATTN = 1e-5
ATOL_LOGITS = 2e-5


def _key(name):
    return ("layers", "0", "attn", name)


class _Leaf:
    def __init__(self, shape):
        self.shape = shape


def _pl(*dims):
    return S.placements(dims, AXES)


# ---------------------------------------------------------------------------
# the reference's eight rule cases (tests/test_sharding_rules.py), ported
# ---------------------------------------------------------------------------
def test_column_row_specs():
    assert S.param_spec(_key("wq"), _Leaf((896, 896)),
                        model_size=16) == _pl(None, "model")
    assert S.param_spec(_key("wo"), _Leaf((896, 896)),
                        model_size=16) == _pl("model", None)


def test_divisibility_fallback_replicates():
    assert S.param_spec(_key("wq"), _Leaf((896, 14 * 64)),
                        model_size=32) == _pl(None, "model")
    assert S.param_spec(_key("wq"), _Leaf((897, 13)),
                        model_size=16) == _pl(None, None)


def test_per_layer_leaves_drop_the_stacked_dim():
    # the reference's stacked body leaf (24, 896, 896) is P(None, None,
    # "model"); the port's per-layer leaf gets it without the repeats dim
    ref = RS.param_spec((jax.tree_util.DictKey("body"),
                         jax.tree_util.DictKey("wq")), _Leaf((24, 896, 896)),
                        model_size=16)
    port = S.param_spec(("layers", "5", "attn", "wq"), _Leaf((896, 896)),
                        model_size=16)
    assert port == S.placements(tuple(ref)[1:], AXES) == _pl(None, "model")


def test_expert_weights_expert_parallel_vs_ff_fallback():
    sp = S.param_spec(_key("wi"), _Leaf((160, 5120, 3072)), model_size=16)
    assert sp == _pl("model", None, None)
    sp = S.param_spec(_key("wi"), _Leaf((40, 1536, 1024)), model_size=16)
    assert sp == _pl(None, None, "model")


def test_serve2d_vs_fsdp_expert_sharding():
    sp = S.param_spec(_key("wi"), _Leaf((160, 5120, 3072)), model_size=16,
                      data_size=16, serve2d=True)
    assert sp == _pl("model", None, "data")
    sp = S.param_spec(_key("wi"), _Leaf((160, 5120, 3072)), model_size=16,
                      data_size=16, fsdp=True)
    assert sp == _pl("model", "data", None)


def test_cache_heads_vs_seq_sharding():
    kw = dict(model_size=16, batch_axes=("data",))
    assert S.cache_spec(("0", "k"), _Leaf((128, 32768, 16, 128)),
                        **kw) == _pl(("data",), None, "model", None)
    assert S.cache_spec(("0", "k"), _Leaf((128, 32768, 8, 128)),
                        **kw) == _pl(("data",), "model", None, None)
    assert S.cache_spec(("0", "ckv"), _Leaf((128, 32768, 512)),
                        **kw) == _pl(("data",), "model", None)


def test_recurrent_state_feature_sharding():
    kw = dict(model_size=16, batch_axes=("data",))
    assert S.cache_spec(("0", "h"), _Leaf((32, 4096)),
                        **kw) == _pl(("data",), "model")
    assert S.cache_spec(("0", "C"), _Leaf((32, 4, 1024, 1024)),
                        **kw) == _pl(("data",), None, "model", None)


def test_norms_replicated():
    from torch.distributed.tensor import Replicate
    for n in ("norm1", "final_norm", "a_param", "router"):
        sp = S.param_spec(_key(n), _Leaf((4096,)), model_size=16)
        assert all(isinstance(p, Replicate) for p in sp), sp


def test_multi_pod_batch_is_shard0_on_both_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    sp = S.cache_spec(("0", "k"), _Leaf((128, 32768, 8, 128)),
                      model_size=16, batch_axes=("pod", "data"),
                      axes=("pod", "data", "model"))
    assert sp == (Shard(0), Shard(0), Shard(1))
    assert S.param_spec(_key("norm1"), _Leaf((8,)), model_size=16,
                        axes=("pod", "data", "model")) == (Replicate(),) * 3


# ---------------------------------------------------------------------------
# every registry config at full size: placements == the reference's specs
# ---------------------------------------------------------------------------
def _rel(node) -> dict:
    """{path of names within ``node``: leaf} of a reference subtree."""
    return {tuple(RS._path_names(p)): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(node)[0]}


def _ref_layers(tree, cfg) -> list:
    """The reference's prefix / stacked body / suffix as one list in the
    port's layer order: (stacked, {path within the layer: leaf})."""
    out = [(False, _rel(blk)) for blk in tree["prefix"]]
    for _ in range(cfg.n_repeats):
        out.extend((True, _rel(tree["body"][j]))
                   for j in range(len(cfg.pattern)))
    out.extend((False, _rel(blk)) for blk in tree["suffix"])
    return out


def _port_paths(node) -> dict:
    got = {}
    S.tree_map_with_path(lambda p, x: got.setdefault(p, x), node)
    return got


def _keys(path, stacked):
    return tuple(jax.tree_util.DictKey(k) for k in
                 (("body",) if stacked else ()) + path)


MESHES = [dict(model_size=1, data_size=1), dict(model_size=2, data_size=16),
          dict(model_size=16, data_size=16), dict(model_size=16,
                                                  data_size=1)]
MODES = [dict(), dict(fsdp=True), dict(serve2d=True)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_placements_equal_reference(arch):
    rcfg, pcfg = ref_get_config(arch), get_config(arch)
    ref_tree = RM.abstract_params(rcfg)
    port = M.abstract_params(pcfg)
    ref_top = _rel({k: v for k, v in ref_tree.items()
                    if k not in ("prefix", "body", "suffix")})
    port_top = _port_paths({k: v for k, v in port.items() if k != "layers"})
    assert sorted(ref_top) == sorted(port_top)
    ref_layers = _ref_layers(ref_tree, rcfg)
    assert len(ref_layers) == len(port["layers"])
    for kw in [dict(m, **mode) for m in MESHES for mode in MODES]:
        for path, x in port_top.items():
            r = ref_top[path]
            assert tuple(r.shape) == tuple(x.shape), path
            want = S.placements(tuple(RS.param_spec(_keys(path, False), r,
                                                    **kw)), AXES)
            assert S.param_spec(path, x, axes=AXES, **kw) == want, path
        for i, ((stacked, rl), pl) in enumerate(zip(ref_layers,
                                                    port["layers"])):
            got = _port_paths(pl)
            assert sorted(rl) == sorted(got), i
            for path, r in rl.items():
                x = got[path]
                shape = tuple(r.shape)[1:] if stacked else tuple(r.shape)
                assert shape == tuple(x.shape), (i, path)
                rspec = tuple(RS.param_spec(_keys(path, stacked),
                                            _Leaf(tuple(r.shape)), **kw))
                want = S.placements(rspec[1:] if stacked else rspec, AXES)
                assert S.param_spec(("layers", str(i)) + path, x,
                                    axes=AXES, **kw) == want, (i, path, kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_cache_placements_equal_reference(arch):
    rcfg, pcfg = ref_get_config(arch), get_config(arch)
    b, s = 32, 4096
    ref_layers = _ref_layers(RM.abstract_cache(rcfg, b, s), rcfg)
    port = M.abstract_cache(pcfg, b, s)
    assert len(ref_layers) == len(port)
    for model_size in (1, 2, 16):
        for ba, axes in ((("data",), AXES),
                         (("pod", "data"), ("pod", "data", "model"))):
            for i, ((stacked, rl), pl) in enumerate(zip(ref_layers, port)):
                assert sorted(p[-1] for p in rl) == sorted(pl)
                for path, r in rl.items():
                    x = pl[path[-1]]
                    shape = tuple(r.shape)[1:] if stacked \
                        else tuple(r.shape)
                    assert shape == tuple(x.shape)
                    rspec = tuple(RS.cache_spec(
                        _keys(path, stacked), _Leaf(tuple(r.shape)),
                        model_size=model_size, batch_axes=ba))
                    want = S.placements(rspec[1:] if stacked else rspec,
                                        axes)
                    assert S.cache_spec((str(i), path[-1]), x,
                                        model_size=model_size,
                                        batch_axes=ba, axes=axes) == want


# ---------------------------------------------------------------------------
# attention functions against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [0, 6])
def test_seq_sharded_attn_matches_reference(window):
    rng = np.random.default_rng(0)
    b, sq, h, kvh, hd, s_cache, q_off = 2, 8, 4, 2, 16, 32, 12
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s_cache, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, s_cache, kvh, hd)).astype(np.float32)
    ref = RA.seq_sharded_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_offset=q_off, kv_len=q_off + sq,
                              window=window)
    got = A.seq_sharded_attn(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), q_offset=q_off,
                             kv_len=q_off + sq, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL_ATTN)


@pytest.mark.parametrize("window", [0, 6])
def test_mla_absorbed_attn_matches_reference(window):
    cfg_r = dataclasses.replace(ref_smoke("deepseek_v2_236b"),
                                dtype="float32")
    cfg_p = dataclasses.replace(get_smoke_config("deepseek_v2_236b"),
                                dtype="float32")
    m = cfg_r.mla
    rng = np.random.default_rng(1)
    b, sq, h, s_cache, q_off = 2, 8, cfg_r.n_heads, 32, 12
    wkv_b = rng.standard_normal(
        (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim))
    ).astype(np.float32) * 0.1
    q_nope = rng.standard_normal((b, sq, h, m.qk_nope_head_dim)
                                 ).astype(np.float32)
    q_rope = rng.standard_normal((b, sq, h, m.qk_rope_head_dim)
                                 ).astype(np.float32)
    ckv = rng.standard_normal((b, s_cache, m.kv_lora_rank)
                              ).astype(np.float32)
    kr = rng.standard_normal((b, s_cache, m.qk_rope_head_dim)
                             ).astype(np.float32)
    ref = RA._mla_absorbed_attn(
        {"wkv_b": jnp.asarray(wkv_b)}, cfg_r, jnp.asarray(q_nope),
        jnp.asarray(q_rope), jnp.asarray(ckv), jnp.asarray(kr),
        q_offset=q_off, kv_len=q_off + sq, window=window)
    got = A._mla_absorbed_attn(
        {"wkv_b": torch.from_numpy(wkv_b)}, cfg_p, torch.from_numpy(q_nope),
        torch.from_numpy(q_rope), torch.from_numpy(ckv), torch.from_numpy(kr),
        q_offset=q_off, kv_len=q_off + sq, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL_ATTN)


# ---------------------------------------------------------------------------
# the sharded forward on gloo (data 2 x model 2) against the reference
# ---------------------------------------------------------------------------
B, SEQ, CHUNK = 2, 32, 16
# (case name, arch, config overrides, opts)
CASES = [
    ("qwen2", "qwen2_0_5b", {}, ()),
    ("qwen2_seqkv", "qwen2_0_5b", {}, ("seqkv",)),
    ("qwen2_attn2d", "qwen2_0_5b", {}, ("attn2d",)),
    ("qwen2_seqact", "qwen2_0_5b", {}, ("seqact",)),
    # one KV head on a 2-way model axis: the cache shards its sequence
    ("qwen2_kv1", "qwen2_0_5b", {"n_kv_heads": 1}, ()),
    ("qwen2_kv1_seqkv", "qwen2_0_5b", {"n_kv_heads": 1}, ("seqkv",)),
    ("dsv2_seqkv", "deepseek_v2_236b", {}, ("seqkv",)),
    ("dsv2", "deepseek_v2_236b", {}, ()),
]


def _ref_cfg(arch, over):
    return dataclasses.replace(ref_smoke(arch), dtype="float32", **over)


def _ref_run(cfg, params, toks):
    """The reference's unsharded prefill_chunked + decode_step."""
    cache = RM.init_cache(cfg, B, SEQ + 8)
    first, cache = RM.prefill_chunked(params, cfg, jnp.asarray(toks), cache,
                                      chunk_size=CHUNK)
    nt = jnp.argmax(first[:, -1], axis=-1)[:, None].astype(jnp.int32)
    dec, _ = RM.decode_step(params, cfg, nt, cache,
                            jnp.full((B,), SEQ, jnp.int32))
    return np.asarray(first), np.asarray(dec), np.asarray(nt)


WORKER = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    import numpy as np, torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, path, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        from torch.distributed.tensor.debug import CommDebugMode
        from repro_torch import params as PP
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import attention as A
        from repro_torch.models import model as M
        from repro_torch.models import sharding as S
        job = pickle.load(open(path, "rb"))
        mesh = make_debug_mesh(job["data"], job["model"], device_type="cpu")
        out = {}
        for name, arch, over, opts, tree, toks, nt in job["cases"]:
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32", **over)
            params = PP.from_reference(tree, cfg, device="cpu")
            ps = S.shard(params, mesh, S.param_shardings(params, mesh))
            b, s = toks.shape
            cache = M.init_cache(cfg, b, s + 8, device="cpu")
            cs = S.shard(cache, mesh, S.cache_shardings(cache, mesh))
            ins = S.shard({"t": torch.from_numpy(toks),
                           "n": torch.from_numpy(nt),
                           "p": torch.full((b,), s, dtype=torch.int32)},
                          mesh, {"t": S.data_sharding(mesh),
                                 "n": S.data_sharding(mesh),
                                 "p": S.data_sharding(mesh, extra_dims=0)})
            with torch.no_grad(), S.activation_sharding(mesh, ("data",),
                                                        opts=opts):
                first, cs = M.prefill_chunked(ps, cfg, ins["t"], cs,
                                              chunk_size=job["chunk"])
                dec, cs = M.decode_step(ps, cfg, ins["n"], cs, ins["p"])
            out[name] = (first.full_tensor().numpy(),
                         dec.full_tensor().numpy())
        for name, arch, over, opts, fsdp, micro, tree, toks, labels in \
                job.get("train", ()):
            # forward_train, then the trainer's own gradients and one
            # train step, sharded
            from torch.distributed.tensor import DTensor
            from repro_torch.train import optimizer as opt, trainer
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      dtype="float32", **over)
            params = PP.from_reference(tree, cfg, device="cpu")
            ps = S.shard(params, mesh, S.param_shardings(params, mesh,
                                                         fsdp=fsdp))
            flat = S.leaves(ps)
            ins = S.shard({"t": torch.from_numpy(toks),
                           "l": torch.from_numpy(labels)}, mesh,
                          {"t": S.data_sharding(mesh),
                           "l": S.data_sharding(mesh)})
            st = opt.init(ps)
            with S.activation_sharding(mesh, ("data",), opts=opts):
                with torch.no_grad():
                    logits, _ = M.forward_train(ps, cfg, ins["t"])
                grads, loss = trainer.lm_grads(ps, cfg, ins["t"], ins["l"],
                                               microbatch=micro)
                trainer.make_train_step(cfg, job["opt"], microbatch=micro)(
                    ps, st, ins["t"], ins["l"])
            full = [DTensor.from_local(g, p.device_mesh, p.placements,
                                       run_check=False, shape=p.shape,
                                       stride=p.stride()).full_tensor()
                    for g, p in zip(S.leaves(grads), flat)]
            out[name] = (logits.full_tensor().numpy(), float(loss),
                         [g.numpy() for g in full],
                         [p.full_tensor().numpy() for p in S.leaves(ps)],
                         [m.full_tensor().numpy() for m in S.leaves(st.m)])
        if job.get("attn"):
            q, k, v, q_off, kv_len = job["attn"]
            # the cache's sequence over the model axis only
            from torch.distributed.tensor import DTensor, Replicate, Shard
            pl = (Replicate(), Shard(1))
            kd, vd = (DTensor.from_local(
                S.local_chunk(torch.from_numpy(x), mesh, pl).clone(), mesh,
                pl, run_check=False) for x in (k, v))
            with CommDebugMode() as comm, torch.no_grad(), \\
                    S.activation_sharding(mesh, ("data",)):
                got = A.seq_sharded_attn(torch.from_numpy(q), kd, vd,
                                         q_offset=q_off, kv_len=kv_len)
            out["attn"] = (got.numpy(), {op.__name__: n for op, n in
                                         comm.get_comm_counts().items()})
        if rank == 0:
            pickle.dump(out, open(path + ".out", "wb"))
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], int(sys.argv[2])), nprocs=4)
""")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_gloo(tmp_path, job, name="job"):
    path = str(tmp_path / f"{name}.pkl")
    pickle.dump(job, open(path, "wb"))
    script = tmp_path / f"{name}.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), path,
                          str(_free_port())], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return pickle.load(open(path + ".out", "rb"))


# MoE: the group size follows the data axis, as in the reference.
# Granite-MoE smoke with capacity factor 1 (tokens are dropped): at data
# 2 the reference's groups are one data shard's tokens, so its logits
# differ from the unsharded ones; the port on gloo (data 2 x model 2,
# experts 2 a rank) must equal the reference's sharded run, which runs
# in a subprocess with two JAX CPU devices.
MOE_REF = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke_config
    from repro.models import model as M
    from repro.models import sharding as S
    job = pickle.load(open(sys.argv[1], "rb"))
    cfg = dataclasses.replace(get_smoke_config("granite_moe_3b_a800m"),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=job["cf"]))
    params = jax.tree.map(jnp.asarray, job["tree"])
    toks = jnp.asarray(job["toks"])
    b, s = toks.shape
    mesh = jax.make_mesh((2, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for sharded in (False, True):
        cache = M.init_cache(cfg, b, s + 8)
        if sharded:
            with mesh, S.activation_sharding(mesh, ("data",)):
                first, cache = M.prefill_chunked(params, cfg, toks, cache,
                                                 chunk_size=job["chunk"])
                nt = jnp.argmax(first[:, -1], -1)[:, None].astype(jnp.int32)
                dec, _ = M.decode_step(params, cfg, nt, cache,
                                       jnp.full((b,), s, jnp.int32))
        else:
            first, cache = M.prefill_chunked(params, cfg, toks, cache,
                                             chunk_size=job["chunk"])
            nt = jnp.argmax(first[:, -1], -1)[:, None].astype(jnp.int32)
            dec, _ = M.decode_step(params, cfg, nt, cache,
                                   jnp.full((b,), s, jnp.int32))
        out[sharded] = (np.asarray(first), np.asarray(dec), np.asarray(nt))
    pickle.dump(out, open(sys.argv[1] + ".out", "wb"))
""")




def _moe_case(tmp):
    """(the gloo job's MoE case, the reference's unsharded and sharded
    (first, decode, next token))."""
    cfg = dataclasses.replace(ref_smoke("granite_moe_3b_a800m"),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    path = str(tmp / "moe.pkl")
    pickle.dump(dict(tree=tree, toks=toks, cf=1.0, chunk=CHUNK),
                open(path, "wb"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", MOE_REF, path], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = pickle.load(open(path + ".out", "rb"))
    case = ("moe", "granite_moe_3b_a800m",
            {"moe": dataclasses.replace(get_smoke_config(
                "granite_moe_3b_a800m").moe, capacity_factor=1.0)}, (),
            tree, toks, ref[True][2])
    return case, ref


@pytest.fixture(scope="module")
def gloo_forward(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo_fwd")
    cases, refs, trees = [], {}, {}
    rng = np.random.default_rng(0)
    for name, arch, over, opts in CASES:
        key = (arch, tuple(sorted(over.items())))
        cfg = _ref_cfg(arch, over)
        if key not in trees:
            params = RM.init_params(jax.random.PRNGKey(0), cfg)
            toks = rng.integers(0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
            trees[key] = (jax.tree.map(np.asarray, params), toks,
                          _ref_run(cfg, params, toks))
        tree, toks, ref = trees[key]
        refs[name] = ref
        cases.append((name, arch, over, opts, tree, toks, ref[2]))
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    train, train_refs = [], {}
    for name, over, opts, fsdp, micro in TRAIN_CASES:
        cfg = _ref_cfg("qwen2_0_5b", over)
        params = RM.init_params(jax.random.PRNGKey(1), cfg)
        toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        logits, _ = RM.forward_train(params, cfg, jnp.asarray(toks))
        tree = jax.tree.map(np.asarray, params)
        train_refs[name] = (np.asarray(logits), tree, toks, labels)
        train.append((name, "qwen2_0_5b", over, opts, fsdp, micro, tree,
                      toks, labels))
    moe, moe_ref = _moe_case(tmp)
    job = dict(data=2, model=2, chunk=CHUNK, cases=cases + [moe],
               train=train, opt=TRAIN_OPT, attn=(q, k, v, 12, 20))
    out = run_gloo(tmp, job)
    return out, refs, (q, k, v), train_refs, moe_ref


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_forward_matches_reference(gloo_forward, name):
    out, refs, *_ = gloo_forward
    first, dec = out[name]
    r_first, r_dec, _ = refs[name]
    np.testing.assert_allclose(first, r_first, rtol=0, atol=ATOL_LOGITS)
    np.testing.assert_allclose(dec, r_dec, rtol=0, atol=ATOL_LOGITS)


def test_seq_sharded_attn_on_gloo_reduces_without_gathering(gloo_forward):
    out, _, (q, k, v), *_ = gloo_forward
    got, comm = out["attn"]
    want = A.seq_sharded_attn(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), q_offset=12, kv_len=20)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=ATOL_ATTN)
    # the row max, the row sum and the PV partials: three all-reduces
    assert comm == {"all_reduce": 3}, comm


# forward_train on gloo: "attn2d" splits the batch over the model axis
# when the heads cannot shard (one KV head), "seqact" shards the residual
# stream's sequence, "fsdp" shards the weights over the data axis too (the
# dry run's train layout), here with two microbatches; logits against the
# reference's forward_train, the trainer's sharded gradients (the global
# mean loss, vocab-parallel cross entropy, Megatron's operators, the
# data-axis sums) against the port's unsharded autograd, which
# tests/test_torch_train.py holds against jax.grad
# (name, config overrides, opts, fsdp, microbatches)
TRAIN_CASES = [("train", {}, (), False, 1),
               ("train_attn2d", {"n_kv_heads": 1}, ("attn2d",), False, 1),
               ("train_seqact", {}, ("seqact",), False, 1),
               ("train_fsdp_mb2", {}, (), True, 2)]
GRAD_RTOL = 1e-5        # of each leaf's largest |gradient|
# warm at step 1 (lr 3e-4) and a clip norm below the gradients' norm, so
# the clip (the norm over the whole mesh) scales the step; Adam's first
# step is x / (|x| + eps) of the clipped gradient x, so eps is set above
# the x here: the step is then smooth in x (with a small eps an x near
# eps turns f32 noise into a large change) and linear in the clip scale
PARAM_ATOL = 1e-6       # updated weights, f32 (a step moves them <= 3e-4)
TRAIN_OPT = opt.AdamWConfig(warmup_steps=1, clip_norm=1e-2, eps=1e-3)


def _train_case(name):
    return next(c for c in TRAIN_CASES if c[0] == name)


def _unsharded(name, train_refs):
    _, over, _, _, micro = _train_case(name)
    _, tree, toks, labels = train_refs[name]
    cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                              dtype="float32", **over)
    return cfg, PP.from_reference(tree, cfg, device="cpu"), toks, labels


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_sharded_train_forward_and_grads(gloo_forward, name):
    out, _, _, train_refs, _ = gloo_forward
    logits, loss, grads, _, _ = out[name]
    ref_logits = train_refs[name][0]
    np.testing.assert_allclose(logits, ref_logits, rtol=0,
                               atol=ATOL_LOGITS)
    cfg, params, toks, labels = _unsharded(name, train_refs)
    g, (total, _) = trainer.grads_of(lambda p: trainer.lm_loss(
        p, cfg, torch.from_numpy(toks), torch.from_numpy(labels)), params)
    assert abs(loss - float(total)) <= 1e-5 * abs(float(total))
    want = S.leaves(g)
    assert len(want) == len(grads)
    for got, exp in zip(grads, want):
        exp = exp.numpy()
        np.testing.assert_allclose(got, exp, rtol=0, atol=GRAD_RTOL * max(
            1.0, float(np.abs(exp).max())))


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_sharded_train_step_matches_unsharded(gloo_forward, name):
    """One ``trainer.make_train_step`` step on the mesh against the same
    step unsharded: the first moments (the clipped gradients: a clip
    norm over one rank's shards would scale them otherwise) and the
    updated weights.  The moments are linear in the gradients, so they
    carry the gradients' tolerance through the same map."""
    out, _, _, train_refs, _ = gloo_forward
    _, _, _, got_params, got_m = out[name]
    cfg, params, toks, labels = _unsharded(name, train_refs)
    micro = _train_case(name)[4]
    st = opt.init(params)
    g, _ = trainer.lm_grads(params, cfg, torch.from_numpy(toks),
                            torch.from_numpy(labels), microbatch=micro)
    norm = float(opt.global_norm(g))
    assert norm > 10 * TRAIN_OPT.clip_norm
    scale = (1 - TRAIN_OPT.b1) * TRAIN_OPT.clip_norm / norm
    trainer.make_train_step(cfg, TRAIN_OPT, microbatch=micro)(
        params, st, toks, labels)
    for got, exp, gl in zip(got_m, S.leaves(st.m), S.leaves(g)):
        np.testing.assert_allclose(got, exp.numpy(), rtol=0,
                                   atol=scale * GRAD_RTOL * max(
                                       1.0, float(gl.abs().max())))
    for got, exp in zip(got_params, S.leaves(params)):
        np.testing.assert_allclose(got, exp.detach().numpy(), rtol=0,
                                   atol=PARAM_ATOL)


def test_moe_group_size_follows_the_data_axis(gloo_forward):
    out, *_, ref = gloo_forward
    assert not np.allclose(ref[True][0], ref[False][0], atol=1e-3)
    first, dec = out["moe"]
    np.testing.assert_allclose(first, ref[True][0], rtol=0,
                               atol=ATOL_LOGITS)
    np.testing.assert_allclose(dec, ref[True][1], rtol=0, atol=ATOL_LOGITS)


def test_unsharded_helpers_are_the_plain_operations():
    """Outside a context every hook is the plain operation."""
    x, w = torch.randn(3, 4), torch.randn(4, 6)
    assert not S.active() and S.data_axis_size() == 1
    assert torch.equal(S.col_full(x, w), x @ w)
    assert torch.equal(S.row(x, w), x @ w)
    assert S.act_constrain(x[None]) is not None
    assert S.opt_on("seqkv") is False
    t = torch.arange(5)
    e = torch.randn(7, 2)
    assert torch.equal(S.embed_lookup(e, t), e[t])
