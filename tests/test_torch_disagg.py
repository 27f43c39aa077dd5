"""The pod-to-pod KV handoff and ``make_disagg_step`` on a gloo group of
four processes, a (pod 2, data 1, model 2) mesh, against the reference.

``kv_handoff``: every pod-1 rank receives its pod-0 partner's shard of
every cache leaf, exactly, and pod 0 holds zeros afterwards.
``make_disagg_step`` on the qwen2 smoke config (f32): pod 0 prefills,
pod 1 decodes from a cache it never computed; both logits equal the
reference's unsharded ``prefill_chunked`` + ``decode_step`` within 2e-5
(all-reduced partial sums over the 2-way model axis), pod 1's cache
equals the reference's within the same bound, and pod 0's cache is
zero.  Kernel 5 (its plain version on the CPU) runs on pod 0 only.  The
weights require grad, and the step records no autograd graph.
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

from repro.configs import get_smoke_config as ref_smoke
from repro.models import model as RM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5
B, SEQ, CHUNK = 2, 32, 16

WORKER = textwrap.dedent("""
    import dataclasses, pickle, sys
    import numpy as np, torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, path, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch import params as PP
        from repro_torch.configs import get_smoke_config
        from repro_torch.core.disagg import kv_handoff, make_disagg_step
        from repro_torch.kernels import ops
        from repro_torch.models import model as M
        from repro_torch.models import sharding as S
        from repro_torch.train.optimizer import leaves
        job = pickle.load(open(path, "rb"))
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 1, 2),
                          mesh_dim_names=("pod", "data", "model"))
        pod = mesh.get_local_rank("pod")
        cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                                  dtype="float32")
        out = {}
        # 1. the handoff alone: pod 0's random leaves, pod 1's zeros
        g = torch.Generator().manual_seed(7)
        full = [{"k": torch.randn(2, 8, 2, 4, generator=g),
                 "v": torch.randn(2, 8, 2, 4, generator=g)},
                {"k": torch.randn(2, 8, 2, 4, generator=g),
                 "v": torch.randn(2, 8, 2, 4, generator=g)}]
        mine = full if pod == 0 else [{k: torch.zeros_like(x)
                                       for k, x in l.items()} for l in full]
        cs = S.shard(mine, mesh, S.cache_shardings(mine, mesh))
        before = [{k: S.local(x).clone() for k, x in l.items()} for l in cs]
        kv_handoff(cs, mesh)
        after = [{k: S.local(x).clone() for k, x in l.items()} for l in cs]
        expect = S.shard(full, mesh, S.cache_shardings(full, mesh))
        out["handoff"] = dict(
            pod=pod,
            zero=all(float(x.abs().sum()) == 0 for l in after
                     for x in l.values()),
            exact=all(torch.equal(after[i][k], S.local(expect[i][k]))
                      for i in range(2) for k in ("k", "v")),
            had=all(float(x.abs().sum()) > 0 for l in before
                    for x in l.values()))
        # 2. the disaggregated step
        params = PP.from_reference(job["tree"], cfg, device="cpu")
        ps = S.shard(params, mesh, S.param_shardings(params, mesh))
        cache = M.init_cache(cfg, B, SEQ + 8, device="cpu")
        cs = S.shard(cache, mesh, S.cache_shardings(cache, mesh))
        toks = S.shard({"t": torch.from_numpy(job["toks"])}, mesh,
                       {"t": S.data_sharding(mesh)})["t"]
        n0 = ops.chunked_prefill_attention.launches
        calls = []
        real = ops.chunked_prefill_attention

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)
        ops.chunked_prefill_attention = counted
        # weights that require grad: the step records no graph all the same
        for x in leaves(ps):
            x.requires_grad_(True)
        step = make_disagg_step(cfg, mesh, chunk_size=CHUNK)
        first, dec, cs = step(ps, toks, cs)
        ops.chunked_prefill_attention = real
        out["kernel5_calls"] = len(calls)
        out["graph"] = sum(t.grad_fn is not None
                           for t in [first, dec] + leaves(cs)
                           if t is not None)
        out["flags"] = all(x.requires_grad for x in leaves(ps))
        out["first"] = first.full_tensor().numpy()
        out["dec"] = None if dec is None else dec.full_tensor().numpy()
        out["cache"] = [{k: x.full_tensor().numpy() for k, x in l.items()}
                        for l in cs]
        res = [None] * 4
        dist.all_gather_object(res, out)
        if rank == 0:
            pickle.dump(res, open(path + ".out", "wb"))
        dist.destroy_process_group()

    B, SEQ, CHUNK = %d, %d, %d
    if __name__ == "__main__":
        mp.spawn(run, args=(sys.argv[1], int(sys.argv[2])), nprocs=4)
""") % (B, SEQ, CHUNK)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def disagg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("disagg")
    cfg = dataclasses.replace(ref_smoke("qwen2_0_5b"), dtype="float32")
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, SEQ)).astype(np.int32)
    cache = RM.init_cache(cfg, B, SEQ + 8)
    first, cache = RM.prefill_chunked(params, cfg, jnp.asarray(toks), cache,
                                      chunk_size=CHUNK)
    nt = jnp.argmax(first[:, -1], axis=-1)[:, None].astype(jnp.int32)
    dec, cache = RM.decode_step(params, cfg, nt, cache,
                                jnp.full((B,), SEQ, jnp.int32))
    ref = dict(first=np.asarray(first), dec=np.asarray(dec),
               k=np.asarray(cache["body"][0]["k"]),
               v=np.asarray(cache["body"][0]["v"]))
    path = str(tmp / "job.pkl")
    pickle.dump(dict(tree=jax.tree.map(np.asarray, params), toks=toks),
                open(path, "wb"))
    script = tmp / "job.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), path,
                        str(_free_port())], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return pickle.load(open(path + ".out", "rb")), ref


def test_kv_handoff_moves_every_leaf_pod0_to_pod1(disagg):
    res, _ = disagg
    for r in res:
        h = r["handoff"]
        if h["pod"] == 0:
            assert h["had"] and h["zero"]     # ownership transferred
        else:
            assert h["exact"]                 # pod 0's shard, bit for bit


def test_disagg_step_logits_equal_reference(disagg):
    res, ref = disagg
    for r in res:
        np.testing.assert_allclose(r["first"], ref["first"], rtol=0,
                                   atol=ATOL)
        if r["handoff"]["pod"] == 1:
            np.testing.assert_allclose(r["dec"], ref["dec"], rtol=0,
                                       atol=ATOL)
        else:
            assert r["dec"] is None           # pod 0 decodes nothing


def test_disagg_step_cache_lands_on_pod1_only(disagg):
    res, ref = disagg
    n_layers = ref["k"].shape[0]
    for r in res:
        if r["handoff"]["pod"] == 0:
            assert all(float(np.abs(x).sum()) == 0 for l in r["cache"]
                       for x in l.values())
            continue
        for i in range(n_layers):
            np.testing.assert_allclose(r["cache"][i]["k"], ref["k"][i],
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(r["cache"][i]["v"], ref["v"][i],
                                       rtol=0, atol=ATOL)


def test_disagg_prefill_runs_on_pod0_only(disagg):
    res, _ = disagg
    layers = ref_smoke("qwen2_0_5b").n_layers
    for r in res:
        want = layers * (SEQ // CHUNK) if r["handoff"]["pod"] == 0 else 0
        assert r["kernel5_calls"] == want


def test_disagg_step_records_no_graph(disagg):
    res, _ = disagg
    for r in res:
        assert r["graph"] == 0 and r["flags"]
