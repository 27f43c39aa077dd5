"""The port's coupled vLLM-style baseline (``runtime/baseline_vllm.py``,
``CoupledEngine``) against the JAX package's on the same weights and
requests, and the output equivalence the reference holds its
disaggregated serving to, on the port: ``Cluster(runtime="engine")``
and a bare prefill -> decode engine pair give ``CoupledEngine``'s
tokens (tests/test_serving_cluster.py:175, tests/test_system.py:65).

CPU, f32: the reference's Pallas kernels in interpret mode, the port's
kernels' plain versions.  Greedy tokens must be identical.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.models import model as RM  # noqa: E402
from repro.runtime.baseline_vllm import CoupledEngine as RefCoupled  # noqa: E402,E501
from repro.runtime.workload import generate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from repro_torch.runtime.baseline_vllm import CoupledEngine  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402
from repro_torch.runtime.workload import generate as port_generate  # noqa: E402,E501
from repro_torch.serving import Cluster  # noqa: E402


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _port_requests(ref_reqs):
    return [Request(rid=r.rid, prompt_len=r.prompt_len,
                    decode_len=r.decode_len, arrival=r.arrival,
                    prompt_tokens=r.prompt_tokens) for r in ref_reqs]


def _run_coupled(eng, reqs):
    for r in reqs:
        eng.submit(r)
    out, t = {}, 0.0
    for _ in range(3000):
        for fin in eng.step(t):
            out[fin.req.rid] = fin.tokens
        t += 0.01
        if eng.done():
            break
    return out


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "recurrentgemma_9b",
                                  "xlstm_1_3b"])
def test_coupled_matches_reference(arch):
    """Tokens, iterations, prefill iterations and the timestamps of
    every request equal the reference engine's; nothing held after."""
    cfg = _cfg(arch)
    ref_params = RM.init_params(jax.random.PRNGKey(0), cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    reqs = generate("Mixed", 5, seed=3, max_prompt=40, max_decode=8,
                    vocab_size=cfg.vocab_size)
    # as many slots as requests: a waiting request with no free slot
    # keeps the reference's engine in prefill iterations that admit
    # nothing
    kw = dict(max_slots=8, max_seq=64, prefill_batch=2)
    ref = RefCoupled(cfg, ref_params, **kw)
    eng = CoupledEngine(cfg, params, device="cpu", **kw)
    ref_reqs, port_reqs = copy.deepcopy(reqs), _port_requests(reqs)
    want = _run_coupled(ref, ref_reqs)
    got = _run_coupled(eng, port_reqs)
    assert len(got) == 5 and got == want
    assert (eng.iterations, eng.prefill_iterations) \
        == (ref.iterations, ref.prefill_iterations)
    for a, b in zip(ref_reqs, port_reqs):
        assert (a.t_first_token, a.t_decode_start, a.t_finish) \
            == (b.t_first_token, b.t_decode_start, b.t_finish)
    assert eng.alloc.used_pages == 0


@pytest.fixture(scope="module")
def qwen():
    cfg = _cfg("qwen2_0_5b")
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_cluster_token_identical_to_coupled(qwen):
    """Mirrors tests/test_serving_cluster.py:175: the port's Cluster
    with 2 prefill and 2 decode instances gives the port's
    CoupledEngine's tokens, and spreads work over all four."""
    cfg, params = qwen
    reqs = port_generate("Mixed", 8, seed=0, max_prompt=48, max_decode=12,
                         vocab_size=cfg.vocab_size)
    reqs_b = copy.deepcopy(reqs)
    cluster = Cluster(cfg, runtime="engine", params=params, chunk_size=16,
                      max_seq=128, max_batch=8, n_pages=256, n_prefill=2,
                      n_decode=2, device="cpu")
    handles = [cluster.submit(request=r) for r in reqs]
    cluster.run()
    out = {h.rid: h.result().tokens for h in handles}
    base = CoupledEngine(cfg, params, max_slots=8, max_seq=128,
                         device="cpu")
    assert out == _run_coupled(base, reqs_b)
    assert sum(1 for i in cluster.instances if i.pe.chunk_steps) == 2
    assert sum(1 for i in cluster.instances if i.de.iterations) == 2
    for r in reqs:
        assert 0 <= r.t_prefill_start <= r.t_first_token
        assert r.t_first_token <= r.t_transfer_done <= r.t_decode_start
        assert r.t_decode_start <= r.t_finish


@pytest.mark.parametrize("arch,backend", [("qwen2_0_5b", "paged"),
                                          ("recurrentgemma_9b", "dense"),
                                          ("xlstm_1_3b", "dense")])
def test_disagg_token_identical_to_coupled(arch, backend):
    """Mirrors tests/test_system.py:65: a prefill engine and a decode
    engine give the coupled engine's tokens, on the paged backend and
    on the dense one."""
    cfg = _cfg(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    reqs = port_generate("LPLD", 6, seed=1, max_prompt=48, max_decode=12,
                         vocab_size=cfg.vocab_size)
    want = _run_coupled(CoupledEngine(cfg, params, max_slots=8,
                                      max_seq=128, device="cpu"),
                        copy.deepcopy(reqs))
    pe = PrefillEngine("p0", cfg, params, chunk_size=16, max_seq=128,
                       device="cpu")
    de = DecodeEngine("d0", cfg, params, max_slots=8, max_seq=128,
                      policy="greedy", device="cpu")
    assert pe.backend == de.backend == backend
    for r in reqs:
        pe.submit(r)
    got, t = {}, 0.0
    for _ in range(3000):
        for pk in pe.step(t):
            de.receive(pk)
        de.admit(t)
        for f in de.step(t):
            got[f.req.rid] = f.tokens
        t += 0.01
        if pe.idle() and de.idle():
            break
    assert len(got) == 6 and got == want


def test_recurrentgemma_cluster_matches_reference():
    """A RecurrentGemma Cluster (1 + 1 instances, dense backend) gives
    the reference's Cluster the same record: tokens, instance
    assignment, timestamps and wire bytes."""
    from repro.serving import Cluster as RefCluster
    cfg = _cfg("recurrentgemma_9b")
    ref_params = RM.init_params(jax.random.PRNGKey(2), cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    reqs = generate("Mixed", 4, seed=4, max_prompt=40, max_decode=6,
                    vocab_size=cfg.vocab_size)
    kw = dict(runtime="engine", chunk_size=16, max_seq=64, max_batch=4,
              n_pages=64, n_prefill=1, n_decode=1)
    records = []
    for cls, p, rs in ((RefCluster, ref_params, copy.deepcopy(reqs)),
                       (Cluster, params, _port_requests(reqs))):
        extra = {} if cls is RefCluster else {"device": "cpu"}
        cluster = cls(cfg, params=p, **kw, **extra)
        hs = [cluster.submit(request=r) for r in rs]
        cluster.run()
        res = cluster.result()
        records.append(dict(
            requests={h.rid: (h.result().tokens, h.result().t_first_token,
                              h.result().t_decode_start, h.result().t_finish)
                      for h in hs},
            assignment={rid: (e.prefill_iid, e.decode_iid)
                        for rid, e in cluster.gsched.table.items()},
            bytes=cluster.network.bytes_sent, metrics=res.metrics))
    assert records[0] == records[1]
    assert len(records[1]["requests"]) == 4 and records[1]["bytes"] > 0
