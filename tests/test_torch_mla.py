"""The port's MLA + MoE path (DeepSeek-V2) against the JAX package's.

Inputs come from numpy with a seed (or from the JAX ``init_params``
through ``from_reference``) and go to both sides.  Both run on the CPU:
the JAX side with its Pallas kernels in interpret mode, the port with
its kernels' plain versions.  Tolerances:

* kernel 3 (paged MLA decode): 2e-5 in f32 (summation order), 3e-2 in
  bf16 (one bf16 rounding of outputs of magnitude ~1), as
  tests/test_kernels.py states for the Pallas kernel;
* ``moe_forward``: 1e-5 (f32 products of d_model-wide rows);
* MLA prefill/decode outputs: 1e-4 (f32 matmuls through two low-rank
  projections and the absorbed up-projections), pools 1e-5;
* engines: token streams identical, latent payloads within 1e-5.

Configs: the smoke config (``reduced``: q_lora_rank 0, no dense prefix,
drop-free MoE) and a variant with ``q_lora_rank=32``, one dense prefix
layer and ``capacity_factor=1.3``, so the low-rank query, the dense
first layer and token drops all run.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.decode_engine import DecodeEngine as RefDecode  # noqa: E402
from repro.core.prefill_engine import PrefillEngine as RefPrefill  # noqa: E402,E501
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import mlp as RMLP  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.config import ATTN as REF_ATTN  # noqa: E402
from repro.runtime.workload import generate  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.backend import backend_for  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.kv_transfer import kv_page_bytes  # noqa: E402
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kvcache.paged import PagePool  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import mlp as MLP  # noqa: E402
from repro_torch.models.config import ATTN  # noqa: E402
from repro_torch.params import from_reference, to_tensor  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402

ARCH = "deepseek_v2_236b"
PAGE = 4
KW = dict(max_seq=64, page_size=PAGE, n_pages=128)


def _variant(cfg, attn_kind):
    """q_lora path, dense first layer, capacity drops."""
    return dataclasses.replace(
        cfg, mla=dataclasses.replace(cfg.mla, q_lora_rank=32),
        prefix=(attn_kind,),
        moe=dataclasses.replace(cfg.moe, capacity_factor=1.3))


def _configs(name, dtype="float32"):
    """(port config, reference config) of one name, in ``dtype``."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    rcfg = dataclasses.replace(ref_smoke(ARCH), dtype=dtype)
    if name == "variant":
        cfg, rcfg = _variant(cfg, ATTN), _variant(rcfg, REF_ATTN)
    return cfg, rcfg


@pytest.fixture(scope="module", params=["smoke", "variant"])
def setup(request):
    cfg, rcfg = _configs(request.param)
    ref_params = RM.init_params(jax.random.PRNGKey(2), rcfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    return cfg, rcfg, ref_params, params


def _np(x):
    return np.asarray(x).astype(np.float32)


def _err(t, j):
    a, b = t.float().numpy(), _np(j)
    assert a.shape == b.shape
    assert not np.isnan(a).any()
    return float(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# kernel 3: the plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------
def _mla_case(seed, b=3, h=4, lora=32, rope=16, npages=10, page=16,
              nslots=4, lens=(7, 16, 50)):
    rng = np.random.default_rng(seed)
    return dict(
        ql=rng.standard_normal((b, h, lora)).astype(np.float32),
        qr=rng.standard_normal((b, h, rope)).astype(np.float32),
        cp=rng.standard_normal((npages, page, lora)).astype(np.float32),
        kr=rng.standard_normal((npages, page, rope)).astype(np.float32),
        bt=rng.integers(0, npages, (b, nslots)).astype(np.int32),
        lens=np.asarray(lens, np.int32), scale=(lora + rope) ** -0.5)


def _run_mla(c, dtype, window):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    arrs = [c[k] for k in ("ql", "qr", "cp", "kr")]
    out = ops.mla_decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in arrs),
        torch.from_numpy(c["bt"]), torch.from_numpy(c["lens"]),
        scale=c["scale"], window=window)
    exp = jops.mla_decode_attention(
        *(jnp.asarray(a, jdt) for a in arrs), jnp.asarray(c["bt"]),
        c["lens"], scale=c["scale"], window=window)
    return out, exp


# mirrors tests/test_kernels.py:205
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 3, 16, 21])
def test_mla_decode_plain_matches_pallas(dtype, window):
    out, exp = _run_mla(_mla_case(41), dtype, window)
    assert out.dtype == getattr(torch, dtype)
    assert _err(out, exp) < (3e-2 if dtype == "bfloat16" else 2e-5)


def test_mla_decode_empty_slot_and_scratch_pages():
    """A lens = 0 slot gives 0; table slots past lens may point at a
    scratch page full of garbage that must never reach the softmax."""
    c = _mla_case(43, lens=(0, 21, 33), nslots=5)
    trash = c["cp"].shape[0] - 1
    c["cp"][trash], c["kr"][trash] = 1e4, -1e4
    c["bt"][0] = trash
    c["bt"][1, 2:] = trash                  # 21 tokens: slots 0..1 live
    c["bt"][2, 3:] = trash
    c["bt"][:, :3] %= trash                 # live slots on real pages
    out, exp = _run_mla(c, "float32", 0)
    assert float(out[0].abs().max()) == 0.0
    assert _err(out[1:], exp[1:]) < 2e-5
    clean = dict(c, bt=np.where(c["bt"] == trash, 0, c["bt"]))
    out_clean, _ = _run_mla(clean, "float32", 0)
    assert torch.equal(out[1:], out_clean[1:])


# ---------------------------------------------------------------------------
# routed MoE
# ---------------------------------------------------------------------------
def _moe_pair(n_shared, cf):
    cfg, rcfg = _configs("smoke")
    moe = dict(n_shared=n_shared, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    rcfg = dataclasses.replace(rcfg,
                               moe=dataclasses.replace(rcfg.moe, **moe))
    rp = RMLP.init_moe(jax.random.PRNGKey(5), rcfg, jnp.float32)
    p = {k: to_tensor(np.asarray(v), "cpu") for k, v in rp.items()}
    return cfg, rcfg, rp, p


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("cf,b,s,group", [
    (160.0, 2, 8, 2048),        # drop-free (the smoke config's factor)
    (1.3, 4, 16, 2048),         # capacity drops
    (1.3, 2, 7, 4),             # n = 14 not a multiple of g = 4: padding
])
def test_moe_forward_matches_reference(n_shared, cf, b, s, group):
    cfg, rcfg, rp, p = _moe_pair(n_shared, cf)
    x = np.random.default_rng(6).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    if cf < 2:
        # skew the routing towards expert 0 so that its queue overflows
        col = np.asarray(rp["router"])[:, 0]
        x += 4.0 * col / np.linalg.norm(col)
    out, aux = MLP.moe_forward(p, cfg, torch.from_numpy(x),
                               group_size=group)
    rout, raux = RMLP.moe_forward(rp, rcfg, jnp.asarray(x),
                                  group_size=group)
    assert _err(out, rout) < 1e-5
    assert abs(float(aux) - float(raux)) < 1e-6
    if cf < 2:
        # the case drops tokens: the drop-free result differs
        free, _ = MLP.moe_forward(p, cfg, torch.from_numpy(x),
                                  group_size=group, capacity_factor=160.0)
        assert float((free - out).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# MLA attention against one layer's latent pool
# ---------------------------------------------------------------------------
def _latent_pools(cfg, seed, npages):
    rng = np.random.default_rng(seed)
    m = cfg.mla
    return (rng.standard_normal((npages, PAGE, m.kv_lora_rank))
            .astype(np.float32),
            rng.standard_normal((npages, PAGE, m.qk_rope_head_dim))
            .astype(np.float32))


def test_mla_prefill_paged_matches_reference(setup):
    """Two packed segments (one continuing at q_offset 5, one fresh)
    plus a pad segment on the scratch page; the attention output and
    both pool halves against the reference."""
    cfg, rcfg, ref_params, params = setup
    rp, p = ref_params["body"][0]["attn"], params["layers"][-1]["attn"]
    rp = jax.tree.map(lambda a: a[-1], rp)
    npages, trash, sq = 12, 11, 8
    ckv, kr = _latent_pools(cfg, 7, npages)
    x = np.random.default_rng(8).standard_normal(
        (3, sq, cfg.d_model)).astype(np.float32)
    q_off = np.array([5, 0, 0], np.int32)
    n_tok = np.array([7, 8, 0], np.int32)
    kv_len = q_off + n_tok
    bt = np.full((3, 4), trash, np.int32)
    bt[0, :3], bt[1, :2] = [3, 1, 6], [2, 8]
    pos = q_off[:, None] + np.arange(sq)[None, :]
    pg = np.full((3, sq), trash, np.int32)
    off = (pos % PAGE).astype(np.int32)
    for i in range(2):
        pg[i, :n_tok[i]] = bt[i][pos[i, :n_tok[i]] // PAGE]
    ints = dict(positions=pos.astype(np.int32), q_offset=q_off,
                kv_len=kv_len, block_tables=bt, pages_idx=pg,
                offs_idx=off)
    rout, rckv, rkr = RA.mla_prefill_paged(
        rp, rcfg, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
        **{k: jnp.asarray(v) for k, v in ints.items()})
    t_ckv, t_kr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    out = A.mla_prefill_paged(
        p, cfg, torch.from_numpy(x), t_ckv, t_kr,
        **{k: torch.from_numpy(v) for k, v in ints.items()})
    assert _err(out[:2], rout[:2]) < 1e-4
    live = np.arange(npages) != trash
    assert _err(t_ckv[live], np.asarray(rckv)[live]) < 1e-5
    assert _err(t_kr[live], np.asarray(rkr)[live]) < 1e-5


def test_mla_decode_paged_matches_reference(setup):
    """A slot batch as the decode engine packs it: ragged lengths across
    pages, a dead slot (lens 0) writing to the scratch page."""
    cfg, rcfg, ref_params, params = setup
    rp, p = ref_params["body"][0]["attn"], params["layers"][-1]["attn"]
    rp = jax.tree.map(lambda a: a[-1], rp)
    npages, trash = 12, 11
    ckv, kr = _latent_pools(cfg, 9, npages)
    x = np.random.default_rng(10).standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([9, 0, 3, 14], np.int32)
    bt = np.full((4, 4), trash, np.int32)
    bt[0, :3], bt[2, :1], bt[3, :4] = [4, 0, 7], [5], [1, 2, 3, 6]
    lens = np.array([10, 0, 4, 15], np.int32)
    pages = np.where(lens > 0, bt[np.arange(4), pos // PAGE], trash)
    ints = dict(pos=pos, pages=pages.astype(np.int32),
                offs=(pos % PAGE).astype(np.int32), block_tables=bt,
                lens=lens)
    rout, rckv, rkr = RA.mla_decode_paged(
        rp, rcfg, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
        **{k: jnp.asarray(v) for k, v in ints.items()})
    t_ckv, t_kr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    out = A.mla_decode_paged(
        p, cfg, torch.from_numpy(x), t_ckv, t_kr,
        **{k: torch.from_numpy(v) for k, v in ints.items()})
    assert _err(out, rout) < 1e-4
    live = np.arange(npages) != trash
    assert _err(t_ckv[live], np.asarray(rckv)[live]) < 1e-5
    assert _err(t_kr[live], np.asarray(rkr)[live]) < 1e-5


# ---------------------------------------------------------------------------
# engines: prefill -> latent page handoff -> decode
# ---------------------------------------------------------------------------
def _drive(pe, de, reqs):
    """The engines' loop; returns (token streams, prefill payloads)."""
    for r in reqs:
        pe.submit(r)
    out, shipped, t = {}, {}, 0.0
    for _ in range(500):
        for pk in pe.step(t):
            shipped[pk.req.rid] = pk
            de.receive(pk, now=t)
        de.admit(t)
        for f in de.step(t):
            out[f.req.rid] = f.tokens
        t += 0.01
        if pe.idle() and de.idle():
            break
    return out, shipped


def test_engine_roundtrip_matches_reference_engines(setup):
    """Mirrors tests/test_paged_path.py:345 and :375: the port's paged
    engines against the JAX paged engines on the same weights — same
    first tokens and greedy streams, the same latent page payloads, the
    same wire bytes, and every page back on both sides."""
    cfg, rcfg, ref_params, params = setup
    reqs = generate("Mixed", 4, seed=32, max_prompt=24, max_decode=6,
                    vocab_size=cfg.vocab_size)
    rpe = RefPrefill("p0", rcfg, ref_params, chunk_size=8, backend="paged",
                     **KW)
    rde = RefDecode("d0", rcfg, ref_params, max_slots=4, backend="paged",
                    **KW)
    out_ref, ship_ref = _drive(rpe, rde, copy.deepcopy(reqs))
    pe = PrefillEngine("p0", cfg, params, chunk_size=8, device="cpu", **KW)
    de = DecodeEngine("d0", cfg, params, max_slots=4, device="cpu", **KW)
    port_reqs = [Request(rid=r.rid, prompt_len=r.prompt_len,
                         decode_len=r.decode_len, arrival=r.arrival,
                         prompt_tokens=r.prompt_tokens) for r in reqs]
    out, ship = _drive(pe, de, port_reqs)
    assert len(out) == len(out_ref) == 4
    assert out == out_ref
    m = cfg.mla
    for rid, pk in ship.items():
        rpk = ship_ref[rid]
        assert pk.first_token == rpk.first_token
        assert pk.pages_k.shape[-1] == m.kv_lora_rank
        assert pk.pages_v.shape[-1] == m.qk_rope_head_dim
        assert _err(pk.pages_k, rpk.pages_k) < 1e-5
        assert _err(pk.pages_v, rpk.pages_v) < 1e-5
    assert pe.fused_calls == rpe.fused_calls
    assert de.iterations == rde.iterations
    assert pe.network.bytes_sent == rpe.network.bytes_sent > 0
    assert pe.alloc.used_pages == de.alloc.used_pages == 0


def test_latent_wire_width():
    """Mirrors tests/test_paged_path.py:388: the wire carries the latent,
    n_layers x (kv_lora_rank + qk_rope_head_dim) scalars per token; 576
    per token per layer at full width."""
    cfg, _ = _configs("variant")
    m = cfg.mla
    spec = backend_for(cfg)
    assert spec.layout == "latent"
    assert spec.token_width == m.kv_lora_rank + m.qk_rope_head_dim
    assert kv_page_bytes(cfg, 16, 16, dtype_bytes=4) \
        == cfg.n_layers * spec.token_width * 16 * 4
    full = backend_for(get_config(ARCH))
    assert (full.token_width, full.page_token_bytes) == (576, 1152)
    pool = PagePool.create_latent(2, 3, PAGE, 8, 4, torch.float32, "cpu")
    pool.k[:, 1] = 1.0
    pool.v[:, 1] = 2.0
    pk, pv = pool.gather([1])
    pool.install([2], pk, pv).copy_pages([2], [0])
    assert float(pool.k[:, 0].min()) == 1.0 and float(pool.v[:, 0].min()) == 2.0


def test_from_reference_carries_mla_and_moe_leaves():
    """Every MLA and MoE leaf crosses over unchanged, in layer order, and
    the router stays f32 in a bf16 model."""
    cfg, rcfg = _configs("variant", dtype="bfloat16")
    rp = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(3),
                                                 rcfg))
    params = from_reference(rp, cfg, "cpu")
    ref_layers = list(rp["prefix"]) + [
        jax.tree.map(lambda a: a[r], rp["body"][0])
        for r in range(cfg.n_repeats)]
    assert len(params["layers"]) == len(ref_layers) == cfg.n_layers
    assert "mlp" in params["layers"][0] and "moe" in params["layers"][1]
    assert set(params["layers"][0]["attn"]) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    for layer, ref_layer in zip(params["layers"], ref_layers):
        flat = jax.tree_util.tree_flatten_with_path(ref_layer)[0]
        for path, leaf in flat:
            t = layer
            for key in path:
                t = t[key.key]
            assert t.dtype == (torch.float32 if leaf.dtype == np.float32
                               else torch.bfloat16)
            assert np.array_equal(t.float().numpy(),
                                  np.asarray(leaf).astype(np.float32))
    assert params["layers"][1]["moe"]["router"].dtype == torch.float32
    assert params["layers"][1]["moe"]["wi"].dtype == torch.bfloat16
