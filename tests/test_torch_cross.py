"""The port's cross-attention paged path (Llama-3.2-Vision, Whisper)
against the JAX package's.

Inputs come from numpy with a seed, weights from the JAX ``init_params``
through ``from_reference``; both sides run on the CPU, the JAX side
with its Pallas kernels in interpret mode, the port with its kernels'
plain versions.  Tolerances:

* kernel 4 (paged cross decode) and kernel 1's non-causal read: 2e-5 in
  f32 (summation order), 2e-2 in bf16 (one bf16 rounding of outputs of
  magnitude ~1), as tests/test_paged_cross.py states for the Pallas
  kernels;
* encoder output and model logits: ``LOGIT_TOL`` 1e-4 (f32 matmuls over
  a few layers); pool contents ``POOL_TOL`` 1e-5 (K/V projections);
* engines: token streams identical, payloads within ``POOL_TOL``, the
  same wire bytes and counters.

Configs: the smoke configs of both archs in f32 and an ``n_ctx=13``
variant of each, whose last cross page (page size 4) is partly filled.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_full  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.decode_engine import DecodeEngine as RefDecode  # noqa: E402
from repro.core.prefill_engine import PrefillEngine as RefPrefill  # noqa: E402,E501
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.runtime.workload import generate  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.backend import backend_for  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.kv_transfer import kv_page_bytes  # noqa: E402
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kvcache.paged import OutOfPages, PagedAllocator  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.frontends import fake_frontend, frontend_shape  # noqa: E402,E501
from repro_torch.params import from_reference  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402

PAGE = 4
KW = dict(max_seq=64, page_size=PAGE, n_pages=128)
F32_TOL = 2e-5
BF16_TOL = 2e-2
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
ARCHS = {"whisper": "whisper_tiny", "vlm": "llama_3_2_vision_11b"}


def _with_ctx(cfg, n_ctx):
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, n_ctx=n_ctx))


def _configs(name):
    """(port config, reference config) in f32: ``<arch>`` or
    ``<arch>-ctx13`` (13 encoder tokens: the last cross page holds 1 of
    its 4)."""
    arch, _, variant = name.partition("-")
    cfg = dataclasses.replace(get_smoke_config(ARCHS[arch]),
                              dtype="float32")
    rcfg = dataclasses.replace(ref_smoke(ARCHS[arch]), dtype="float32")
    if variant:
        cfg, rcfg = _with_ctx(cfg, 13), _with_ctx(rcfg, 13)
    return cfg, rcfg


@pytest.fixture(scope="module",
                params=["whisper", "vlm", "whisper-ctx13", "vlm-ctx13"])
def setup(request):
    cfg, rcfg = _configs(request.param)
    ref_params = RM.init_params(jax.random.PRNGKey(3), rcfg)
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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# kernel 4: the plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------
def _cross_case(seed, b=2, h=4, kvh=2, hd=32, npages=12, page=16,
                nslots=4, lens=(1, 3)):
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((b, h, hd)).astype(np.float32),
                kp=rng.standard_normal((npages, page, kvh, hd))
                .astype(np.float32),
                vp=rng.standard_normal((npages, page, kvh, hd))
                .astype(np.float32),
                bt=rng.integers(0, npages, (b, nslots)).astype(np.int32),
                lens=np.asarray(lens, np.int32))


def _run_cross(c, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    arrs = [c[k] for k in ("q", "kp", "vp")]
    out = ops.cross_decode_attention(
        *(_t(a).to(tdt) for a in arrs), _t(c["bt"]), _t(c["lens"]))
    exp = jops.cross_decode_attention(
        *(jnp.asarray(a, jdt) for a in arrs), jnp.asarray(c["bt"]),
        c["lens"])
    return out, exp


# mirrors tests/test_paged_cross.py:62: encoder lengths straddling page
# boundaries (sub-page, one page, one past, mid-table, the full table)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("enc_lens", [(1, 3), (4, 5), (16, 31), (64, 64)])
def test_cross_decode_plain_matches_pallas(dtype, enc_lens):
    out, exp = _run_cross(_cross_case(17, lens=enc_lens), dtype)
    assert out.dtype == getattr(torch, dtype)
    assert _err(out, exp) < (BF16_TOL if dtype == "bfloat16" else F32_TOL)


def test_cross_decode_empty_slot_and_pad_slots():
    """Mirrors tests/test_paged_cross.py:81: table slots past enc_len may
    point at a scratch page of garbage that never reaches the softmax;
    an empty slot (enc_len 0, its row all scratch) gives 0, as the
    Pallas kernel does (the oracle would give mean(V))."""
    c = _cross_case(19, b=3, npages=8, nslots=3, lens=(0, 16, 17))
    trash = 7
    c["kp"][trash], c["vp"][trash] = 1e4, -1e4
    # slot 1 has exactly one page of encoder tokens, slot 2 one past it
    c["bt"] = np.array([[trash] * 3, [0, trash, trash], [1, 2, trash]],
                       np.int32)
    out, exp = _run_cross(c, "float32")
    assert float(out[0].abs().max()) == 0.0
    assert _err(out, exp) < F32_TOL         # Pallas gives 0 there too
    clean = dict(c, bt=np.where(c["bt"] == trash, 0, c["bt"]))
    out_clean, _ = _run_cross(clean, "float32")
    assert torch.equal(out[1:], out_clean[1:])


# mirrors tests/test_paged_cross.py:97: the cross read of a prefill
# chunk is kernel 1 with causal=False, q_offset 0, kv_len = enc_len
@pytest.mark.parametrize("enc_len", [3, 16, 17, 48])
def test_cross_prefill_read_plain_matches_pallas(enc_len):
    rng = np.random.default_rng(8)
    b, sq, h, kvh, hd, npages, page, nslots = 3, 16, 4, 2, 32, 12, 16, 3
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    kp = rng.standard_normal((npages, page, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, kvh, hd)).astype(np.float32)
    bt = rng.integers(0, npages, (b, nslots)).astype(np.int32)
    lens = np.asarray([enc_len, max(1, enc_len - 2), 0], np.int32)
    zero = np.zeros_like(lens)
    out = ops.prefill_attention(_t(q), _t(kp), _t(vp), _t(lens), _t(zero),
                                block_table=_t(bt), causal=False)
    exp = jops.prefill_attention(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), lens, zero,
                                 block_table=bt, causal=False)
    assert _err(out, exp) < F32_TOL
    assert float(out[2].abs().max()) == 0.0     # a pad segment gives 0


# ---------------------------------------------------------------------------
# configs, frontend, weights, backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_configs_copy_the_reference(arch):
    for port, ref in ((get_config(arch), ref_full(arch)),
                      (get_smoke_config(arch), ref_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    spec = backend_for(get_config(arch))
    cfg = get_config(arch)
    assert (spec.layout, spec.cross) == ("gqa", "pages")
    assert spec.cross_ctx == cfg.encoder.n_ctx
    assert spec.n_cross_layers == cfg.n_cross_layers


def test_full_cross_layout_and_wire_bytes():
    """Llama-3.2-Vision: cross sublayers on layers 3, 8, ..., 38; each
    request ships 8 cross layers x 1600 tokens x 4096 B (52.4 MB) of
    encoder K/V.  Whisper: 4 x 1500 tokens, rounded up to 94 whole pages
    of 16, x 1536 B."""
    vlm, wh = get_config("llama_3_2_vision_11b"), get_config("whisper_tiny")
    assert [i for i, k in enumerate(vlm.layer_kinds)
            if k == "cross_attn"] == list(range(3, 40, 5))
    assert vlm.cross_kv_bytes_per_token() == 8 * 4096
    assert (kv_page_bytes(vlm, 1, 16, enc_len=1600)
            - kv_page_bytes(vlm, 1, 16) == 8 * 1600 * 4096 == 52_428_800)
    assert (kv_page_bytes(wh, 1, 16, enc_len=1500)
            - kv_page_bytes(wh, 1, 16) == 4 * 94 * 16 * 1536)


def test_fake_frontend():
    cfg = get_smoke_config("whisper_tiny")
    gen = torch.Generator().manual_seed(0)
    x = fake_frontend(cfg, 3, gen, "cpu")
    assert tuple(x.shape) == frontend_shape(cfg, 3) == (3, 16, 128)
    assert x.dtype == torch.bfloat16
    assert 0.01 < float(x.float().std()) < 0.03
    again = fake_frontend(cfg, 3, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(x, again)
    assert fake_frontend(get_smoke_config("qwen2_0_5b"), 3, gen,
                         "cpu") is None


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
def test_from_reference_carries_encoder_and_cross_leaves(arch):
    """Every encoder and cross leaf crosses over unchanged, in bf16: the
    cross sublayer of Llama's pattern index 3 in each of two repeats
    (absolute layers 3 and 8), Whisper's encoder blocks and norm.  The
    full configs' layer kinds at small widths."""
    small = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
                 vocab_size=64, n_layers=10 if "llama" in arch else 2)
    cfg, rcfg = (dataclasses.replace(c, **small)
                 for c in (get_config(arch), ref_full(arch)))
    if cfg.encoder.n_layers:
        cfg, rcfg = (dataclasses.replace(
            c, encoder=dataclasses.replace(c.encoder, n_layers=2))
            for c in (cfg, rcfg))
    rp = jax.tree.map(np.asarray,
                      RM.init_params(jax.random.PRNGKey(5), rcfg))
    params = from_reference(rp, cfg, "cpu")
    kinds = cfg.layer_kinds
    for i, (layer, kind) in enumerate(zip(params["layers"], kinds)):
        j, r = i % len(cfg.pattern), i // len(cfg.pattern)
        assert ("cross" in layer) == (kind == "cross_attn")
        if "cross" in layer:
            ref_layer = rp["body"][j]
            for k in ("wq", "wk", "wv", "wo"):
                t = layer["cross"][k]
                assert t.dtype == torch.bfloat16
                assert np.array_equal(t.float().numpy(), _np(
                    ref_layer["cross"][k][r]))
            assert np.array_equal(layer["norm_c"].float().numpy(),
                                  _np(ref_layer["norm_c"][r]))
    enc = params.get("encoder")
    assert (enc is not None) == cfg.is_encoder_decoder
    if enc is not None:
        assert len(enc["blocks"]) == cfg.encoder.n_layers
        assert np.array_equal(enc["blocks"][1]["mlp"]["wi"].float()
                              .numpy(),
                              _np(rp["encoder"]["blocks"][1]["mlp"]
                                  ["wi"]))
        assert np.array_equal(enc["norm"].float().numpy(),
                              _np(rp["encoder"]["norm"]))


# ---------------------------------------------------------------------------
# model: encoder, fused prefill with the one-shot scatter, read-only chunk,
# decode with cross tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["whisper", "whisper-ctx13"])
def test_encoder_forward_matches_reference(name):
    """Whisper's bidirectional encoder (Llama-3.2-Vision has none: its
    patch embeddings feed the cross layers as they are)."""
    cfg, rcfg = _configs(name)
    ref_params = RM.init_params(jax.random.PRNGKey(3), rcfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    enc = np.random.default_rng(4).standard_normal(
        (2, cfg.cross_ctx, cfg.d_model)).astype(np.float32)
    out = M.encoder_forward(params, cfg, _t(enc))
    exp = jax.jit(RM.encoder_forward, static_argnums=1)(
        ref_params, rcfg, jnp.asarray(enc))
    assert _err(out, exp) < LOGIT_TOL


def test_encoder_runs_in_f32_on_a_bf16_model():
    """The reference promotes the f32 embeddings against bf16 weights to
    f32: the encoder and the cross K/V run in f32 and only the scatter
    casts to the pool's bf16."""
    cfg = get_smoke_config("whisper_tiny")
    rcfg = ref_smoke("whisper_tiny")
    ref_params = RM.init_params(jax.random.PRNGKey(6), rcfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    enc = np.random.default_rng(5).standard_normal(
        (1, cfg.cross_ctx, cfg.d_model)).astype(np.float32)
    out = M.encoder_forward(params, cfg, _t(enc))
    exp = jax.jit(RM.encoder_forward, static_argnums=1)(
        ref_params, rcfg, jnp.asarray(enc))
    assert out.dtype == torch.float32 and exp.dtype == jnp.float32
    assert _err(out, exp) < 1e-3
    p, rp = params["layers"][0]["cross"], ref_params["body"][0]["cross"]
    ck, _ = A.cross_kv(p, cfg, out)
    rck, _ = RA.cross_kv(jax.tree.map(lambda a: a[0], rp), rcfg, exp)
    assert ck.dtype == torch.float32 and rck.dtype == jnp.float32
    assert _err(ck, rck) < 1e-2


def test_promoted_weights_are_copied_once():
    """The f32 copy of a bf16 weight is made on the first call and reused
    after; a weight changed in place gets a new copy; a weight already of
    the promoted type is not copied."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((8, 4), generator=g).to(torch.bfloat16)
    w32 = torch.randn((8, 4), generator=g)
    first = A.promoted({"w": w, "w32": w32}, torch.float32)
    again = A.promoted({"w": w, "w32": w32}, torch.float32)
    assert first["w"].dtype == torch.float32 and again["w"] is first["w"]
    assert torch.equal(first["w"], w.float()) and again["w32"] is w32
    assert A.promoted({"w": w}, torch.bfloat16)["w"] is w
    w.mul_(2)
    fresh = A.promoted({"w": w}, torch.float32)["w"]
    assert fresh is not first["w"] and torch.equal(fresh, w.float())


def _pools(cfg, seed, npages):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, npages, PAGE, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _chunk(cfg, trash):
    """A chunk as the prefill engine packs it: segment 0 a request's
    first (q_offset 0, its cross pages scattered now), segment 1 a later
    segment of another request (q_offset 6, its cross pages already
    written, its scatter on the scratch page), segment 2 a pad (kv_len 0,
    cross_len 0, everything on the scratch page)."""
    ec, sq, cs = cfg.cross_ctx, 8, -(-cfg.cross_ctx // PAGE)
    rng = np.random.default_rng(11)
    toks = rng.integers(1, cfg.vocab_size, (3, sq)).astype(np.int32)
    toks[2] = 0
    q_off = np.array([0, 6, 0], np.int32)
    n_tok = np.array([7, 8, 0], np.int32)
    bt = np.full((3, 5), trash, np.int32)
    bt[0, :2], bt[1, :4] = [3, 1], [0, 6, 2, 7]
    pos = q_off[:, None] + np.arange(sq)[None, :]
    pg = np.full((3, sq), trash, np.int32)
    for i in range(2):
        pg[i, :n_tok[i]] = bt[i][pos[i, :n_tok[i]] // PAGE]
    cbt = np.full((3, cs), trash, np.int32)
    cbt[0] = 8 + np.arange(cs)
    cbt[1] = 8 + cs + np.arange(cs)
    cpg = np.full((3, ec), trash, np.int32)
    cpg[0] = cbt[0][np.arange(ec) // PAGE]
    enc = np.zeros((3, ec, cfg.d_model), np.float32)
    enc[0] = rng.standard_normal((ec, cfg.d_model))
    return dict(tokens=toks, q_offset=q_off, kv_len=q_off + n_tok,
                last_idx=np.maximum(n_tok - 1, 0).astype(np.int32),
                block_tables=bt, pages_idx=pg,
                offs_idx=(pos % PAGE).astype(np.int32)), dict(
                    enc_embeds=enc, cross_bt=cbt,
                    cross_len=np.array([ec, ec, 0], np.int32),
                    cross_pg=cpg,
                    cross_off=np.tile(np.arange(ec, dtype=np.int32) % PAGE,
                                      (3, 1)))


def _both_prefill(cfg, rcfg, ref_params, params, kp, vp, ints, cross):
    """One fused prefill chunk on both sides from the same pools; the
    port's pools are updated in place.  Returns (port tokens, logits,
    pools), (reference tokens, logits, pools)."""
    names = ("tokens", "q_offset", "kv_len", "last_idx", "block_tables",
             "pages_idx", "offs_idx")
    j_args = [jnp.asarray(ints[k]) for k in names]
    t_args = [_t(ints[k]) for k in names]
    jc = {k: jnp.asarray(v) for k, v in cross.items()}
    tc = {k: _t(v) for k, v in cross.items()}
    rtok, rlg, rkp, rvp = jax.jit(RM.prefill_paged, static_argnums=1)(
        ref_params, rcfg, *j_args, jnp.asarray(kp), jnp.asarray(vp), **jc)
    tkp, tvp = _t(kp.copy()), _t(vp.copy())
    tok, lg = M.prefill_paged(params, cfg, *t_args, tkp, tvp, **tc)
    return (tok, lg, tkp, tvp), (rtok, rlg, rkp, rvp)


def _check_prefill(port, ref, trash, rows):
    (tok, lg, tkp, tvp), (rtok, rlg, rkp, rvp) = port, ref
    assert _err(lg[rows], rlg[rows]) < LOGIT_TOL
    assert np.array_equal(tok[rows].numpy(), np.asarray(rtok)[rows])
    live = np.arange(tkp.shape[1]) != trash
    assert _err(tkp[:, live], _np(rkp)[:, live]) < POOL_TOL
    assert _err(tvp[:, live], _np(rvp)[:, live]) < POOL_TOL


def test_prefill_paged_scatter_and_read_only_chunk(setup):
    """A chunk with encoder work (one segment scatters its cross pages
    once, one reads pages written earlier, one pad), then a read-only
    chunk (no encoder, no scatter): logits, next tokens, and the self and
    cross pool contents against the reference."""
    cfg, rcfg, ref_params, params = setup
    cs = -(-cfg.cross_ctx // PAGE)
    npages = 8 + 2 * cs + 1
    trash = npages - 1
    kp, vp = _pools(cfg, 7, npages)
    ints, cross = _chunk(cfg, trash)
    port, ref = _both_prefill(cfg, rcfg, ref_params, params, kp, vp, ints,
                              cross)
    _check_prefill(port, ref, trash, slice(0, 2))
    # the scatter wrote segment 0's cross pages in the cross layers only
    cross_layers = [i for i, k in enumerate(cfg.layer_kinds)
                    if k == "cross_attn"]
    seg0 = cross["cross_bt"][0]
    for layer in range(cfg.n_layers):
        moved = not np.array_equal(port[2].numpy()[layer, seg0],
                                   kp[layer, seg0])
        assert moved == (layer in cross_layers)
    # the next chunk: both requests continue (segment 0 with 1 token at
    # position 7, segment 1 with 2 at 14), and the chunk only reads
    kp2, vp2 = (np.asarray(a, np.float32) for a in ref[2:])
    bt = ints["block_tables"]
    ints2 = dict(ints, q_offset=np.array([7, 14, 0], np.int32),
                 kv_len=np.array([8, 16, 0], np.int32),
                 last_idx=np.array([0, 1, 0], np.int32))
    pos = ints2["q_offset"][:, None] + np.arange(8)[None, :]
    ints2["pages_idx"] = np.full((3, 8), trash, np.int32)
    ints2["pages_idx"][0, 0] = bt[0][1]
    ints2["pages_idx"][1, :2] = bt[1][3]
    ints2["offs_idx"] = (pos % PAGE).astype(np.int32)
    ro = {k: cross[k] for k in ("cross_bt", "cross_len")}
    port2, ref2 = _both_prefill(cfg, rcfg, ref_params, params, kp2, vp2,
                                ints2, ro)
    _check_prefill(port2, ref2, trash, slice(0, 2))
    # read-only: no page moved but those of the chunk's new tokens
    touched = np.zeros(npages, bool)
    touched[[bt[0][1], bt[1][3], trash]] = True
    assert np.array_equal(port2[2][:, ~touched].numpy(), kp2[:, ~touched])


def _ref_decode_logits(ref_params, rcfg, a, kp, vp):
    """The reference's ``decode_step_paged`` up to its logits."""
    h = RM._embed(ref_params, rcfg, a["tokens"], a["pos"][:, None])

    def attn(p, x, k_layer, v_layer):
        return RA.gqa_decode_paged(
            p, rcfg, x, k_layer, v_layer, pos=a["pos"], pages=a["pages"],
            offs=a["offs"], block_tables=a["block_tables"], lens=a["lens"])

    def cross(p, x, k_layer, v_layer):
        return RA.cross_decode_paged(p, rcfg, x, k_layer, v_layer,
                                     cross_bt=a["cross_bt"],
                                     cross_len=a["cross_len"])
    h, kp, vp = RM._run_layers_paged(ref_params, rcfg, h, kp, vp, attn,
                                     cross)
    return RM._head(ref_params, rcfg, h)[:, -1]


def test_decode_step_paged_with_cross_tables(setup):
    """A slot batch as the decode engine packs it: ragged self lengths,
    every live slot reading its cross pages, an empty slot (lens 0,
    cross_len 0) on the scratch page.  Logits, greedy tokens and pools
    against the reference."""
    cfg, rcfg, ref_params, params = setup
    cs = -(-cfg.cross_ctx // PAGE)
    npages = 8 + 3 * cs + 1
    trash = npages - 1
    kp, vp = _pools(cfg, 9, npages)
    x = np.random.default_rng(10)
    pos = np.array([9, 0, 3, 14], np.int32)
    bt = np.full((4, 4), trash, np.int32)
    bt[0, :3], bt[2, :1], bt[3, :4] = [4, 0, 7], [5], [1, 2, 3, 6]
    lens = np.array([10, 0, 4, 15], np.int32)
    cbt = np.full((4, cs), trash, np.int32)
    for s, k in ((0, 0), (2, 1), (3, 2)):
        cbt[s] = 8 + k * cs + np.arange(cs)
    a = dict(tokens=x.integers(1, cfg.vocab_size, (4, 1)).astype(np.int32),
             pos=pos, block_tables=bt, lens=lens,
             pages=np.where(lens > 0, bt[np.arange(4), pos // PAGE],
                            trash).astype(np.int32),
             offs=(pos % PAGE).astype(np.int32), cross_bt=cbt,
             cross_len=np.where(lens > 0, cfg.cross_ctx, 0)
             .astype(np.int32))
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ta = {k: _t(v) for k, v in a.items()}
    rlg = jax.jit(_ref_decode_logits, static_argnums=1)(
        ref_params, rcfg, ja, jnp.asarray(kp), jnp.asarray(vp))
    rtok, rkp, rvp = jax.jit(RM.decode_step_paged, static_argnums=1)(
        ref_params, rcfg, ja["tokens"], ja["pos"], ja["pages"], ja["offs"],
        ja["block_tables"], ja["lens"], jnp.asarray(kp), jnp.asarray(vp),
        ja["cross_bt"], ja["cross_len"])
    args = [ta[k] for k in ("tokens", "pos", "pages", "offs",
                            "block_tables", "lens")]
    lg = M.decode_logits_paged(params, cfg, *args, _t(kp.copy()),
                               _t(vp.copy()), ta["cross_bt"],
                               ta["cross_len"])
    tkp, tvp = _t(kp.copy()), _t(vp.copy())
    tok = M.decode_step_paged(params, cfg, *args, tkp, tvp, ta["cross_bt"],
                              ta["cross_len"])
    live = [0, 2, 3]
    assert _err(lg[live], rlg[np.asarray(live)]) < LOGIT_TOL
    assert np.array_equal(tok[live].numpy(), np.asarray(rtok)[live])
    keep = np.arange(npages) != trash
    assert _err(tkp[:, keep], _np(rkp)[:, keep]) < POOL_TOL
    assert _err(tvp[:, keep], _np(rvp)[:, keep]) < POOL_TOL


# ---------------------------------------------------------------------------
# engines: prefill -> cross + self page handoff -> decode
# ---------------------------------------------------------------------------
def _port_requests(reqs):
    return [Request(rid=r.rid, prompt_len=r.prompt_len,
                    decode_len=r.decode_len, arrival=r.arrival,
                    prompt_tokens=r.prompt_tokens,
                    enc_embeds=r.enc_embeds) for r in reqs]


def _drive(pe, de, reqs):
    """The engines' loop; returns (token streams, prefill payloads, most
    slots busy at once)."""
    for r in reqs:
        pe.submit(r)
    out, shipped, busy, t = {}, {}, 0, 0.0
    for _ in range(500):
        for pk in pe.step(t):
            shipped[pk.req.rid] = pk
            de.receive(pk, now=t)
        de.admit(t)
        busy = max(busy, len(de.slots))
        for f in de.step(t):
            out[f.req.rid] = f.tokens
        t += 0.01
        if pe.idle() and de.idle():
            break
    return out, shipped, busy


def test_engine_roundtrip_matches_reference_engines(setup):
    """Mirrors tests/test_paged_cross.py:168 and :294 against the
    reference's paged engines on the same weights: the same first tokens
    and greedy streams, the same self and cross payloads, one encoder
    call per chunk holding a first segment, the same wire bytes (the
    one-shot cross pages included), and every page, self and cross, back
    on both sides."""
    cfg, rcfg, ref_params, params = setup
    reqs = generate("Mixed", 4, seed=42, max_prompt=24, max_decode=6,
                    vocab_size=cfg.vocab_size, enc_ctx=cfg.cross_ctx,
                    enc_dim=cfg.d_model)
    rpe = RefPrefill("p0", rcfg, ref_params, chunk_size=8, **KW)
    rde = RefDecode("d0", rcfg, ref_params, max_slots=4, **KW)
    out_ref, ship_ref, _ = _drive(rpe, rde, copy.deepcopy(reqs))
    pe = PrefillEngine("p0", cfg, params, chunk_size=8, device="cpu", **KW)
    de = DecodeEngine("d0", cfg, params, max_slots=4, device="cpu", **KW)
    out, ship, _ = _drive(pe, de, _port_requests(reqs))
    assert len(out) == len(out_ref) == 4
    assert out == out_ref
    cs = -(-cfg.cross_ctx // PAGE)
    for rid, pk in ship.items():
        rpk = ship_ref[rid]
        assert pk.first_token == rpk.first_token
        assert pk.enc_len == rpk.enc_len == cfg.cross_ctx
        assert pk.cross_k.shape == (cfg.n_layers, cs, PAGE, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)
        for a, b in ((pk.pages_k, rpk.pages_k), (pk.pages_v, rpk.pages_v),
                     (pk.cross_k, rpk.cross_k), (pk.cross_v, rpk.cross_v)):
            assert _err(a, b) < POOL_TOL
    assert (pe.fused_calls, pe.encoder_calls) == (rpe.fused_calls,
                                                  rpe.encoder_calls)
    assert 0 < pe.encoder_calls < pe.fused_calls
    assert de.iterations == rde.iterations
    assert pe.network.bytes_sent == rpe.network.bytes_sent
    self_bytes = sum(kv_page_bytes(cfg, r.prompt_len, PAGE) for r in reqs)
    assert pe.network.bytes_sent - self_bytes == 4 * (
        cs * PAGE * cfg.cross_kv_bytes_per_token())
    assert pe.alloc.used_pages == de.alloc.used_pages == 0
    assert rpe.alloc.used_pages == rde.alloc.used_pages == 0


def test_decode_admission_counts_cross_pages():
    """Mirrors tests/test_paged_cross.py:280 on the decode engine: a pool
    with room for two requests' self pages but not for their cross pages
    too admits one request at a time; both still stream the reference's
    tokens and every page comes back."""
    cfg, rcfg = _configs("whisper")
    ref_params = RM.init_params(jax.random.PRNGKey(8), rcfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    reqs = generate("Mixed", 2, seed=3, max_prompt=6, max_decode=3,
                    vocab_size=cfg.vocab_size, enc_ctx=cfg.cross_ctx,
                    enc_dim=cfg.d_model)
    kw = dict(KW, n_pages=10)                # 4 cross pages a request
    rpe = RefPrefill("p0", rcfg, ref_params, chunk_size=8, **KW)
    rde = RefDecode("d0", rcfg, ref_params, max_slots=4, **kw)
    out_ref, _, busy_ref = _drive(rpe, rde, copy.deepcopy(reqs))
    pe = PrefillEngine("p0", cfg, params, chunk_size=8, device="cpu", **KW)
    de = DecodeEngine("d0", cfg, params, max_slots=4, device="cpu", **kw)
    out, _, busy = _drive(pe, de, _port_requests(reqs))
    assert out == out_ref and len(out) == 2
    assert busy == busy_ref == 1
    assert de.alloc.used_pages == 0


def test_cross_pages_freed_exactly_once():
    """Mirrors tests/test_paged_cross.py:259 and :280 on the port's
    allocator: the cross table is disjoint from the self pages and never
    grows; free returns every page once; admission reserves the cross
    pages."""
    a = PagedAllocator(n_pages=16, page_size=4, cross_tokens=10)
    assert a.cross_pages_per_request == 3
    a.alloc("r", 8)
    assert a.used_pages == 5
    ctab = a.cross_table("r")
    assert len(set(ctab) | set(a.live_pages("r"))) == 5
    for _ in range(5):
        a.append_token("r")
    assert a.cross_table("r") == ctab
    a.free("r")
    assert a.free_pages == 16
    with pytest.raises(KeyError):
        a.free("r")
    b = PagedAllocator(n_pages=4, page_size=4, cross_tokens=12)
    assert not b.can_admit(8) and b.can_admit(4)
    with pytest.raises(OutOfPages):
        b.alloc("r", 8)
    assert b.used_pages == 0
