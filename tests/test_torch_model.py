"""The port's paged model path against the JAX package's, on the same
weights (``from_reference`` of the JAX ``init_params``), the same
tables and the same pools: fused chunk prefill (logits, first tokens,
pool contents) and slot-batch decode (logits, tokens, pool contents).

Both run on the CPU in f32: the JAX side with its Pallas kernels in
interpret mode, the port with its kernels' plain versions.  Logits
agree within 1e-4 (float summation order over d_model-wide products),
tokens exactly, pools within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.kvcache.paged import PagePool as RefPool  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kvcache.paged import PagePool  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402
from repro_torch.params import from_reference, to_tensor  # noqa: E402

PAGE = 4
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5


def _configs():
    smoke = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                                dtype="float32")
    # the full config's GQA ratio (14 heads over 2 KV heads) at small size
    gqa7 = dataclasses.replace(
        reduced(get_config("qwen2_0_5b"), layers=2, d_model=448, n_heads=14,
                n_kv_heads=2), dtype="float32")
    return {"smoke": smoke, "gqa7": gqa7}


@pytest.fixture(scope="module", params=["smoke", "gqa7"])
def setup(request):
    cfg = _configs()[request.param]
    ref_params = RM.init_params(jax.random.PRNGKey(0), cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    return cfg, ref_params, params


def _pools(cfg, n_pages):
    kvh, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    return (RefPool.create(L, n_pages, PAGE, kvh, hd, jnp.float32),
            PagePool.create(L, n_pages, PAGE, kvh, hd, torch.float32,
                            device="cpu"))


def _pools_close(ref_pool, pool):
    assert np.abs(np.asarray(ref_pool.k) - pool.k.numpy()).max() < POOL_TOL
    assert np.abs(np.asarray(ref_pool.v) - pool.v.numpy()).max() < POOL_TOL


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _prefill_both(cfg, ref_params, params, ref_pool, pool, args):
    """args: numpy (tokens, q_offset, kv_len, last, bt, pg, off)."""
    nxt_r, lg_r, kp, vp = RM.prefill_paged(
        ref_params, cfg, *(jnp.asarray(a) for a in args), ref_pool.k,
        ref_pool.v)
    nxt, lg = M.prefill_paged(params, cfg, *(_t(a) for a in args), pool.k,
                              pool.v)
    return RefPool(k=kp, v=vp), (nxt_r, lg_r), (nxt, lg)


def _chunk_args(segments, sq, n_slots, trash, ns=0):
    """segments: list of (tokens, q_offset, table) -> packed arrays, with
    pad segments up to ``ns`` as the engine packs them (kv_len 0, every
    slot on the scratch page)."""
    ns = ns or len(segments)
    toks = np.zeros((ns, sq), np.int32)
    qoff = np.zeros(ns, np.int32)
    kvlen = np.zeros(ns, np.int32)
    last = np.zeros(ns, np.int32)
    bt = np.full((ns, n_slots), trash, np.int32)
    pg = np.full((ns, sq), trash, np.int32)
    off = np.tile(np.arange(sq, dtype=np.int32) % PAGE, (ns, 1))
    for i, (tk, q0, table) in enumerate(segments):
        n = len(tk)
        toks[i, :n] = tk
        qoff[i], kvlen[i], last[i] = q0, q0 + n, n - 1
        bt[i, :len(table)] = table
        pos = q0 + np.arange(n)
        pg[i, :n] = np.asarray(table)[pos // PAGE]
        off[i, :n] = pos % PAGE
    return toks, qoff, kvlen, last, bt, pg, off


def test_fused_chunk_prefill_matches_reference(setup):
    """Mirrors tests/test_paged_path.py:48 at the model level: two fused
    multi-segment chunks — the second holds a request's second segment
    (q_offset > 0, attending its first chunk's pages), a fresh request,
    and a pow2 pad segment — give the reference's logits, first tokens
    and pool contents."""
    cfg, ref_params, params = setup
    rng = np.random.default_rng(1)
    trash = 15
    ref_pool, pool = _pools(cfg, trash + 1)
    a = rng.integers(0, cfg.vocab_size, 14).astype(np.int32)
    b = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    c = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    ta, tb, tc = [0, 1, 2, 3], [4, 5], [6, 7]
    chunks = [
        [(a[:9], 0, ta), (b[:3], 0, tb)],                    # 12 tokens
        [(a[9:], 9, ta), (b[3:], 3, tb), (c, 0, tc)],        # + pad seg
    ]
    for segs in chunks:
        args = _chunk_args(segs, 16, 8, trash, ns=1 << (len(segs) - 1)
                           .bit_length())
        ref_pool, (nxt_r, lg_r), (nxt, lg) = _prefill_both(
            cfg, ref_params, params, ref_pool, pool, args)
        n = len(segs)
        assert nxt.tolist()[:n] == np.asarray(nxt_r).tolist()[:n]
        assert np.abs(lg.numpy()[:n] - np.asarray(lg_r)[:n]).max() \
            < LOGIT_TOL
    # the scratch page takes pad writes in an unspecified order: compare
    # the pages the tables own
    ref_pool = RefPool(k=ref_pool.k[:, :trash], v=ref_pool.v[:, :trash])
    _pools_close(ref_pool, PagePool(k=pool.k[:, :trash],
                                    v=pool.v[:, :trash]))


def _ref_decode_logits(cfg, params, toks, pos, pages, offs, bt, lens, kp,
                       vp):
    """The reference's decode_step_paged up to its logits (it returns
    only the argmax), through the same internals it runs."""
    h = RM._embed(params, cfg, toks, pos[:, None])

    def attn(p, x, k_layer, v_layer):
        return RA.gqa_decode_paged(p, cfg, x, k_layer, v_layer, pos=pos,
                                   pages=pages, offs=offs, block_tables=bt,
                                   lens=lens)
    h, _, _ = RM._run_layers_paged(params, cfg, h, kp, vp, attn)
    return RM._head(params, cfg, h)[:, -1]


def test_paged_decode_matches_reference_over_ragged_multipage(setup):
    """Mirrors tests/test_paged_path.py:80: slots of 3, 2 and 1 pages
    (ragged lengths), one empty slot on the scratch page, tables growing
    page-at-a-time over 4 decode iterations: same logits, tokens and
    pool contents as the reference."""
    cfg, ref_params, params = setup
    rng = np.random.default_rng(3)
    trash = 16
    ref_pool, pool = _pools(cfg, trash + 1)
    lens = [11, 6, 1]
    tables = {0: [0, 1, 2], 1: [3, 4], 2: [5]}
    first = []
    for i, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        args = _chunk_args([(toks, 0, tables[i])], 1 << max(0, n - 1)
                           .bit_length(), 8, trash)
        ref_pool, (nxt_r, _), (nxt, _) = _prefill_both(
            cfg, ref_params, params, ref_pool, pool, args)
        assert int(nxt[0]) == int(nxt_r[0])
        first.append(int(nxt[0]))
    slots = 4                                    # slot 3 stays empty
    last, cur, free_page = list(first) + [0], list(lens), 6
    for _ in range(4):
        pos = np.zeros(slots, np.int32)
        pos[:3] = cur
        pages = np.full(slots, trash, np.int32)
        bt = np.full((slots, 8), trash, np.int32)
        for i in range(3):
            tab = tables[i]
            if cur[i] >= len(tab) * PAGE:        # grow page-at-a-time
                tab.append(free_page)
                free_page += 1
            pages[i] = tab[cur[i] // PAGE]
            bt[i, :len(tab)] = tab
        offs = pos % PAGE
        lens_now = np.where(np.arange(slots) < 3, pos + 1, 0).astype(
            np.int32)
        toks = np.asarray(last, np.int32)[:, None]
        args = (toks, pos, pages, offs, bt, lens_now)
        jargs = [jnp.asarray(a) for a in args]
        lg_r = _ref_decode_logits(cfg, ref_params, *jargs, ref_pool.k,
                                  ref_pool.v)
        nxt_r, kp, vp = RM.decode_step_paged(ref_params, cfg, *jargs,
                                             ref_pool.k, ref_pool.v)
        ref_pool = RefPool(k=kp, v=vp)
        targs = [_t(a) for a in args]
        lg = M.decode_logits_paged(params, cfg, *targs,
                                   pool.k.clone(), pool.v.clone())
        nxt = M.decode_step_paged(params, cfg, *targs, pool.k, pool.v)
        assert nxt.tolist()[:3] == np.asarray(nxt_r).tolist()[:3]
        assert np.abs(lg.numpy()[:3] - np.asarray(lg_r)[:3]).max() \
            < LOGIT_TOL
        last = nxt.tolist()[:3] + [0]
        cur = [c + 1 for c in cur]
    owned = slice(0, free_page)
    _pools_close(RefPool(k=ref_pool.k[:, owned], v=ref_pool.v[:, owned]),
                 PagePool(k=pool.k[:, owned], v=pool.v[:, owned]))


def test_from_reference_unstacks_the_scanned_body(setup):
    cfg, ref_params, params = setup
    assert len(params["layers"]) == cfg.n_layers
    for layer in range(cfg.n_layers):
        wq = np.asarray(ref_params["body"][0]["attn"]["wq"][layer])
        assert np.array_equal(params["layers"][layer]["attn"]["wq"].numpy(),
                              wq)
    assert params["embed"].dtype == torch.float32


def test_from_reference_keeps_bfloat16_bits():
    """ml_dtypes bfloat16 arrays cross through an int16 view: every bit
    survives, and the tensors come out as torch.bfloat16."""
    cfg = ref_smoke("qwen2_0_5b")
    assert cfg.dtype == "bfloat16"
    ref_params = RM.init_params(jax.random.PRNGKey(2), cfg)
    tree = jax.tree.map(np.asarray, ref_params)
    params = from_reference(tree, get_smoke_config("qwen2_0_5b"), "cpu")
    emb = params["embed"]
    assert emb.dtype == torch.bfloat16
    assert np.array_equal(emb.float().numpy(),
                          tree["embed"].astype(np.float32))
    wi = params["layers"][1]["mlp"]["wi"]
    assert np.array_equal(wi.float().numpy(),
                          tree["body"][0]["mlp"]["wi"][1].astype(np.float32))
    assert to_tensor(np.arange(3, dtype=np.int32), "cpu").dtype == \
        torch.int32


def test_init_params_matches_reference_layout_and_law(setup):
    """The port's own init draws the reference's law: same shapes and
    dtypes as the bridged reference weights, ones for norms, zeros for
    biases, normal weights at the reference's scales."""
    cfg, _, bridged = setup
    own = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert own.keys() == bridged.keys()
    for a, b in zip(own["layers"], bridged["layers"]):
        for key in ("norm1", "norm2"):
            assert torch.equal(a[key], torch.ones_like(a[key]))
        for name, t in a["attn"].items():
            assert t.shape == b["attn"][name].shape
            if name.startswith("b"):
                assert float(t.abs().max()) == 0.0
        for name, t in a["mlp"].items():
            assert t.shape == b["mlp"][name].shape
    d = cfg.d_model
    assert abs(float(own["embed"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    wo = own["layers"][0]["mlp"]["wo"]
    assert abs(float(wo.std()) - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
