"""On-device sampling in the port (``model.sample_tokens`` and the decode
engine's sampled dispatch).

Sampled lanes cannot match the reference's JAX PRNG bit for bit, so
they are held by properties: greedy lanes exactly argmax in a mixed
batch, draws a function of (request seed, step) only, the same stream
in any slot or batch, the hash equal bit for bit to a numpy version of
itself, and the frequencies of many draws close to the softmax of the
tempered, top-k masked logits.  Greedy requests are also held
token-identical to the reference's Cluster.  f32, on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.decode_engine import _step_seed
from repro_torch.models import model as M
from repro_torch.models.model import draw_bits, hash32, sample_tokens
from repro_torch.runtime.request import Request
from repro_torch.serving import Cluster, SamplingParams

N_DRAWS = 20_000
# total variation between the frequencies of N_DRAWS draws and the
# distribution: its mean is about sum_i sqrt(p_i (1 - p_i) / (2 pi N)),
# at most 0.011 for the 16 outcomes below; 0.03 is ~3x that
TV_BOUND = 0.03


def _logits(rows=4, vocab=64, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(rows, vocab)
                            .astype(np.float32))


def test_sample_tokens_greedy_lanes_exact():
    """Mirrors tests/test_async_runtime.py:252: temperature-0 lanes of a
    mixed batch are exactly argmax, the draws are deterministic per
    seed, and top-k 1 gives argmax at any temperature.  The greedy lanes
    equal the reference's ``sample_tokens`` too."""
    logits = _logits()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temps = torch.tensor([0.0, 0.9, 0.0, 1.3])
    tks = torch.tensor([0, 8, 0, 0], dtype=torch.int32)
    seeds = torch.tensor([0, 123, 0, 77])
    out = sample_tokens(logits, temps, tks, seeds)
    assert out.dtype == torch.int32
    assert out[0] == greedy[0] and out[2] == greedy[2]
    assert torch.equal(out, sample_tokens(logits, temps, tks, seeds))
    one = sample_tokens(logits, torch.full((4,), 2.0),
                        torch.ones(4, dtype=torch.int32), seeds)
    assert torch.equal(one, greedy)
    # 16 greedy lanes beside 16 sampled ones at temperature 1
    wide = _logits(32, 64, seed=1)
    lanes = torch.arange(32) % 2 == 0
    mixed = sample_tokens(wide, torch.where(lanes, 0.0, 1.0),
                          torch.zeros(32, dtype=torch.int32),
                          torch.arange(32))
    assert torch.equal(mixed[lanes], torch.argmax(wide[lanes], dim=-1)
                       .to(torch.int32))
    assert not torch.equal(mixed[~lanes], torch.argmax(wide[~lanes], dim=-1)
                           .to(torch.int32))
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.model import sample_tokens as ref_sample
    ref = np.asarray(ref_sample(jnp.asarray(logits.numpy()),
                                jnp.asarray(temps.numpy()),
                                jnp.asarray(tks.numpy()),
                                jnp.asarray(seeds.numpy(), jnp.uint32)))
    assert ref[0] == out[0] and ref[2] == out[2]


def test_top_k_keeps_ties_and_zero_keeps_all():
    """top-k keeps every logit >= the k-th largest, ties included; k = 0
    restricts nothing.  Over many seeds the draws cover exactly the kept
    set."""
    row = torch.tensor([[5.0, 3.0, 3.0, 1.0, 0.5]])
    seen = {0: set(), 2: set()}
    for s in range(400):
        for k in (0, 2):
            tok = sample_tokens(row, torch.tensor([4.0]),
                                torch.tensor([k]), torch.tensor([s]))
            seen[k].add(int(tok))
    assert seen[2] == {0, 1, 2}
    assert seen[0] == {0, 1, 2, 3, 4}


def _np_hash32(x):
    x = x.astype(np.uint64)
    m = np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & m
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & m
    return x ^ (x >> np.uint64(16))


def test_hash_matches_numpy_bit_for_bit():
    """The int64 torch hash against a uint64 numpy version of the same
    function (products wrap mod 2**64 there, then masked to 32 bits),
    over the whole 32-bit range of seeds and indices."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(0, 1 << 32, 5000, dtype=np.int64),
                        [0, 1, (1 << 32) - 1, 1 << 31]])
    assert np.array_equal(hash32(torch.from_numpy(x)).numpy(),
                          _np_hash32(x).astype(np.int64))
    seeds = np.array([0, 1, 7, (1 << 32) - 1, 2 ** 31 + 5], np.int64)
    vocab = 1000
    m = np.uint64(0xFFFFFFFF)
    key = _np_hash32((seeds.astype(np.uint64) + np.uint64(0x9E3779B9)) & m
                     )[:, None]
    idx = np.arange(vocab, dtype=np.uint64)[None, :]
    want = _np_hash32((_np_hash32(idx ^ key) + key) & m)
    got = draw_bits(torch.from_numpy(seeds), vocab).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert got.min() >= 0 and got.max() < (1 << 32)


@pytest.mark.parametrize("temp,top_k", [(0.7, 0), (1.5, 5)])
def test_draws_match_the_softmax(temp, top_k):
    """N_DRAWS draws, one per step seed, of one row of 16 logits: the
    frequencies are within TV_BOUND (total variation) of softmax(logits
    / temp) restricted to the top-k, and no draw leaves the top-k."""
    logits = _logits(1, 16, seed=3)[0] * 2
    keep = torch.ones(16, dtype=torch.bool)
    if top_k:
        keep = logits >= torch.sort(logits, descending=True).values[
            top_k - 1]
    p = torch.softmax(torch.where(keep, logits / temp,
                                  torch.tensor(float("-inf"))), dim=-1)
    seeds = torch.tensor([_step_seed(11, i) for i in range(N_DRAWS)])
    rows = logits.expand(N_DRAWS, 16)
    toks = sample_tokens(rows, torch.full((N_DRAWS,), temp),
                         torch.full((N_DRAWS,), top_k), seeds)
    freq = torch.bincount(toks.long(), minlength=16).double() / N_DRAWS
    assert float(freq[~keep].sum()) == 0.0
    tv = 0.5 * float((freq - p.double()).abs().sum())
    assert tv < TV_BOUND, tv


def _requests(cfg, greedy_only=False, order=range(4)):
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(4):
        sp = SamplingParams(max_new_tokens=6) if greedy_only or i < 2 \
            else SamplingParams(max_new_tokens=6, temperature=0.8,
                                top_k=20, seed=40 + i)
        reqs.append(Request(
            rid=f"s{i}", prompt_len=10 + i, decode_len=6,
            prompt_tokens=rng.integers(1, cfg.vocab_size, size=10 + i)
            .astype(np.int32), sampling=sp))
    return [reqs[i] for i in order]


@pytest.fixture(scope="module")
def engine_setup():
    cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _run(cfg, params, reqs, n_decode=1, max_batch=8):
    c = Cluster(cfg, runtime="engine", params=params, chunk_size=16,
                max_seq=128, max_batch=max_batch, n_pages=256,
                n_prefill=1, n_decode=n_decode, device="cpu")
    hs = [c.submit(request=r) for r in reqs]
    c.run()
    return {h.rid: h.result().tokens for h in hs}


def test_sampling_deterministic_and_greedy_unperturbed(engine_setup):
    """Mirrors tests/test_async_runtime.py:288 through the port's
    Cluster: two mixed runs are identical, the greedy requests keep
    their all-greedy tokens, and some sampled request parts from
    greedy."""
    cfg, params = engine_setup
    mixed1 = _run(cfg, params, _requests(cfg))
    mixed2 = _run(cfg, params, _requests(cfg))
    pure = _run(cfg, params, _requests(cfg, greedy_only=True))
    assert mixed1 == mixed2
    assert mixed1["s0"] == pure["s0"] and mixed1["s1"] == pure["s1"]
    assert any(mixed1[f"s{i}"] != pure[f"s{i}"] for i in (2, 3))
    assert all(len(t) == 6 for t in mixed1.values())


def test_sampled_stream_does_not_depend_on_slot_or_batch(engine_setup):
    """The same requests in another submission order (other decode
    slots), over two decode instances (other batches), with one slot a
    batch, or a sampled request alone, give the same streams."""
    cfg, params = engine_setup
    want = _run(cfg, params, _requests(cfg))
    assert _run(cfg, params, _requests(cfg, order=(3, 2, 1, 0))) == want
    assert _run(cfg, params, _requests(cfg), n_decode=2) == want
    assert _run(cfg, params, _requests(cfg), max_batch=1) == want
    alone = _run(cfg, params, _requests(cfg, order=(3,)))
    assert alone == {"s3": want["s3"]}


def test_greedy_streams_match_reference_cluster(engine_setup):
    """The greedy requests of a mixed batch give the reference Cluster's
    tokens on the same weights (its sampled lanes draw from JAX's PRNG
    and are not compared)."""
    jax = pytest.importorskip("jax")
    from repro.models import model as RM
    from repro.runtime.request import Request as RefRequest
    from repro.runtime.request import SamplingParams as RefSP
    from repro.serving import Cluster as RefCluster
    from repro_torch.params import from_reference
    cfg, _ = engine_setup
    ref_params = RM.init_params(jax.random.PRNGKey(0), cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    mine = _run(cfg, params, _requests(cfg))
    c = RefCluster(cfg, runtime="engine", params=ref_params, chunk_size=16,
                   max_seq=128, max_batch=8, n_pages=256, n_prefill=1,
                   n_decode=1)
    hs = []
    for r in _requests(cfg):
        sp = r.sampling
        hs.append(c.submit(request=RefRequest(
            rid=r.rid, prompt_len=r.prompt_len, decode_len=r.decode_len,
            prompt_tokens=r.prompt_tokens,
            sampling=RefSP(max_new_tokens=sp.max_new_tokens,
                           temperature=sp.temperature, top_k=sp.top_k,
                           seed=sp.seed))))
    c.run()
    ref = {h.rid: h.result().tokens for h in hs}
    assert mine["s0"] == ref["s0"] and mine["s1"] == ref["s1"]
    # the first token comes from the greedy prefill on both sides
    assert all(mine[r][0] == ref[r][0] for r in mine)


def test_step_seed_is_the_reference_crc32():
    """_step_seed is the reference's crc32 of "{seed}:{n_generated}"."""
    import zlib
    for seed, n in [(0, 1), (40, 3), (2 ** 31, 17)]:
        assert _step_seed(seed, n) \
            == zlib.crc32(f"{seed}:{n}".encode()) & 0xFFFFFFFF
    pytest.importorskip("jax")
    from repro.core.decode_engine import _step_seed as ref_step_seed
    assert [_step_seed(7, n) for n in range(5)] \
        == [ref_step_seed(7, n) for n in range(5)]
