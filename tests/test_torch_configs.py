"""The five full-attention configs the port registers beside qwen2-0.5b
(Phi-4-mini, Mistral-Nemo, DeepSeek-67B, Granite-MoE, OPT-13B) against
the JAX package's: the same fields, full size and smoke size, and the
same engine round trip on the same weights (``from_reference`` of the
reference's ``init_params``).  The round trip runs in f32 on the CPU:
the reference's engines with their Pallas kernels in interpret mode,
the port's with its kernels' plain versions; it must give the same
tokens, fused prefill calls, decode iterations and wire bytes, and
leave both pools empty.
"""
import copy
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.decode_engine import DecodeEngine as RefDecode  # noqa: E402
from repro.core.prefill_engine import PrefillEngine as RefPrefill  # noqa: E402,E501
from repro.models import model as RM  # noqa: E402
from repro.runtime.workload import generate  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.configs import deepseek_67b, mistral_nemo_12b  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.prefill_engine import PrefillEngine  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from repro_torch.runtime.request import Request  # noqa: E402

ARCHS = ("phi4_mini_3_8b", "mistral_nemo_12b", "deepseek_67b",
         "granite_moe_3b_a800m", "opt_13b")
KW = dict(max_seq=64, page_size=4, n_pages=128)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field of the full and the smoke config equals the
    reference's (nested MoE fields included); the served variants change
    only what their docstrings say."""
    fields = dataclasses.asdict
    assert arch in ARCH_IDS
    assert fields(get_config(arch)) == fields(ref_config(arch))
    assert fields(get_smoke_config(arch)) == fields(ref_smoke(arch))
    full = fields(get_config(arch))
    if arch == "deepseek_67b":
        cut = fields(deepseek_67b.served())
        assert cut.pop("n_layers") == deepseek_67b.SERVED_LAYERS < 95
        full.pop("n_layers")
        assert cut == full
    if arch == "mistral_nemo_12b":
        win = fields(mistral_nemo_12b.windowed())
        assert win.pop("sliding_window") == 4096
        assert full.pop("sliding_window") == 0
        assert win == full


def _port_requests(ref_reqs):
    return [Request(rid=r.rid, prompt_len=r.prompt_len,
                    decode_len=r.decode_len, arrival=r.arrival,
                    prompt_tokens=r.prompt_tokens) for r in ref_reqs]


def _drive(pe, de, reqs):
    for r in reqs:
        pe.submit(r)
    out, t = {}, 0.0
    for _ in range(2000):
        for pk in pe.step(t):
            de.receive(pk, now=t)
        de.admit(t)
        for f in de.step(t):
            out[f.req.rid] = f.tokens
        t += 0.01
        if pe.idle() and de.idle():
            break
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_roundtrip_matches_reference(arch):
    """Mirrors tests/test_torch_serving.py's round trip for each new
    config at smoke size in f32: prefill -> page handoff -> decode gives
    the reference engines' tokens, fused calls, iterations and wire
    bytes, and both pools end empty.  OPT-13B runs learned positions and
    GELU, Granite a routed MoE with no shared expert, Mistral-Nemo a
    head width decoupled from d_model / n_heads in the full config."""
    ref_cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ref_params = RM.init_params(jax.random.PRNGKey(7), ref_cfg)
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg,
                            "cpu")
    reqs = generate("Mixed", 5, seed=17, max_prompt=24, max_decode=6,
                    vocab_size=cfg.vocab_size)
    rpe = RefPrefill("p0", ref_cfg, ref_params, chunk_size=8,
                     backend="paged", **KW)
    rde = RefDecode("d0", ref_cfg, ref_params, max_slots=4,
                    backend="paged", **KW)
    out_ref = _drive(rpe, rde, copy.deepcopy(reqs))
    pe = PrefillEngine("p0", cfg, params, chunk_size=8, device="cpu", **KW)
    de = DecodeEngine("d0", cfg, params, max_slots=4, device="cpu", **KW)
    out = _drive(pe, de, _port_requests(reqs))
    assert len(out) == len(out_ref) == 5
    assert out == out_ref
    assert pe.fused_calls == pe.chunk_steps == rpe.fused_calls
    assert de.iterations == rde.iterations
    assert pe.network.bytes_sent == rpe.network.bytes_sent > 0
    assert pe.alloc.used_pages == de.alloc.used_pages == 0
    assert rpe.alloc.used_pages == rde.alloc.used_pages == 0
