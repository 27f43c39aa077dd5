"""The reference decoder against the port's paged prefill and decode
logits at the OPT and Mistral-Nemo smoke widths, in float32 on the CPU
(the test imports both; the reference imports nothing of the port)."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference.decoder import Decoder, q8, widest_gap
from portbench.serve import registry_config
from portbench.tests.conftest import SMOKE
from portbench.weights import make


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_reference_equals_port_paged_logits(name):
    from repro_torch.core.prefill_engine import make_page_pool
    from repro_torch.models import model as M

    cfg = SMOKE[name]
    reg = dataclasses.replace(registry_config(cfg), dtype="float32")
    params = make(cfg, 99, "cpu", dtype=torch.float32)
    s, ps = 37, 4
    n_pages = 16
    pool, trash = make_page_pool(reg, n_pages, ps, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, cfg["vocab_size"], size=s + 1), dtype=torch.int32)
    bt = torch.arange(n_pages, dtype=torch.int32)[None]
    pos = torch.arange(s)
    i32 = torch.int32
    _, pre = M.prefill_paged(
        params, reg, toks[None, :s], torch.tensor([0], dtype=i32),
        torch.tensor([s], dtype=i32), torch.tensor([s - 1], dtype=i32), bt,
        (pos // ps).to(i32)[None], (pos % ps).to(i32)[None], pool.k, pool.v)
    dec = M.decode_logits_paged(
        params, reg, toks[None, s:s + 1], torch.tensor([s], dtype=i32),
        torch.tensor([s // ps], dtype=i32), torch.tensor([s % ps], dtype=i32),
        bt, torch.tensor([s + 1], dtype=i32), pool.k, pool.v)
    ref = Decoder(cfg, params).logits([toks[:s + 1]], [s - 1])[0]
    torch.testing.assert_close(pre[0].float(), ref[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dec[0].float(), ref[1], rtol=1e-4, atol=1e-4)


def test_widest_gap_reads_the_served_token():
    lg = torch.tensor([[0.0, 2.0, 1.5], [3.0, 0.0, -1.0]])
    assert widest_gap(lg, torch.tensor([1, 0])) == 0.0
    assert widest_gap(lg, torch.tensor([2, 2])) == pytest.approx(4.0)


def test_float8_rounding_keeps_three_mantissa_bits():
    x = torch.linspace(-3, 3, 101)[None]
    err = (q8(x) - x).abs().max()
    assert 0 < err <= 3 * 2 ** -4


def test_control_departs_from_the_reference():
    """The float8 control, put in the program's place at the smoke
    widths, lands far from the float32 reference's best token."""
    cfg = SMOKE["opt-smoke"]
    params = make(cfg, 7, "cpu", dtype=torch.bfloat16)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        1, cfg["vocab_size"], size=200), dtype=torch.int32)
    ref = Decoder(cfg, params).logits([toks], [0])[0]
    low = Decoder(cfg, params, fp8=True).logits([toks], [0])[0]
    assert widest_gap(ref, low.argmax(-1)) > 0.05
