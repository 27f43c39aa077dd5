"""A whole run on the CPU at the smoke widths, past the harness's look
for a card: sound, it comes out correct; with the timed path broken
underneath, it comes out not correct, once for each fault a served
model can have."""
import importlib.util
import time

import pytest
import torch

from portbench.spec import Spec
from portbench.tests.conftest import CHECKOUT

SEED = 2 ** 31 + 11


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "portbench_run", CHECKOUT / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(tiny, cell="opt-smoke.tiny", traced=False):
    spec = Spec(tiny / "BENCHMARK.json", tiny / "portbench")
    return _run_module().run_cell(spec, cell, SEED, 2.0, traced, "cpu",
                                  time.monotonic())


@pytest.mark.parametrize("cell,traced", [("opt-smoke.tiny", False),
                                          ("nemo-smoke.tiny", True)])
def test_sound_run_is_correct(tiny, cell, traced):
    result, checks = _run(tiny, cell, traced)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert checks["tokens_judged"]["value"] >= 3
    names = set(result["metrics"])
    assert "setup_s" not in names if traced else "setup_s" in names
    if traced:
        assert "decode_step_ms" in names and "busy_s" in result["device"]


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 4000002100])
def test_sample_spans_chunks(seed):
    """The sample of every cell holds the window's longest prompt: for
    ``opt13b.mixed`` one longer than a chunk, so a prefill across chunk
    boundaries is judged whatever the seed."""
    from portbench import serve as SV
    from portbench import traffic as T
    spec = Spec()
    seconds = spec.bench["run_seconds"]
    for w in spec.bench["workloads"]:
        cfg = spec.config(w["config"])
        items = T.schedule(spec.traffic(w["traffic"]), seconds, seed,
                           cfg["vocab_size"])
        recs = [SV.Rec(rid=str(i), due=it.due, submit=it.due,
                       prompt_len=it.prompt_len, n_out=it.n_out,
                       prompt=it.tokens, finished=True, n_tokens=it.n_out)
                for i, it in enumerate(items)]
        picked = SV.sample(recs, spec.cell_settings(w["name"]), seed)
        widest = max(r.prompt_len for r in recs)
        assert max(r.prompt_len for r in picked) == widest
        assert len({id(r) for r in picked}) == len(picked)
        if w["name"] == "opt13b.mixed":
            assert widest > cfg["serving"]["chunk_size"]


def _token(monkeypatch):
    from repro_torch.models import model as M
    orig = M.decode_step_paged

    def altered(params, cfg, *a, **k):
        return (orig(params, cfg, *a, **k) + 1) % cfg.vocab_size
    monkeypatch.setattr(M, "decode_step_paged", altered)


def _state(monkeypatch):
    from repro_torch.models import model as M
    orig = M.decode_step_paged

    def unchanged(params, cfg, tokens, pos, pages, offs, bt, lens, k, v,
                  **kw):
        return orig(params, cfg, tokens, pos, pages, offs, bt, lens,
                    k.clone(), v.clone(), **kw)
    monkeypatch.setattr(M, "decode_step_paged", unchanged)


def _half_batch(monkeypatch):
    from repro_torch.models import model as M
    orig = M.prefill_paged

    def half(params, cfg, tokens, *a, **k):
        tokens = tokens.clone()
        tokens[:, tokens.shape[1] // 2:] = 0
        return orig(params, cfg, tokens, *a, **k)
    monkeypatch.setattr(M, "prefill_paged", half)


def _exchange(monkeypatch):
    from repro_torch.kvcache.paged import PagePool
    orig = PagePool.install

    def dropped(self, pages, k_pages, v_pages):
        return orig(self, pages, torch.zeros_like(k_pages),
                    torch.zeros_like(v_pages))
    monkeypatch.setattr(PagePool, "install", dropped)


@pytest.mark.parametrize("fault", [_token, _state, _half_batch, _exchange],
                         ids=["token_altered", "state_unchanged",
                              "half_the_chunk_left_out",
                              "kv_handoff_left_out"])
def test_broken_path_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    result, checks = _run(tiny)
    assert not result["correct"]
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


@pytest.mark.gpu
def test_control_fails_on_the_card(tiny):
    """The float8 control at the smoke widths on the card: the program's
    reading passes the tiny cell's limit, the control's does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec_ = importlib.util.spec_from_file_location(
        "portbench_control", CHECKOUT / "portbench" / "control.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    spec = Spec(tiny / "BENCHMARK.json", tiny / "portbench")
    limit = spec.cell_settings("opt-smoke.tiny")["limits"]["logit_gap"]
    for seed in (1, 2, 3):
        r = mod.readings(spec, "opt-smoke.tiny", seed, 2.0, True, "cuda:0")
        assert r["program_gap"] <= limit < r["control_gap"]
