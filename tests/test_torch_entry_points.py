"""The port's entry points on the CPU against the reference's:
``python -m repro_torch.quickstart --device cpu`` (``main``) against
``examples/quickstart.py``, ``python -m repro_torch.launch.serve
--real --device cpu`` against ``python -m repro.launch.serve --real``,
and the cost-model run of each (no ``--real``: the same lines).

The quickstart runs on the reference's weights (``init_params`` from
key 0, converted with ``params.from_reference``): it must print the
same lines, ``OK`` last, and stream the same tokens.  ``serve --real``
draws its own random weights on each side, but its requests stop at
their oracle lengths, so every virtual-clock number of its summary must
match: all lines but the tokens and the wall-clock resource time, and
the trace and metrics files its observability flags write.  ``serve
--real --wall-clock`` (the AsyncCluster) prints the reference's summary
lines: the same model, request count, arrival process and token counts;
its times are wall seconds and differ.
"""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch import quickstart
from repro_torch.launch import serve
from repro_torch.params import from_reference

ROOT = Path(__file__).resolve().parents[1]


def _reference_quickstart():
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_reference(capsys):
    jax = pytest.importorskip("jax")
    from repro.models import model as RM
    ref = _reference_quickstart()
    clusters = []

    class Recorded(ref.Cluster):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            clusters.append(self)
    ref.Cluster = Recorded
    ref.main()
    want_out = capsys.readouterr().out
    want = {rid: list(buf) for rid, buf in clusters[0]._buffers.items()}

    cfg = dataclasses.replace(ref.get_smoke_config("qwen2_0_5b"),
                              dtype="float32")
    tree = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    from repro_torch.configs import get_smoke_config
    port_cfg = dataclasses.replace(get_smoke_config("qwen2_0_5b"),
                                   dtype="float32")
    results = quickstart.main(device="cpu", params=from_reference(
        tree, port_cfg, device="cpu"))
    got_out = capsys.readouterr().out
    assert got_out.splitlines()[-1] == "OK"
    assert got_out == want_out
    assert {r.rid: list(r.tokens) for r in results} == want
    assert [r.phase.value for r in results].count("cancelled") == 1


def _summary(out):
    """The lines of ``_print_result`` whose numbers run on the virtual
    clock, and the token count of each printed request."""
    keep = []
    for line in out.splitlines():
        if line.startswith("resource time"):
            keep.append(line.split("perf/$")[1].split("req/inst-s")[1])
        elif line.startswith("  r"):
            keep.append(line.split(" tokens")[0])
        elif not line.startswith("wrote"):
            keep.append(line)
    return keep


def test_serve_real_matches_reference(capsys, monkeypatch, tmp_path):
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve
    args = ["--real", "--requests", "8", "--n-prefill", "2",
            "--n-decode", "2", "--slo-ttft", "0.05", "--slo-tbt", "0.02"]
    files = {}
    for side in ("ref", "port"):
        files[side] = (tmp_path / f"{side}.jsonl", tmp_path / f"{side}.json")
        obs = ["--trace-jsonl", str(files[side][0]),
               "--metrics-out", str(files[side][1])]
        if side == "ref":
            monkeypatch.setattr(sys, "argv", ["serve", *args, *obs])
            ref_serve.main()
        else:
            serve.main([*args, "--device", "cpu", *obs])
        files[side] += (capsys.readouterr().out,)
    (ref_trace, ref_metrics, ref_out) = files["ref"]
    (trace, metrics, out) = files["port"]
    assert _summary(out) == _summary(ref_out)
    assert any(line.startswith("SLO goodput") for line in out.splitlines())
    assert "flips=" in out and "avg KV transfer" in out
    assert trace.read_text() == ref_trace.read_text()
    assert json.loads(metrics.read_text()) == json.loads(
        ref_metrics.read_text())


def _wall_summary(out):
    """The lines of the wall-clock summary that do not depend on the
    clock: the model, each printed request's token count, the arrival
    process, the request count, and every line's leading words."""
    keep = []
    for line in out.splitlines():
        if line.startswith("  r"):
            keep.append(line.split(" tokens")[0])
        elif line.startswith(("model:", "open-loop")):
            keep.append(line)
        elif line.startswith("n="):
            keep.append(line.split()[0])
        else:
            keep.append(line.split()[0])
    return keep


def test_serve_refuses_the_modes_not_ported(capsys, monkeypatch):
    """Every mode now runs.  The cost-model run (no ``--real``) prints
    the reference's summary, line for line; ``serve --real
    --wall-clock`` runs the wall-clock AsyncCluster and prints the
    reference's summary lines."""
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve
    sim = ["--requests", "16", "--workload", "LPHD"]
    monkeypatch.setattr(sys, "argv", ["serve", *sim])
    ref_serve.main()
    want = capsys.readouterr().out
    serve.main([*sim, "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert "workload=LPHD n=16" in want
    args = ["--real", "--wall-clock", "--requests", "8", "--n-prefill",
            "2", "--n-decode", "2"]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    ref_serve.main()
    want = capsys.readouterr().out
    serve.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert _wall_summary(got) == _wall_summary(want)
    assert "n=8 " in got and "(wall seconds)" in got
