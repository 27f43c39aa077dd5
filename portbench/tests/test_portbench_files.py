"""Every file ``BENCHMARK.json`` names loads, and a cell, a traffic mix
and a metric dropped into a copy as new files are found by name."""
import json
import shutil
from pathlib import Path

import pytest

from portbench import spec as S
from portbench import traffic as T
from portbench.tests.conftest import CHECKOUT, make_tiny


def test_every_named_file_loads():
    spec = S.Spec()
    bench = spec.bench
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"]
        assert set(cfg["serving"]) >= {"n_pages", "max_batch", "max_seq",
                                       "chunk_size", "page_size"}
        for key in c["reduced"]:
            assert key in cfg["published"], key
    for w in bench["workloads"]:
        mix = spec.traffic(w["traffic"])
        assert T.schedule(mix, 5.0, 1, 1000) or mix["arrivals"]
        assert spec.cell_settings(w["name"])["limits"]["logit_gap"] > 0
        assert spec.metrics(w["name"], trace=False)
        assert spec.metrics(w["name"], trace=True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    assert (CHECKOUT / bench["command"][1]).exists()


def test_registry_matches_config_files():
    """Every configuration file states the widths of the port's
    registry config."""
    from portbench.serve import registry_config
    files = sorted((CHECKOUT / "portbench" / "configs").glob("*.json"))
    assert files
    for path in files:
        cfg = S.load_json(path)
        S.check_registry(cfg, registry_config(cfg))
        assert set(cfg["serving"]) >= {"n_pages", "max_batch", "max_seq"}


def test_registry_check_refuses_a_changed_width():
    from portbench.serve import registry_config
    cfg = S.Spec().config("opt-13b")
    bad = dict(cfg, ffn_dim=cfg["ffn_dim"] // 2)
    with pytest.raises(SystemExit):
        S.check_registry(bad, registry_config(cfg))


def test_new_files_are_found_by_name(tmp_path):
    root = make_tiny(tmp_path)
    pb = root / "portbench"
    # a new mix, a new cell on it and a new metric: files and entries only
    mix = json.loads((pb / "traffic" / "tiny.json").read_text())
    mix["arrivals"] = {"process": "poisson", "rate": 4.0}
    mix["classes"] = {"HP": [60, 0.3, 4, 0.5]}
    mix["weights"] = {"HP": 1.0}
    (pb / "traffic" / "tiny.long.json").write_text(json.dumps(mix))
    shutil.copy(pb / "cells" / "opt-smoke.tiny.json",
                pb / "cells" / "opt-smoke.long.json")
    (pb / "metrics" / "requests_due.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "opt-smoke.long",
                               "config": "opt-smoke",
                               "traffic": "tiny.long", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "requests_due", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving runtime",
                               "moves": "ttft_p75_s",
                               "workloads": ["opt-smoke.long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = S.Spec(root / "BENCHMARK.json", pb)
    names = [m["name"] for m in spec.metrics("opt-smoke.long", True)]
    assert "requests_due" in names
    assert "requests_due" not in [
        m["name"] for m in spec.metrics("opt-smoke.tiny", True)]
    assert spec.reader("requests_due")(type("R", (), {"requests": [1, 2]})) \
        == 2.0
    items = T.schedule(spec.traffic("tiny.long"), 10.0, 3, 512)
    assert len(items) == 40 and all(0 <= it.due < 10.0 for it in items)
    assert min(it.prompt_len for it in items) > 20
    assert spec.cell_settings("opt-smoke.long")["limits"]


def test_metric_cells_report_what_they_move():
    """Each per-layer metric's cells report the end-to-end metric it
    moves, and every cell reports setup_s and another end-to-end metric
    and a per-layer one."""
    bench = S.Spec().bench
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in
                                             bench["workloads"]]))
           for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    spec = S.Spec()
    for w in bench["workloads"]:
        names = [m["name"] for m in spec.metrics(w["name"], False)]
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics(w["name"], True)


def test_tiny_copy_has_no_program(tmp_path):
    root = make_tiny(tmp_path)
    assert not (root / "src").exists()
    assert (root / "portbench" / "run.py").exists()
    assert Path(root / "BENCHMARK.json").exists()
