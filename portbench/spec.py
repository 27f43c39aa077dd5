"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

Nothing here knows a cell, a configuration, a traffic mix or a metric
by name: a configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json``, a cell's correctness settings
``cells/<cell>.json`` and a metric's reader ``metrics/<metric>.py``.
A later cell, mix or metric is new files plus a ``BENCHMARK.json``
entry.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent

# the configuration file's published keys -> the port's ModelConfig fields
REGISTRY_FIELDS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "ffn_dim": "d_ff",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "tie_word_embeddings": "tie_embeddings",
    "norm_eps": "norm_eps",
}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """One ``BENCHMARK.json`` and the folder of files it names."""

    def __init__(self, bench_path: Optional[Path] = None,
                 root: Path = HERE):
        bench_path = Path(bench_path or CHECKOUT / "BENCHMARK.json")
        self.base = bench_path.parent
        self.root = Path(root)
        self.bench = load_json(bench_path)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(self.base / c["file"])
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.root / "traffic" / f"{name}.json")

    def cell_settings(self, name: str) -> dict:
        return load_json(self.root / "cells" / f"{name}.json")

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics the cell reports: its per-layer ones with
        ``trace``, else its end-to-end ones (``setup_s`` included)."""
        e2e = [m for m in self.bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell])
                and m["moves"] in moved]

    def reader(self, metric: str):
        """The ``read(run)`` function of ``metrics/<metric>.py``."""
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def widths(cfg: dict) -> Dict[str, object]:
    """The configuration file's values under the port's field names."""
    out = {}
    for key, field in REGISTRY_FIELDS.items():
        if key in cfg:
            out[field] = cfg[key]
    return out


def check_registry(cfg: dict, registry_cfg) -> None:
    """Refuse to serve when the port's registry config differs from the
    configuration file in any width it states."""
    bad = [f"{field}: file {v!r}, registry {getattr(registry_cfg, field)!r}"
           for field, v in widths(cfg).items()
           if getattr(registry_cfg, field) != v]
    if registry_cfg.resolved_head_dim != cfg["head_dim"]:
        bad.append(f"head_dim: file {cfg['head_dim']}, registry "
                   f"{registry_cfg.resolved_head_dim}")
    positions = cfg.get("learned_positions", 0)
    if registry_cfg.n_positions != positions:
        bad.append(f"n_positions: file {positions}, registry "
                   f"{registry_cfg.n_positions}")
    if registry_cfg.mlp_act != cfg["mlp_act"]:
        bad.append(f"mlp_act: file {cfg['mlp_act']}, registry "
                   f"{registry_cfg.mlp_act}")
    rope = cfg.get("rope_theta")
    if bool(rope) != registry_cfg.use_rope or (
            rope and float(rope) != registry_cfg.rope_theta):
        bad.append(f"rope: file {rope}, registry {registry_cfg.use_rope} "
                   f"{registry_cfg.rope_theta}")
    if registry_cfg.sliding_window or registry_cfg.moe or registry_cfg.mla:
        bad.append("registry config has a window, experts or MLA")
    if bad:
        raise SystemExit(f"{cfg['name']}: the port's registry config "
                         f"differs from the file: {'; '.join(bad)}")
