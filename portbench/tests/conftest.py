"""A tiny copy of the benchmark for the CPU tests: the smoke widths of
both served architectures, small mixes, and a ``BENCHMARK.json`` that
names them, in a temporary folder laid out as a checkout."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (str(CHECKOUT), str(CHECKOUT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE = {
    "opt-smoke": {
        "name": "opt-smoke", "registry": "opt_13b.smoke",
        "num_hidden_layers": 2, "hidden_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 64,
        "ffn_dim": 512, "vocab_size": 512, "learned_positions": 4096,
        "tie_word_embeddings": True, "rope_theta": None, "mlp_act": "gelu",
        "norm_eps": 1e-6},
    "nemo-smoke": {
        "name": "nemo-smoke", "registry": "mistral_nemo_12b.smoke",
        "num_hidden_layers": 2, "hidden_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
        "intermediate_size": 512, "vocab_size": 512,
        "tie_word_embeddings": False, "rope_theta": 1000000.0,
        "mlp_act": "swiglu", "norm_eps": 1e-6},
}
SERVING = {"n_prefill": 1, "n_decode": 1, "chunk_size": 32, "page_size": 4,
           "prefill_policy": "sjf", "sched_batch": 16,
           "decode_policy": "reserve-dynamic", "dispatch_policy": "power2",
           "predictor_accuracy": 0.749, "n_pages": 96, "max_batch": 4,
           "max_seq": 128}
MIX = {"classes": {"LP": [4, 0.5, 6, 0.5], "HP": [40, 0.3, 8, 0.5]},
       "weights": {"LP": 0.5, "HP": 0.5}, "prompt_clip": [1, 90],
       "output_clip": [1, 20], "context_max": 110,
       "arrivals": {"process": "poisson", "rate": 6.0}, "draw_seed": 5,
       "drain_s": 60, "warmup": [2, 2]}
CELL = {"sample_tokens": 40, "sample_requests": 40,
        "limits": {"logit_gap": 0.05}}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_tiny(root: Path) -> Path:
    """A checkout-like folder: a copy of ``portbench`` with the tiny
    configurations, mixes and cells, and its ``BENCHMARK.json``."""
    pb = root / "portbench"
    shutil.copytree(CHECKOUT / "portbench", pb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name, cfg in SMOKE.items():
        write(pb / "configs" / f"{name}.json", dict(cfg, serving=SERVING))
        bench["configs"].append({"name": name, "source": "smoke widths",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "CPU test"})
        cell = f"{name}.tiny"
        write(pb / "cells" / f"{cell}.json", CELL)
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "CPU test"})
    write(pb / "traffic" / "tiny.json", MIX)
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    write(root / "BENCHMARK.json", bench)
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("tiny"))
