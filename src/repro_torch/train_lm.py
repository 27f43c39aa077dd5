"""End-to-end LM training driver, the reference's
``examples/train_lm.py`` on the port: the training substrate (AdamW,
per-layer checkpointing, the data pipeline) on a qwen2-family model.

Default preset is CPU-sized (~12M params, 200 steps, loss should fall
well below the unigram entropy); ``--preset 100m`` selects the ~100M
configuration for the card.  ``--device`` defaults to the card.

    PYTHONPATH=src python -m repro_torch.train_lm [--steps 200] \\
        [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.train import data as D
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

PRESETS = {
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                 d_ff=512, vocab_size=2048),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2048, vocab_size=32768),
}


def preset_config(name: str) -> ModelConfig:
    return ModelConfig(name=f"lm-{name}", pattern=(ATTN,), qkv_bias=True,
                       rope_theta=1e6, mlp_act="swiglu",
                       tie_embeddings=True, dtype="float32",
                       **PRESETS[name])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args(argv)

    cfg = preset_config(args.preset)
    params = M.init_params(
        cfg, torch.Generator(device=args.device).manual_seed(0),
        args.device)
    n_params = M.param_count(cfg)
    print(f"training {cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch={args.batch} seq={args.seq}")

    state = opt.init(params)
    step = trainer.make_train_step(
        cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=20,
                             total_steps=args.steps))
    stream = D.lm_batches(cfg.vocab_size, args.batch, args.seq, seed=1)
    first = last = None
    t0 = time.time()
    for i, (toks, labels) in zip(range(args.steps), stream):
        params, state, loss = step(params, state, toks, labels)
        if i == 0:
            first = float(loss)
        last = float(loss)
        if i % 20 == 0:
            print(f"step {i:4d} loss={float(loss):.3f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps")
    assert last < first * 0.8, "training failed to reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
