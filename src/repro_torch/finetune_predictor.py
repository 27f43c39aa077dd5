"""Fine-tune the length-prediction model (paper §3.3.2, Fig. 8), the
reference's ``examples/finetune_predictor.py`` on the port.

The offline flow: build a (prompt -> decode-length-bucket) dataset from
the target model's behaviour (synthesized here), fine-tune the small
OPT-125M-class classifier with the port's AdamW trainer, and report
bucket accuracy per granularity.  The fine-tuned predictor plugs into
the serving ``Cluster`` (``ModelPredictor``).  ``--device`` defaults
to the card.

    PYTHONPATH=src python -m repro_torch.finetune_predictor \\
        [--steps 80] [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.predictor import ModelPredictor
from repro_torch.models import model as M
from repro_torch.train import data as D
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--granularity", type=int, default=200)
    ap.add_argument("--n-data", type=int, default=768)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n_classes = max(2, 2048 // args.granularity)
    cfg = dataclasses.replace(get_smoke_config("opt_125m_cls"),
                              n_classes=n_classes, dtype="float32")
    toks, lens, labels = D.predictor_dataset(
        args.n_data, vocab=cfg.vocab_size, granularity=args.granularity,
        n_classes=n_classes, seed=0)
    split = int(0.8 * args.n_data)

    dev = args.device
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    state = opt.init(params)
    step = trainer.make_cls_train_step(
        cfg, opt.AdamWConfig(lr=3e-3, warmup_steps=10,
                             total_steps=args.steps, weight_decay=0.0))
    it = D.batched((toks[:split], lens[:split], labels[:split]), 64,
                   seed=1)
    for i, (bt, bl, by) in zip(range(args.steps), it):
        params, state, loss, acc = step(params, state, bt, bl, by)
        if i % 10 == 0:
            print(f"step {i:4d} loss={float(loss):.3f} "
                  f"train_acc={float(acc):.2f}")

    with torch.no_grad():
        ev = M.classify(params, cfg, torch.as_tensor(toks[split:],
                                                     device=dev),
                        torch.as_tensor(lens[split:], device=dev))
    acc = float((torch.argmax(ev, -1).cpu()
                 == torch.as_tensor(labels[split:])).float().mean())
    print(f"\neval bucket accuracy (granularity={args.granularity}): "
          f"{100*acc:.1f}%  (chance {100/n_classes:.1f}%, paper@200: 74.9%)")

    pred = ModelPredictor(cfg, params, granularity=args.granularity)
    b, lo, hi = pred.predict_range(toks[split], 0)
    print(f"sample prediction: bucket={b} range=({lo},{hi}] tokens")
    assert acc > 2.0 / n_classes, "predictor failed to learn"
    print("OK")


if __name__ == "__main__":
    main()
