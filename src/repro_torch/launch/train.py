"""Training launcher, the reference's ``launch/train.py`` on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --steps 100

With ``--arch`` it trains the reduced (smoke) config of that
architecture in f32 on synthetic LM batches; without, it runs
``repro_torch.train_lm`` (the reference's ``examples/train_lm.py``) with
the same arguments.  ``--device`` defaults to the card, as
``launch.serve`` does; ``--device cpu`` runs the plain versions of the
kernels.
"""
import argparse
import dataclasses
import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="train the reduced config of an assigned arch")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args, _ = ap.parse_known_args(argv)

    if not args.arch:
        from repro_torch import train_lm
        train_lm.main(argv)
        return

    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import frontends as F
    from repro_torch.models import model as M
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    ap.parse_args(argv)             # no argument left unknown
    cfg = dataclasses.replace(get_smoke_config(args.arch), dtype="float32")
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = M.init_params(cfg, gen, args.device)
    state = opt.init(params)
    has_enc = cfg.encoder is not None
    step = trainer.make_train_step(
        cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=10,
                             total_steps=args.steps),
        has_encoder=has_enc)
    stream = D.lm_batches(cfg.vocab_size, args.batch, args.seq, seed=0)
    enc = F.fake_frontend(cfg, args.batch, gen, args.device)
    t0 = time.time()
    for i, (toks, labels) in zip(range(args.steps), stream):
        a = (params, state, toks, labels)
        if has_enc:
            a = a + (enc,)
        params, state, loss = step(*a)
        if i % 10 == 0:
            print(f"step {i:4d} loss={float(loss):.3f}")
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s, "
          f"final loss {float(loss):.3f}")


if __name__ == "__main__":
    main()
