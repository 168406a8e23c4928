"""LM training launcher: ``python -m repro_torch.launch.train --arch X``.

Port of ``repro/launch/train.py``: a synthetic token stream
(``token_batches``, the reference's numpy draws), AdamW
(``train/optimizer.py``) and checkpoint/restart (``train/checkpoint.py``,
the reference's layout).  Runs on the card by default (``--device cpu``
for the CPU), on the reduced config unless ``--full`` asks for the
published widths, with weights drawn from seed 0.  The encoder-decoder
family gets zero ``src_embeds`` [batch, seq, d_model] and the vision
family zero ``image_embeds`` [batch, num_image_tokens, d_model], as the
reference's launcher makes them (their frontends are stubs).

Each step is the port's ``Trainer`` step (``train/trainer.py``): forward,
autograd and the AdamW update written in place into the params and
moments, captured once as a CUDA graph on the card and run op by op on
the CPU.  It reads its metrics back once.

Where it differs from the reference's launcher:

- A step whose loss is not finite leaves the params and moments as they
  were (``Trainer`` selects the update away on the device); the
  reference's loop has no NaN handling and applies it.
- A resumed run skips the batches of the steps its checkpoint holds, so
  6 steps equal 3 steps, a restart and 3 more, bit for bit; the
  reference restarts its token stream at the first batch.
- The reference's ``--reduced`` is ``store_true`` with ``default=True``,
  so its CLI always trains the reduced config; here ``--reduced`` is
  accepted for the same command lines and ``--full`` selects the
  published widths.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import apply_overrides
from repro_torch.models import api
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import Trainer, TrainerConfig


def token_batches(vocab: int, batch: int, seq: int, seed: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic LM data: Zipf-ish ngram stream (data pipeline stand-in);
    int32 numpy ``tokens`` and ``labels`` [batch, seq], the reference's
    draws for ``seed``."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the reduced "
                         "config")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    cfg = apply_overrides(cfg, dict(s.split("=", 1) for s in args.set))
    params, _ = api.init_params(cfg, seed=0, device=device)
    ocfg = opt_lib.OptConfig(lr=args.lr, warmup_steps=args.steps // 10,
                             total_steps=args.steps)
    # the trainer resumes from the newest checkpoint in ckpt_dir
    trainer = Trainer(lambda p, b: api.loss_fn(p, cfg, b), params,
                      TrainerConfig(total_steps=args.steps, opt=ocfg,
                                    ckpt_dir=args.ckpt_dir,
                                    ckpt_every=args.ckpt_every),
                      device=device)
    del params                  # the trainer holds its own copy
    step0 = trainer.step
    if step0:
        print(f"resumed from step {step0}")

    data = token_batches(cfg.vocab_size, args.batch, args.seq)
    for _ in range(step0):      # the batches the checkpoint's steps took
        next(data)
    metrics: Dict[str, float] = {}
    t0 = time.time()
    for step in range(step0 + 1, args.steps + 1):
        batch = next(data)
        if cfg.family == "encdec":
            batch["src_embeds"] = np.zeros(
                (args.batch, args.seq, cfg.d_model), np.float32)
        if cfg.family == "vlm":
            batch["image_embeds"] = np.zeros(
                (args.batch, cfg.num_image_tokens, cfg.d_model), np.float32)
        metrics = trainer.train_step(data, batch)
        trainer.step = step
        if step % 10 == 0 or step == args.steps:
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"({(time.time()-t0)/max(step-step0,1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and step % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, step,
                          {"params": trainer.params,
                           "opt": trainer.opt_state})
    print("done")
    return metrics


if __name__ == "__main__":
    main()
