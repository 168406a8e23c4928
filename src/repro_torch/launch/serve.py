"""Serving launcher: ``python -m repro_torch.launch.serve --arch X`` —
batched greedy decoding with optional INT8 weights and the FENIX
admission gate (core/gate.py).  Port of ``repro/launch/serve.py``.

Runs on the card by default (``--device cpu`` for the CPU), on the
reduced config unless ``--full`` asks for the published widths, with
random weights drawn from seed 0.  The decode step is a CUDA graph on
the card and runs op by op on the CPU.  The encoder-decoder family gets
``src_embeds`` [batch, prompt length, d_model] and the vision family
``image_embeds`` [batch, num_image_tokens, d_model], float32 normals from
seed 0 (their frontends are stubs), as the reference's launcher makes
them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import apply_overrides
from repro_torch.models import api
from repro_torch.serve.engine import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--quant", default="none", choices=["none", "int8"])
    ap.add_argument("--gate-rate", type=float, default=None,
                    help="requests/s; enables the FENIX admission gate")
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
    eng = ServingEngine(cfg, params, ServeConfig(
        max_new_tokens=args.new_tokens, quant=args.quant,
        gate_backend_rate=args.gate_rate), device=device)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (args.batch, args.prompt_len))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.normal(
            0, 1, (args.batch, args.prompt_len, cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            0, 1, (args.batch, cfg.num_image_tokens, cfg.d_model)
        ).astype(np.float32)
    t0 = time.time()
    out = eng.generate(batch)
    print(f"arch={cfg.name} device={device} quant={args.quant} "
          f"step={eng.step_backend} "
          f"decode {out['decode_tok_per_s']:.1f} tok/s "
          f"(prefill {out['prefill_s']:.3f} s, capture "
          f"{out['capture_s']:.3f} s, wall {time.time()-t0:.1f}s)")
    print("sample tokens:", out["tokens"][0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
