"""Serving entry point: batched generation with a policy-driven engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --full \
      --batch 4 --prompt-len 128 --new-tokens 32

Runs on the card unless ``--device cpu`` is given. Weights are random,
drawn from a generator seeded with 0 on the run's device; prompts, and the
vlm family's patch embeddings or the audio family's frames (side inputs
that ride the prompt's transfer), come from ``np.random.default_rng(0)``.

One divergence from the reference's launcher: for the vlm family the
cache also holds the ``n_prefix_tokens`` patch positions, so ``max_seq``
is prompt + new + 8 + n_prefix_tokens (the reference's prompt + new + 8
cannot hold pixtral-12b's 256 prefix tokens at full width).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.device import default_device
from repro_torch.models.api import build_model
from repro_torch.serve.engine import ServeConfig, ServingEngine


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    max_seq = args.prompt_len + args.new_tokens + 8
    if cfg.family == "vlm":
        max_seq += cfg.n_prefix_tokens
    eng = ServingEngine(model, params,
                        ServeConfig(max_batch=args.batch, max_seq=max_seq,
                                    temperature=args.temperature))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = rng.standard_normal(
            (args.batch, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        extra["frames"] = rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)
    try:
        res = eng.generate(prompts, max_new_tokens=args.new_tokens,
                           extra_inputs=extra or None)
    finally:
        eng.close()
    for i, r in enumerate(res):
        print(f"req{i}: prefill={r.prefill_s*1e3:.1f}ms "
              f"decode={r.decode_s*1e3:.1f}ms tok/s={r.tokens_per_s:.1f} "
              f"tokens={r.tokens[:8].tolist()}...")
    return res


if __name__ == "__main__":
    main()
