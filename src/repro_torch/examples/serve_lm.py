"""Serving example: continuous batching over heterogeneous requests.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The port's counterpart of ``examples/serve_lm.py``: qwen2.5-3b's smoke
config, random weights from a generator seeded with 0, ten requests of
random lengths through a 4-slot ``ContinuousBatchingEngine``. Runs on the
card unless ``--device cpu`` is given. Unlike the reference's example, a
request that admission sheds is submitted again after its
``retry_after_s`` (the reference's drops it): a runtime whose TOKEN class
has just missed half its deadlines sheds a backlogged request.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.device import default_device
from repro_torch.models.api import build_model
from repro_torch.serve.continuous import ContinuousBatchingEngine, Request


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = smoke_config("qwen2.5-3b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    eng = ContinuousBatchingEngine(model, params, n_slots=4, max_seq=96)

    rng = np.random.default_rng(0)
    n_requests = 10
    for i in range(n_requests):
        req = Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, rng.integers(6, 24)).astype(
                np.int32),
            max_new_tokens=int(rng.integers(4, 12)))
        while not (decision := eng.submit(req)).admitted:
            time.sleep(decision.retry_after_s)

    t0 = time.perf_counter()
    try:
        done = eng.run_to_completion()
    finally:
        eng.close()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.tokens) for r in done)
    print(f"served {len(done)} requests / {total_tokens} tokens in "
          f"{dt:.2f}s over {eng.steps} batched decode steps "
          f"({total_tokens / max(eng.steps, 1):.2f} tokens/step; slot "
          f"refill keeps the batch full)")
    for r in sorted(done, key=lambda r: r.rid)[:4]:
        print(f"  req{r.rid}: prompt_len={len(r.prompt)} -> {r.tokens}")
    return done


if __name__ == "__main__":
    main()
