"""Quickstart: build an assigned architecture, train a few steps, serve it.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's counterpart of ``examples/quickstart.py``: qwen2.5-3b's smoke
config trained for 20 steps under the kernel-level (interrupt) staging
policy, then served by the port's ``ServingEngine``. Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.registry import smoke_config
from repro_torch.core.transfer import TransferPolicy
from repro_torch.data.pipeline import DataConfig, StagedPipeline, SyntheticLMSource
from repro_torch.device import default_device
from repro_torch.models.api import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.serve.engine import ServeConfig, ServingEngine
from repro_torch.train.loop import TrainConfig, Trainer


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    # 1. pick an architecture (reduced config; full ones need a pod)
    cfg = smoke_config("qwen2.5-3b")
    model = build_model(cfg)

    # 2. train briefly with the kernel-level (interrupt) staging policy
    tcfg = TrainConfig(steps=20, n_microbatches=2, warmup=2,
                       opt=AdamWConfig(lr=1e-3), log_every=5)
    source = SyntheticLMSource(DataConfig(global_batch=8, seq_len=64), cfg)
    pipe = StagedPipeline(source, TransferPolicy.kernel_level(),
                          device=device)
    trainer = Trainer(model, tcfg)
    try:
        out = trainer.run(pipe, device=device)
    finally:
        pipe.close()
    print("loss:", [round(r["loss"], 3) for r in trainer.history])

    # 3. serve the trained params
    eng = ServingEngine(model, out["params"], ServeConfig(max_seq=128))
    try:
        res = eng.generate(np.ones((2, 16), np.int32), max_new_tokens=16)
    finally:
        eng.close()
    print("generated:", res[0].tokens.tolist())
    print(f"decode tok/s: {res[0].tokens_per_s:.1f}")
    return res


if __name__ == "__main__":
    main()
