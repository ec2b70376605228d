"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --full --steps 4 --batch 2 --seq 1024 --policy interrupt

Runs the real Trainer (fault-tolerant loop, policy-driven data staging,
async checkpoints) on the card unless ``--device cpu`` is given. --smoke
(the default) selects the reduced same-family config; --full the
published one, at full width (qwen2.5-3b's step holds ~55 GB of params,
gradients and AdamW state on an 80 GB card). Weights are random, drawn
from a generator seeded with 0 on the run's device. The transfer policy
chooses the paper's driver mode for host->device batch staging.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.core.transfer import (
    Buffering,
    Management,
    Partitioning,
    TransferPolicy,
)
from repro_torch.data.pipeline import DataConfig, StagedPipeline, SyntheticLMSource
from repro_torch.device import default_device
from repro_torch.models.api import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import TrainConfig, Trainer

POLICIES = {
    "polling": TransferPolicy.user_level_polling,
    "scheduled": TransferPolicy.user_level_scheduled,
    "interrupt": TransferPolicy.kernel_level,
    "interrupt-double-blocks": lambda: TransferPolicy(
        Management.INTERRUPT, Buffering.DOUBLE, Partitioning.BLOCKS),
}


def main(argv: list[str] | None = None) -> tuple[Trainer, dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", choices=sorted(POLICIES), default="interrupt")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    tcfg = TrainConfig(
        steps=args.steps, n_microbatches=args.microbatches,
        warmup=max(args.steps // 10, 1),
        opt=AdamWConfig(lr=args.lr),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every)
    policy = POLICIES[args.policy]()
    source = SyntheticLMSource(
        DataConfig(global_batch=args.batch, seq_len=args.seq), cfg)
    pipe = StagedPipeline(source, policy, device=device)
    trainer = Trainer(model, tcfg)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"training {cfg.name} for {args.steps} steps "
          f"(policy={policy.tag}, device={name})")
    try:
        out = trainer.run(pipe, device=device)
    finally:
        pipe.close()
    for row in trainer.history:
        print(json.dumps({k: round(v, 4) for k, v in row.items()}))
    f = out["fault"]
    print(f"done. restarts={f.restarts} stragglers={f.stragglers_detected} "
          f"skipped_nonfinite={f.steps_skipped_nonfinite}")
    if device.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    return trainer, out


if __name__ == "__main__":
    main()
