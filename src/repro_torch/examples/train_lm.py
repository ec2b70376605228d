"""End-to-end driver: train a ~100M-param dense LM for a few hundred steps
with checkpointing, restart, and policy-driven data staging.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \
        [--resume] [--device cpu]

The port's counterpart of ``examples/train_lm.py``: the same ``lm_100m``
config, trainer settings and data, on the card unless ``--device cpu`` is
given (random weights from a generator seeded with 0 on that device).
Checkpoints go to ``build/lm100m_ckpt`` under the checkout (gitignored)
unless ``--checkpoint-dir`` names another directory; ``--resume`` keeps
them and restarts from the latest.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from repro_torch.core.transfer import TransferPolicy
from repro_torch.data.pipeline import DataConfig, StagedPipeline, SyntheticLMSource
from repro_torch.device import default_device
from repro_torch.models.api import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import TrainConfig, Trainer

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "lm100m_ckpt"


def lm_100m() -> ModelConfig:
    """~100M params: 12L, d=768, llama-style."""
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        vocab=32000, n_heads=12, n_kv_heads=4, d_ff=2048,
        mlp="gated_silu", norm="rms", dtype="float32", remat=False,
    )


def main(argv: list[str] | None = None) -> tuple[Trainer, dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = lm_100m()
    model = build_model(cfg)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    if not args.resume:
        shutil.rmtree(args.checkpoint_dir, ignore_errors=True)
    tcfg = TrainConfig(steps=args.steps, n_microbatches=2,
                       warmup=20, log_every=20,
                       opt=AdamWConfig(lr=6e-4),
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=100)
    source = SyntheticLMSource(
        DataConfig(global_batch=args.batch, seq_len=args.seq), cfg)
    pipe = StagedPipeline(source, TransferPolicy.kernel_level(),
                          device=device)
    trainer = Trainer(model, tcfg)
    try:
        out = trainer.run(pipe, device=device)
    finally:
        pipe.close()
    first, last = trainer.history[0], trainer.history[-1]
    print(f"loss {first['loss']:.3f} -> {last['loss']:.3f} over "
          f"{args.steps} steps; mean step {last['dt_s']*1e3:.0f}ms; "
          f"restarts={out['fault'].restarts}")
    if not last["loss"] < first["loss"]:
        raise RuntimeError("loss must decrease")
    return trainer, out


if __name__ == "__main__":
    main()
