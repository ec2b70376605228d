"""Fault-tolerance walkthrough: kill training mid-run, restart from the
latest checkpoint, then re-plan the mesh for a degraded device set.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart \
        [--device cpu] [--checkpoint-dir DIR]

The port's counterpart of ``examples/elastic_restart.py``: the same
h2o-danube-1.8b smoke config, trainer settings, data and three phases,
on the card unless ``--device cpu`` is given. Checkpoints go to
``build/elastic_ckpt`` under the checkout (gitignored) unless
``--checkpoint-dir`` names another directory; the run starts by removing
it, as the reference's does.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from repro_torch.configs.registry import smoke_config
from repro_torch.core.transfer import TransferPolicy
from repro_torch.data.pipeline import DataConfig, StagedPipeline, SyntheticLMSource
from repro_torch.device import default_device
from repro_torch.dist.elastic import reshard_plan, shrink_mesh
from repro_torch.models.api import build_model
from repro_torch.train.loop import TrainConfig, Trainer

CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "elastic_ckpt"


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = smoke_config("h2o-danube-1.8b")
    model = build_model(cfg)
    ckpt = args.checkpoint_dir
    shutil.rmtree(ckpt, ignore_errors=True)

    def make(steps):
        tcfg = TrainConfig(steps=steps, warmup=2, log_every=5,
                           checkpoint_dir=ckpt, checkpoint_every=5,
                           async_checkpoint=False)
        src = SyntheticLMSource(DataConfig(global_batch=4, seq_len=64), cfg)
        return Trainer(model, tcfg), StagedPipeline(
            src, TransferPolicy.kernel_level(), device=device)

    # phase 1: run 10 steps (checkpoints at 5, 10), simulate a crash after
    t1, p1 = make(10)
    try:
        t1.run(p1, device=device)
    finally:
        p1.close()
    print("phase 1 done (crash simulated after step 10)")

    # phase 2: a fresh Trainer resumes from step 10 automatically
    t2, p2 = make(20)
    try:
        out = t2.run(p2, device=device)
    finally:
        p2.close()
    print(f"phase 2 resumed: restarts={out['fault'].restarts}, "
          f"steps logged from {t2.history[0]['step']}")
    if out["fault"].restarts != 1 or t2.history[0]["step"] < 10:
        raise RuntimeError("the second Trainer did not resume at step 10")

    # phase 3: elastic re-plan — pretend a pod dropped: 512 -> 384 devices
    plan = shrink_mesh(384, model_parallel=16, multi_pod=True)
    print("degraded mesh plan:", plan)
    reshard = reshard_plan(256, shrink_mesh(512, model_parallel=16,
                                            multi_pod=True), plan)
    print(reshard)
    return {"restarts": out["fault"].restarts,
            "first_resumed_step": t2.history[0]["step"],
            "losses": [r["loss"] for r in t1.history + t2.history],
            "plan": plan, "reshard": reshard}


if __name__ == "__main__":
    main()
