from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    restore_latest,
    save_checkpoint,
)
