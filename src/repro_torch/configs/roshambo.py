"""roshambo-nullhop: the paper's own workload (the Table I scenario)."""

from repro_torch.accel.roshambo import RoShamBoConfig


def config() -> RoShamBoConfig:
    return RoShamBoConfig()


def smoke_config() -> RoShamBoConfig:
    return RoShamBoConfig(input_hw=16)
