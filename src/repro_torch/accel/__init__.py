"""NullHop-style CNN accelerator executor + the RoShamBo CNN (the paper's
real workload, Table I)."""

from repro_torch.accel.roshambo import RoShamBoCNN, roshambo_config  # noqa: F401
from repro_torch.accel.nullhop import NullHopExecutor  # noqa: F401
