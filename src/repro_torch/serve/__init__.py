from repro_torch.serve.engine import ServeConfig, ServingEngine  # noqa: F401
from repro_torch.serve.continuous import ContinuousBatchingEngine, Request  # noqa: F401
