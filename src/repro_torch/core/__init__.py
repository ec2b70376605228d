"""repro_torch.core — the transfer-strategy engine on PyTorch and CUDA.

The policy matrix of Rios-Navarro et al. (2018) — management (polling /
scheduled / interrupt), buffering (single / double / ring), partitioning
(unique / blocks) — at the host <-> device boundary of an NVIDIA GPU:

- completion dispatch: :mod:`repro_torch.core.runtime`
- submit context   : :mod:`repro_torch.core.qos`
- host <-> device  : :mod:`repro_torch.core.transfer` (pinned staging, CUDA
                     copy streams and events)
- multi-channel    : :mod:`repro_torch.core.channels` (striped rings, one
                     copy-stream pair a channel, + the calibrated policy)
- online adaptation: :mod:`repro_torch.core.adaptive` (rolling t0/BW refit,
                     hysteresis-gated replans applied at ring-drain points)
- fault injection  : :mod:`repro_torch.core.faults` (seeded faults behind
                     the ``engine_factory`` seam, recovery tuning)
- per-layer stream : :mod:`repro_torch.core.streaming` (the NullHop
                     execution model)
- cost model       : :mod:`repro_torch.core.cost_model`
"""

from repro_torch.core.runtime import (  # noqa: F401
    CooperativeScheduler,
    PriorityClass,
    TransferRuntime,
    get_runtime,
)
from repro_torch.core.qos import QosSpec  # noqa: F401
from repro_torch.core.transfer import (  # noqa: F401
    Buffering,
    BufferInFlightError,
    LayoutCache,
    Management,
    Partitioning,
    StagedLayout,
    TransferEngine,
    TransferPolicy,
    TransferStats,
)
from repro_torch.core.channels import (  # noqa: F401
    ChannelGroup,
    ChannelPlan,
    StagingPool,
    calibrate_transfer,
    plan_channels,
)
from repro_torch.core.adaptive import (  # noqa: F401
    AdaptiveChannelGroup,
    AdaptiveConfig,
    OnlineTransferController,
    RollingFit,
    choose_management,
)
from repro_torch.core.cost_model import TransferCostModel  # noqa: F401
