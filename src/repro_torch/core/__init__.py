"""repro_torch.core — the transfer-strategy engine on PyTorch and CUDA.

The policy matrix of Rios-Navarro et al. (2018) — management (polling /
scheduled / interrupt), buffering (single / double / ring), partitioning
(unique / blocks) — at the host <-> device boundary of an NVIDIA GPU:

- completion dispatch: :mod:`repro_torch.core.runtime`
- submit context   : :mod:`repro_torch.core.qos`
- host <-> device  : :mod:`repro_torch.core.transfer` (pinned staging, CUDA
                     copy streams and events)
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
from repro_torch.core.cost_model import TransferCostModel  # noqa: F401
