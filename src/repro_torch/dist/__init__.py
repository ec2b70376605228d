"""repro_torch.dist — elastic re-meshing, sharding rules and fault policy.

The distributed-systems face of the paper's lesson: just as the transfer
engine bounds how long the host is blocked on one DMA, the training loop
must bound how long the fleet is blocked on one failed or straggling host.
:mod:`repro_torch.dist.elastic` plans the shrunken device mesh after a host
loss; :mod:`repro_torch.dist.fault` tracks restarts, stragglers and skipped
non-finite steps for the :class:`repro_torch.train.loop.Trainer`, and holds
the transfer stack's fault ledger (:class:`TransferFaultState`);
:mod:`repro_torch.dist.sharding` maps parameter, optimizer-state, batch and
cache trees to ``DTensor`` placements on a
:class:`torch.distributed.device_mesh.DeviceMesh` (the production meshes of
:mod:`repro_torch.launch.mesh`).
"""

from repro_torch.dist.elastic import MeshPlan, reshard_plan, shrink_mesh  # noqa: F401
from repro_torch.dist.fault import (  # noqa: F401
    FaultPolicy,
    FaultState,
    TransferFaultState,
)
from repro_torch.dist.sharding import (  # noqa: F401
    batch_sharding_tree,
    cache_sharding,
    opt_state_sharding,
    param_sharding,
)
