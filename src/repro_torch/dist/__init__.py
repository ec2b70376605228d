"""repro_torch.dist — fault-tolerance policy and fault-event accounting.

:mod:`repro_torch.dist.fault` counts restarts, stragglers and skipped
non-finite steps for a training loop, and holds the transfer stack's fault
ledger (:class:`TransferFaultState`) that channel groups and serving
engines report. Elastic re-meshing and the sharding rules of the reference
(``dist/elastic.py``, ``dist/sharding.py``) are not ported yet: ROADMAP
Queue 1 items 26 and 21.
"""

from repro_torch.dist.fault import (  # noqa: F401
    FaultPolicy,
    FaultState,
    TransferFaultState,
)
