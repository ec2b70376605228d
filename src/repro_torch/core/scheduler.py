# analysis: skip-module — deprecated re-export shim, no locks of its own
"""Back-compat shim — :class:`CooperativeScheduler` lives in
:mod:`repro_torch.core.runtime`, where it is the user-level 'scheduled'
backend of the unified TransferRuntime interface (the paper's three
management modes as three backends of one abstraction; see
:class:`repro_torch.core.runtime.ScheduledBackend`). Import from there."""

import warnings

from repro_torch.core.runtime import (  # noqa: F401
    CooperativeScheduler,
    SchedulerStats,
)

warnings.warn(
    "repro_torch.core.scheduler is deprecated; import CooperativeScheduler "
    "from the repro_torch.core facade (SchedulerStats stays in "
    "repro_torch.core.runtime, the 'scheduled' management backend — see "
    "repro_torch.core.runtime.ScheduledBackend). The shim will be removed "
    "next release.",
    DeprecationWarning,
    stacklevel=2,
)
