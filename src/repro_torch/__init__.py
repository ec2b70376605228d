"""repro_torch — the PyTorch / CUDA port of ``repro``.

The transfer-policy engine of Rios-Navarro et al., "Performance evaluation
over HW/SW co-design SoC memory transfers for a CNN accelerator" (2018),
on an NVIDIA H100: the policy matrix (polling / scheduled / interrupt x
single / double / ring x unique / blocks) drives every host <-> device copy,
and the CNN layers and the dense LM's attention run on hand-written CUDA
kernels. Module paths mirror ``repro``'s, so each module's counterpart is
at the same relative path.
"""

__version__ = "0.1.0"

from repro_torch.core.transfer import (  # noqa: F401
    Buffering,
    Management,
    Partitioning,
    TransferPolicy,
)
