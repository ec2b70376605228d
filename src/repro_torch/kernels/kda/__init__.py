from repro_torch.kernels.kda.ops import kda_chunk, kda_step  # noqa: F401
