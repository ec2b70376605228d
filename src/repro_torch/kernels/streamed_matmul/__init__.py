from repro_torch.kernels.streamed_matmul.ops import streamed_matmul  # noqa: F401
