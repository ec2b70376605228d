from repro_torch.kernels.conv2d.ops import conv2d_relu  # noqa: F401
