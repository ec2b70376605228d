"""The benchmark of the PyTorch/CUDA port (`repro_torch`); see README.md."""
