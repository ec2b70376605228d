from repro_torch.kernels.ssd_scan.ops import ssd_full, ssd_intra_chunk  # noqa: F401
