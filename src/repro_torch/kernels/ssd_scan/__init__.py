from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: F401
