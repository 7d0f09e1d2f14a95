from repro_torch.kernels.rglru_scan.ops import path_for, rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

__all__ = ["path_for", "rglru_scan", "rglru_scan_ref"]
