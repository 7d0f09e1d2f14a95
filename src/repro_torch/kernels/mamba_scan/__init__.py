from repro_torch.kernels.mamba_scan.ops import mamba_scan, path_for
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref, scan_from

__all__ = ["mamba_scan", "mamba_scan_ref", "path_for", "scan_from"]
