"""Mamba-2 SSD chunked scan: CUDA kernel, plain version, wrapper."""
from repro_torch.kernels.ssd_scan.ops import chunk_len, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["chunk_len", "ssd_scan", "ssd_scan_ref"]
