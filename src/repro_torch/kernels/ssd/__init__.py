"""Mamba2 SSD chunked-scan kernel."""
from repro_torch.kernels.ssd.ops import ssd  # noqa: F401
