"""Device resolution and kernel launch counts.

Every entry point of the port takes an explicit ``device``. ``None``
means the card: the port exists to run there, so without CUDA it raises
instead of carrying on quietly on the CPU. Tests pass ``device="cpu"``.

`KERNEL_LAUNCHES` counts, per hand-written kernel, the launches its
wrapper made. A wrapper bumps its count where it launches and nowhere
else (the plain version a CPU tensor takes never counts), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

KERNEL_LAUNCHES: dict[str, int] = {"forest": 0, "template": 0,
                                   "flash_attention": 0, "ssd": 0}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when the requested device is CUDA and
    no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return dev
