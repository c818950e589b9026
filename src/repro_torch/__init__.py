"""PyTorch/CUDA port of `repro`, the JAX reproduction of "Prediction-Based
Power Oversubscription in Cloud Platforms".

It mirrors `repro`'s layout (`core/`, `kernels/<name>/`, `serve/`,
`sim/`) and is held against it module by module in the tests. It
imports neither JAX nor `repro`: host-side numpy code it needs is
carried over as its own copy. Entry points run on the card unless the
caller passes ``device="cpu"`` (`repro_torch.device`).
"""
from repro_torch.device import KERNEL_LAUNCHES, reset_launches, resolve_device

__all__ = ["KERNEL_LAUNCHES", "reset_launches", "resolve_device"]
