"""Oblivious-forest inference kernel."""
from repro_torch.kernels.forest.ops import forest_predict  # noqa: F401
