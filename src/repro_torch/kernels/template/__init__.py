"""Criticality template-scoring kernel."""
from repro_torch.kernels.template.ops import \
    criticality_scores  # noqa: F401
