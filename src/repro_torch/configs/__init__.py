"""Model configurations: every architecture `repro.configs` has, as
plain copies."""
from repro_torch.configs.registry import ARCHS, get_config  # noqa: F401
