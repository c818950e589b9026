"""Optimizers and schedules of the training path, as `repro.optim` has
them: functional `init`/`update` over the parameter tree."""
from repro_torch.optim.adafactor import adafactor  # noqa: F401
from repro_torch.optim.adamw import adamw  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401


def get_optimizer(name: str, **kw):
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise KeyError(name)
