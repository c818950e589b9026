"""Architecture registry: --arch <id> resolution for every launcher."""
from __future__ import annotations

from repro_torch.configs.arctic_480b import CONFIG as arctic_480b
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.llama3_8b import CONFIG as llama3_8b
from repro_torch.configs.mamba2_2_7b import CONFIG as mamba2_2_7b
from repro_torch.configs.mixtral_8x22b import CONFIG as mixtral_8x22b
from repro_torch.configs.nemotron_4_15b import CONFIG as nemotron_4_15b
from repro_torch.configs.phi4_mini_3_8b import CONFIG as phi4_mini_3_8b
from repro_torch.configs.qwen2_5_32b import CONFIG as qwen2_5_32b
from repro_torch.configs.qwen2_vl_72b import CONFIG as qwen2_vl_72b
from repro_torch.configs.whisper_tiny import CONFIG as whisper_tiny
from repro_torch.configs.zamba2_2_7b import CONFIG as zamba2_2_7b

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    phi4_mini_3_8b, llama3_8b, nemotron_4_15b, qwen2_5_32b,
    mamba2_2_7b, mixtral_8x22b, arctic_480b, zamba2_2_7b,
    qwen2_vl_72b, whisper_tiny,
]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(runnable, reason). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped " \
            "(DESIGN.md §5)"
    return True, ""


def all_cells():
    """Every (arch x shape) cell with its skip status — 40 total."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, reason = cell_is_runnable(arch, shape)
            yield arch, shape, ok, reason
