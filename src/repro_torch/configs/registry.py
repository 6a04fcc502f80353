"""--arch registry: name -> (full config, smoke config)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "granite-34b": "granite_34b",
    "llama3-405b": "llama3_405b",
    "qwen2-0.5b": "qwen2_0_5b",
    "minicpm3-4b": "minicpm3_4b",
    "chameleon-34b": "chameleon_34b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-780m": "mamba2_780m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "musicgen-medium": "musicgen_medium",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cells() -> list[tuple[str, str]]:
    """All 40 (arch, shape) dry-run cells. long_500k on full-attention archs
    is marked by runnable_cell() as skipped (see DESIGN.md §5)."""
    return [(a, s) for a in _MODULES for s in SHAPES]


def runnable_cell(arch: str, shape: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    sh = get_shape(shape)
    if sh.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch; 500k dense decode "
                       "needs sub-quadratic attention (DESIGN.md §5)")
    return True, ""
