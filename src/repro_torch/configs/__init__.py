"""Assigned architecture configs + registry (--arch lookup): data copies of
the JAX package's ``configs``, so ``get_config``/``get_smoke``/
``list_archs`` answer for every arch. The port's model builds the dense
block kinds (``attn``, ``local_attn``); the others raise
``NotImplementedError`` from ``repro_torch.models.lm``."""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.registry import get_config, get_smoke, list_archs

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_config", "get_smoke",
           "list_archs"]
