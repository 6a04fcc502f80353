"""Assigned architecture configs + registry (--arch lookup): data copies of
the JAX package's ``configs``, so ``get_config``/``get_smoke``/
``list_archs`` answer for every arch, and the port's model
(``repro_torch.models.lm``) builds each of them."""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.registry import get_config, get_smoke, list_archs

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_config", "get_smoke",
           "list_archs"]
