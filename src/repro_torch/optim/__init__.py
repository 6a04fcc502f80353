"""AdamW and Adafactor, the learning-rate schedule, and the int8
error-feedback data-parallel mean in ``optim.compression`` (port of
``repro.optim``)."""
from repro_torch.optim.optimizers import (OptState, Optimizer, adafactor,
                                          adamw, clip_by_global_norm,
                                          pick_optimizer)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["Optimizer", "OptState", "adamw", "adafactor", "pick_optimizer",
           "clip_by_global_norm", "cosine_schedule"]
