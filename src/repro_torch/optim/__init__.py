"""AdamW and Adafactor, and the learning-rate schedule (port of
``repro.optim``; its ``compression`` waits for the data-parallel mesh,
ROADMAP queue 1 item 8.4)."""
from repro_torch.optim.optimizers import (OptState, Optimizer, adafactor,
                                          adamw, clip_by_global_norm,
                                          pick_optimizer)
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["Optimizer", "OptState", "adamw", "adafactor", "pick_optimizer",
           "clip_by_global_norm", "cosine_schedule"]
