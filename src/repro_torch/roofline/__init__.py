"""Roofline terms of a step (port of ``repro.roofline``; its HLO parser
has no counterpart: PyTorch produces no HLO, see ``report``)."""
from repro_torch.roofline.report import (H100, RooflineTerms, StepCost,
                                         count_collectives, model_flops,
                                         record_collective, roofline_terms)

__all__ = ["H100", "RooflineTerms", "StepCost", "count_collectives",
           "model_flops", "record_collective", "roofline_terms"]
