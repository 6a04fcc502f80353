"""Abstract inputs of every step kind (port of ``repro.launch.specs``).

``batch_specs`` gives ``meta`` tensors, the counterpart of the reference's
``ShapeDtypeStruct``s: shapes and dtypes, nothing allocated. The dry-run
runs the step on them; a training loop builds real tensors of the same
shapes.
[audio]/[vlm] archs take precomputed frame/patch embeddings from the
modality frontend instead of token ids.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import batch_axes_for
from repro_torch.launch.partition import ShardSpec, map_names


def _abstract(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig):
    """Abstract inputs for the step kind. Returns (dict of meta tensors,
    dict of logical axes naming their dims)."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        if cfg.embed_inputs:
            specs = {"tokens": _abstract((b, s), i32),
                     "labels": _abstract((b, s), i32)}
            axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        else:
            specs = {"embeds": _abstract((b, s, cfg.d_model), bf16),
                     "labels": _abstract((b, s), i32)}
            axes = {"embeds": ("batch", "seq", None),
                    "labels": ("batch", "seq")}
        return specs, axes
    if shape.kind == "prefill":
        if cfg.embed_inputs:
            return ({"tokens": _abstract((b, s), i32)},
                    {"tokens": ("batch", "seq")})
        return ({"embeds": _abstract((b, s, cfg.d_model), bf16)},
                {"embeds": ("batch", "seq", None)})
    if shape.kind == "decode":
        if cfg.embed_inputs:
            return ({"token": _abstract((b,), i32), "pos": _abstract((), i32)},
                    {"token": ("batch",), "pos": ()})
        return ({"embed": _abstract((b, cfg.d_model), bf16),
                 "pos": _abstract((), i32)},
                {"embed": ("batch", None), "pos": ()})
    raise ValueError(shape.kind)


def resolve_batch_rules(mesh, shape: ShapeConfig) -> dict:
    """Per-shape logical rules: batch axes chosen by divisibility."""
    return {"batch": batch_axes_for(mesh, shape.global_batch)}


def sharding_for_axes(mesh, axes, rules: dict):
    """A tree of logical axes as :class:`ShardSpec`s under ``rules`` (axes
    the mesh lacks dropped; no divisibility check, as in the reference)."""
    def one(names, _leaf):
        specs = []
        for n in names:
            v = rules.get(n) if n else None
            if v is None:
                specs.append(None)
            else:
                cand = (v,) if isinstance(v, str) else tuple(
                    a for a in v if a in mesh.axis_names)
                specs.append(cand if cand else None)
        return ShardSpec(mesh, tuple(specs))
    return map_names(one, axes)
