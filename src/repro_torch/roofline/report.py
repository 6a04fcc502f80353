"""Three-term roofline of one step (port of ``repro.roofline.report``).

Hardware model: one NVIDIA H100 SXM 80GB HBM3 at 700 W, the card the port
runs on: 989 TFLOP/s dense bf16, 3.35 TB/s HBM, 450 GB/s of NVLink each
way, 80 GB.

Terms (seconds, per step, per device):
  compute    = FLOPs / 989e12
  memory     = HBM bytes / 3.35e12
  collective = collective bytes / 450e9
The dominant term approximates step time under perfect overlap; the ratio
MODEL_FLOPS / counted FLOPs flags remat and redundancy.

The reference reads its cost from XLA's post-SPMD HLO
(``roofline.hlo_analysis``, ``roofline.breakdown``). PyTorch produces no
HLO, so those two modules have no counterpart; the port's cost is a
:class:`StepCost` that ``launch.dryrun`` fills: FLOPs counted by
:class:`FlopCounter` (``torch.utils.flop_counter``'s rules) over the step
run on ``meta`` tensors (divided over the devices), HBM bytes the
per-device bytes of the step's arguments and outputs, and collective bytes
those the port's explicit collectives record here (``record_collective``:
the expert-parallel all-to-alls, the compressed gradient reduce), 0 where
the step runs none.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd

H100 = {
    "name": "NVIDIA H100 80GB HBM3, 700 W",
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "nvlink_bw_per_direction": 450e9,
    "hbm_bytes": 80e9,
}

_COUNTERS: list[dict] = []


def record_collective(kind: str, nbytes: int) -> None:
    """Add ``nbytes`` moved by one collective of ``kind`` to every active
    :func:`count_collectives` block (a no-op outside one)."""
    for detail in _COUNTERS:
        d = detail.setdefault(kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += int(nbytes)


@contextlib.contextmanager
def count_collectives():
    """Yields a dict ``kind -> {"count", "bytes"}`` of the collectives
    recorded within the block (summed over the mesh's devices)."""
    detail: dict = {}
    _COUNTERS.append(detail)
    try:
        yield detail
    finally:
        _COUNTERS.remove(detail)


class FlopCounter(TorchDispatchMode):
    """Counts the FLOPs of the products ``FlopCounterMode`` knows (its
    ``flop_registry``: mm, addmm, bmm, baddbmm, convolutions, attention)
    in ``flops`` while the block runs. Unlike ``FlopCounterMode`` it does
    not decompose every other op into primitives to look for products
    inside (the models reach the dispatcher with their products already
    ``mm`` / ``bmm``), so a step on ``meta`` tensors runs their C++ meta
    kernels: ~20x faster on the expert-parallel layers' 256 device
    blocks.

    It also keeps ``peak_bytes``, the peak of the bytes held by the
    storages that ops within the block create (activations, the tensors
    autograd saves, gradients, outputs), each counted from its creation
    until its storage is freed: the eager step's working memory beyond
    the tensors it was given. Views and in-place results add nothing."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: set = set()

    def _free(self, key: int, nbytes: int) -> None:
        self._live.discard(key)
        self.live_bytes -= nbytes

    def _track(self, out, args, kwargs) -> None:
        inputs = None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            if inputs is None:
                inputs = {a.untyped_storage()._cdata
                          for a in tree_leaves((args, kwargs))
                          if isinstance(a, torch.Tensor)}
            if key in inputs:  # a view or in-place result of an input
                continue
            nbytes = st.nbytes()
            self._live.add(key)
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), _COMPOSITE):
            # a composite op that reaches the mode whole (under
            # inference_mode): its C++ decomposition, whose products come
            # back here
            with self:
                return func._op_dk(_COMPOSITE, *args, **kwargs)
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        self._track(out, args, kwargs)
        return out


@dataclasses.dataclass
class StepCost:
    """Per-device cost of a step: the fields ``roofline_terms`` reads."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_device: float
    analyzed_flops_per_device: float
    useful_fraction: float      # MODEL_FLOPS / analyzed
    roofline_fraction: float    # compute_s / max(term)  (MFU-vs-bound proxy)
    step_time_s: float          # max of terms (perfect-overlap bound)

    def to_json(self):
        return dataclasses.asdict(self)


def model_flops(cfg, shape, n_devices: int) -> float:
    """Useful FLOPs per step per device: 6·N_active·D train, 2·N_active·D
    inference (D = tokens processed per step)."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        total = 2.0 * n_active * tokens
    return total / n_devices


def roofline_terms(cost: StepCost, cfg, shape, n_devices: int,
                   model_flops_override: float | None = None
                   ) -> RooflineTerms:
    compute_s = cost.flops / H100["peak_flops_bf16"]
    memory_s = cost.hbm_bytes / H100["hbm_bw"]
    collective_s = cost.collective_bytes / H100["nvlink_bw_per_direction"]
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    if model_flops_override is not None:
        mf = model_flops_override
    else:
        if cfg is None or shape is None:
            raise ValueError("model_flops needs cfg and shape (or "
                             "model_flops_override)")
        mf = model_flops(cfg, shape, n_devices)
    step = max(terms.values())
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops_per_device=mf,
        analyzed_flops_per_device=cost.flops,
        useful_fraction=mf / cost.flops if cost.flops else 0.0,
        roofline_fraction=((mf / H100["peak_flops_bf16"]) / step
                           if step else 0.0),
        step_time_s=step)
