"""Production and debug meshes (port of ``repro.launch.mesh``).

Functions, never module constants, as in the reference: importing this
module touches no device. A mesh is the port's ``core.distributed.Mesh``
(a named numpy grid of ``torch.device``); its entries may repeat
(``"cuda:0"`` eight times runs a (2, 4) mesh on one card) and may be
``meta`` devices, which hold shapes only: the dry-run's production meshes
of 256 and 512 devices are ``meta`` meshes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.distributed import Mesh


def _mesh(shape: tuple, axes: tuple, device) -> Mesh:
    """A ``shape`` grid of ``device`` (one device, repeated) or of the
    devices of a sequence of ``prod(shape)`` entries (row-major)."""
    size = int(np.prod(shape))
    if isinstance(device, (list, tuple)):
        if len(device) != size:
            raise ValueError(f"a {shape} mesh needs {size} devices, got "
                             f"{len(device)}")
        devices = list(device)
    else:
        devices = [device] * size
    grid = np.empty(size, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """Single pod: (16,16)=(data,model), 256 devices. Multi-pod:
    (2,16,16)=(pod,data,model), 512 devices; ``pod`` is the cross-pod
    dimension. ``device``: one device repeated over the grid (``"meta"``
    for the dry-run) or a sequence of 256 / 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_debug_mesh(shape=(2, 4), axes=("data", "model"), device="cuda"
                    ) -> Mesh:
    """Small mesh for tests and the smoke run (``device`` repeated, or a
    sequence of ``prod(shape)`` devices)."""
    return _mesh(tuple(shape), tuple(axes), device)


def batch_axes_for(mesh, global_batch: int):
    """Largest prefix of (pod, data) axes that divides the global batch.

    decode batch 1 (long_500k) -> () = replicated; batch 128 on the
    multi-pod mesh -> ("pod","data") = 32-way; etc."""
    candidates = [ax for ax in ("pod", "data") if ax in mesh.axis_names]
    chosen: list[str] = []
    size = 1
    for ax in candidates:
        ax_size = mesh.shape[ax]
        if global_batch % (size * ax_size) == 0:
            chosen.append(ax)
            size *= ax_size
    return tuple(chosen)
