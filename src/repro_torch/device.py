"""Device resolution and tile arithmetic shared by the port.

The JAX package resolves a tri-state ``interpret`` flag per kernel
(``repro.kernels.common.default_interpret``). The port has no such switch:
the device of the tensor decides. A kernel wrapper handed a CPU tensor runs
its plain PyTorch version; handed a CUDA tensor it launches the kernel or
raises. What remains here is the one place that turns a caller's
``device=`` into a ``torch.device``, and it never falls back: asking for
CUDA on a machine without it is an error, not a quiet move to the CPU.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for and PyTorch
    sees none, and ``ValueError`` when its index is beyond
    ``torch.cuda.device_count()``; tests and CPU users pass
    ``device="cpu"`` explicitly.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type == "cuda" and dev.index is not None:
        count = torch.cuda.device_count()
        if dev.index >= count:
            raise ValueError(f"device {str(dev)!r} requested but this "
                             f"machine has {count} CUDA device(s)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         "'cpu'")
    return dev


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of ``mult`` that is >= ``x`` (tile padding)."""
    return x + (-x) % mult


def check_fp32_matmul(t: torch.Tensor) -> None:
    """Raise if fp32 matmuls on ``t``'s device would run in TF32, which
    keeps about three decimal digits and mis-ranks neighbours."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "exact NN search needs IEEE fp32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")
