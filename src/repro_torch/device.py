"""Device resolution, tile arithmetic and card timing shared by the port.

The JAX package resolves a tri-state ``interpret`` flag per kernel
(``repro.kernels.common.default_interpret``). The port has no such switch:
the device of the tensor decides. A kernel wrapper handed a CPU tensor runs
its plain PyTorch version; handed a CUDA tensor it launches the kernel or
raises. What remains here is the one place that turns a caller's
``device=`` into a ``torch.device``, and it never falls back: asking for
CUDA on a machine without it is an error, not a quiet move to the CPU.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` when a CUDA device is asked for and PyTorch
    sees none, and ``ValueError`` when its index is beyond
    ``torch.cuda.device_count()``; tests and CPU users pass
    ``device="cpu"`` explicitly. ``"meta"`` (shapes only: the dry-run's
    devices) is accepted too.
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
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         "'cpu'")
    return dev


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of ``mult`` that is >= ``x`` (tile padding)."""
    return x + (-x) % mult


def check_fp32_matmul(t: torch.Tensor) -> None:
    """Raise if fp32 matmuls on ``t``'s device would run in TF32, which
    keeps about three decimal digits: it mis-ranks neighbours, MoE experts
    and MLA's absorbed decode scores."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "these fp32 products need IEEE fp32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (first
    card); every timing is kept beside it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_CYCLES_PER_MS: list[float] = []


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card, measured
    once."""
    if not _CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 10)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def device_ms(fn, reps: int = 20, blocks: int = 5, warmup: int = 3):
    """Device time of one call of ``fn`` on the current CUDA device:
    ``(median, min, max, ahead)`` in ms over ``blocks`` blocks, each the
    CUDA-event time of ``reps`` back-to-back calls divided by ``reps``.

    Each block is queued behind a busy-wait kernel (``torch.cuda._sleep``)
    sized to twice the host's time for ``reps`` calls, so the host has
    enqueued every call before the first one starts and the window holds
    device time only, not the wrappers' host overhead. If the first block's
    start event fired before the host finished enqueueing, it is retried
    twice with a doubled wait; if it never got ahead, ``fn`` syncs the host
    inside (a plain version that copies a scalar to the card), no wait can
    help, and the remaining blocks run without one: ``ahead`` is then False
    and the time includes those host gaps.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(_sleep_cycles_per_ms() * (2.0 * reps * host_ms + 0.5))
    times, ahead = [], True
    for block in range(blocks):
        for _attempt in range(3 if block == 0 else 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if ahead:
                torch.cuda._sleep(cycles)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            got_ahead = not start.query()
            end.synchronize()
            if got_ahead or not ahead:
                break
            cycles *= 2
        ahead = ahead and got_ahead
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), min(times), max(times), ahead
