"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

under ``build/`` at the repository root (listed in ``.gitignore``). The file
name carries a hash of the flags and sources, so an edited kernel is rebuilt
and a stale library is never loaded. :func:`build_all` starts one ``nvcc``
per source, all at once. Nothing here runs at import time: the CPU tests
import every module on machines without ``nvcc``.

:func:`kernel_attributes` reads what the compiler and the card give a built
kernel (registers, spills, shared memory, occupancy) through the query each
library exports (``csrc/kernel_attributes.cuh``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the "
                       "card")


def sources() -> dict[str, pathlib.Path]:
    """Kernel sources by name (``csrc/<name>.cu``)."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(sources()[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile the named sources (default: all) in parallel.

    Returns ``{name: nvcc's output}`` (ptxas's register and spill report;
    for a library already built from the same sources, the output saved
    beside it). Raises ``RuntimeError`` with the compiler's output if any
    build fails.
    """
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs: dict[str, str] = {}
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            saved = out.with_suffix(".log")
            logs[name] = saved.read_text() if saved.exists() else "cached"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: concurrent builds agree
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


# The order of csrc/kernel_attributes.cuh's out[].
ATTRIBUTES = ("registers", "local_bytes", "static_shared_bytes",
              "max_threads_per_block", "blocks_per_sm", "max_threads_per_sm")


def kernel_attributes(query, *, threads: int, device) -> dict:
    """A built kernel's resources on the card ``device``: ``query(out)``
    calls a library's ``fpps_*_attributes`` function (the library is loaded
    inside it, so nothing is built for another device), ``threads`` is the
    kernel's threads a block. Returns :data:`ATTRIBUTES` and ``occupancy``,
    the resident threads' share of the SM's most. Raises for a device other
    than CUDA: the numbers are the card's."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"kernel attributes are read on a CUDA device, not "
                         f"{dev}")
    out = (ctypes.c_int * len(ATTRIBUTES))()
    with torch.cuda.device(dev):
        err = query(out)
    if err != 0:
        raise RuntimeError(f"kernel attribute query failed: CUDA error {err}")
    attrs = dict(zip(ATTRIBUTES, out))
    attrs["occupancy"] = (attrs["blocks_per_sm"] * threads
                          / attrs["max_threads_per_sm"])
    return attrs
