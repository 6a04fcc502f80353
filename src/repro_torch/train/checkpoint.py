"""Fault-tolerant checkpointing: atomic, async, keep-k (port of
``repro.train.checkpoint``).

The reference's on-disk layout, so a checkpoint of either package restores
in the other: ``step_%010d/`` holding ``arrays.npz`` (every leaf as a full
numpy array under its "::"-joined tree path) and ``manifest.json`` (step,
extra, each key's shape and dtype), written under ``step_%010d.tmp`` and
published by one atomic ``os.rename``. A port :class:`TrainState` is
stored in the reference's tree layout (``train_step.state_to_reference``:
``groups`` leaves stacked over repeats, the reference's key strings) and
restored through ``train_step.state_from_reference``; any other tree of
dicts, lists, tuples and NamedTuples of tensors or arrays is stored as it
is.

  * **Async save**: the tensors are fetched to the host synchronously,
    then serialised on a background thread so the step loop is not
    blocked on disk.
  * **keep_last_k**: bounded disk usage; the newest complete checkpoint is
    never deleted, and crashed ``.tmp`` writes are removed.
  * **Preemption hook**: ``install_preemption_handler`` saves on
    SIGTERM/SIGINT before re-raising.

The reference's elastic restore onto other shardings has no counterpart
on one device: ``restore`` places the leaves on ``device``.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import signal
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train import train_step as ts

_SEP = "::"


def _items(node):
    """(key, child) pairs of a tree node: a dict's sorted keys (JAX's
    flattening order), a NamedTuple's fields, a list's or tuple's
    indices; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(state) -> dict[str, np.ndarray]:
    """Every leaf under its "::"-joined path, as a host numpy array (a port
    ``TrainState`` in the reference's layout)."""
    if isinstance(state, ts.TrainState) and hasattr(state.params, "cfg"):
        state = ts.state_to_reference(state)
    out = {}

    def walk(node, path):
        items = _items(node)
        if items is None:
            out[_SEP.join(path)] = _host(node)
            return
        for key, child in items:
            walk(child, path + (key,))

    walk(state, ())
    return out


def save(path: str | os.PathLike, state, step: int,
         extra: dict | None = None) -> pathlib.Path:
    """Atomic synchronous save. Returns the final checkpoint dir."""
    root = pathlib.Path(path)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:010d}"
    tmp = root / f"step_{step:010d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = _flatten(state)
    manifest = {"step": step, "extra": extra or {},
                "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                         for k, v in arrays.items()}}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(path: str | os.PathLike) -> int | None:
    root = pathlib.Path(path)
    if not root.exists():
        return None
    steps = [int(m.group(1)) for p in root.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


def _unflatten(abstract, data, device, path=()):
    """``abstract``'s tree with each leaf read from ``data`` under its
    path and its shape checked: a tensor of the leaf's dtype on
    ``device``, or with ``device`` None the array as stored."""
    items = _items(abstract)
    if items is None:
        key = _SEP.join(path)
        arr = data[key]
        expect = tuple(abstract.shape)
        if tuple(arr.shape) != expect:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {expect}")
        if device is None:
            return arr
        return torch.from_numpy(np.array(arr)).to(device=device,
                                                  dtype=abstract.dtype)
    children = {key: _unflatten(child, data, device, path + (key,))
                for key, child in items}
    if isinstance(abstract, dict):
        return {k: children[str(k)] for k in abstract}
    if hasattr(abstract, "_fields"):
        return type(abstract)(**children)
    return type(abstract)(children[str(i)] for i in range(len(abstract)))


def restore(path: str | os.PathLike, abstract_state, step: int | None = None,
            device="cuda"):
    """Rebuild ``abstract_state``'s tree from disk on ``device`` (default
    ``"cuda"``; raises without a card): -> (state, step, extra). A port
    ``TrainState`` target (e.g. ``train_step.abstract_state``, on the meta
    device) is read in the reference's layout and rebuilt through
    ``train_step.state_from_reference``. A leaf whose shape differs from
    the target's raises ``ValueError``."""
    dev = resolve_device(device)
    root = pathlib.Path(path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    ckpt = root / f"step_{step:010d}"
    with np.load(ckpt / "arrays.npz") as data:
        if isinstance(abstract_state, ts.TrainState) and hasattr(
                abstract_state.params, "cfg"):
            tree = _unflatten(ts.state_to_reference(abstract_state), data,
                              None)
            state = ts.state_from_reference(tree, abstract_state.params.cfg,
                                            dev)
        else:
            state = _unflatten(abstract_state, data, dev)
    manifest = json.loads((ckpt / "manifest.json").read_text())
    return state, manifest["step"], manifest.get("extra", {})


class CheckpointManager:
    """Async keep-k manager with preemption handling."""

    def __init__(self, directory: str | os.PathLike, keep_last_k: int = 3,
                 save_interval_steps: int = 100):
        self.dir = pathlib.Path(directory)
        self.keep = keep_last_k
        self.interval = save_interval_steps
        self._thread: threading.Thread | None = None
        self._last_saved: int | None = latest_step(self.dir)

    def should_save(self, step: int) -> bool:
        return step % self.interval == 0

    def save_async(self, state, step: int, extra: dict | None = None):
        """Fetch to host now; serialise + publish on a worker thread."""
        self.wait()  # one in-flight save at a time
        host_state = _flatten(state)  # "::" keys: flattens to itself

        def work():
            save(self.dir, host_state, step, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        self._last_saved = step

    def save_sync(self, state, step: int, extra: dict | None = None):
        self.wait()
        save(self.dir, state, step, extra)
        self._last_saved = step
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, abstract_state, device="cuda"):
        self.wait()
        return restore(self.dir, abstract_state, device=device)

    def _gc(self):
        steps = sorted(int(m.group(1)) for p in self.dir.iterdir()
                       if (m := re.fullmatch(r"step_(\d+)", p.name)))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
        for p in self.dir.glob("step_*.tmp"):  # crashed partial writes
            shutil.rmtree(p, ignore_errors=True)


def install_preemption_handler(manager: CheckpointManager,
                               get_state: Callable[[], tuple[Any, int]]):
    """SIGTERM/SIGINT -> synchronous save -> re-raise default behaviour."""
    def handler(signum, frame):
        state, step = get_state()
        manager.save_sync(state, step, extra={"preempted": True})
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    return handler


class StragglerWatchdog:
    """Step-time EMA monitor: flags steps slower than ``threshold`` x the
    running mean (on a fleet this triggers a hot-spare swap or a
    checkpoint restart; here it logs and counts)."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1):
        self.threshold = threshold
        self.alpha = alpha
        self.ema: float | None = None
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, duration_s: float) -> bool:
        is_straggler = (self.ema is not None
                        and duration_s > self.threshold * self.ema)
        if is_straggler:
            self.flagged.append((step, duration_s))
        self.ema = (duration_s if self.ema is None
                    else (1 - self.alpha) * self.ema + self.alpha * duration_s)
        return is_straggler
