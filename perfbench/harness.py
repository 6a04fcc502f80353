"""What every cell's run shares: finding a cell, its configuration, its
traffic mix, its driver and its per-layer metric readers by name; the
trace of a window and its reduction to device time; the checks that
decide ``correct``; the result line; the import guard.

Everything is found by name, so a later cell, configuration, mix or
metric is a new file and an entry in ``BENCHMARK.json``, never an edit:

  * a cell: ``perfbench/workloads/<cell>.json``
  * a configuration: ``perfbench/configs/<config>.json``, whose
    ``driver`` names ``perfbench/drivers/<driver>.py``
  * a traffic mix: ``perfbench/traffic/mixes/<traffic>.json``
  * a per-layer metric: ``perfbench/metrics/<family>.py`` with a
    ``read(trace) -> float | None``, where the family is the metric's name,
    or its name without the part after the last dot (the cell's split, as
    in ``icp.launches_per_step.pairs``), dots written as ``_``.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import pathlib
import sys
import time
from typing import NamedTuple

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# -- registry -----------------------------------------------------------------

def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic/mixes", name)


def _load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    """The driver module ``perfbench/drivers/<name>.py``."""
    path = HERE / "drivers" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no driver named {name!r} ({path} is missing)")
    return _load_module(path, f"perfbench.drivers.{name}")


def metric_file(name: str) -> pathlib.Path:
    """The reader file of per-layer metric ``name``."""
    candidates = [name] + ([name.rsplit(".", 1)[0]] if "." in name else [])
    for family in candidates:
        path = HERE / "metrics" / (family.replace(".", "_") + ".py")
        if path.is_file():
            return path
    raise KeyError(f"no reader for metric {name!r} under {HERE / 'metrics'}")


def metric_reader(name: str):
    path = metric_file(name)
    return _load_module(path, f"perfbench.metrics.{path.stem}").read


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


# -- checks -------------------------------------------------------------------

class Check(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # NaN fails


# -- trace --------------------------------------------------------------------

class Trace(NamedTuple):
    """A traced window, reduced: device intervals and host spans in
    nanoseconds of the wall clock, and the driver's counters."""
    window: tuple[int, int]        # host clock, ns
    device: list                   # [(start, end, name)] kernels and copies
    runtime: list                  # [(start, end, name)] CUDA runtime calls
    spans: list                    # [(start, end, name)] the driver's spans
    counters: dict

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> list:
        return [d for d in self.device
                if not d[2].startswith(("Memcpy", "Memset"))]


def union_ns(intervals) -> int:
    total, cur = 0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


class Tracer:
    """``torch.profiler`` over the device's activity alone (no per-op host
    records), plus the driver's own host spans, on the same wall clock.

    Use :meth:`warm` in set-up (the first profiler start takes seconds),
    then ``with tracer:`` around the window and :meth:`span` around the
    calls into each layer. With ``enabled=False`` every method is free."""

    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = enabled
        self.spans: list = []
        self._prof = None
        self.window = (0, 0)

    def warm(self) -> None:
        if self.enabled:
            with self._profile():
                self.torch.ones(1, device="cuda").sum()
                self.torch.cuda.synchronize()

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        if self.enabled:
            self.torch.cuda.synchronize()
            self._prof = self._profile()
            self._prof.__enter__()
            self.window = (time.time_ns(), 0)
        return self

    def __exit__(self, *exc):
        if self.enabled:
            self.torch.cuda.synchronize()
            self.window = (self.window[0], time.time_ns())
            self._prof.__exit__(*exc)
        return False

    def span(self, name: str):
        return _Span(self, name)

    def reduce(self, counters: dict) -> Trace:
        events = self._prof.profiler.kineto_results.events()
        lo, hi = self.window
        device, runtime = [], []
        for e in events:
            a = e.start_ns()
            b = a + e.duration_ns()
            if b < lo or a > hi:
                continue
            row = (max(a, lo), min(b, hi), e.name())
            if str(e.device_type()).endswith("CUDA"):
                device.append(row)
            elif e.name().startswith("cuda"):
                runtime.append(row)
        return Trace(self.window, device, runtime, list(self.spans), counters)


class _Span:
    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        if self.tracer.enabled:
            self.t0 = time.time_ns()

    def __exit__(self, *exc):
        if self.tracer.enabled:
            self.tracer.spans.append((self.t0, time.time_ns(), self.name))
        return False


class _Cover:
    """Which of a set of non-overlapping rows (start, end, name) covers a
    time: the last row that starts at or before it, if it has not ended."""

    def __init__(self, rows):
        self.rows = sorted(rows)
        self.starts = [r[0] for r in self.rows]

    def name(self, t: int) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.rows[i][1] >= t:
            return self.rows[i][2]
        return None


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of
    the device summed by what the host was doing: the driver's span (the
    drivers' spans do not nest) and the CUDA runtime call in progress."""
    per_op: dict = {}
    for a, b, name in trace.device:
        key = name[:120]
        per_op[key] = per_op.get(key, 0) + (b - a)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    spans, calls = _Cover(trace.spans), _Cover(trace.runtime)
    gaps: dict = {}
    cursor = trace.window[0]
    for a, b, _ in sorted(trace.device) + [(trace.window[1],) * 2 + ("",)]:
        if a > cursor:
            mid = (cursor + a) // 2
            call = calls.name(mid)
            key = ((spans.name(mid) or "outside spans")
                   + (f" / {call}" if call else ""))
            gaps[key] = gaps.get(key, 0) + (a - cursor)
        cursor = max(cursor, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v / 1e9] for k, v in ops],
            "idle_gaps": [[k, v / 1e9] for k, v in idle]}


# -- the run's end ------------------------------------------------------------

def forbidden_imports() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def device_info(torch, count: int, memory_peak: int | None,
                trace: Trace | None) -> dict:
    """The result line's ``device``: ``memory_peak`` is the reading taken
    as the window closed (``Context.read_memory_peak``)."""
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": memory_peak}
    if trace is not None:
        out["busy_s"] = union_ns((a, b) for a, b, _ in trace.device) / 1e9
        out["window_s"] = trace.window_s
    return out
