"""One run of one benchmark cell on the machine it is started on:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``perfbench/workloads/<cell>.json``)
names its configuration, traffic mix and chips; the configuration names
its driver (``perfbench/drivers``), which sets up, measures for
``--seconds`` and checks the answers against the plain reference. With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``perfbench/metrics``), read from a
device trace of the window.

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), ending with ``checks``: each number compared
with the reference, beside its limit; the same numbers are the last lines
of standard error. Exits non-zero, with no result, without as many CUDA
cards as the cell asks for, when the program cannot be imported, or when a
module of the JAX package or of JAX itself is loaded once the window has
closed.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from perfbench import harness


class Context:
    """What a driver gets: the run's arguments, its cell's configuration
    and mix, the tracer, and the calls that close the window."""

    def __init__(self, torch, seed: int, seconds: float, trace: bool,
                 config: dict, mix: dict, device: str, t_start: float,
                 control: bool = False):
        self.torch, self.seed = torch, seed
        self.seconds, self.config, self.mix = seconds, config, mix
        self.device, self.t_start, self.control = device, t_start, control
        self.tracer = harness.Tracer(torch, trace and device == "cuda")
        self.memory_peak = None

    def end_setup(self) -> float:
        """Close the set-up: warm the profiler (a traced run), wait for the
        device, and move every object set-up made out of the collector's
        way, so the window's collections do not walk them. Returns
        ``setup_s``."""
        self.tracer.warm()
        self.sync()
        gc.collect()
        gc.freeze()
        return time.perf_counter() - self.t_start

    def read_memory_peak(self) -> None:
        """The program's peak device memory, read as the window closes."""
        if self.device == "cuda":
            self.memory_peak = int(self.torch.cuda.max_memory_allocated())

    def sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def free(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.empty_cache()

    def finish_window(self, counters: dict):
        if not self.tracer.enabled:
            return None
        return self.tracer.reduce(counters)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             config: dict | None = None, mix: dict | None = None,
             control: bool = False) -> dict:
    """Run one cell and return its result (the driver's dict with the
    ``Context`` under ``context``). ``config`` and ``mix`` replace the
    cell's files (the tests' small sizes)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    # the configurations state fp32 products: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = harness.workload(cell)
    config = harness.config(w["config"]) if config is None else config
    mix = harness.traffic(w["traffic"]) if mix is None else mix
    ctx = Context(torch, seed, seconds, trace, config, mix, device, t_start,
                  control)
    out = harness.driver(config["driver"]).run(ctx)
    out["context"] = ctx
    return out


def result_line(cell: str, trace: bool, out: dict, bench: dict) -> dict:
    """The run's result object, ``checks`` last."""
    import torch
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in harness.cell_metrics(bench, cell, kind):
        if trace:
            value = harness.metric_reader(m["name"])(out["trace"], m["name"])
        else:
            value = out["metrics"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = harness.device_info(torch, harness.workload(cell)["chips"],
                                 out["context"].memory_peak, out["trace"])
    line = {"correct": (all(c.ok for c in out["checks"])
                        and out["failed"] == 0),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = harness.breakdown(out["trace"])
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out["checks"]}
    return line


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    chips = harness.workload(args.workload)["chips"]
    # one host thread for the math libraries: the program's host work is
    # small and serial, and idle pool threads only add noise to its pace
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(harness.ROOT / "src"))   # the program
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    bad = harness.forbidden_imports()
    if bad:
        print(f"perfbench: modules loaded that the benchmark may not load: "
              f"{bad}", file=sys.stderr)
        return 3
    line = result_line(args.workload, bool(args.trace), out, bench)
    for c in out["checks"]:
        print(f"check {c.name} = {c.value:.6g} (limit {c.limit:.6g}): "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
