"""``nn_search_roofline.<split>``: the least time the work given to
the brute-force NN kernel needs on an H100, over the kernel's device time
in the trace, in %.

The work is counted from the valid rows the launches were given, not from
the kernel's layout: 8 FLOP (4 FMA) for each pair of a valid query and a
valid target, and one add a query, at the fp32 peak outside the tensor
cores; each valid input point read once (3 fp32) and each query's index
and distance written once, at the HBM peak. A launch's least time is the
larger of the two; lanes masked dead count no work. Layer: the kernels
(``kernels/nn_search.py``, ``kernels/csrc/nn_search.cu``).
"""
import sys

from perfbench.metrics._split import matches

KERNEL_NAMES = ("nn_search_kernel",)   # substrings of the device kernel's name
PEAK_FLOPS = 67e12     # H100 SXM fp32, outside the tensor cores (FLOP/s)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 (B/s)


def least_seconds(pairs: int, queries: int, targets: int) -> float:
    """The least time of one launch's work on an H100."""
    flops = 8.0 * pairs + queries
    nbytes = 12.0 * (queries + targets) + 8.0 * queries
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def read(trace, name: str):
    if not matches(trace, name) or "nn_work" not in trace.counters:
        return None
    kernels = [k for k in trace.kernels()
               if any(s in k[2] for s in KERNEL_NAMES)]
    work = trace.counters["nn_work"]
    if not kernels or not work:
        return None
    if len(kernels) != len(work):
        print(f"{name}: {len(kernels)} NN kernels in the trace, {len(work)} "
              f"launches counted; not read", file=sys.stderr)
        return None
    device_s = sum(b - a for a, b, _ in kernels) / 1e9
    return 100.0 * sum(least_seconds(*w) for w in work) / device_s
