"""``icp.launches_per_step.<split>``: device kernels in the trace over the
ICP loop steps the window ran (one NN launch a step). A count that repeats
exactly; the Kabsch epilogue's eager launches are most of it. Layer: the
ICP loop and Kabsch epilogue (``core/icp.py``, ``core/svd3x3.py``,
``core/transform.py``)."""
from perfbench.metrics._split import matches


def read(trace, name: str):
    if not matches(trace, name):
        return None
    steps = trace.counters.get("loop_steps", 0)
    kernels = trace.kernels()
    return len(kernels) / steps if steps and kernels else None
