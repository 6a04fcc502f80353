"""``device_idle_share.<split>``: 1 minus the union of the device's kernel
and copy intervals over the traced window's wall time, in %. Layer: the
device."""
from perfbench import harness
from perfbench.metrics._split import matches


def read(trace, name: str):
    if not matches(trace, name) or not trace.device:
        return None
    busy = harness.union_ns((a, b) for a, b, _ in trace.device) / 1e9
    return 100.0 * (1.0 - busy / trace.window_s)
