"""The cell split a metric name ends with, and whether a trace is of it."""


def matches(trace, name: str) -> bool:
    """True when ``name`` ends with the split the trace's driver records
    (``pairs`` or ``fleet``)."""
    return trace is not None and name.rsplit(".", 1)[-1] == \
        trace.counters.get("split")
