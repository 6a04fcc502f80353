"""Per-layer metric readers, one file a family, each ``read(trace, name)
-> float | None`` over a :class:`perfbench.harness.Trace`: ``None`` when
the trace holds nothing for it to read."""
