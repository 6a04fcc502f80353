"""``icp.useful_step_share.<split>``: the loop steps that moved a lane
over the steps its lanes ran, Σ ``ICPResult.iterations`` over lanes x the
loop's steps (the fixed ``max_iterations`` of the batched loop). The rest
is the fixed-iteration loop's waste once lanes freeze. Layer: the ICP loop
(``core/icp.py`` under ``core/engine.py``)."""
from perfbench.metrics._split import matches


def read(trace, name: str):
    if not matches(trace, name) or trace.counters.get("split") != "pairs":
        return None
    c = trace.counters
    return c["lane_iterations"] / c["lane_steps"] if c["lane_steps"] else None
