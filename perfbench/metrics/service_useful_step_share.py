"""``service.useful_step_share.<split>``: over the traced rounds, Σ
``FrameDiagnostics.iterations`` of the registered frames over (registering
lanes x the round's loop steps, its slowest lane's iterations): the waste
of a round waiting on its slowest lane. Layer: the service
(``serve/registration_service.py``)."""
from perfbench.metrics._split import matches


def read(trace, name: str):
    if not matches(trace, name) or trace.counters.get("split") != "fleet":
        return None
    c = trace.counters
    return c["lane_iterations"] / c["lane_steps"] if c["lane_steps"] else None
