"""The shape of the result line."""
import json

import pytest
from perfbench import harness, run


class _Ctx:
    memory_peak = 123


class _FakeCuda:
    @staticmethod
    def get_device_name(i=0):
        return "NVIDIA H100 80GB HBM3"


class _FakeTorch:
    cuda = _FakeCuda()


def _out(ok=True, trace=None):
    return {"metrics": {"pairs_per_s": 80.5, "setup_s": 12.0},
            "attempted": 768, "failed": 0, "trace": trace,
            "checks": [harness.Check("pair_t_err_m",
                                     0.001 if ok else 0.5, 0.01)],
            "context": _Ctx()}


@pytest.fixture
def fake_torch(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "torch", _FakeTorch())


def test_untraced_line(fake_torch):
    line = run.result_line("pairs-hdl64-b128", False, _out(),
                           harness.benchmark())
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["metrics"] == {
        "setup_s": {"value": 12.0, "unit": "s"},
        "pairs_per_s": {"value": 80.5, "unit": "pairs/s"}}
    assert line["device"] == {"platform": "gpu",
                              "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    assert line["checks"] == {"pair_t_err_m": {"value": 0.001,
                                               "limit": 0.01}}
    json.dumps(line)


def test_a_failed_check_is_not_correct(fake_torch):
    line = run.result_line("pairs-hdl64-b128", False, _out(ok=False),
                           harness.benchmark())
    assert line["correct"] is False


def test_traced_line_has_per_layer_metrics_busy_window_and_breakdown(
        fake_torch):
    dev = [(0, 400, "(anonymous namespace)::nn_search_kernel(x)"),
           (600, 700, "Memcpy HtoD (Pageable -> Device)")]
    trace = harness.Trace(
        (0, 1000), dev, [(400, 600, "cudaLaunchKernel")],
        [(0, 1000, "register_pairs")],
        {"split": "pairs", "loop_steps": 1, "lane_iterations": 10,
         "lane_steps": 50, "nn_work": [(1000, 10, 100)]})
    line = run.result_line("pairs-hdl64-b128", True, _out(trace=trace),
                           harness.benchmark())
    m = line["metrics"]
    assert m["icp.useful_step_share.pairs"]["value"] == pytest.approx(0.2)
    assert m["icp.launches_per_step.pairs"]["value"] == 1
    assert m["device_idle_share.pairs"]["value"] == pytest.approx(50.0)
    assert "nn_search_roofline.pairs" in m
    assert line["device"]["busy_s"] == pytest.approx(500e-9)
    assert line["device"]["window_s"] == pytest.approx(1000e-9)
    assert line["breakdown"]["idle_gaps"] == [
        ["register_pairs / cudaLaunchKernel", pytest.approx(200e-9)],
        ["register_pairs", pytest.approx(300e-9)]] or \
        line["breakdown"]["idle_gaps"][0][0].startswith("register_pairs")
    assert len(line["breakdown"]["device_ops"]) == 2
    assert list(line)[-1] == "checks"
    json.dumps(line)
