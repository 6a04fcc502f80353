"""The NN search's roofline count at hand-computed shapes, and its
reader."""
import pytest
from perfbench import harness
from perfbench.metrics import nn_search_roofline as roof


def test_least_time_at_the_papers_shape():
    # 8 FLOP x 4096 x 131,072 at 67 TFLOP/s: compute-bound, 0.0641 ms
    assert roof.least_seconds(4096 * 131072, 4096, 131072) * 1e3 == \
        pytest.approx(0.0641, abs=5e-5)
    flops = 8.0 * 4096 * 131072 + 4096
    assert roof.least_seconds(4096 * 131072, 4096, 131072) == \
        pytest.approx(flops / 67e12, rel=1e-12)


def test_least_time_is_the_byte_bound_when_work_is_thin():
    # one query against many targets: reading the targets bounds it
    nbytes = 12.0 * (1 + 10_000_000) + 8.0
    assert roof.least_seconds(10_000_000, 1, 10_000_000) == \
        pytest.approx(nbytes / 3.35e12, rel=1e-12)


def _trace(kernel_ns, work, split="pairs"):
    device = [(i * 10**7, i * 10**7 + ns, "(anonymous namespace)::"
               "nn_search_kernel(float const*)") for i, ns in
              enumerate(kernel_ns)]
    device.append((0, 5, "void at::native::reduce_kernel"))
    return harness.Trace((0, 10**9), device, [], [],
                         {"split": split, "nn_work": work, "loop_steps": 2})


def test_reader_divides_least_time_by_kernel_time():
    w = (4096 * 131072, 4096, 131072)
    t = _trace([128_200, 128_200], [w, w])   # 2 x 0.1282 ms
    share = roof.read(t, "nn_search_roofline.pairs")
    assert share == pytest.approx(100 * 0.0641 / 0.1282, rel=1e-3)


def test_dead_lanes_count_no_work():
    live = (4096 * 131072, 4096, 131072)
    # a second lane masked dead adds nothing to the launch's work
    assert roof.least_seconds(*live) == roof.least_seconds(
        live[0] + 0 * 131072, live[1] + 0, live[2] + 0)


def test_reader_reads_nothing_without_kernels_or_other_split():
    w = (1, 1, 1)
    assert roof.read(_trace([], [w]), "nn_search_roofline.pairs") \
        is None
    assert roof.read(_trace([100], [w], split="fleet"),
                     "nn_search_roofline.pairs") is None
    # a launch count that disagrees with the trace is not read
    assert roof.read(_trace([100, 100], [w]),
                     "nn_search_roofline.pairs") is None
