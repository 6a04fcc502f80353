"""Port vs reference: the sensor-fault injectors.

``repro_torch.data.corruption`` is a copy of ``repro.data.corruption``
(numpy only). Every injector and ``apply_faults`` on combined specs get the
same seeded numpy cloud on both sides; points and masks must be equal
(``np.array_equal``, NaN rows equal to NaN rows), parse errors must raise
the same types.
"""
import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401

from repro.data import corruption as jc
from repro_torch.data import corruption as tc

SEEDS = (0, 7, 123)
INJECTORS = (
    ("sector_occlusion", {}),
    ("sector_occlusion", {"width_deg": 45.0, "center_deg": 30.0}),
    ("random_dropout", {"frac": 0.4}),
    ("low_overlap_crop", {"keep_frac": 0.3}),
    ("frame_drop", {}),
    ("range_noise", {}),
    ("range_noise", {"std": 0.1, "heavy_tail": True, "df": 3.0}),
    ("ghost_points", {"count": 64}),
    ("duplicate_points", {"count": 32}),
    ("inject_nonfinite", {"count": 12, "inf_frac": 0.5}),
)
SPECS = ("dropout:0.3,occlusion:90deg,nan:10",
         "crop:0.4,noise:0.05m,ghost:64",
         "tnoise:0.2,dup:16,drop",
         "crop:0.15")


def _cloud(seed, n=500):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20.0, 20.0, (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.9
    return pts, valid


def _assert_same(out_t, out_j):
    (pt, vt), (pj, vj) = out_t, out_j
    assert pt.dtype == pj.dtype and vt.dtype == vj.dtype
    assert np.array_equal(pt, pj, equal_nan=True)
    assert np.array_equal(vt, vj)


def test_constants_match_reference():
    assert tc.FAULT_NAMES == jc.FAULT_NAMES
    assert tc.PAD_SENTINEL == jc.PAD_SENTINEL


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,kwargs", INJECTORS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(INJECTORS)])
def test_injector_bit_identical(name, kwargs, seed):
    pts, valid = _cloud(seed)
    for v in (valid, None):
        _assert_same(getattr(tc, name)(pts, v, seed=seed, **kwargs),
                     getattr(jc, name)(pts, v, seed=seed, **kwargs))


@pytest.mark.parametrize("name", ["duplicate_points", "inject_nonfinite"])
def test_injector_on_all_invalid_cloud(name):
    pts, _ = _cloud(3, n=64)
    valid = np.zeros(64, bool)
    _assert_same(getattr(tc, name)(pts, valid, seed=1),
                 getattr(jc, name)(pts, valid, seed=1))


@pytest.mark.parametrize("spec", SPECS)
def test_apply_faults_bit_identical(spec):
    for seed in SEEDS:
        pts, valid = _cloud(seed)
        for frame in (0, 5):
            _assert_same(
                tc.apply_faults(pts, spec, seed=seed, frame=frame,
                                valid=valid),
                jc.apply_faults(pts, spec, seed=seed, frame=frame,
                                valid=valid))


def test_parse_and_seed_match_reference():
    for spec in SPECS:
        parsed_t, parsed_j = tc.parse_fault_spec(spec), \
            jc.parse_fault_spec(spec)
        assert [(f.name, f.fn.__name__, f.kwargs) for f in parsed_t] == \
            [(f.name, f.fn.__name__, f.kwargs) for f in parsed_j]
        # already-parsed specs pass through
        assert tc.parse_fault_spec(parsed_t) == parsed_t
    for seed, frame, name in ((0, 0, "crop"), (7, 3, "nan"),
                              (2 ** 31, 99, "dropout")):
        assert tc.fault_seed(seed, frame, name) == \
            jc.fault_seed(seed, frame, name)


@pytest.mark.parametrize("spec", ["bogus:1", "dropout:abc", "ghost:1.5x"])
def test_parse_errors_raise_the_same_type(spec):
    with pytest.raises(Exception) as et:
        tc.parse_fault_spec(spec)
    with pytest.raises(Exception) as ej:
        jc.parse_fault_spec(spec)
    assert et.type is ej.type
