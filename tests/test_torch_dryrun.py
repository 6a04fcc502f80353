"""Slice 12 of the port against the reference, on the CPU: the dry-run
(``launch/dryrun.py``) and the roofline report (``roofline/report.py``).

The reference's dry-run regressions (``tests/test_dryrun_cell.py``) lower
and compile its cells on 256 / 512 forced host devices; the port runs the
same two cells on a production mesh of ``meta`` devices, in this process
(seconds). The per-device argument bytes must be the sum of the bytes of
the reference's ``NamedSharding.shard_shape`` blocks of its params, cache
and inputs on ``jax.sharding.AbstractMesh`` under the same rules, and
``model_flops`` the reference's for every cell. The FLOPs the port counts
over a dense prefill of 2 x 64 tokens (no long attention) must come
within 5% of 2·N_active·T, its vocabulary projection counted at the last
position only. Also the reference's ``test_roofline_model.py``
cases on the port's ``report.py`` and a failing cell's record.
"""
import json

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import dryrun as jdryrun
from repro.launch.partition import param_sharding as jparam_sharding
from repro.launch.specs import batch_specs as jbatch_specs
from repro.launch.specs import sharding_for_axes as jsharding_for_axes
from repro.models import lm as jlm
from repro.roofline.report import model_flops as jmodel_flops
from repro_torch.configs import (SHAPES, ShapeConfig, get_config,
                                 get_smoke, list_archs)
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.roofline.report import (FlopCounter, RooflineTerms,
                                         StepCost, model_flops,
                                         roofline_terms)

FLOPS_RTOL = 0.05


def _ref_bytes(shardings, abstract):
    total = 0
    for sh, leaf in zip(jax.tree_util.tree_leaves(shardings),
                        jax.tree_util.tree_leaves(abstract)):
        total += int(np.prod(sh.shard_shape(leaf.shape))) * leaf.dtype.itemsize
    return total


def test_decode_cell_on_meta(tmp_path):
    rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", "single", tmp_path)
    assert rec == json.loads((tmp_path / "qwen2-0.5b__decode_32k__single.json"
                              ).read_text())
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 256
    mem = rec["memory"]
    assert mem["temp_bytes"] > 0
    assert mem["fits_h100_80g"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                    < 80e9)
    assert mem["fits_h100_80g"]
    r = rec["roofline"]
    assert r["dominant"] == "memory"          # decode is memory-bound
    assert 0 < r["memory_s"] < 10
    assert rec["analyzed"]["collective_bytes"] == 0
    # the reference's per-device argument bytes on AbstractMesh
    cfg, shape = jget_config("qwen2-0.5b"), JSHAPES["decode_32k"]
    mesh = AbstractMesh((16, 16), ("data", "model"))
    rules = jdryrun._rules_for(mesh, shape.global_batch, None, cfg)
    params = jlm.init_abstract(cfg)
    cache = jax.eval_shape(lambda: jlm.init_cache(cfg, shape.global_batch,
                                                  shape.seq_len))
    specs, axes = jbatch_specs(cfg, shape)
    want = (_ref_bytes(jparam_sharding(jlm.param_logical_axes(params), mesh,
                                       rules, params), params)
            + _ref_bytes(jparam_sharding(jlm.cache_logical_axes(cache), mesh,
                                         rules, cache), cache)
            + _ref_bytes(jsharding_for_axes(mesh, axes, rules), specs))
    assert rec["memory"]["argument_bytes"] == want


def test_icp_cell_on_meta(tmp_path):
    rec = dryrun.run_cell("fpps-icp", "fleet_130k", "multi", tmp_path)
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 512            # the pod axis shards
    assert rec["sharding"]["frame_axes"] == ["pod", "data"]
    assert rec["sharding"]["target_axes"] == ["model"]
    spec = dryrun.ICP_SHAPES["fleet_130k"]
    f, n, m = spec["frames"], spec["n_src"], spec["m_dst"]
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    src = jax.ShapeDtypeStruct((f, n, 3), np.float32)
    dst = jax.ShapeDtypeStruct((f, m, 3), np.float32)
    want = (_ref_bytes([NamedSharding(mesh, P(("pod", "data")))], [src])
            + _ref_bytes([NamedSharding(mesh, P(("pod", "data"),
                                                ("model",)))], [dst]))
    assert rec["memory"]["argument_bytes"] == want
    # the NN kernel's four-term product: 8 FLOPs a (query, target) pair
    # against the useful 6 of the xyz cross-term
    r = rec["roofline"]
    assert r["useful_fraction"] == pytest.approx(0.75)
    assert r["model_flops_per_device"] == pytest.approx(
        spec["iters"] * f * 6.0 * n * m / 512)


def test_model_flops_match_reference():
    for arch in list_archs():
        for name in SHAPES:
            for n_dev in (256, 512):
                assert model_flops(get_config(arch), SHAPES[name], n_dev) \
                    == jmodel_flops(jget_config(arch), JSHAPES[name], n_dev)


def test_counted_flops_of_a_dense_prefill():
    """2 x 64 tokens of qwen2-0.5b: the counted FLOPs within 5% of
    2·N_active·T, but for the (tied) vocabulary projection, which the
    prefill, as the reference's, runs at the last position only: 2·V·d·B
    (measured 0.7% above: the attention scores)."""
    cfg = get_config("qwen2-0.5b")
    b, s = 2, 64
    shape = ShapeConfig("prefill_64", s, b, "prefill")
    rec = dryrun._run_lm_cell("qwen2-0.5b", shape, "single")
    counted = rec["analyzed"]["flops"] * rec["n_devices"]
    head = cfg.vocab_size * cfg.d_model
    want = 2.0 * (cfg.active_params() - head) * b * s + 2.0 * head * b
    assert abs(counted / want - 1) < FLOPS_RTOL, counted / want


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-moe-16b",
                                  "mamba2-780m", "minicpm3-4b"])
def test_flop_counter_matches_flop_counter_mode(arch):
    """``FlopCounter`` (no decompositions) counts what ``FlopCounterMode``
    counts over a smoke model's loss and backward on ``meta``."""
    cfg = get_smoke(arch)
    model = lm.init_abstract(cfg)
    batch = {"tokens": torch.empty((2, 16), dtype=torch.int32,
                                   device="meta"),
             "labels": torch.empty((2, 16), dtype=torch.int32,
                                   device="meta")}
    with FlopCounterMode(display=False) as want:
        lm.loss_fn(model, cfg, batch)[0].backward()
    with FlopCounter() as got:
        lm.loss_fn(model, cfg, batch)[0].backward()
    assert got.flops == want.get_total_flops() > 0


def test_flop_counter_peak_bytes():
    """``peak_bytes``: the most bytes that ops within the block created and
    held at once; views and in-place results add nothing, and a freed
    storage leaves the count."""
    a = torch.empty(1000, device="meta")
    with FlopCounter() as c:
        b = a * 2
        x = b + 1
        assert c.live_bytes == c.peak_bytes == 8000
        del b
        assert c.live_bytes == 4000
        x.view(10, 100).add_(1)
        a[:10].mul_(3)
        y = x * 3
    assert (c.live_bytes, c.peak_bytes) == (8000, 8000)
    del x, y
    assert c.live_bytes == 0


def test_cell_that_does_not_fit():
    """qwen2-0.5b's prefill of 262,144 x 1,024 tokens on 256 devices: its
    arguments are 0.1 GB a device, but the eager step's working memory is
    ~101 GB a device (its 2^28 tokens' activations), so it does not fit."""
    shape = ShapeConfig("prefill_256k_x_1k", 1024, 262144, "prefill")
    mem = dryrun._run_lm_cell("qwen2-0.5b", shape, "single")["memory"]
    assert mem["argument_bytes"] < 1e9 < 80e9 < mem["temp_bytes"]
    assert not mem["fits_h100_80g"]


def test_model_flops_definitions():
    cfg = get_config("deepseek-moe-16b")
    train = model_flops(cfg, SHAPES["train_4k"], 256)
    decode = model_flops(cfg, SHAPES["decode_32k"], 256)
    assert train / decode == (6 * 256 * 4096) / (2 * 128)


def test_roofline_terms_dominance():
    cost = StepCost(flops=1e15, hbm_bytes=1e9, collective_bytes=1e9)
    t = roofline_terms(cost, None, None, 1, model_flops_override=5e14)
    assert isinstance(t, RooflineTerms)
    assert t.dominant == "compute"
    assert abs(t.useful_fraction - 0.5) < 1e-9
    cost = StepCost(flops=1e12, hbm_bytes=1e13, collective_bytes=1e9)
    t = roofline_terms(cost, None, None, 1, model_flops_override=1e12)
    assert t.dominant == "memory"
    cost = StepCost(flops=1e9, hbm_bytes=1e9, collective_bytes=1e13)
    assert roofline_terms(cost, None, None, 1,
                          model_flops_override=1e9).dominant == "collective"


def test_failing_cell_is_recorded(tmp_path):
    """A train cell whose accumulation depth does not split the batch: the
    step raises, and the record says so."""
    rec = dryrun.run_cell("qwen2-0.5b", "train_4k", "single", tmp_path,
                          accum=3)
    assert rec["status"] == "error"
    assert "does not split" in rec["error"]
    assert "Traceback" in rec["traceback"]
    saved = json.loads((tmp_path / "qwen2-0.5b__train_4k__single.json"
                        ).read_text())
    assert saved["status"] == "error"
