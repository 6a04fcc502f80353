"""Slice 12 of the port against the reference, on the CPU: the partition
rules (``launch/{mesh,partition,specs}.py``), the LM's logical axes
(``lm.PARAM_RULES``, ``param_logical_axes``, ``cache_logical_axes``), the
optimizer-state axes and ``make_train_step(grad_shardings=)``.

The reference's ``param_sharding`` runs in this process on
``jax.sharding.AbstractMesh`` (no devices) for every arch at full width,
on the single-pod (16, 16) and the two-pod (2, 16, 16) production meshes,
under the dry-run's rules; every leaf's ``PartitionSpec`` and shard shape
must be the port's ``ShardSpec``'s (``spec``, ``shard_shape``) on the
port's production mesh of ``meta`` devices. Also the reference's
``tests/test_partition_rules.py`` cases on the port.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.launch import dryrun as jdryrun
from repro.launch.partition import param_sharding as jparam_sharding
from repro.models import lm as jlm
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.configs.registry import cells, get_shape, runnable_cell
from repro_torch.launch import dryrun, partition
from repro_torch.launch.mesh import (batch_axes_for, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.models import lm
from repro_torch.optim import adafactor, adamw, cosine_schedule
from repro_torch.train import train_step as ts


class FakeMesh:
    """Duck-typed mesh: .axis_names + .shape mapping (what the rule code
    uses)."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = shape


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
ARCHS = list_archs()


@pytest.mark.parametrize("mesh,batch,expect", [
    (SINGLE, 256, ("data",)),
    (SINGLE, 1, ()),                       # long_500k: replicated
    (SINGLE, 128, ("data",)),
    (MULTI, 256, ("pod", "data")),
    (MULTI, 32, ("pod", "data")),          # prefill batch 32 = 2*16
    (MULTI, 2, ("pod",)),
    (MULTI, 3, ()),
])
def test_batch_axes_for(mesh, batch, expect):
    assert batch_axes_for(mesh, batch) == expect


def test_trim_batch_axes_respects_override_order():
    got = dryrun._trim_batch_axes(SINGLE, ("pod", "data", "model"), 256)
    assert got == ("data", "model")
    assert dryrun._trim_batch_axes(SINGLE, ("pod", "data", "model"),
                                   128) == ("data",)


def test_rules_for_merges_arch_overrides():
    cfg = get_config("qwen2-0.5b")
    rules = dryrun._rules_for(SINGLE, 256, None, cfg)
    assert rules["heads"] is None          # 14 heads: no TP
    assert rules["batch"] == ("data", "model")
    assert rules["tokens"] == rules["batch"]
    rules = dryrun._rules_for(SINGLE, 256, None, get_config("llama3-405b"))
    assert rules["kv_heads"] is None       # 8 kv heads < TP=16
    assert rules["heads"] == "model"


@pytest.mark.parametrize("mesh", [SINGLE, MULTI])
def test_rules_for_match_reference(mesh):
    for arch in ARCHS:
        for batch in (1, 32, 128, 256):
            assert dryrun._rules_for(mesh, batch, None, get_config(arch)) \
                == jdryrun._rules_for(mesh, batch, None, jget_config(arch))


def test_cell_registry_complete():
    cs = cells()
    assert len(cs) == 40                   # 10 archs x 4 shapes
    assert len(dryrun.ICP_SHAPES) == 2     # + the paper's own cells
    assert dryrun.ICP_SHAPES == jdryrun.ICP_SHAPES
    skipped = [c for c in cs if not runnable_cell(*c)[0]]
    assert len(skipped) == 8
    assert all(s == "long_500k" for _, s in skipped)
    runnable = {a for a, s in cs if s == "long_500k"
                and runnable_cell(a, s)[0]}
    assert runnable == {"mamba2-780m", "recurrentgemma-9b"}
    assert get_shape("decode_32k").kind == "decode"
    with pytest.raises(KeyError):
        get_shape("nope")


def test_production_meshes():
    single = make_production_mesh(device="meta")
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in multi.devices.flat} == {"meta"}
    debug = make_debug_mesh(device="cpu")
    assert debug.shape == {"data": 2, "model": 4}
    with pytest.raises(RuntimeError):
        make_production_mesh()  # cuda by default: no card here


def _norm(entry):
    """A PartitionSpec entry as a tuple of mesh axes, or None."""
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return axes or None


def _jax_flat(tree, is_leaf=None):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", getattr(
            k, "name", k)))) for k in path]
        out["/".join(keys)] = leaf
    return out


def _port_flat(tree, is_leaf, path=()):
    if is_leaf(tree):
        return {"/".join(path): tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((f, getattr(tree, f)) for f in tree._fields)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, is_leaf, path + (str(k),)))
    return out


def _is_tensor(t):
    return isinstance(t, torch.Tensor)


def _is_names(t):
    return isinstance(t, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in t)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_logical_axes_match_reference(arch):
    want = _jax_flat(jlm.param_logical_axes(jlm.init_abstract(
        jget_config(arch))), is_leaf=_is_names)
    got = _port_flat(lm.param_logical_axes(get_config(arch)), _is_names)
    assert got == want
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 2, 16))
    want = _jax_flat(jlm.cache_logical_axes(jcache), is_leaf=_is_names)
    cache = lm.reference_cache(cfg, lm.init_cache(cfg, 2, 16,
                                                  device="meta"))
    got = _port_flat(lm.cache_logical_axes(cache), _is_names)
    assert got == want
    shapes = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
              for k, v in _port_flat(cache, _is_tensor).items()}
    assert shapes == {k: (tuple(v.shape), str(v.dtype))
                      for k, v in _jax_flat(jcache).items()}


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_sharding_matches_reference(arch, multi):
    """Every leaf's spec and shard shape, under the dry-run's train rules,
    on the production mesh."""
    jmesh = AbstractMesh((2, 16, 16) if multi else (16, 16),
                         ("pod", "data", "model") if multi
                         else ("data", "model"))
    mesh = make_production_mesh(multi_pod=multi, device="meta")
    jcfg, cfg = jget_config(arch), get_config(arch)
    jabs = jlm.init_abstract(jcfg)
    jsh = jparam_sharding(jlm.param_logical_axes(jabs), jmesh,
                          jdryrun._rules_for(jmesh, 256, None, jcfg), jabs)
    abstract = lm.abstract_reference(cfg)
    sh = partition.param_sharding(lm.param_logical_axes(cfg), mesh,
                                  dryrun._rules_for(mesh, 256, None, cfg),
                                  abstract)
    want, leaves = _jax_flat(jsh), _jax_flat(jabs)
    got = _port_flat(sh, lambda t: isinstance(t, partition.ShardSpec))
    shapes = _port_flat(abstract, _is_tensor)
    assert set(got) == set(want)
    for key, spec in got.items():
        ref_spec = tuple(_norm(e) for e in want[key].spec)
        assert tuple(_norm(e) for e in spec.spec) == ref_spec, key
        assert tuple(shapes[key].shape) == tuple(leaves[key].shape), key
        assert spec.shard_shape(shapes[key].shape) == tuple(
            want[key].shard_shape(leaves[key].shape)), key


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "recurrentgemma-9b"])
def test_state_logical_axes_match_reference(arch, opt):
    jopt = (jadamw if opt == "adamw" else jadafactor)(lambda s: 1e-3)
    topt = (adamw if opt == "adamw" else adafactor)(cosine_schedule(1e-3))
    want = _jax_flat(jts.state_logical_axes(jget_smoke(arch), jopt),
                     is_leaf=_is_names)
    got = _port_flat(ts.state_logical_axes(get_smoke(arch), topt),
                     _is_names)
    assert got == want
    # and they lay out the port's state in the reference's layout
    cfg = get_smoke(arch)
    state = ts.state_to_reference(ts.abstract_state(cfg, topt))
    mesh = make_debug_mesh(device="meta")
    sh = partition.param_sharding(ts.state_logical_axes(cfg, topt), mesh,
                                  None, state)
    assert partition.shard_bytes(sh, state) > 0


def test_context_and_aconstraint():
    mesh = make_debug_mesh((2, 4), device="cpu")
    x = torch.ones(4, 8)
    assert partition.active_context() is None
    assert partition.aconstraint(x, ("batch", "heads")) is x
    assert partition.logical_to_spec(("batch", None)) == ()
    with partition.partitioning(mesh, {"seq": "data",
                                       "moe_impl": ("gspmd_sort",)}) as rules:
        assert partition.active_context() == (mesh, rules)
        assert rules["batch"] == ("data",)          # "pod" dropped
        assert rules["heads"] == ("model",)
        assert rules["seq"] == ("data",)
        assert rules["moe_impl"] == "gspmd_sort"    # passed through
        assert rules["embed"] is None
        assert partition.aconstraint(x, ("batch", "heads")) is x
        assert partition.logical_to_spec(("batch", None, "vocab")) == (
            ("data",), None, ("model",))
        with pytest.raises(ValueError):
            partition.aconstraint(x, ("batch", "seq", "embed"))
    assert partition.active_context() is None


def test_shard_spec_shard_and_gather():
    mesh = make_debug_mesh((2, 4), device="cpu")
    x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    spec = partition.ShardSpec(mesh, (("data",), ("model",)))
    blocks = spec.shard(x)
    assert blocks.shape == (2, 4) and spec.shard_shape(x.shape) == (4, 3, 3)
    assert torch.equal(blocks[1, 2], x[4:8, 6:9])
    assert torch.equal(spec.gather(blocks), x)
    both = partition.ShardSpec(mesh, (("data", "model"),))
    assert both.shard_shape(x.shape) == (1, 12, 3)
    assert torch.equal(both.shard(x)[1, 3], x[7:8])
    with pytest.raises(ValueError):
        partition.ShardSpec(mesh, (None, ("data", "model"))).shard_shape(
            (2, 12))


def _smoke_step(grad_shardings):
    cfg = get_smoke("qwen2-0.5b")
    opt = adamw(cosine_schedule(3e-4, 2, 10))
    state = ts.init_state(0, cfg, opt, device="cpu")
    batch = {k: np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8), dtype=np.int32)
        for k in ("tokens", "labels")}
    step = ts.make_train_step(cfg, opt, remat="none", accum_steps=2,
                              grad_shardings=grad_shardings)
    state, metrics = step(state, batch)
    return dict(state.params.named_parameters()), float(metrics["loss"])


def test_grad_shardings_change_no_bits():
    cfg = get_smoke("qwen2-0.5b")
    mesh = make_debug_mesh((2, 4), device="cpu")
    rules = dryrun._rules_for(mesh, 2, None, cfg)
    sh = partition.param_sharding(lm.param_logical_axes(cfg), mesh, rules,
                                  lm.abstract_reference(cfg))
    plain, loss = _smoke_step(None)
    pinned, loss_p = _smoke_step(sh)
    assert loss == loss_p
    assert all(torch.equal(plain[k], pinned[k]) for k in plain)
    bad = dict(sh)
    bad.pop("final_norm")
    with pytest.raises(ValueError):
        ts.make_train_step(cfg, adamw(cosine_schedule(1e-3)),
                           grad_shardings=bad)
    wrong = dataclasses.replace(sh["final_norm"]["scale"],
                                spec=(None, None))
    with pytest.raises(ValueError):
        ts.make_train_step(cfg, adamw(cosine_schedule(1e-3)),
                           grad_shardings={**sh, "final_norm": {
                               "scale": wrong}})
