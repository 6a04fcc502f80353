"""Slice 11 of the port against the reference, on the CPU at smoke sizes:
the trainable model, ``loss_fn`` and its gradients (qwen2, mamba2,
minicpm3, musicgen, deepseek-moe; recurrentgemma and qwen3-moe in
``tests/test_torch_checkpoint.py``), remat, the schedule, AdamW and
Adafactor, and ``make_train_step`` (trajectories and gradient
accumulation). Both packages run in this process on the same numpy
weights (``init_params_numpy``, the reference's tree) and batches.

Bars (``tests/_torch_train_ref.py`` gives the shared ones and their
readings): the trainable model's forward is the serving model's bits (its
fp32 leaves are cast at use where the serving model cast them at load);
remat ``none`` / ``full`` / ``dots`` give the same bits; the schedule is
within one fp32 ulp (numpy's cos against XLA's); one optimizer update on
the same gradients and state gives the new state within ``OPT_RTOL`` =
1e-6 relative L2 per leaf and each parameter's change within it up to one
ulp of the parameter; 10-step trajectories and ``accum_steps=2`` within
``TRAJ_TOL`` and ``PARAM_RTOL`` (Adam's first steps move a coordinate by
about the learning rate whatever its gradient's size, so a coordinate
whose gradient is near 0 may move the other way: no per-leaf bar holds).

Cost: each reference program is compiled once, at XLA's backend
optimisation level 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_ref import (compiled, grads_case, hold_grads, hold_run,
                              leaves_of, lm_batch, numpy_tree, port_grads,
                              rel)

from repro.configs import get_smoke as jsmoke
from repro.data.tokens import TokenStream as JStream
from repro.models import lm as jlm
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim import pick_optimizer as jpick
from repro.train import train_step as jts
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.models import lm as tlm
from repro_torch.optim import (adafactor, adamw, clip_by_global_norm,
                               cosine_schedule, pick_optimizer)
from repro_torch.optim.optimizers import leaf_groups
from repro_torch.train import train_step as tts

OPT_RTOL = 1e-6
# a block kind or FFN each, without and with a mask: swiglu + attn with
# QKV bias (qwen2), ssd (mamba2), mla (minicpm3), embeds in and a gelu MLP
# (musicgen); a dense prefix and shared experts (deepseek, masked). The
# rglru + local_attn kind and the renormalised MoE are held in
# tests/test_torch_checkpoint.py, on models restored from reference
# checkpoints
GRAD_CASES = {"qwen2-0.5b": (False, True), "mamba2-780m": (False, True),
              "minicpm3-4b": (False, True), "musicgen-medium": (False, True),
              "deepseek-moe-16b": (True,)}


# -- the trainable model -----------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_trainable_forward_is_the_serving_bits(arch):
    """Every leaf an fp32 ``nn.Parameter`` (no buffer), the serving model's
    parameter count, and its logits and aux bit for bit."""
    cfg = get_smoke(arch)
    tree = tlm.init_params_numpy(cfg, 0)
    serve = tlm.params_from_reference(tree, cfg, "cpu")
    train = tlm.params_from_reference(tree, cfg, "cpu", trainable=True)
    assert not list(train.buffers())
    assert all(isinstance(p, torch.nn.Parameter) and p.requires_grad
               and p.dtype == torch.float32 for p in train.parameters())
    assert tlm.param_count(train) == tlm.param_count(serve)
    batch = lm_batch(cfg, 2, 16, 0)
    x = {k: torch.from_numpy(v) for k, v in batch.items() if k != "labels"}
    ls, auxs = serve(**x)
    lt, auxt = train(**x)
    assert not ls.requires_grad and lt.requires_grad
    assert torch.equal(ls, lt.detach()) and torch.equal(auxs, auxt.detach())
    abstract = tlm.init_abstract(cfg)
    assert [(n, p.shape, p.dtype) for n, p in abstract.named_parameters()] \
        == [(n, p.shape, p.dtype) for n, p in train.named_parameters()]
    assert all(p.is_meta for p in abstract.parameters())


def test_reference_layout_round_trip():
    """``to_reference`` stacks the port's layers into the reference's tree
    (the shapes of ``lm.init_abstract``), ``from_reference`` undoes it."""
    cfg = get_smoke("recurrentgemma-9b")  # a 3-layer period and a suffix
    tree = tlm.init_params_numpy(cfg, 0)
    model = tlm.params_from_reference(tree, cfg, "cpu", trainable=True)
    named = {n: p.detach() for n, p in model.named_parameters()}
    back = numpy_tree(tlm.to_reference(cfg, named))
    jabs = jlm.init_abstract(jsmoke("recurrentgemma-9b"))
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(jabs)
    for (_, a), b in zip(leaves_of(back), jax.tree_util.tree_leaves(jabs)):
        assert a.shape == b.shape
    for (_, a), (_, b) in zip(leaves_of(back), leaves_of(tree)):
        assert np.array_equal(a, b)
    flat = tlm.from_reference(cfg, tree)
    assert set(flat) == set(named)
    assert all(np.array_equal(flat[n], named[n].numpy()) for n in named)


# -- loss and gradients ------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(GRAD_CASES))
def grads(request):
    return grads_case(request.param, masks=GRAD_CASES[request.param])


def test_loss_and_grads_match_reference(grads):
    cfg, ref, got = grads
    for masked in ref:
        hold_grads(cfg, ref[masked], got[masked])


# -- remat -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b",
                                  "mamba2-780m", "deepseek-moe-16b",
                                  "minicpm3-4b"])
def test_remat_modes_give_the_same_bits(arch):
    cfg = get_smoke(arch)
    model = tlm.init_params(cfg, 0, "cpu", trainable=True)
    batch = lm_batch(cfg, 2, 16, 1)
    ref = port_grads(model, cfg, batch, "none")
    for remat in ("full", "dots"):
        got = port_grads(model, cfg, batch, remat)
        assert got[0] == ref[0] and got[1] == ref[1]
        for n, g in ref[2].items():
            assert torch.equal(g, got[2][n]), (remat, n)
    with pytest.raises(ValueError):
        port_grads(model, cfg, batch, "selective")


# -- schedule and optimizers -------------------------------------------------

@pytest.mark.parametrize("args", [(1e-3, 2, 50), (3e-4, 20, 21),
                                  (1.0, 10, 100, 0.2)])
def test_cosine_schedule_matches_reference(args):
    ref, got = jcosine(*args), cosine_schedule(*args)
    warm = args[1]
    for step in (0, 1, warm - 1, warm, warm + 1, (warm + args[2]) // 2,
                 args[2] - 1, args[2], args[2] + 7, 10 * args[2]):
        r = np.float32(ref(jnp.asarray(step, jnp.int32)))
        g = got(step)
        assert isinstance(g, np.float32)
        assert abs(g - r) <= np.spacing(r), (step, r, g)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((4, 5)).astype(np.float32) * 3,
         "b": rng.standard_normal(7).astype(np.float32)}
    for max_norm in (1.0, 100.0):
        jc, jn = jclip({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        tc, tn = clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for k in g:
            assert rel(jc[k], tc[k]) <= 1e-6


def test_pick_optimizer_threshold():
    lr = cosine_schedule(1e-3)
    assert pick_optimizer(int(100e9) - 1, lr).name == "adamw"
    assert pick_optimizer(int(100e9), lr).name == "adafactor"
    for arch in list_archs():
        n = get_config(arch).total_params()
        assert pick_optimizer(n, lr).name == jpick(n, jcosine(1e-3)).name


def _opt_inputs(cfg, seed=4):
    """Parameters, gradients and a non-zero optimizer state (step 3) in the
    reference's layout, as numpy."""
    rng = np.random.default_rng(seed)
    params = tlm.init_params_numpy(cfg, 0)
    like = lambda scale: jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
        params)
    return params, like(1e-2), rng


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_one_update_matches_reference(name):
    """One update on the same gradients and state (qwen2 smoke: 3 stacked
    repeats): every parameter's change and every state leaf within
    ``OPT_RTOL``; Adafactor's state keyed and shaped as the reference's
    stacked leaves."""
    cfg = get_smoke("qwen2-0.5b")
    params, g, rng = _opt_inputs(cfg)
    lr = (jcosine, cosine_schedule)
    # lr 0.1: a change far above the ulps of the parameters it moves
    jopt = (jadamw if name == "adamw" else jadafactor)(lr[0](0.1, 2, 50))
    topt = (adamw if name == "adamw" else adafactor)(lr[1](0.1, 2, 50))
    jstate = jopt.init(params)
    # a state 3 steps in: positive second moments, signed first ones
    inner = jax.tree_util.tree_map(
        lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32)
        * 1e-4, jstate.inner)
    if name == "adamw":
        inner["m"] = jax.tree_util.tree_map(
            lambda a: (a - 5e-5).astype(np.float32), inner["m"])
    jstate = jstate._replace(step=np.int32(3), inner=inner)
    ref_p, ref_s = compiled(jopt.update, g, jstate, params)(g, jstate,
                                                              params)
    state = tts.state_from_reference(
        {"params": params, "opt_state": jstate}, cfg, "cpu")
    model = state.params
    grads = {n: torch.from_numpy(np.array(a))
             for n, a in tlm.from_reference(cfg, g).items()}
    _, new = topt.update(grads, state.opt_state, model)
    assert new.step == 4
    got = numpy_tree(tts.state_to_reference(tts.TrainState(model, new)))
    assert int(got["opt_state"]["step"]) == int(ref_s.step)
    for (path, r), (_, t), (_, p0) in zip(leaves_of(numpy_tree(ref_p)),
                                          leaves_of(got["params"]),
                                          leaves_of(params)):
        # the change within OPT_RTOL, up to one ulp of where it lands
        err = np.linalg.norm(np.float64(t) - r)
        assert err <= (OPT_RTOL * np.linalg.norm(np.float64(r) - p0)
                       + np.linalg.norm(np.spacing(r))), path
    ref_inner = numpy_tree(ref_s.inner)
    assert [p for p, _ in leaves_of(ref_inner)] \
        == [p for p, _ in leaves_of(got["opt_state"]["inner"])]
    for (path, r), (_, t) in zip(leaves_of(ref_inner),
                                 leaves_of(got["opt_state"]["inner"])):
        assert r.shape == t.shape and rel(r, t) <= OPT_RTOL, path


def test_adafactor_factors_the_stacked_leaves():
    """A group's norm scale is one (reps, d) leaf to Adafactor, as in the
    reference: factored (``vr`` (reps,), ``vc`` (d,)), its update clip
    over the stack. Factoring each layer's (d,) scale alone (a model
    without an arch config) updates it otherwise."""
    cfg = get_smoke("qwen2-0.5b")
    model = tlm.init_params(cfg, 0, "cpu", trainable=True)
    opt = adafactor(cosine_schedule(1e-3, 2, 50))
    state = opt.init(model)
    reps, d = cfg.n_layers, cfg.d_model
    scale = "groups/0/mixer_norm/scale"
    assert state.inner[scale]["vr"].shape == (reps,)
    assert state.inner[scale]["vc"].shape == (d,)
    groups = {k: (names, stacked) for k, names, stacked in
              leaf_groups(model)}
    assert groups[scale] == ([f"layers.{r}.mixer_norm.scale"
                              for r in range(reps)], True)
    flat = tlm.init_params(cfg, 0, "cpu", trainable=True)
    flat.cfg = None
    assert all(len(v) == 1 for _, v, _ in leaf_groups(flat))
    rng = np.random.default_rng(0)
    grads = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                 .astype(np.float32))
             for n, p in model.named_parameters()}
    opt.update(grads, state, model)
    opt.update(grads, opt.init(flat), flat)
    name = "layers.1.mixer_norm.scale"
    stacked, alone = model.get_parameter(name), flat.get_parameter(name)
    assert rel(stacked.detach(), alone.detach()) > 1e-4


# -- the train step ----------------------------------------------------------

def _reference_run(cfg, jcfg, opt, batches, remat="full", accum=1):
    """The reference's ``make_train_step`` (compiled once) over
    ``batches`` from ``init_params_numpy(cfg, 0)``: -> (losses, final
    params as numpy)."""
    params = tlm.init_params_numpy(cfg, 0)
    state = jts.TrainState(params=params, opt_state=opt.init(params))
    step = compiled(jts.make_train_step(jcfg, opt, remat=remat,
                                        accum_steps=accum), state,
                    batches[0])
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        assert set(metrics) == ({"loss"} if accum > 1 else
                                {"loss", "nll", "aux"})
        losses.append(float(metrics["loss"]))
    return losses, numpy_tree(state.params)


def _port_run(cfg, opt, batches, remat="full", accum=1):
    state = tts.init_state(0, cfg, opt, "cpu")
    step = tts.make_train_step(cfg, opt, remat=remat, accum_steps=accum)
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        assert set(metrics) == ({"loss"} if accum > 1 else
                                {"loss", "nll", "aux"})
        assert all(not v.requires_grad for v in metrics.values())
        losses.append(float(metrics["loss"]))
    named = {n: p.detach() for n, p in state.params.named_parameters()}
    return losses, numpy_tree(tlm.to_reference(cfg, named))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_ten_step_trajectory_matches_reference(name):
    """10 steps of ``make_train_step`` (its default ``remat="full"``) from
    the same weights on ``TokenStream(vocab, 2, 16, seed=3)``, as
    ``tests/test_checkpoint.py`` trains."""
    cfg, jcfg = get_smoke("qwen2-0.5b"), jsmoke("qwen2-0.5b")
    make = {"adamw": (jadamw, adamw), "adafactor": (jadafactor, adafactor)}
    jopt = make[name][0](jcosine(1e-3, warmup_steps=2, total_steps=50))
    topt = make[name][1](cosine_schedule(1e-3, warmup_steps=2,
                                         total_steps=50))
    stream = JStream(cfg.vocab_size, batch=2, seq_len=16, seed=3)
    batches = [stream.batch_at(s) for s in range(10)]
    ref = _reference_run(cfg, jcfg, jopt, batches)
    got = _port_run(cfg, topt, batches)
    assert got[0][-1] < got[0][0]
    hold_run(ref, got)


def test_accumulation_matches_reference():
    """``accum_steps=2`` on 4 x 16 tokens, 3 steps: the reference's
    microbatch accumulation; also within the bars of ``accum_steps=1`` on
    the same batches."""
    cfg, jcfg = get_smoke("qwen2-0.5b"), jsmoke("qwen2-0.5b")
    jopt = jadamw(jcosine(1e-3, warmup_steps=2, total_steps=50))
    topt = adamw(cosine_schedule(1e-3, warmup_steps=2, total_steps=50))
    stream = JStream(cfg.vocab_size, batch=4, seq_len=16, seed=7)
    batches = [stream.batch_at(s) for s in range(3)]
    ref = _reference_run(cfg, jcfg, jopt, batches, remat="none", accum=2)
    got = _port_run(cfg, topt, batches, remat="none", accum=2)
    hold_run(ref, got)
    one = _port_run(cfg, topt, batches, remat="none")
    hold_run(one, got)
    with pytest.raises(ValueError):
        tts.make_train_step(cfg, topt, accum_steps=3)(
            tts.init_state(0, cfg, topt, "cpu"), batches[0])


def test_entry_points_default_to_cuda():
    """The training entry points default to the card and raise without
    one; nothing quietly moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    cfg = get_smoke("qwen2-0.5b")
    opt = adamw(cosine_schedule(1e-3))
    with pytest.raises(RuntimeError):
        tts.init_state(0, cfg, opt)
    with pytest.raises(RuntimeError):
        tlm.init_params(cfg, 0, trainable=True)
    from repro_torch.launch import train as launch
    with pytest.raises(RuntimeError):
        launch.main(["--smoke", "--steps", "1"])
