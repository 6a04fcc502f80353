"""Slice 11 of the port against the reference, on the CPU at smoke sizes:
checkpoints (``train/checkpoint.py``), resume, the train launcher and the
example. Both packages run in this process on the same numpy weights.

  * the reference's ``tests/test_checkpoint.py`` contracts on the port:
    round trip, atomicity, keep-k, async save, a shape mismatch raises,
    the straggler watchdog; a resumed run gives the uninterrupted bits;
  * the on-disk layout is the reference's: a reference checkpoint
    (AdamW's state after 2 reference steps) restores into the port bit
    for bit, and the port's into the reference; the next step of each
    agrees with the other's within the trajectory bars;
  * recurrentgemma-9b's rglru + local_attn and qwen3-moe's renormalised
    top-8 under Adafactor's state: a reference checkpoint of their initial
    state restores into the port and back, whose loss and gradients match
    ``jax.value_and_grad(lm.loss_fn)`` (bars in
    ``tests/_torch_train_ref.py``; recurrentgemma with a mask, qwen3
    without, to keep the file's compiles in time);
  * the launcher at ``--smoke --steps 6 --device cpu`` against the
    reference's ``make_train_step`` loop on the same weights and
    ``TokenStream``; resume through ``--ckpt-dir`` gives the uninterrupted
    run's bits; the example prints ``OK`` from a fresh directory.

Cost: each reference program is compiled once, at XLA's backend
optimisation level 0.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401
from _torch_train_ref import (TRAJ_TOL, compiled, grads_case, hold_grads,
                              hold_run, numpy_tree)

from repro.configs import get_smoke as jsmoke
from repro.data.tokens import TokenStream as JStream
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.optim import pick_optimizer as jpick
from repro.train import checkpoint as jckpt
from repro.train import train_step as jts
from repro_torch.configs import get_smoke
from repro_torch.examples import train_lm
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.optim import adafactor, adamw, cosine_schedule
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as tts

OPTS = {"adamw": (jadamw, adamw), "adafactor": (jadafactor, adafactor)}


def _opts(name):
    """The reference's and the port's optimizer ``name`` on
    ``cosine_schedule(1e-3, 2, 50)``, as ``tests/test_checkpoint.py``
    trains."""
    j, t = OPTS[name]
    return (j(jcosine(1e-3, warmup_steps=2, total_steps=50)),
            t(cosine_schedule(1e-3, warmup_steps=2, total_steps=50)))


def _stream(cfg, b=2, s=16, seed=3):
    return JStream(cfg.vocab_size, batch=b, seq_len=s, seed=seed)


def _arrays(state) -> dict:
    """A port state as the reference's checkpoint keys -> numpy."""
    return ckpt._flatten(state)


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _trained(name, steps=1):
    cfg = get_smoke("qwen2-0.5b")
    opt = _opts(name)[1]
    state = tts.init_state(0, cfg, opt, "cpu")
    step = tts.make_train_step(cfg, opt, remat="none")
    stream = _stream(cfg)
    for s in range(steps):
        state, _ = step(state, stream.batch_at(s))
    return cfg, opt, state


@pytest.fixture(scope="module", params=["adamw", "adafactor"])
def state(request):
    """qwen2 smoke (3 stacked repeats) one step in, so no state leaf is
    zero: (cfg, optimizer, state)."""
    return _trained(request.param)


# -- the reference's checkpoint contracts ------------------------------------

def test_save_restore_roundtrip(tmp_path, state):
    cfg, opt, st = state
    ckpt.save(tmp_path, st, step=7, extra={"note": "x"})
    restored, step, extra = ckpt.restore(tmp_path,
                                         tts.abstract_state(cfg, opt),
                                         device="cpu")
    assert step == 7 and extra == {"note": "x"}
    assert restored.opt_state.step == st.opt_state.step == 1
    _same(_arrays(st), _arrays(restored))
    assert all(isinstance(p, torch.nn.Parameter)
               for p in restored.params.parameters())
    # the reference's layout and keys: groups stacked over the 3 repeats
    manifest = (tmp_path / "step_0000000007" / "manifest.json").read_text()
    assert '"params::groups::0::mixer::wq::kernel"' in manifest
    assert _arrays(st)["params::groups::0::mixer::wq::kernel"].shape \
        == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.d_head)


def test_atomicity_no_partial_checkpoints(tmp_path, state):
    """A .tmp dir (simulated crash) must not be restorable/visible."""
    cfg, opt, st = state
    ckpt.save(tmp_path, st, step=1)
    (tmp_path / "step_0000000002.tmp").mkdir()
    assert ckpt.latest_step(tmp_path) == 1
    _, step, _ = ckpt.restore(tmp_path, tts.abstract_state(cfg, opt),
                              device="cpu")
    assert step == 1


def test_keep_last_k(tmp_path, state):
    mgr = ckpt.CheckpointManager(tmp_path, keep_last_k=2,
                                 save_interval_steps=1)
    (tmp_path / "step_0000000009.tmp").mkdir()
    for s in (1, 2, 3, 4):
        mgr.save_sync(state[2], s)
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["step_0000000003", "step_0000000004"]


def test_async_save_and_restore(tmp_path, state):
    cfg, opt, st = state
    mgr = ckpt.CheckpointManager(tmp_path, keep_last_k=3)
    mgr.save_async(st, 10)
    mgr.wait()
    restored, step, _ = mgr.restore_latest(tts.abstract_state(cfg, opt),
                                           device="cpu")
    assert step == 10
    _same(_arrays(st), _arrays(restored))


def test_restore_shape_mismatch_raises(tmp_path, state):
    cfg, opt, st = state
    ckpt.save(tmp_path, st, step=1)
    wider = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + 8)
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, tts.abstract_state(wider, opt), device="cpu")
    # any other tree of tensors round-trips as it is, and is shape-checked
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.int32), torch.zeros(())]}
    ckpt.save(tmp_path, tree, step=2)
    back, _, _ = ckpt.restore(tmp_path, tree, step=2, device="cpu")
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"][0], tree["b"][0])
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, {"a": torch.zeros(3, 2), "b": tree["b"]},
                     step=2, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", tree, device="cpu")


def test_straggler_watchdog():
    wd = ckpt.StragglerWatchdog(threshold=2.0, alpha=0.5)
    for _ in range(5):
        wd.observe(0, 1.0)
    assert not wd.observe(5, 1.5)
    assert wd.observe(6, 10.0)          # 10x the EMA -> flagged
    assert wd.flagged and wd.flagged[-1][0] == 6


def test_train_resume_bit_identical(tmp_path):
    """Crash/restart: a run resumed from a checkpoint gives the
    uninterrupted run's parameters and state, bit for bit."""
    cfg = get_smoke("qwen2-0.5b")
    opt = _opts("adamw")[1]
    stream = _stream(cfg)
    step_fn = tts.make_train_step(cfg, opt)

    def run(n, state, start=0):
        for s in range(start, n):
            state, _ = step_fn(state, stream.batch_at(s))
        return state

    full = run(6, tts.init_state(1, cfg, opt, "cpu"))
    mid = run(3, tts.init_state(1, cfg, opt, "cpu"))
    ckpt.save(tmp_path, mid, step=3)
    restored, step, _ = ckpt.restore(tmp_path, tts.abstract_state(cfg, opt),
                                     device="cpu")
    resumed = run(6, restored, start=step)
    _same(_arrays(full), _arrays(resumed))


# -- across packages ---------------------------------------------------------

def _reference_state(cfg, jopt, tree=None):
    tree = tlm.init_params_numpy(cfg, 0) if tree is None else tree
    return jts.TrainState(params=tree, opt_state=jopt.init(tree))


@pytest.fixture(scope="module")
def launch_program():
    """The reference's ``make_train_step`` at the launcher's ``--smoke``
    defaults (qwen2 smoke, AdamW, ``cosine_schedule(3e-4, 20, 21)``,
    remat none, 8 x 128 from ``TokenStream(vocab, 8, 128, seed=0)``),
    compiled once: -> (reference's optimizer, port's, step, batches)."""
    cfg, jcfg = get_smoke("qwen2-0.5b"), jsmoke("qwen2-0.5b")
    stream = JStream(cfg.vocab_size, 8, 128, seed=0)
    batches = [stream.batch_at(s) for s in range(6)]
    jopt = jadamw(jcosine(3e-4, warmup_steps=20, total_steps=21))
    topt = adamw(cosine_schedule(3e-4, warmup_steps=20, total_steps=21))
    step = compiled(jts.make_train_step(jcfg, jopt, remat="none"),
                    _reference_state(cfg, jopt), batches[0])
    return jopt, topt, step, batches


def test_checkpoints_restore_across_packages(tmp_path, launch_program):
    """Reference -> port and port -> reference after 2 AdamW steps each:
    the restored state is the saved one's bits, and the next step agrees
    within the bars (Adafactor's stacked state crosses in
    ``restored_grads``)."""
    cfg = get_smoke("qwen2-0.5b")
    jopt, topt, jstep, batches = launch_program
    jstate = _reference_state(cfg, jopt)
    tstep = tts.make_train_step(cfg, topt, remat="none")
    for b in batches[:2]:
        jstate, _ = jstep(jstate, b)
    jckpt.save(tmp_path / "ref", jstate, step=2)
    port, step, _ = ckpt.restore(tmp_path / "ref",
                                 tts.abstract_state(cfg, topt), device="cpu")
    assert step == 2 and port.opt_state.step == 2
    _same(jckpt._flatten(jstate), _arrays(port))
    jnext, jm = jstep(jstate, batches[2])
    tnext, tm = tstep(port, batches[2])
    hold_run(([float(jm["loss"])], numpy_tree(jnext.params)),
             ([float(tm["loss"])], numpy_tree(_ref_params(cfg, tnext))))

    own = tts.init_state(0, cfg, topt, "cpu")
    for b in batches[:2]:
        own, _ = tstep(own, b)
    ckpt.save(tmp_path / "port", own, step=2)
    abstract = jax.eval_shape(lambda: _reference_state(cfg, jopt))
    back, step, _ = jckpt.restore(tmp_path / "port", abstract)
    assert step == 2
    _same(_arrays(own), jckpt._flatten(back))
    jnext, jm = jstep(back, batches[2])
    tnext, tm = tstep(own, batches[2])
    hold_run(([float(jm["loss"])], numpy_tree(jnext.params)),
             ([float(tm["loss"])], numpy_tree(_ref_params(cfg, tnext))))


def _ref_params(cfg, state):
    return tlm.to_reference(cfg, {n: p.detach() for n, p in
                                  state.params.named_parameters()})


# rglru + local_attn (masked); renormalised top-8 with QK-norm under
# Adafactor's state (unmasked): (optimizer, masks)
RESTORED = {"recurrentgemma-9b": ("adamw", (True,)),
            "qwen3-moe-235b-a22b": ("adafactor", (False,))}


@pytest.fixture(scope="module", params=sorted(RESTORED))
def restored_grads(request, tmp_path_factory):
    """A reference checkpoint of the arch's initial state restored into the
    port, and saved back by the port: the reference restores that one to
    the bits it wrote (Adafactor's stacked state both ways for qwen3)."""
    arch = request.param
    name, masks = RESTORED[arch]
    cfg = get_smoke(arch)
    jopt, topt = _opts(name)
    path = tmp_path_factory.mktemp(arch)
    ref = _reference_state(cfg, jopt)
    jckpt.save(path / "ref", ref, step=0)
    state, _, _ = ckpt.restore(path / "ref", tts.abstract_state(cfg, topt),
                               device="cpu")
    ckpt.save(path / "port", state, step=0)
    back, _, _ = jckpt.restore(path / "port", jax.eval_shape(lambda: ref))
    _same(jckpt._flatten(ref), jckpt._flatten(back))
    return grads_case(arch, model=state.params, masks=masks)


def test_restored_loss_and_grads_match_reference(restored_grads):
    cfg, ref, got = restored_grads
    for masked in ref:
        hold_grads(cfg, ref[masked], got[masked])


# -- the launcher and the example --------------------------------------------

def test_launcher_matches_reference_loop(capsys, launch_program):
    """``--smoke --steps 6`` (8 x 128, AdamW by ``pick_optimizer``,
    ``cosine_schedule(3e-4, 20, 21)``, remat none) against the reference's
    ``make_train_step`` loop on ``init_params_numpy(cfg, 0)`` and
    ``TokenStream(vocab, 8, 128, seed=0)``."""
    cfg, jcfg = get_smoke("qwen2-0.5b"), jsmoke("qwen2-0.5b")
    got = tlaunch.main(["--smoke", "--steps", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "tok/s" in out
    assert "done: 6 steps" in out
    assert jpick(jcfg.total_params(), jcosine(3e-4)).name == "adamw"
    jopt, _, step, batches = launch_program
    state = _reference_state(cfg, jopt)
    ref = []
    for batch in batches:
        state, m = step(state, batch)
        ref.append(float(m["loss"]))
    assert len(got) == 6 and got[-1] < got[0]
    assert max(abs(a - b) for a, b in zip(ref, got)) <= TRAJ_TOL


def _final(path) -> dict:
    with np.load(path / "step_0000000012" / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


def test_launcher_resume_gives_uninterrupted_bits(tmp_path, capsys):
    args = ["--smoke", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-every", "4"]
    tlaunch.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    tlaunch.main(args + ["--steps", "12", "--ckpt-dir", str(tmp_path / "a")])
    assert "resumed from step 6" in capsys.readouterr().out
    tlaunch.main(args + ["--steps", "12", "--ckpt-dir", str(tmp_path / "b")])
    _same(_final(tmp_path / "a"), _final(tmp_path / "b"))
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) \
        == ["step_0000000004", "step_0000000008", "step_0000000012"]


def test_example_prints_ok_from_a_fresh_directory(tmp_path, capsys,
                                                  monkeypatch):
    """The example at a short run from its default directory (under the
    temporary directory) prints OK; a second run from there has no step
    left and fails on the empty loss list, as the reference's does
    (ROADMAP queue 3)."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    args = ["--steps", "25", "--batch", "2", "--seq", "32",
            "--device", "cpu"]
    losses = train_lm.main(args)
    assert capsys.readouterr().out.rstrip().endswith("OK")
    assert len(losses) == 25 and losses[-1] < losses[0]
    assert (tmp_path / "repro_train_lm" / "step_0000000025").is_dir()
    with pytest.raises(IndexError):
        train_lm.main(args)
