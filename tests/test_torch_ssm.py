"""Slice 9 of the port against the reference, on the CPU at smoke sizes: the
state-space mixers of ``models/ssm.py``, Mamba-2's chunked SSD and
Griffin's RG-LRU block. Both packages run in this process on the same
seeded numpy inputs; the weights are one layer of the port's
``lm.init_params_numpy`` (the reference's layout and initialisers).

Tolerances, each scaled to the largest magnitude of the reference's
output:
  * fp32 functions of the same fp32 inputs (``ssd_chunked``,
    ``ssd_naive``, ``_segsum``, ``_rglru_core``'s ``h_last``, the gates)
    within ``FP32_ULPS`` fp32 ulps: the port's cumsum and einsums add in
    another order than XLA's (measured <= 10.7 ulps); the scan's odd/even
    recursion gives ``jax.lax.associative_scan``'s bits;
  * bf16 outputs, and the fp32 states of a whole block (downstream of its
    bf16 matmuls), within ``BF16_ULPS`` bf16 ulps (a bf16 ulp of the top
    of the binade, as ``tests/test_torch_lm.py``'s ``_ulps``): a
    float-order difference flips a bf16 rounding by an ulp, and the gated
    RMS norm spreads it across the row (measured <= 0.75 ulp);
  * the port's streaming decode against its own full forward within the
    reference's own bars (``tests/test_ssm.py``: 2e-3 for Mamba-2, 1e-4
    for the RG-LRU block), the chunked SSD against the sequential oracle
    ``ssd_naive`` within ``FP32_ULPS``.
The reference programs are compiled at XLA's backend optimisation level 0,
which gives the default level's bits on these programs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

FP32_ULP = 2.0 ** -23
BF16_ULP = 2.0 ** -7
FP32_ULPS = 32
BF16_ULPS = 2
FAST_COMPILE = {"xla_backend_optimization_level": 0}
CPU = torch.device("cpu")


def _run_ref(fn, *args, static=()):
    compiled = jax.jit(fn, static_argnums=static).lower(*args).compile(
        FAST_COMPILE)
    return compiled(*(a for i, a in enumerate(args) if i not in static))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(ref, got, ulp):
    """max |ref - got| in ulps (``ulp``, relative) of max |ref|."""
    ref, got = _f32(ref), _f32(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / (ulp * np.abs(ref).max()))


def _hold(ref, got, name="", block=False):
    """``got`` against the reference's ``ref``: the same dtype, within
    ``BF16_ULPS`` bf16 ulps if bf16 or the output of a block (whose fp32
    states inherit its bf16 matmuls' roundings), else within ``FP32_ULPS``
    fp32 ulps."""
    want = str(jnp.asarray(ref).dtype)
    assert str(got.dtype) == f"torch.{want}", (name, got.dtype, want)
    if block or want == "bfloat16":
        assert _ulps(ref, got, BF16_ULP) <= BF16_ULPS, (
            name, _ulps(ref, got, BF16_ULP))
    else:
        assert _ulps(ref, got, FP32_ULP) <= FP32_ULPS, (
            name, _ulps(ref, got, FP32_ULP))


def _layer(arch):
    """(reference config, port config, numpy weights of one mixer) for an
    arch's smoke config, from ``init_params_numpy``."""
    cfg = tconfigs.get_smoke(arch)
    tree = tlm.init_params_numpy(cfg, seed=0)
    mixer = jax.tree_util.tree_map(lambda a: a[0], tree["groups"]["0"]
                                   ["mixer"])
    if arch == "mamba2-780m":
        kw = dict(d_model=cfg.d_model, d_state=cfg.ssm_state,
                  expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                  chunk=cfg.ssm_chunk, conv_width=cfg.conv_width)
        return jssm.SSMConfig(**kw), tlm.ssm_config(cfg), mixer
    kw = dict(d_model=cfg.d_model, lru_width=cfg.lru_width,
              conv_width=cfg.conv_width)
    return jssm.RGLRUConfig(**kw), tlm.rglru_config(cfg), mixer


def _both(tree):
    """numpy weights as the reference's arrays and the port's tensors."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tlm._convert(tree, CPU))


def _activations(rng, shape):
    """bf16 activations (B, S, D) for both packages."""
    u = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(u).astype(jnp.bfloat16), torch.from_numpy(u).bfloat16()


# -- Mamba-2 / SSD -----------------------------------------------------------

def _ssd_inputs(seed, b=2, s=64, h=4, p=16, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_reference_and_naive(chunk):
    """``ssd_chunked`` from an initial state against the reference's and
    against the sequential ``ssd_naive`` of both packages."""
    arrs = _ssd_inputs(chunk)
    J = [jnp.asarray(a) for a in arrs]
    T = [torch.from_numpy(a) for a in arrs]
    ref = _run_ref(lambda *a: (jssm.ssd_chunked(*a[:5], chunk,
                                                initial_state=a[5]),
                               jssm.ssd_naive(*a[:5], initial_state=a[5])),
                   *J)
    got = tssm.ssd_chunked(*T[:5], chunk, initial_state=T[5])
    naive = tssm.ssd_naive(*T[:5], initial_state=T[5])
    for i, name in enumerate(("y", "final_state")):
        _hold(ref[0][i], got[i], f"chunked {name}")
        _hold(ref[1][i], naive[i], f"naive {name}")
        _hold(naive[i].numpy(), got[i], f"chunked vs naive {name}")


def test_segsum_masks_after_the_subtraction():
    """Above the diagonal -inf (exp 0), below it the reference's sums, and
    no NaN where a log decay is -inf (no inf - inf)."""
    x = np.random.default_rng(1).standard_normal((3, 16)).astype(np.float32)
    x[1, 5] = -np.inf
    got = tssm._segsum(torch.from_numpy(x))
    ref = np.asarray(_run_ref(jssm._segsum, jnp.asarray(x)))
    upper = ~np.tri(16, dtype=bool)
    assert np.isneginf(got.numpy()[:, upper]).all()
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(ref))
    assert not np.isnan(got.numpy()[[0, 2]]).any()
    finite = np.isfinite(ref)
    assert np.array_equal(finite, np.isfinite(got.numpy()))
    assert np.abs(ref[finite] - got.numpy()[finite]).max() <= (
        FP32_ULPS * FP32_ULP * np.abs(ref[finite]).max())
    assert not torch.exp(got[[0, 2]]).isnan().any()


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg, mixer = _layer("mamba2-780m")
    jp, tp = _both(mixer)
    return jcfg, tcfg, jp, tp


# prompt lengths: a chunk multiple and ragged (padded to the next chunk)
@pytest.mark.parametrize("s", [32, 27])
def test_mamba2_forward_state_and_decode_match_reference(mamba, s):
    """``mamba2_forward`` with ``return_state`` over S tokens (padded up to
    a multiple of the 16-token chunk when ragged), then four
    ``mamba2_decode_step`` tokens; the streamed outputs equal the port's own
    full forward over S + 4, and the final state the unpadded sequence's
    (the port's decode loop from the zero state)."""
    jcfg, tcfg, jp, tp = mamba
    steps = 4
    uj, ut = _activations(np.random.default_rng(s), (2, s + steps,
                                                     tcfg.d_model))

    def reference(p, u):
        fwd = jssm.mamba2_forward(p, u, jcfg)
        out, state = jssm.mamba2_forward(p, u[:, :s], jcfg,
                                         return_state=True)
        outs = [out]
        for t in range(s, s + steps):
            o, state = jssm.mamba2_decode_step(p, u[:, t:t + 1], state, jcfg)
            outs.append(o)
        return fwd, jnp.concatenate(outs, axis=1), state

    ref_fwd, ref_stream, ref_state = _run_ref(reference, jp, uj)
    fwd = tssm.mamba2_forward(tp, ut, tcfg)
    out, state = tssm.mamba2_forward(tp, ut[:, :s], tcfg, return_state=True)
    loop = tssm.mamba2_init_state(2, tcfg)
    for t in range(s):
        _, loop = tssm.mamba2_decode_step(tp, ut[:, t:t + 1], loop, tcfg)
    _hold(loop[1].numpy(), state[1], "final state vs the decode loop",
          block=True)
    outs = [out]
    for t in range(s, s + steps):
        o, state = tssm.mamba2_decode_step(tp, ut[:, t:t + 1], state, tcfg)
        outs.append(o)
    stream = torch.cat(outs, dim=1)
    _hold(ref_fwd, fwd, "forward")
    _hold(ref_stream, stream, "stream")
    for i, name in enumerate(("conv state", "ssm state")):
        _hold(ref_state[i], state[i], name, block=True)
    assert np.abs(_f32(stream) - _f32(fwd)).max() <= 2e-3  # tests/test_ssm.py


def test_mamba2_decode_from_init_state_matches_reference(mamba):
    """Decode from ``mamba2_init_state``: the fp32 zero conv state comes back
    bf16 (the activations' dtype), the SSD state stays fp32, as in the
    reference, and each step's output and state agree with its."""
    jcfg, tcfg, jp, tp = mamba
    uj, ut = _activations(np.random.default_rng(5), (2, 6, tcfg.d_model))
    init = tssm.mamba2_init_state(2, tcfg)
    assert [s.dtype for s in init] == [torch.float32] * 2

    def reference(p, u):
        state, outs = jssm.mamba2_init_state(2, jcfg), []
        for t in range(u.shape[1]):
            o, state = jssm.mamba2_decode_step(p, u[:, t:t + 1], state, jcfg)
            outs.append(o)
        return jnp.concatenate(outs, axis=1), state

    ref_out, ref_state = _run_ref(reference, jp, uj)
    state, outs = init, []
    for t in range(ut.shape[1]):
        o, state = tssm.mamba2_decode_step(tp, ut[:, t:t + 1], state, tcfg)
        outs.append(o)
    assert state[0].dtype == torch.bfloat16 and state[1].dtype == torch.float32
    _hold(ref_out, torch.cat(outs, dim=1), "outputs")
    _hold(ref_state[0], state[0], "conv state", block=True)
    _hold(ref_state[1], state[1], "ssm state", block=True)


# -- RG-LRU ------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
def test_linear_scan_matches_associative_scan_and_sequential(s):
    """The odd/even recursion against ``jax.lax.associative_scan`` with the
    reference's combine (the same bits: the same products and sums) and
    against the sequential oracle."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    b = rng.standard_normal((2, s, 8)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    ref = _run_ref(lambda a, b: jax.lax.associative_scan(combine, (a, b),
                                                         axis=1),
                   jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tssm.linear_scan(ta, tb)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
    _hold(tssm.linear_scan_naive(ta, tb).numpy(), got[1], "sequential")


def _aten_ops(fn, *args) -> int:
    """The number of ATen operations ``fn(*args)`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn(*args)
    return Count.n


def test_linear_scan_has_log_depth():
    """Each doubling of S adds the same number of operations (one more
    level of the recursion), so S = 1024 takes ~10 levels, not S steps."""
    ops = [_aten_ops(tssm.linear_scan, torch.ones(1, s, 4),
                     torch.ones(1, s, 4)) for s in (256, 512, 1024)]
    assert ops[2] - ops[1] == ops[1] - ops[0] > 0
    assert ops[2] < 1024 // 2, ops


@pytest.fixture(scope="module")
def rglru():
    jcfg, tcfg, mixer = _layer("recurrentgemma-9b")
    jp, tp = _both(mixer)
    return jcfg, tcfg, mixer, jp, tp


def test_rglru_block_full_and_streaming_match_reference(rglru):
    """``rglru_block_forward`` over a sequence, then streamed: a prompt from
    ``rglru_init_state`` and one token at a time with ``state=``. Streaming
    equals the port's full forward (``tests/test_ssm.py``'s bar); the conv
    state comes back bf16, ``h`` fp32 and unrounded, as the reference's."""
    jcfg, tcfg, _, jp, tp = rglru
    s, steps = 24, 6
    uj, ut = _activations(np.random.default_rng(7), (2, s + steps,
                                                     tcfg.d_model))

    def reference(p, u):
        fwd = jssm.rglru_block_forward(p, u, jcfg)
        out, st = jssm.rglru_block_forward(
            p, u[:, :s], jcfg, state=jssm.rglru_init_state(2, jcfg),
            return_state=True)
        outs = [out]
        for t in range(s, s + steps):
            o, st = jssm.rglru_block_forward(p, u[:, t:t + 1], jcfg, state=st,
                                             return_state=True)
            outs.append(o)
        nostate = jssm.rglru_block_forward(p, u[:, :s], jcfg,
                                           return_state=True)[1]
        return fwd, jnp.concatenate(outs, axis=1), st, nostate

    ref_fwd, ref_stream, ref_state, ref_nostate = _run_ref(reference, jp, uj)
    fwd = tssm.rglru_block_forward(tp, ut, tcfg)
    out, st = tssm.rglru_block_forward(tp, ut[:, :s], tcfg,
                                       state=tssm.rglru_init_state(2, tcfg),
                                       return_state=True)
    nostate = tssm.rglru_block_forward(tp, ut[:, :s], tcfg,
                                       return_state=True)[1]
    outs = [out]
    for t in range(s, s + steps):
        o, st = tssm.rglru_block_forward(tp, ut[:, t:t + 1], tcfg, state=st,
                                         return_state=True)
        outs.append(o)
    stream = torch.cat(outs, dim=1)
    assert st[0].dtype == torch.bfloat16 and st[1].dtype == torch.float32
    _hold(ref_fwd, fwd, "forward")
    _hold(ref_stream, stream, "stream")
    for i, name in enumerate(("conv state", "h")):
        _hold(ref_state[i], st[i], name, block=True)
        _hold(ref_nostate[i], nostate[i], f"{name} without a state",
              block=True)
    assert np.abs(_f32(stream) - _f32(fwd)).max() <= 1e-4  # tests/test_ssm.py


def test_rglru_core_h_last_is_unrounded_fp32(rglru):
    """``_rglru_core`` returns the sequence in the activations' dtype and
    ``h_last`` as the fp32 ``h[:, -1]`` before that rounding."""
    jcfg, tcfg, _, jp, tp = rglru
    uj, ut = _activations(np.random.default_rng(8), (2, 9, tcfg.lru_width))
    ref_h, ref_last = _run_ref(lambda p, x: jssm._rglru_core(p, x, jcfg),
                               jp, uj)
    h, last = tssm._rglru_core(tp, ut, tcfg)
    assert h.dtype == torch.bfloat16 and last.dtype == torch.float32
    assert not torch.equal(last, h[:, -1].float())
    _hold(ref_h, h, "h")
    _hold(ref_last, last, "h_last")


def test_rglru_gates_stay_fp32_and_decay_bounds(rglru):
    """``w_a`` and ``w_i`` are fp32 matmuls in the reference, so the port
    keeps their kernel and bias fp32 at load (every other kernel is bf16);
    rounding them to bf16 would move the gates off the reference's. The
    ``lambda`` init keeps the decay a = exp(-c softplus(Λ) r) in (0, 1],
    and in (0.9, 0.999) at r = 1 (Griffin's appendix)."""
    jcfg, tcfg, mixer, jp, tp = rglru
    for name, leaf in (("w_a", "kernel"), ("w_a", "bias"), ("w_i", "kernel"),
                       ("w_i", "bias")):
        assert tp[name][leaf].dtype == torch.float32, name
    for name in ("w_gate", "w_rec_in", "w_out"):
        assert tp[name]["kernel"].dtype == torch.bfloat16, name
    x = np.random.default_rng(9).standard_normal((2, 5, tcfg.lru_width))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(_run_ref(
        lambda p, x: jax.nn.sigmoid(jssm.L.dense(p, x, jnp.float32)),
        jp["w_a"], xb))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = tssm._sigmoid(tssm.L.dense(tp["w_a"], xt, torch.float32))
    rounded = {k: v.bfloat16() for k, v in tp["w_a"].items()}
    moved = tssm._sigmoid(tssm.L.dense(rounded, xt, torch.float32))
    _hold(ref, got, "gate r")
    assert np.abs(ref - moved.numpy()).max() > 64 * np.abs(
        ref - got.numpy()).max()
    lam = tp["lambda"]
    sp = tssm._softplus(lam)
    a_r0 = torch.exp(-tcfg.c * sp * 0.0)
    a_r1 = torch.exp(-tcfg.c * sp * 1.0)
    assert bool((a_r0 <= 1.0).all()) and bool((a_r1 > 0.0).all())
    assert bool((a_r1 > 0.9 - 1e-6).all()) and bool((a_r1 < 0.999 + 1e-6)
                                                    .all())
    assert np.array_equal(mixer["lambda"], lam.numpy())
