"""The serving path (slices 8-10) against the reference, on the CPU at
smoke size: the lockstep ``Engine``, the serve launcher and example, the VQ
modality frontends and the synthetic token stream. Both packages run in
this process on the same numpy weights and inputs.

The reference ``Engine`` runs once an arch (qwen2-0.5b, the recurrent
mamba2-780m and recurrentgemma-9b, minicpm3-4b's MLA and the MoE
deepseek-moe-16b and qwen3-moe-235b-a22b), at the launcher's defaults (the
smoke config, 4 prompts of 32 tokens, 32 generated), on weights from
``lm.init_params_numpy(cfg, 0)`` and prompts from
``launch.serve.prompt_tokens(1, ...)``: what the port's launcher and
example serve with ``--arch`` and ``--device cpu``. Greedy tokens must
equal the reference's up to a row's first difference, and that must fall
where the reference's own teacher-forced top-2 gap (the forward over
prompt + generated tokens) is at most 1e-2, the reference's decode
tolerance (for the recurrent archs, three bf16 ulps of the largest
teacher-forced logit, the bar ``tests/test_torch_lm.py`` holds their
logits to): a near-tie may flip, and later tokens are then free (free
generation diverges after a flipped near-tie). Every
engine must also meet the reference's own contract
(``tests/test_data_and_serve.py``): its tokens are the teacher-forced
argmax of its own forward. VQ indices are exact nearest neighbours: equal
to the reference's except where the two candidates' squared distances lie
within 1e-5 (a near-tie).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.configs import get_smoke as jget_smoke
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import lm as jlm
from repro.serve import modality as jmodality
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import get_smoke
from repro_torch.data.tokens import PrefetchLoader, TokenStream
from repro_torch.examples import serve_lm
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serve import modality
from repro_torch.serve.engine import Engine

ARCH = "qwen2-0.5b"
SSM_ARCHS = ("mamba2-780m", "recurrentgemma-9b")
MLA_MOE_ARCHS = ("minicpm3-4b", "deepseek-moe-16b", "qwen3-moe-235b-a22b")
BATCH, PROMPT, GEN = 4, 32, 32  # the launcher's defaults
DECODE_TOL = 1e-2               # tests/test_arch_smoke.py
SSM_ULPS, ULP = 3, 2.0 ** -7    # tests/test_torch_lm.py
NEAR_TIE = 1e-5
# XLA's backend optimisation level 0: the default level's bits on these
# programs, compiled 2-3x faster.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _teacher_forced(logits, prompt_len):
    """(argmax, top-2 gap) of the forward's logits at the positions that
    predict each generated token."""
    x = np.asarray(logits)[:, prompt_len - 1:-1]
    top2 = np.sort(x, axis=-1)[..., -2:]
    return x.argmax(-1), top2[..., 1] - top2[..., 0]


@pytest.fixture(scope="module", params=(ARCH,) + SSM_ARCHS + MLA_MOE_ARCHS)
def served(request):
    """The reference Engine and the port's on the launcher's inputs."""
    arch = request.param
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    tree = lm.init_params_numpy(cfg, seed=0)
    prompts = serve.prompt_tokens(1, BATCH, PROMPT, cfg.vocab_size)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = np.asarray(JEngine(jcfg, jp, max_len=PROMPT + GEN).generate(
        jnp.asarray(prompts), GEN))
    full = jnp.asarray(np.concatenate([prompts, ref], axis=1))
    ref_logits, _ = jax.jit(jlm.forward, static_argnums=1).lower(
        jp, jcfg, full).compile(FAST_COMPILE)(jp, full)
    model = lm.params_from_reference(tree, cfg, device="cpu")
    got = Engine(cfg, model, max_len=PROMPT + GEN, device="cpu").generate(
        prompts, GEN)
    tol = (SSM_ULPS * ULP * float(np.abs(np.asarray(ref_logits)).max())
           if arch in SSM_ARCHS else DECODE_TOL)
    return dict(arch=arch, cfg=cfg, model=model, prompts=prompts, ref=ref,
                got=got, ref_tf=_teacher_forced(ref_logits, PROMPT), tol=tol)


def _hold_to_reference(tokens, served):
    """Equal to the reference's tokens up to each row's first difference,
    which must fall where the reference's teacher-forced gap is within the
    tolerance."""
    tokens = np.asarray(tokens)
    _, gap = served["ref_tf"]
    for row in range(BATCH):
        diff = np.flatnonzero(tokens[row] != served["ref"][row])
        if diff.size:
            first = diff[0]
            assert gap[row, first] <= served["tol"], (row, first,
                                                      gap[row, first])


def _hold_teacher_forced(tokens, teacher_forced, served):
    """The reference's contract (``tests/test_data_and_serve.py``): greedy
    tokens are the argmax of the forward over prompt + generated tokens.
    A recurrent arch's decode step and its forward (the chunked SSD, the
    scanned RG-LRU) add in another order, MLA's decode is the absorbed
    form of its forward (other products; the reference's own minicpm3-4b
    tokens leave its forward's argmax on three near-ties here), and a MoE
    decode step routes its B tokens as a batch of its own (deepseek's
    reference tokens leave the argmax on one near-tie): there a token may
    differ on a near-tie of that forward, within the tolerance."""
    argmax, gap = teacher_forced
    tokens = np.asarray(tokens)
    if served["arch"] == ARCH:
        np.testing.assert_array_equal(tokens, argmax)
        return
    off = tokens != argmax
    assert (gap[off] <= served["tol"]).all(), (gap[off], served["tol"])


def test_engine_greedy_matches_reference(served):
    got = served["got"]
    assert got.shape == (BATCH, GEN) and got.dtype == torch.int32
    _hold_to_reference(got, served)
    # the reference's own contract, on both packages
    _hold_teacher_forced(served["ref"], served["ref_tf"], served)
    cfg, model = served["cfg"], served["model"]
    full = torch.cat([torch.from_numpy(served["prompts"]), got], dim=1)
    logits, _ = lm.forward(model, cfg, tokens=full)
    _hold_teacher_forced(got.numpy(), _teacher_forced(logits, PROMPT),
                         served)


def test_engine_is_deterministic_and_samples_from_a_generator(served):
    cfg, model, prompts = served["cfg"], served["model"], served["prompts"]
    again = Engine(cfg, model, max_len=PROMPT + GEN, device="cpu").generate(
        torch.from_numpy(prompts), GEN)
    assert torch.equal(again, served["got"])
    eng = Engine(cfg, model, max_len=PROMPT + 8, device="cpu")
    draws = [eng.generate(prompts, 8, temperature=1.0,
                          generator=torch.Generator().manual_seed(seed))
             for seed in (7, 7, 8)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < cfg.vocab_size
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompts, 9)


def test_launcher_and_example_serve_the_reference_tokens(served, capsys):
    arch = ["--arch", served["arch"]]
    out = serve.main(arch + ["--smoke", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"generated {BATCH * GEN} tokens" in printed
    assert "tok/s" in printed
    assert torch.equal(out, served["got"])
    _hold_to_reference(out, served)
    example = serve_lm.main((arch if served["arch"] != ARCH else [])
                            + ["--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == "OK"
    assert torch.equal(example, served["got"])


def test_launcher_refuses_embedding_archs():
    with pytest.raises(SystemExit, match="precomputed embeddings"):
        serve.main(["--arch", "chameleon-34b", "--smoke", "--device", "cpu"])


def test_entry_points_default_to_cuda():
    """Without a card each entry point raises rather than fall back to the
    CPU (``device="cpu"`` asks for the plain path)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    cfg = get_smoke(ARCH)
    model = lm.init_params(cfg, 0, device="cpu")
    runs = (lambda: Engine(cfg, model), lambda: serve.main(["--smoke"]),
            lambda: serve_lm.main([]), lambda: lm.init_params(cfg, 0),
            lambda: modality.chameleon_image_stub(0, 1, 4, 3, 8),
            lambda: modality.musicgen_frame_stub(0, 1, 4, 8, 2, 8),
            lambda: PrefetchLoader(TokenStream(10, 1, 4)))
    for run in runs:
        with pytest.raises(RuntimeError, match="cuda"):
            run()


# -- VQ frontends ------------------------------------------------------------

def _hold_codes(got, ref, latents, codebook):
    """Equal indices except on near-ties of the exact squared distance."""
    got, ref = np.asarray(got).ravel(), np.asarray(ref).ravel()
    lat = np.asarray(latents, np.float64).reshape(got.size, -1)
    book = np.asarray(codebook, np.float64)
    for i in np.flatnonzero(got != ref):
        d = ((lat[i] - book[[got[i], ref[i]]]) ** 2).sum(-1)
        assert abs(d[0] - d[1]) <= NEAR_TIE, (i, d)


@pytest.mark.parametrize("d,use_kernel", [(3, True), (3, False), (16, False)])
def test_vq_encode_matches_reference(d, use_kernel):
    """A 3-D codebook with the kernel flag takes ``nn_search_cuda`` (its
    plain version on a CPU tensor); the others the matmul expansion."""
    books, latents = modality.stub_normals(d, (512, d), (4, 300, d),
                                           device="cpu")
    codes, quant = modality.vq_encode(latents, books, use_kernel=use_kernel)
    ref, ref_quant = jmodality.vq_encode(jnp.asarray(latents.numpy()),
                                         jnp.asarray(books.numpy()))
    assert codes.shape == (4, 300) and codes.dtype == torch.int32
    _hold_codes(codes, ref, latents, books)
    assert torch.equal(quant, books[codes.long()])
    same = codes.numpy() == np.asarray(ref)
    np.testing.assert_array_equal(quant.numpy()[same],
                                  np.asarray(ref_quant)[same])


def test_rvq_and_stubs_match_reference():
    codes, recon = modality.musicgen_frame_stub(3, 2, 12, d_latent=8,
                                                n_books=3, codebook_size=16,
                                                device="cpu")
    books, latents = modality.stub_normals(3, (3, 16, 8), (2, 12, 8),
                                           device="cpu")
    ref, ref_recon = jmodality.rvq_encode(jnp.asarray(latents.numpy()),
                                          jnp.asarray(books.numpy()))
    assert codes.shape == (3, 2, 12) and recon.shape == (2, 12, 8)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
    np.testing.assert_allclose(recon.numpy(), np.asarray(ref_recon),
                               atol=1e-6)
    codes, book = modality.chameleon_image_stub(4, 2, 16, d_latent=8,
                                                codebook_size=32,
                                                device="cpu")
    book2, latents = modality.stub_normals(4, (32, 8), (2, 16, 8),
                                           device="cpu")
    assert torch.equal(book, book2) and codes.shape == (2, 16)
    ref, _ = jmodality.vq_encode(jnp.asarray(latents.numpy()),
                                 jnp.asarray(book.numpy()))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))


# -- token stream ------------------------------------------------------------

@pytest.mark.parametrize("embed_dim", [None, 32])
def test_token_stream_matches_reference_bits(embed_dim):
    args = (1000, 4, 16)
    a = TokenStream(*args, seed=5, embed_dim=embed_dim)
    b = JTokenStream(*args, seed=5, embed_dim=embed_dim)
    for step in (0, 3, 10_000):
        x, y = a.batch_at(step), b.batch_at(step)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_prefetch_loader_order_and_placement():
    stream = TokenStream(100, 2, 8, seed=1)
    loader = PrefetchLoader(stream, device="cpu", prefetch=2)
    got = [next(loader) for _ in range(5)]
    loader.close()
    assert not loader._thread.is_alive()
    assert [s for s, _ in got] == [0, 1, 2, 3, 4]
    for step, batch in got:
        want = stream.batch_at(step)
        for k, v in batch.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), want[k])
