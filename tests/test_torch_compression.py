"""Slice 12 of the port against the reference, on the CPU: the int8
error-feedback data-parallel mean (``optim/compression.py``).

The reference's ``compressed_psum_mean`` runs once for the module on a
4-device ("data",) mesh in a process of its own (``tests/_torch_ep_ref.py``,
forced host devices), on numpy gradients made here: a (4, 1000) case (no
padding) and a (4, 37, 3) case (111 values padded to 112) with a nonzero
starting residual, three steps each chained through the residuals. The
port runs on a ("data",) mesh of 4 repeated CPU devices.

Contracts: the int8 codes of both quantizations and each replica's mean
are the reference's bits at every step, and so is each new residual, but
where XLA's CPU code rounds the reference's ``flat - q * scale`` twice:
XLA fuses the product and the subtraction into one rounding in most lanes
and not in others (the last column of the (37, 3) leaf); the port rounds
once everywhere, so there each element is the reference's one-rounding or
two-rounding result. Then the
reference worker's checks (``tests/grad_compression_worker.py``) on the
port alone: one reduction over 8 replicas within 2% of the exact mean,
20 steps of error feedback within 2% accumulated, and a 4-replica
data-parallel fit of the worker's tanh MLP (in this process; the
reference's 8-device run took minutes) whose compressed final loss stays
within 1.5x (+1e-3) of the uncompressed one. Wire bytes: ~1 byte a value
each way against 8 for an fp32 ring.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro_torch.launch import mesh as tmesh
from repro_torch.optim import compression as tc
from repro_torch.roofline.report import count_collectives

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = {"flat": (1000,), "padded": (37, 3)}
SEEDS = {"flat": 10, "padded": 11}
STEPS = 3
N_REF = 4
REL_TOL = 0.02      # tests/grad_compression_worker.py's bars
LOSS_RATIO = 1.5


def _case_inputs(case):
    shape = CASES[case]
    rng = np.random.default_rng(SEEDS[case])
    gs = [rng.standard_normal((N_REF,) + shape, dtype=np.float32)
          + np.float32(0.3) for _ in range(STEPS)]
    ef = (np.zeros((N_REF,) + shape, np.float32) if case == "flat" else
          rng.standard_normal((N_REF,) + shape, dtype=np.float32)
          * np.float32(0.01))
    return gs, ef


def _mesh(n):
    return tmesh.make_debug_mesh((n,), ("data",), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("compress_ref")
    arrays = {"steps": np.array(STEPS)}
    for case in CASES:
        gs, ef = _case_inputs(case)
        arrays[f"ef/{case}"] = ef
        for step, g in enumerate(gs):
            arrays[f"g/{case}/{step}"] = g
    np.savez(d / "in.npz", **arrays)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_ep_ref.py"),
         str(d / "in.npz"), str(d / "out.npz")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_codes_means_and_residuals_are_the_reference_bits(ref, case):
    gs, ef = _case_inputs(case)
    mesh = _mesh(N_REF)
    efs = [torch.from_numpy(e.copy()) for e in ef]
    unfused = 0
    for step, g in enumerate(gs):
        codes = []
        flats = [torch.from_numpy(r.copy()) + e for r, e in zip(g, efs)]
        means, efs = tc.compressed_psum_mean(
            [torch.from_numpy(r.copy()) for r in g], mesh, "data", efs,
            codes=codes)
        (q, q2), = codes
        tag = f"c/{case}/{step}"
        for r in range(N_REF):
            assert np.array_equal(q[r].reshape(-1).numpy(),
                                  ref[f"{tag}/q"][r]), (step, r)
            assert np.array_equal(q2[r].numpy(), ref[f"{tag}/q2"][r]), (
                step, r)
            assert np.array_equal(means[r].numpy(), ref[f"{tag}/mean"][r]), (
                step, r)
            # the residual flat - q * scale rounded once (fused), as XLA
            # computes it but in lanes its vectorizer leaves unfused
            want = ref[f"{tag}/ef"][r]
            got = efs[r].numpy()
            scale = np.float32(np.abs(np.pad(flats[r].numpy().ravel(), (
                0, (-flats[r].numel()) % N_REF))).max()) * np.float32(
                1 / 127)
            two = (flats[r].numpy() - (q[r].reshape(-1)[:got.size].numpy()
                                       .reshape(got.shape) * scale))
            assert np.all((got == want) | (two == want)), (step, r)
            unfused += int((got != want).sum())
        # the next step starts from the reference's residuals (the same as
        # the port's where no lane is unfused)
        efs = [torch.from_numpy(ref[f"{tag}/ef"][r].copy())
               for r in range(N_REF)]
    # the (4, 1000) case has no unfused lane; the (37, 3) case's last
    # column is computed unfused by the reference
    assert (unfused == 0) == (case == "flat"), unfused


def test_replica_per_device_gives_the_same_bits(monkeypatch):
    """Each replica in a group of its own (a mesh of distinct devices: the
    chunks move one by one) gives the bits of one batch of all four."""
    gs, ef = _case_inputs("padded")

    def run():
        codes = []
        means, efs = tc.compressed_psum_mean(
            [torch.from_numpy(r.copy()) for r in gs[0]], _mesh(N_REF), "data",
            [torch.from_numpy(e.copy()) for e in ef], codes=codes)
        (q, q2), = codes
        return means + efs + q + q2

    one = run()
    monkeypatch.setattr(tc, "device_groups", lambda devices: [
        (dev, [r]) for r, dev in enumerate(devices)])
    assert all(torch.equal(a, b) for a, b in zip(one, run()))


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def test_single_reduction_near_exact_mean():
    """The worker's check 1: 8 replicas of 1000 normal values."""
    n = 8
    gs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (n, 1000), dtype=np.float32))
    means, _ = tc.compressed_psum_mean(list(gs), _mesh(n), "data",
                                       [torch.zeros(1000)] * n)
    exact = gs.mean(0)
    assert all(torch.equal(m, means[0]) for m in means)
    assert _rel(means[0], exact) < REL_TOL


def test_error_feedback_accumulates_unbiased():
    """The worker's check 1, continued: 20 steps of N(0.3, 1) gradients,
    the compressed means' sum within 2% of the exact means' sum."""
    n = 8
    mesh = _mesh(n)
    efs = [torch.zeros(1000)] * n
    acc_c = torch.zeros(1000)
    acc_e = torch.zeros(1000)
    for step in range(20):
        g = torch.from_numpy(np.random.default_rng(step).standard_normal(
            (n, 1000), dtype=np.float32)) + 0.3
        means, efs = tc.compressed_psum_mean(list(g), mesh, "data", efs)
        acc_c += means[0]
        acc_e += g.mean(0)
    assert _rel(acc_c, acc_e) < REL_TOL


def test_data_parallel_fit_tracks_fp32():
    """The worker's check 2 at smoke size: its tanh MLP fitted by 4
    data-parallel replicas, 40 steps of SGD, with the compressed and the
    exact gradient mean."""
    n = 4
    rng = np.random.default_rng(7)
    w0 = {"a": rng.standard_normal((16, 32), dtype=np.float32) * 0.1,
          "b": rng.standard_normal((32, 4), dtype=np.float32) * 0.1}
    x = torch.from_numpy(rng.standard_normal((64, 16), dtype=np.float32))
    y = torch.tanh(x[:, :4]) * 0.5
    mesh = _mesh(n)

    def loss_fn(w, xb, yb):
        return ((torch.tanh(xb @ w["a"]) @ w["b"] - yb) ** 2).mean()

    def run(compress):
        w = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
        efs = [tc.init_error_feedback(w) for _ in range(n)]
        for _ in range(40):
            grads = []
            for r in range(n):
                wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
                loss_fn(wr, x[r * 16:(r + 1) * 16],
                        y[r * 16:(r + 1) * 16]).backward()
                grads.append({k: v.grad for k, v in wr.items()})
            if compress:
                means, efs = tc.compressed_grad_reduce(grads, mesh, "data",
                                                       efs)
                g = means[0]
            else:
                g = {k: torch.stack([gr[k] for gr in grads]).mean(0)
                     for k in w}
            w = {k: w[k] - 0.2 * g[k] for k in w}
        return float(loss_fn(w, x, y))

    l_fp32, l_int8 = run(False), run(True)
    assert l_int8 < LOSS_RATIO * l_fp32 + 1e-3, (l_fp32, l_int8)


def test_wire_bytes_quarter_of_fp32_ring():
    n, values = 4, 4096
    gs = [torch.ones(values) for _ in range(n)]
    with count_collectives() as coll:
        tc.compressed_psum_mean(gs, _mesh(n), "data",
                                [torch.zeros(values)] * n)
    wire = sum(d["bytes"] for d in coll.values())
    ring = tc.fp32_ring_bytes(values, n)
    # int8 chunks each way, plus one fp32 scale a replica each way
    assert wire == 2 * (n - 1) * values + 2 * n * (n - 1) * 4
    assert 3.9 < ring / wire <= 4.0
