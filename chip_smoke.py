"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Run from the repository root on a machine with one CUDA card; without one
(or outside a checkout) it exits non-zero and prints no result. Every check
that fails raises. Phases:

  0. IEEE fp32 matmuls (TF32 off), the card's name and power limit, and the
     build of every kernel under ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, in parallel) with ptxas's register report.
  1. Kernel vs plain on the card: ``nn_search_kernel`` against
     ``ref.blocked_argmin`` on the same augmented operands, at the main
     path's shapes (seq-0 frame pair, B=1 and B=8, N=4096, M=32768; a 4x
     scene at M=131072), a ragged N/M and a duplicated-target tie case.
     Indices must agree except on near-ties (plain scores of the two
     candidates within 1e-4), ties must go to the first index exactly,
     and max |d2 difference| <= 1e-3. Times the kernel, the plain version
     and one PyTorch call (``matmul`` + ``min``) with CUDA events.
  2. Table-I path: ``FppsICP(engine="cuda").align()`` on seq 0 frame 0 at
     the paper protocol (4096 sampled source points, full target, <= 50
     iterations, 1.0 m gate, epsilon 1e-5), held to the ground truth and
     to the k-d tree baseline (``core/baseline.py``) on the same pair.
  3. Batched path: ``get_engine("cuda").register_pairs`` on 8 consecutive
     seq-0 pairs (one kernel launch per iteration for the whole batch) and
     on one 4x-scene pair (target bucket 131072): per-frame latency,
     iterations, and the kernel's share of an iteration.

The launch counter is set to 0 just before each main-path phase (2, 3) and
read just after. The last lines are the ``{"kernels": [...]}`` report, the
card line from ``nvidia-smi`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FLOPS_PER_PAIR = 10  # 5 fp32 FMA per (query, target) pair; rows 5..7 are 0
NEAR_TIE = 1e-4
D2_TOL = 1e-3
# Reference bands (tests/test_icp.py::test_parity_with_kdtree_baseline).
RMSE_VS_KDTREE = 0.01   # paper: accelerator RMSE within 0.01 m of software
T_VS_KDTREE = 5e-3      # elementwise on the 4x4 transform
T_VS_GT = 0.05          # elementwise on the 4x4 transform


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg=""):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rt_err(Ta, Tb):
    """(rotation angle in rad, translation distance in m) between two T."""
    import numpy as np
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    # ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2): well conditioned near 0,
    # unlike arccos of the trace.
    chord = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(2.0 * np.arcsin(min(chord, 1.0))),
            float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])))


def time_ms(torch, fn, warmup=3, reps=25):
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(b, n, m):
    """Least time (ms) of one search over (b, 8, n) x (b, 8, m) operands."""
    ops_s = b * n * m * FLOPS_PER_PAIR / PEAK_FP32_FLOPS
    bytes_s = (b * 8 * (n + m) * 4 + b * n * 8) / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def phase1(torch, np, scenes):
    """Kernel vs plain on the card at the main path's shapes."""
    from repro_torch.data.collate import bucket_size, collate_pairs, pad_cloud
    from repro_torch.device import round_up
    from repro_torch.kernels import ref
    from repro_torch.kernels.nn_search import (BLOCK_N, TILE_M,
                                               nn_search_kernel)

    dev = torch.device("cuda")

    def operands(src, dst, T):
        src, dst, T = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                       for x in (src, dst, T))
        n, m = src.shape[-2], dst.shape[-2]
        return (ref.augment_source(src, T, pad_to=round_up(n, BLOCK_N)),
                ref.augment_target(dst, pad_to=round_up(m, TILE_M)), n, m)

    def padded(dst):  # the engine's bucketing: far-sentinel rows
        return pad_cloud(dst, bucket_size(len(dst)))[0]

    pairs = scenes["seq0"]
    src0, dst0, T0 = pairs[0]
    batch = collate_pairs([(s, d) for s, d, _ in pairs])
    src4, dst4, T4 = scenes["scene4x"]
    base = dst0[:10240]
    cases = {
        "seq0_b1": operands(src0, padded(dst0), T0),
        "seq0_b8": operands(batch.src, batch.dst,
                            np.stack([T for _, _, T in pairs])),
        "scene4x_b1": operands(src4, padded(dst4), T4),
        "ragged": operands(src0[:3000], dst0[:20001], T0),
        "ties": operands(base[::2][:4096] + np.float32(0.01),
                         np.concatenate([base] * 3), np.eye(4)),
    }
    rows = []
    for name, (src_aug, dst_aug, n, m) in cases.items():
        b = src_aug.shape[0] if src_aug.dim() == 3 else 1
        d2_k, idx_k = nn_search_kernel(src_aug, dst_aug)
        torch.cuda.synchronize()
        d2_p, idx_p = ref.blocked_argmin(src_aug, dst_aug, TILE_M)
        d2_k, idx_k = d2_k[..., :n], idx_k[..., :n]
        d2_p, idx_p = d2_p[..., :n], idx_p[..., :n]

        def score(idx):  # plain score of a chosen column, same arithmetic
            cols = dst_aug.gather(-1, idx.long()[..., None, :].expand(
                *idx.shape[:-1], 8, n))
            return (src_aug[..., :n] * cols).sum(-2)

        diff = idx_k != idx_p
        n_diff = int(diff.sum())
        gap = float((score(idx_k) - score(idx_p))[diff].abs().max()) \
            if n_diff else 0.0
        max_d2 = float((d2_k - d2_p).abs().max())
        check(gap < NEAR_TIE, f"{name}: {n_diff} index mismatches, largest "
              f"plain-score gap {gap} >= {NEAR_TIE}")
        check(max_d2 <= D2_TOL, f"{name}: max |d2 diff| {max_d2} > {D2_TOL}")
        check(bool((idx_k >= 0).all()) and bool((idx_k < m).all()),
              f"{name}: index outside the {m} real targets")
        if name == "ties":  # every copy scores the same: the first wins
            check(bool((idx_k < len(base)).all()),
                  "ties: a later copy of a duplicated target won")
        np_, mp_ = src_aug.shape[-1], dst_aug.shape[-1]
        kernel_ms = time_ms(torch, lambda: nn_search_kernel(src_aug, dst_aug))
        plain_ms = time_ms(torch, lambda: ref.blocked_argmin(
            src_aug, dst_aug, TILE_M))
        library_ms = time_ms(torch, lambda: torch.matmul(
            src_aug.mT, dst_aug).min(dim=-1))
        bound_ms, bound_by = bound(b, np_, mp_)
        row = dict(case=name, shape=[b, n, m], padded=[b, np_, mp_],
                   idx_mismatch=n_diff, near_tie_gap=gap, max_abs_d2=max_d2,
                   kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by)
        rows.append(row)
        log(f"phase1 {name}: B={b} N={n} M={m} (padded {np_}x{mp_}) "
            f"idx_mismatch={n_diff} (near-tie gap {gap:.3g}) "
            f"max|dd2|={max_d2:.3g} | kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, matmul+min {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); "
            f"{bound_ms / kernel_ms:.1%} of bound")
    return rows


def phase2(torch, np, scenes):
    """Table-I path on seq 0 frame 0, against ground truth and k-d tree."""
    from repro_torch.core import FppsICP
    from repro_torch.core.baseline import kdtree_icp
    from repro_torch.kernels.nn_search import nn_search_kernel

    src, dst, T_gt = scenes["seq0"][0]

    def align():
        reg = FppsICP(engine="cuda")
        reg.hardwareInitialize()
        reg.setInputSource(src)
        reg.setInputTarget(dst)
        reg.setMaxCorrespondenceDistance(1.0)
        reg.setMaxIterationCount(50)
        reg.setTransformationEpsilon(1e-5)
        return reg, reg.align()

    align()  # warm-up: first-call allocations, not counted
    nn_search_kernel.launches = 0
    t0 = time.perf_counter()
    reg, T = align()  # ends in a device-to-host copy of the result
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = nn_search_kernel.launches
    res = reg.last_result
    iters = int(res.iterations)
    check(launches > 0, "FppsICP(engine='cuda') never launched the kernel")
    check(launches == iters, f"{launches} launches for {iters} iterations")
    check(np.all(np.isfinite(T)), "non-finite transform")
    t1 = time.perf_counter()
    base = kdtree_icp(src, dst, 50, 1.0, 1e-5)
    base_ms = (time.perf_counter() - t1) * 1e3
    rot, trans = rt_err(T, T_gt)
    b_rot, b_trans = rt_err(base.T, T_gt)
    d_rmse = abs(float(res.rmse) - base.rmse)
    d_T = float(np.abs(T - base.T).max())
    log(f"phase2 FppsICP(engine='cuda').align: N={len(src)} M={len(dst)} "
        f"iterations={iters} converged={bool(res.converged)} "
        f"launches={launches} wall={wall_ms:.2f} ms | rmse={float(res.rmse):.6f}"
        f" kdtree={base.rmse:.6f} (|d|={d_rmse:.2e}) | vs T_gt rot={rot:.3e} "
        f"rad trans={trans:.3e} m (kdtree {b_rot:.3e} / {b_trans:.3e}) | "
        f"max|T-T_kdtree|={d_T:.2e} | kdtree wall={base_ms:.1f} ms (CPU)")
    check(d_rmse <= RMSE_VS_KDTREE, f"rmse off the k-d tree by {d_rmse}")
    check(d_T <= T_VS_KDTREE, f"transform off the k-d tree by {d_T}")
    check(float(np.abs(T - T_gt).max()) <= T_VS_GT, "transform off T_gt")
    return dict(launches=launches, iterations=iters, wall_ms=wall_ms,
                rmse=float(res.rmse), kdtree_rmse=base.rmse, rot_err=rot,
                trans_err=trans, kdtree_rot_err=b_rot,
                kdtree_trans_err=b_trans, max_abs_T_vs_kdtree=d_T)


def device_profile(torch, fn):
    """(device kernels, device-busy ms) of one call of ``fn`` from the
    profiler, or (None, None) when it records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")]
    if not kernels:
        return None, None
    busy = sum(e.device_time_total for e in kernels) / 1e3
    return len(kernels), busy


def phase3(torch, np, scenes, kernel_ms):
    """Batched path: 8 consecutive seq-0 pairs, then one 4x-scene pair."""
    from repro_torch.core import ICPParams, get_engine
    from repro_torch.core.baseline import kdtree_icp
    from repro_torch.kernels.nn_search import nn_search_kernel

    engine = get_engine("cuda")
    params = ICPParams(max_iterations=50, max_correspondence_distance=1.0,
                       transformation_epsilon=1e-5)  # the paper's protocol
    out = {}
    runs = (("seq0_b8", scenes["seq0"]), ("scene4x_b1", [scenes["scene4x"]]))
    for name, triples in runs:
        kms = kernel_ms[name]
        pairs = [(s, d) for s, d, _ in triples]
        engine.register_pairs(pairs, params)  # warm-up
        torch.cuda.synchronize()
        nn_search_kernel.launches = 0
        t0 = time.perf_counter()
        res, batch = engine.register_pairs(pairs, params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = nn_search_kernel.launches
        check(launches == params.max_iterations,
              f"{name}: {launches} launches, expected one per iteration "
              f"({params.max_iterations}) for the whole batch")
        iters = [int(x) for x in res.iterations.cpu()]
        Ts = res.T.cpu().numpy()
        rmses = res.rmse.cpu().numpy()
        for k, (s, d, T_gt) in enumerate(triples):
            base = kdtree_icp(s, d, 50, 1.0, 1e-5)
            check(abs(float(rmses[k]) - base.rmse) <= RMSE_VS_KDTREE,
                  f"{name}[{k}]: rmse {rmses[k]} vs k-d tree {base.rmse}")
            check(float(np.abs(Ts[k] - base.T).max()) <= T_VS_KDTREE,
                  f"{name}[{k}]: transform off the k-d tree")
            check(float(np.abs(Ts[k] - T_gt).max()) <= T_VS_GT,
                  f"{name}[{k}]: transform off T_gt")
        iter_ms = wall_ms / params.max_iterations
        share = kms / iter_ms
        # Per-iteration device launches and busy time: difference of one-
        # and two-iteration runs under the profiler.
        p1 = device_profile(torch, lambda: engine.register_pairs(
            pairs, params._replace(max_iterations=1)))
        p2 = device_profile(torch, lambda: engine.register_pairs(
            pairs, params._replace(max_iterations=2)))
        if p1[0] is None or p2[0] is None:
            per_iter_kernels = per_iter_busy = None
        else:
            per_iter_kernels = p2[0] - p1[0]
            per_iter_busy = p2[1] - p1[1]
        out[name] = dict(frames=len(triples), src_bucket=batch.src.shape[1],
                         dst_bucket=batch.dst.shape[1], launches=launches,
                         wall_ms=wall_ms, per_frame_ms=wall_ms / len(triples),
                         iterations=iters, iter_ms=iter_ms,
                         kernel_ms=kms, kernel_share=share,
                         device_kernels_per_iter=per_iter_kernels,
                         device_busy_ms_per_iter=per_iter_busy)
        busy = ("not measured" if per_iter_busy is None else
                f"{per_iter_kernels} device kernels and {per_iter_busy:.3f} "
                f"ms device-busy per iteration (profiler)")
        log(f"phase3 {name}: {len(triples)} frame(s), buckets N="
            f"{batch.src.shape[1]} M={batch.dst.shape[1]}, launches="
            f"{launches} | wall {wall_ms:.2f} ms = {wall_ms / len(triples):.2f}"
            f" ms/frame, {iter_ms:.3f} ms/iteration | iterations {iters} | "
            f"kernel {kms:.4f} ms = {share:.1%} of an iteration | {busy}")
    # The eager Kabsch step (covariance, 3x3 Jacobi SVD, det flip) alone,
    # at the batch's shape: its share of the per-iteration launches.
    from repro_torch.core.transform import estimate_rigid_transform
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = torch.randn(8, 4096, 3, device="cuda", generator=gen)
    q, w = p + 0.1, torch.ones(8, 4096, device="cuda")
    estimate_rigid_transform(p, q, w)  # warm-up
    k, busy = device_profile(torch, lambda: estimate_rigid_transform(p, q, w))
    out["kabsch_b8"] = dict(device_kernels=k, device_busy_ms=busy)
    log("phase3 Kabsch/SVD step alone (B=8, N=4096): " + (
        "not measured" if k is None else
        f"{k} device kernels, {busy:.3f} ms device-busy (profiler)"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(src/repro_torch is missing)")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs one CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.data.pointcloud import (SceneConfig, frame_pair,
                                             frame_pair_from_world,
                                             make_world)
    from repro_torch.kernels import build
    from repro_torch.kernels.nn_search import nn_search_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")
    log(f"build: {sorted(logs)} in {build_s:.1f} s")

    t0 = time.perf_counter()
    world0 = make_world(0)
    seq0 = [frame_pair_from_world(world0, 0, f) for f in range(8)]
    # 4x the default point counts; frame 3 is the first whose target fits
    # the top bucket (130,666 points -> 131072).
    cfg4 = SceneConfig(n_ground=240_000, n_walls=180_000, n_poles=48_000,
                       n_clutter=52_000)
    scenes = {"seq0": seq0, "scene4x": frame_pair(0, 3, cfg4)}
    log(f"scenes: seq0 targets {[len(d) for _, d, _ in seq0]}, 4x target "
        f"{len(scenes['scene4x'][1])} in {time.perf_counter() - t0:.1f} s")

    report = dict(device=kind, card=card, build_s=build_s)
    cases = {r["case"]: r for r in phase1(torch, np, scenes)}
    report["phase1"] = list(cases.values())
    report["phase2"] = phase2(torch, np, scenes)
    report["phase3"] = phase3(torch, np, scenes,
                              {k: v["kernel_ms"] for k, v in cases.items()})
    main_case = cases["seq0_b1"]
    launches = report["phase2"]["launches"] + sum(
        v.get("launches", 0) for v in report["phase3"].values())
    check(launches > 0, "the main path never launched nn_search")
    report["kernels"] = [dict(
        name="nn_search", route="cuda",
        source="src/repro_torch/kernels/csrc/nn_search.cu",
        replaces="src/repro/kernels/nn_search.py:49",
        replaces_wrapper="src/repro/kernels/nn_search.py::nn_search_kernel",
        launches=launches,
        max_abs_err=max(r["max_abs_d2"] for r in cases.values()),
        ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=main_case["library_ms"], shape=main_case["shape"],
        idx_mismatch=sum(r["idx_mismatch"] for r in cases.values()),
        max_abs_d2=max(r["max_abs_d2"] for r in cases.values()),
        kernel_ms=main_case["kernel_ms"])]
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1, default=float))
    log(json.dumps({"kernels": report["kernels"]}, default=float))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
