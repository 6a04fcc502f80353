"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Run from the repository root on a machine with one CUDA card; without one
(or outside a checkout) it exits non-zero and prints no result. Every check
that fails raises. Phases:

  0. IEEE fp32 matmuls (TF32 off), the card's name and power limit, and the
     build of every kernel under ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, in parallel) with ptxas's register and spill
     report (the log is kept beside each library, so a cached build reports
     it too), and the opcode mix of the NN kernel's innermost loop (static
     counts from ``cuobjdump -sass``).
  1. Kernel vs plain on the card: ``nn_search_kernel`` (register-tiled
     queries, one compare per group of targets, the target-axis splits
     merged inside the one kernel) against ``ref.blocked_argmin`` on the
     same augmented operands, at the main path's shapes (seq-0 frame pair,
     B=1 and B=8, N=4096, M=32768; a 4x scene at M=131072), a ragged N/M
     and a duplicated-target tie case. Indices must agree except on
     near-ties (plain scores of the two candidates within 1e-4), ties must
     go to the first index exactly, and max |d2 difference| <= 1e-3; on
     top of these, the kernel must give the plain version's bits: 0 index
     mismatches and max |d2 difference| 0 in every case (the totals over
     all cases are printed). Times the kernel, the plain version and
     one PyTorch call (``matmul`` + ``min``) on the device alone
     (``device_ms``: CUDA events around back-to-back calls queued behind a
     busy-wait, so the wrappers' host overhead is outside the window), and
     counts the device kernels of one call with the profiler at B=1, B=8
     and the 4x scene (must be 1).
  2. Table-I path: ``FppsICP(engine="cuda").align()`` on seq 0 frame 0 at
     the paper protocol (4096 sampled source points, full target, <= 50
     iterations, 1.0 m gate, epsilon 1e-5), held to the ground truth and
     to the k-d tree baseline (``core/baseline.py``) on the same pair.
  3. Batched path: ``get_engine("cuda").register_pairs`` on 8 consecutive
     seq-0 pairs (one kernel launch per iteration for the whole batch) and
     on one 4x-scene pair (target bucket 131072): per-frame latency,
     iterations, and the kernel's share of an iteration.
  4. Grid kernels vs plain on the card: ``candidate_sweep_kernel`` against
     ``ref.candidate_sweep`` and the fused pass (``moment_planes``) against
     ``ref.fused_moment_planes`` on the candidate rows of a (128, 128, 32),
     1 m, K=32 grid: the seq-0 frame-0 target with its 4096 source points
     moved by T_gt (B=1), the 8-pair batch, the 4x scene, a ragged N=3000, a
     duplicated-point target (the first slot must win) and queries outside
     the lattice (d2 = inf, all-zero moments). Slots and d2 within 1e-6
     relative, planes within 1e-6, the 18 sums within 2e-5; kernel, plain
     and bound times; ``polish_stats``; two voxel builds bit-identical.
  5. Pyramid path: ``FppsICP(engine="pyramid").align()`` at the Table-I
     protocol (twice, bit-identical), the fused pyramid, the fused
     ``"cuda"`` engine, odometry's ``levels=()`` huber-0.3 engine,
     ``register_pairs`` on the 8 seq-0 pairs (unfused and fused) and the 4x
     scene, each held to the k-d tree and T_gt with phase 2's bands and to
     exact launch counts; device kernels and busy time of one polish
     iteration; one iteration of the brute, grid and fused chains.
  6. Slice-3 kernels vs plain on the card: ``moment_sweep`` (normals)
     against ``ref.normal_moments`` with the queries = the target cloud,
     radius 1 m over a (128, 128, 32), 1 m, K=32 grid: the seq-0 frame-0
     target (B=1), the 8 bucket-padded seq-0 targets (B=8), the 4x scene, a
     ragged M=20001, a duplicated-point target and queries 500 m outside
     (all ten sums exactly 0). The sums must be the same bits (the plain
     version adds in the kernel's lane order) and within 1e-5 of their
     magnitude; two kernel runs the same bits; normals from the two within
     1e-4 where valid in both, with the validity masks' disagreements
     counted. The 45-plane fused pass (``moment_planes`` with candidate
     normals = knn normals of the seq-0 targets) against
     ``ref.fused_moment_planes`` at B=1 and B=8 (4096 x 864) and on empty
     neighbourhoods, under none, huber 0.3 and tukey 0.8: planes the same
     bits, the 45 sums within 2e-5, and ``prune=True`` the same bits as
     ``prune=False``. Kernel (with and without prune), plain and bound
     times.
  7. Point-to-plane paths at the Table-I protocol on seq 0 frame 0:
     ``FppsICP(engine="cuda")`` and ``FppsICP(engine="pyramid")`` with
     ``setMinimizer("point_to_plane")``, both engines fused, one ``icp`` run
     whose target normals come from ``estimate_normals_radius`` (the
     moment-sweep kernel), and ``register_pairs`` on the 8 seq-0 pairs
     through ``"cuda"``, unfused and fused. Each is held to T_gt (0.05) and
     its true-NN RMSE to the k-d tree's (0.01 m), with exact launch counts;
     device kernels and busy time per iteration of the batch; the knn
     normals' cost at B=8. Each plane run is logged beside the
     point-to-point run of the same path (phases 2, 3 and 5).
  8. Streaming scan-to-map odometry: ``OdometryPipeline(device="cuda")``
     on seq 0 frames 0-14 (default ``SceneConfig``, ~32.5k points a scan)
     with ``OdometryConfig(scan_budget=16384)``, held to JAX reference runs
     of the same streams (constants below, from CPU runs of ``src/repro``):
     (a) the fp32 stream twice (the same bits), positions within 0.05 m of
     the reference's and the same (tier, health, quarantined) per frame;
     (b) fp16 submap storage, likewise against the reference's fp16 run;
     (c) the fused polish, within 0.05 m of (a) with its tiers; (d) a
     ``crop:0.15`` burst on frames 5-8 (the robustness benchmark's): some
     burst frame settles or reasons otherwise than in (a), and no frame's
     error exceeds the reference's by more than 0.05 m; (e) each retry
     tier once on frame 10, its translation within 0.05 m of the
     reference's attempt. Launch counts are exact per run, from every
     registration's engine and iterations; the scan downsample and the
     submap drop no cell. The operands of every kernel call of frame 10
     (one per shape and registration: (a)'s primary, widen, fallback and
     wide_basin, (c)'s fused passes) are kept and held to the plain
     versions: the main path's result and a relaunch the same bits.
     Recorded, not gated: wall ms per frame, its split into prepare,
     probe, registration, health and fuse; the fallback at other iteration
     caps and from the reference's frame-9 position; one primary-only
     frame's device kernels and busy time against its own wall time.

Every kernel count is set to 0 just before each main-path run (phases 2, 3,
5, 7 and 8) and read just after. The last lines are the ``{"kernels": [...]}``
report, the card line from ``nvidia-smi`` and ``{"ok": true, "device":
{...}}``.
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
# The search's work: 4 fp32 FMA per (query, target) pair (the four-term
# sum; rows 5..7 are 0) and one add per query (|p'|², as row 4 of the target
# operand is 1). The first port's bound counted the fifth FMA of every pair;
# ``bound5_ms`` keeps that figure so that older shares of bound compare.
FLOPS_PER_PAIR = 8
FLOPS_PER_PAIR_5FMA = 10
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
    """Median of ``reps`` CUDA-event timings of one call of ``fn`` after a
    warm-up, each from an idle stream: host and device time together (the
    whole eager iteration of a chain)."""
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


_CYCLES_PER_MS = []


def _sleep_cycles_per_ms(torch):
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card, measured
    once."""
    if not _CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(cycles // 10)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def device_ms(torch, fn, reps=20, blocks=5, warmup=3):
    """Device time of one call of ``fn``: ``(median, min, max, ahead)`` in
    ms over ``blocks`` blocks, each the CUDA-event time of ``reps``
    back-to-back calls divided by ``reps``.

    Each block is queued behind a busy-wait kernel (``torch.cuda._sleep``)
    sized to twice the host's time for ``reps`` calls, so the host has
    enqueued every call before the first one starts and the window holds
    device time only, not the wrappers' host overhead. If the first block's
    start event fired before the host finished enqueueing, it is retried
    twice with a doubled wait; if it never got ahead, ``fn`` syncs the host
    inside (a plain version that copies a scalar to the card), no wait can
    help, and the remaining blocks run without one: ``ahead`` is then False
    and the time includes those host gaps.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(_sleep_cycles_per_ms(torch) * (2.0 * reps * host_ms + 0.5))
    times, ahead = [], True
    for block in range(blocks):
        for attempt in range(3 if block == 0 else 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if ahead:
                torch.cuda._sleep(cycles)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            got_ahead = not start.query()
            end.synchronize()
            if got_ahead or not ahead:
                break
            cycles *= 2
        ahead = ahead and got_ahead
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), min(times), max(times), ahead


def fmt_ms(t):
    """``median [min-max]`` of a :func:`device_ms` result."""
    return f"{t[0]:.4f} [{t[1]:.4f}-{t[2]:.4f}]" + ("" if t[3] else " host")


def bound(b, n, m, flops_per_pair=FLOPS_PER_PAIR):
    """Least time (ms) of one search over (b, 8, n) x (b, 8, m) operands."""
    ops_s = b * n * (m * flops_per_pair + 1) / PEAK_FP32_FLOPS
    bytes_s = (b * 8 * (n + m) * 4 + b * n * 8) / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def sass_loop_mix(lib_path, kernel):
    """Opcode counts (static) of ``kernel``'s innermost loop with the most
    FFMA+FMUL in the SASS of ``lib_path``: the range from a backward
    branch's target to the branch, holding no other backward branch. None
    when ``cuobjdump`` gives nothing to read."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    insns, labels, inside = [], {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            labels[m.group(1)] = len(insns)
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9]*)(\S*)\s*([^;]*)", line)
        if m:
            insns.append((int(m.group(1), 16), m.group(2), m.group(4)))
    addr_index = {a: i for i, (a, _, _) in enumerate(insns)}
    loops = []
    for i, (_, op, args) in enumerate(insns):
        if op != "BRA":
            continue
        t = re.search(r"\.L_x_\d+", args)
        if t and t.group(0) in labels:
            target = labels[t.group(0)]
        else:
            t = re.match(r"\s*(?:!?U?P\w+\s*,\s*)?(0x[0-9a-f]+)", args)
            target = addr_index.get(int(t.group(1), 16)) if t else None
        if target is not None and target <= i:
            loops.append((target, i))
    inner = [(a, z) for a, z in loops
             if not any(a <= a2 and z2 <= z and (a2, z2) != (a, z)
                        for a2, z2 in loops)]
    if not inner:
        return None
    mixes = [collections.Counter(op for _, op, _ in insns[a:z + 1])
             for a, z in inner]
    return max(mixes, key=lambda c: c["FFMA"] + c["FMUL"])


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
        d2_p, idx_p = ref.blocked_argmin(src_aug, dst_aug)
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
        check(n_diff == 0 and max_d2 == 0, f"{name}: {n_diff} index "
              f"mismatches, max |d2 diff| {max_d2}; the kernel must give "
              f"the plain version's bits")
        check(bool((idx_k >= 0).all()) and bool((idx_k < m).all()),
              f"{name}: index outside the {m} real targets")
        if name == "ties":  # every copy scores the same: the first wins
            check(bool((idx_k < len(base)).all()),
                  "ties: a later copy of a duplicated target won")
        np_, mp_ = src_aug.shape[-1], dst_aug.shape[-1]
        kern = device_ms(torch, lambda: nn_search_kernel(src_aug, dst_aug))
        plain = device_ms(torch, lambda: ref.blocked_argmin(src_aug, dst_aug))
        lib = device_ms(torch, lambda: torch.matmul(
            src_aug.mT, dst_aug).min(dim=-1))
        bound_ms, bound_by = bound(b, np_, mp_)
        bound5_ms = bound(b, np_, mp_, FLOPS_PER_PAIR_5FMA)[0]
        row = dict(case=name, shape=[b, n, m], padded=[b, np_, mp_],
                   idx_mismatch=n_diff, near_tie_gap=gap, max_abs_d2=max_d2,
                   kernel_ms=kern[0], kernel_ms_spread=kern[1:3],
                   plain_ms=plain[0], plain_ahead=plain[3],
                   library_ms=lib[0], bound_ms=bound_ms, bound_by=bound_by,
                   bound5_ms=bound5_ms)
        rows.append(row)
        log(f"phase1 {name}: B={b} N={n} M={m} (padded {np_}x{mp_}) "
            f"idx_mismatch={n_diff} (near-tie gap {gap:.3g}) "
            f"max|dd2|={max_d2:.3g} | kernel {fmt_ms(kern)} ms, plain "
            f"{fmt_ms(plain)} ms, matmul+min {fmt_ms(lib)} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); "
            f"{bound_ms / kern[0]:.1%} of bound ({bound5_ms / kern[0]:.1%} "
            f"of the 5-FMA bound {bound5_ms:.4f} ms)")
    log(f"phase1 all cases: {sum(r['idx_mismatch'] for r in rows)} index "
        f"mismatches, max |d2 - plain| {max(r['max_abs_d2'] for r in rows)} "
        f"(expected 0 and 0)")
    by_case = {r["case"]: r for r in rows}
    for name in ("seq0_b1", "seq0_b8", "scene4x_b1"):
        src_aug, dst_aug = cases[name][:2]
        kernels, busy, _ = device_profile(
            torch, lambda: nn_search_kernel(src_aug, dst_aug))
        check(kernels == 1, f"{name}: one nn_search_kernel call ran "
              f"{kernels} device kernels, expected 1")
        by_case[name]["device_kernels_per_call"] = kernels
        log(f"phase1 {name}: {kernels} device kernel per nn_search_kernel "
            f"call (profiler, {busy:.4f} ms busy)")
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
    """(device kernels, device-busy ms, host launch calls) of one call of
    ``fn`` from the profiler, or (None, None, launches) when it records no
    device activity.

    One profiling cycle (no schedule) with ``acc_events=True``, so no event
    is cleared between cycles. Device kernels are the CUDA-side kernel
    records (memcpy and memset records excluded); host launch calls are the
    CPU-side ``cudaLaunchKernel``-family runtime records, which the host
    writes synchronously. The two agree when the device trace is whole.
    """
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and not e.name.startswith(("Memcpy", "Memset"))]
    launches = sum(1 for e in events
                   if not str(e.device_type).endswith("CUDA")
                   and "LaunchKernel" in e.name)
    if not kernels:
        return None, None, launches
    busy = sum(e.device_time_total for e in kernels) / 1e3
    return len(kernels), busy, launches


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
        per_iter_launches = p2[2] - p1[2]
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
                         host_launches_per_iter=per_iter_launches,
                         device_busy_ms_per_iter=per_iter_busy)
        busy = ("not measured" if per_iter_busy is None else
                f"{per_iter_kernels} device kernels ({per_iter_launches} "
                f"host launch calls) and {per_iter_busy:.3f} ms device-busy "
                f"per iteration (profiler)")
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
    runs = [device_profile(torch, lambda: estimate_rigid_transform(p, q, w))
            for _ in range(3)]
    k, busy, launches = runs[-1]
    out["kabsch_b8"] = dict(device_kernels=[r[0] for r in runs],
                            host_launches=[r[2] for r in runs],
                            device_busy_ms=busy)
    log("phase3 Kabsch/SVD step alone (B=8, N=4096), 3 profiled calls: " + (
        "not measured" if k is None else
        f"{[r[0] for r in runs]} device kernels, {[r[2] for r in runs]} "
        f"host launch calls, {busy:.3f} ms device-busy (profiler)"))
    return out

# Slice 2: the grid candidate sweep and the fused moment pass, over the
# resident grid's default lattice (core.nn_search_grid.DEFAULT_GRID_DIMS)
# at 1 m voxels.
GRID_K = 32                 # max_per_cell: CK = 27 * 32 = 864
GRID_FLOPS_PER_SLOT = 9     # 3 sub, 3 mul, 2 add, 1 compare
SLOT_D2_RTOL = 1e-6         # kernel vs plain d2; near-tie slots likewise
PLANE_RTOL = 1e-6           # fused per-query planes
SUM_RTOL = 2e-5             # the 18 sums (tests/test_fused_icp.py bar)


def grid_bound(rows, ck, out_bytes_per_row):
    """Least time (ms) of one pass over (rows, ck, 3) candidates: every
    input byte read once, every output byte written once, against the
    direct-form flops; returns (ms, "bytes" | "operations")."""
    bytes_s = (rows * ck * 12 + rows * 12 + rows * out_bytes_per_row) \
        / PEAK_BYTES_PER_S
    ops_s = rows * ck * GRID_FLOPS_PER_SLOT / PEAK_FP32_FLOPS
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def phase4(torch, np, scenes):
    """Grid sweep and fused pass vs their plain versions on the card."""
    from repro_torch.core.nn_search_grid import (DEFAULT_GRID_DIMS,
                                                 gather_candidates,
                                                 neighborhood_stats,
                                                 nn_search_grid, take_slot)
    from repro_torch.core.transform import transform_points
    from repro_torch.data.collate import collate_pairs
    from repro_torch.data.voxelize import build_voxel_grid, voxel_downsample
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_icp import P2P_MOMENTS, moment_planes
    from repro_torch.kernels.nn_search_grid import candidate_sweep_kernel

    dev = torch.device("cuda")

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def case(srcs, dsts, Ts, shift=(0.0, 0.0, 0.0)):
        """Queries = sources moved by their T (B, N, 3); a batched grid over
        the bucket-padded targets with dst_valid."""
        batch = collate_pairs([(srcs[0], d) for d in dsts])
        grid = build_voxel_grid(tensor(batch.dst), 1.0, DEFAULT_GRID_DIMS,
                                valid=tensor(batch.dst_valid, torch.bool))
        q = transform_points(tensor(np.stack(Ts)), tensor(np.stack(srcs)))
        return q + tensor(shift), grid

    pairs = scenes["seq0"]
    src0, dst0, T0 = pairs[0]
    src4, dst4, T4 = scenes["scene4x"]
    base = dst0[:10240]
    eye = np.eye(4, dtype=np.float32)
    cases = {
        "seq0_b1": case([src0], [dst0], [T0]),
        "seq0_b8": case([s for s, _, _ in pairs], [d for _, d, _ in pairs],
                        [T for _, _, T in pairs]),
        "scene4x_b1": case([src4], [dst4], [T4]),
        "ragged": case([src0[:3000]], [dst0], [T0]),
        # every target point three times: the first copy's slot must win
        "ties": case([base[::2][:4096] + np.float32(0.01)],
                     [np.concatenate([base] * 3)], [eye]),
        # the whole frame moved 500 m past the lattice: empty hoods
        "outside": case([src0], [dst0], [T0], shift=(500.0, 0.0, 0.0)),
    }
    rows_out = []
    for name, (q, grid) in cases.items():
        b, n = q.shape[0], q.shape[1]
        cand, cand_idx, cand_valid = gather_candidates(q, grid, GRID_K)
        ck = cand.shape[-2]
        sv = torch.ones(q.shape[:-1], dtype=torch.float32, device=dev)
        d2_k, slot_k = candidate_sweep_kernel(q, cand)
        torch.cuda.synchronize()
        d2_p, slot_p = ref.candidate_sweep(q, cand)

        def slot_d2(slot):  # plain d2 of a chosen slot, same arithmetic
            d = q - take_slot(cand, slot)
            return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
                + d[..., 2] * d[..., 2]

        diff = slot_k != slot_p
        n_diff = int(diff.sum())
        gap = float(((slot_d2(slot_k) - d2_p).abs()
                     / d2_p.abs().clamp_min(1e-30))[diff].max()) \
            if n_diff else 0.0
        d2_err = float(((d2_k - d2_p).abs()
                        / d2_p.abs().clamp_min(1e-30)).max())
        d2_abs = float((d2_k - d2_p).abs().max())
        check(gap <= SLOT_D2_RTOL, f"grid {name}: {n_diff} slot mismatches, "
              f"largest relative d2 gap {gap} > {SLOT_D2_RTOL}")
        check(d2_err <= SLOT_D2_RTOL, f"grid {name}: relative d2 error "
              f"{d2_err} > {SLOT_D2_RTOL}")
        has = cand_valid.any(-1)
        if name == "ties":
            idx = take_slot(cand_idx, slot_k)
            check(bool((idx[has] < len(base)).all()),
                  "ties: a later copy of a duplicated point won")
        if name == "outside":
            check(not bool(has.any()), "outside: a query saw candidates")
            check(bool((d2_k > 1e29).all()), "outside: a finite winner")
            d2_w = nn_search_grid(q, grid, max_per_cell=GRID_K)[0]
            check(bool(torch.isinf(d2_w).all()),
                  "outside: nn_search_grid gave a finite d2")

        fused = []
        robusts = ([("none", 0.5), ("huber", 0.3), ("tukey", 1.0)]
                   if name == "seq0_b1" else [("none", 0.5)])
        for robust, scale in robusts:
            kw = dict(gate=1.0, robust_kernel=robust, robust_scale=scale)
            pl_k = moment_planes(q, cand, sv, **kw)
            torch.cuda.synchronize()
            pl_p = ref.fused_moment_planes(q, cand, sv, **kw)
            plane_ok = bool(((pl_k - pl_p).abs()
                             <= PLANE_RTOL * pl_p.abs() + PLANE_RTOL).all())
            plane_abs = float((pl_k - pl_p).abs().max())
            s_k, s_p = pl_k.sum(-1), pl_p.sum(-1)
            sum_ok = bool(((s_k - s_p).abs()
                           <= SUM_RTOL * s_p.abs() + SUM_RTOL).all())
            sum_rel = float(((s_k - s_p).abs()
                             / s_p.abs().clamp_min(1e-30)).max())
            check(plane_ok, f"fused {name} {robust}: a plane is off its plain "
                  f"version by more than {PLANE_RTOL} relative (max abs "
                  f"{plane_abs})")
            check(sum_ok, f"fused {name} {robust}: a moment sum is off its "
                  f"plain version by more than {SUM_RTOL} relative")
            if name == "outside":
                check(bool((pl_k == 0).all()), "outside: non-zero moments")
            fused.append(dict(robust=robust, max_abs_plane=plane_abs,
                              max_rel_sum=sum_rel,
                              weight_sum=[float(x) for x in
                                          s_k[..., P2P_MOMENTS.index("w")]]))

        stats = neighborhood_stats(q, grid, GRID_K)
        stats = {f: float(v.mean()) for f, v in zip(stats._fields, stats)}
        rows = b * n
        sweep = device_ms(torch, lambda: candidate_sweep_kernel(q, cand))
        sweep_plain = device_ms(torch, lambda: ref.candidate_sweep(q, cand))
        fused_t = device_ms(torch, lambda: moment_planes(q, cand, sv,
                                                         gate=1.0))
        fused_plain = device_ms(torch, lambda: ref.fused_moment_planes(
            q, cand, sv, gate=1.0))
        sweep_bound, sweep_by = grid_bound(rows, ck, 8)
        fused_bound, fused_by = grid_bound(rows, ck, 4 + 4 * len(P2P_MOMENTS))
        row = dict(case=name, shape=[b, n, ck], slot_mismatch=n_diff,
                   near_tie_rel_gap=gap, max_rel_d2=d2_err,
                   max_abs_d2=d2_abs, fused=fused, polish_stats=stats,
                   sweep_ms=sweep[0], sweep_ms_spread=sweep[1:3],
                   sweep_plain_ms=sweep_plain[0],
                   sweep_plain_ahead=sweep_plain[3],
                   sweep_bound_ms=sweep_bound, sweep_bound_by=sweep_by,
                   fused_ms=fused_t[0], fused_ms_spread=fused_t[1:3],
                   fused_plain_ms=fused_plain[0],
                   fused_plain_ahead=fused_plain[3],
                   fused_bound_ms=fused_bound, fused_bound_by=fused_by)
        rows_out.append(row)
        log(f"phase4 {name}: B={b} N={n} CK={ck} slot_mismatch={n_diff} "
            f"max rel d2 {d2_err:.3g} | fused max|dplane| "
            f"{max(f['max_abs_plane'] for f in fused):.3g}, max rel sum "
            f"{max(f['max_rel_sum'] for f in fused):.3g} "
            f"({', '.join(f['robust'] for f in fused)}) | sweep "
            f"{fmt_ms(sweep)} ms (plain {fmt_ms(sweep_plain)}, bound "
            f"{sweep_bound:.4f} {sweep_by}), fused {fmt_ms(fused_t)} ms "
            f"(plain {fmt_ms(fused_plain)}, bound {fused_bound:.4f} "
            f"{fused_by}) | polish_stats "
            + " ".join(f"{k}={v:.4f}" for k, v in stats.items()))
        del cand, cand_idx, cand_valid

    # Deterministic centroids and tables: two builds, the same bits.
    dst = tensor(collate_pairs([(src0, dst0)]).dst[0])
    a = voxel_downsample(dst, 4.0, max_points=8192)
    b = voxel_downsample(dst, 4.0, max_points=8192)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "voxel_downsample differs between two runs on the card")
    g1 = build_voxel_grid(dst, 1.0, DEFAULT_GRID_DIMS)
    g2 = build_voxel_grid(dst, 1.0, DEFAULT_GRID_DIMS)
    check(all(torch.equal(x, y) for x, y in zip(g1[:5], g2[:5])),
          "build_voxel_grid differs between two runs on the card")
    log("phase4 voxel_downsample and build_voxel_grid: bit-identical "
        "between two runs")
    return rows_out


def counted(torch, fn):
    """(result, wall ms, launches per kernel) of ``fn`` with every kernel
    count set to 0 just before it and read just after."""
    from repro_torch.kernels.fused_icp import fused_moment_sweep
    from repro_torch.kernels.nn_search import nn_search_kernel
    from repro_torch.kernels.nn_search_grid import candidate_sweep_kernel
    from repro_torch.kernels.normals import moment_sweep
    counters = dict(nn_search=nn_search_kernel,
                    candidate_sweep=candidate_sweep_kernel,
                    fused_moment_sweep=fused_moment_sweep,
                    moment_sweep=moment_sweep)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return out, wall_ms, {k: c.launches for k, c in counters.items()}


def nn_rmse(np, T, src, dst, gate=1.0):
    """The k-d tree's RMSE measure at transform T: gated true-nearest-
    neighbour residuals of T·src in dst (float64, scipy)."""
    from scipy.spatial import cKDTree
    T = np.asarray(T, np.float64)
    moved = np.asarray(src, np.float64) @ T[:3, :3].T + T[:3, 3]
    dist, _ = cKDTree(np.asarray(dst, np.float64)).query(moved, k=1)
    inl = dist <= gate
    return float(np.sqrt((dist[inl] ** 2).sum() / max(inl.sum(), 1)))


def hold_to_bands(np, name, T, rmse, base, T_gt, src, dst, own_rmse=True):
    """Phase 2's bands: T against the k-d tree and T_gt, and the RMSE of T
    measured the k-d tree's way (``nn_rmse``) against the k-d tree's. The
    engine's own reported RMSE is held to the band too where it is the
    same measure (``own_rmse``); a huber-weighted RMSE, or one over
    candidate sets that ``max_per_cell`` truncated, is not."""
    true_rmse = nn_rmse(np, T, src, dst)
    d_true = abs(true_rmse - base.rmse)
    d_rmse = abs(float(rmse) - base.rmse)
    d_T = float(np.abs(T - base.T).max())
    d_gt = float(np.abs(T - T_gt).max())
    check(np.all(np.isfinite(T)), f"{name}: non-finite transform")
    check(d_true <= RMSE_VS_KDTREE, f"{name}: nearest-neighbour rmse "
          f"{true_rmse} off the k-d tree's {base.rmse} by {d_true}")
    if own_rmse:
        check(d_rmse <= RMSE_VS_KDTREE, f"{name}: rmse off the k-d tree by "
              f"{d_rmse}")
    check(d_T <= T_VS_KDTREE, f"{name}: transform off the k-d tree by {d_T}")
    check(d_gt <= T_VS_GT, f"{name}: transform off T_gt by {d_gt}")
    return dict(rmse=float(rmse), nn_rmse=true_rmse, kdtree_rmse=base.rmse,
                d_rmse=d_rmse, d_nn_rmse=d_true, max_abs_T_vs_kdtree=d_T,
                max_abs_T_vs_gt=d_gt)


def phase5(torch, np, scenes):
    """The pyramid path and the fused point-to-point iteration."""
    from repro_torch.core import FppsICP, ICPParams, get_engine
    from repro_torch.core.baseline import kdtree_icp
    from repro_torch.core.engine import _mask_invalid
    from repro_torch.core.icp import (ICPState, _default_correspond_fn,
                                      _fused_icp_iteration, _icp_iteration)
    from repro_torch.core.nn_search_grid import DEFAULT_GRID_DIMS, grid_nn_fn
    from repro_torch.core.pyramid import DEFAULT_LEVELS
    from repro_torch.data.collate import collate_pairs
    from repro_torch.data.voxelize import build_voxel_grid
    from repro_torch.kernels.fused_icp import make_fused_fn
    from repro_torch.kernels.ops import resident_nn_fn

    coarse = sum(int(lv[1]) for lv in DEFAULT_LEVELS)
    P = ICPParams(max_iterations=50, max_correspondence_distance=1.0,
                  transformation_epsilon=1e-5)  # the paper's protocol
    src, dst, T_gt = scenes["seq0"][0]
    base = kdtree_icp(src, dst, 50, 1.0, 1e-5)
    out, totals = {}, dict(nn_search=0, candidate_sweep=0,
                           fused_moment_sweep=0, moment_sweep=0)

    def record(name, launches, expect, wall_ms, iters, frames, extra):
        expect = dict(expect, moment_sweep=0)
        check(launches == expect, f"{name}: launches {launches}, expected "
              f"{expect}")
        for k, v in launches.items():
            totals[k] += v
        row = dict(launches=launches, wall_ms=wall_ms,
                   per_frame_ms=wall_ms / frames, iterations=iters,
                   **extra)
        out[name] = row
        log(f"phase5 {name}: iterations {iters}, launches {launches} | wall "
            f"{wall_ms:.2f} ms, {wall_ms / frames:.2f} ms/frame | "
            + " ".join(f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in extra.items()))

    # 1. Table-I align() through the pyramid, twice: bit-identical.
    def align():
        reg = FppsICP(engine="pyramid")
        reg.hardwareInitialize()
        reg.setInputSource(src)
        reg.setInputTarget(dst)
        reg.setMaxCorrespondenceDistance(1.0)
        reg.setMaxIterationCount(50)
        reg.setTransformationEpsilon(1e-5)
        return reg, reg.align()

    align()  # warm-up: first-call allocations, not counted
    (reg, T), wall, launches = counted(torch, align)
    (_, T2), _, _ = counted(torch, align)
    check(np.array_equal(T, T2), "align(): two runs differ")
    it = int(reg.last_result.iterations)
    record("align_pyramid", launches,
           dict(nn_search=coarse, candidate_sweep=it, fused_moment_sweep=0),
           wall, it, 1, dict(ms_per_iteration=wall / (coarse + it),
                             bit_identical_rerun=True,
                             **hold_to_bands(np, "align_pyramid", T,
                                             reg.last_result.rmse, base,
                                             T_gt, src, dst)))

    # 2-4. Single-frame engines: pyramid fused, cuda fused, odometry's.
    singles = (
        ("pyramid_fused", get_engine("pyramid"), P._replace(fused=True),
         coarse, True),
        ("cuda_fused", get_engine("cuda"), P._replace(fused=True), 0, True),
        ("odometry_pyramid", get_engine("pyramid", levels=()),
         P._replace(max_iterations=30, robust_kernel="huber",
                    robust_scale=0.3), 0, False),
    )
    for name, engine, params, n_coarse, fused in singles:
        engine.register(src, dst, params)  # warm-up
        res, wall, launches = counted(torch, lambda: engine.register(
            src, dst, params))
        it = int(res.iterations)
        T = res.T.cpu().numpy()
        record(name, launches,
               dict(nn_search=n_coarse, candidate_sweep=0 if fused else it,
                    fused_moment_sweep=it if fused else 0),
               wall, it, 1, dict(ms_per_iteration=wall / (n_coarse + it),
                                 **hold_to_bands(
                                     np, name, T, res.rmse, base, T_gt, src,
                                     dst, own_rmse=params.robust_kernel
                                     == "none")))

    # 5-6. register_pairs: 8 seq-0 pairs unfused and fused, the 4x scene.
    engine = get_engine("pyramid")
    batches = (("pairs_b8", scenes["seq0"], P),
               ("pairs_b8_fused", scenes["seq0"], P._replace(fused=True)),
               ("scene4x", [scenes["scene4x"]], P))
    for name, triples, params in batches:
        pairs = [(s, d) for s, d, _ in triples]
        engine.register_pairs(pairs, params)  # warm-up
        (res, batch), wall, launches = counted(
            torch, lambda: engine.register_pairs(pairs, params))
        iters = [int(x) for x in res.iterations.cpu()]
        Ts, rmses = res.T.cpu().numpy(), res.rmse.cpu().numpy()
        bands = [hold_to_bands(np, f"{name}[{k}]", Ts[k], rmses[k],
                               kdtree_icp(s, d, 50, 1.0, 1e-5), Tg, s, d,
                               own_rmse=name != "scene4x")
                 for k, (s, d, Tg) in enumerate(triples)]
        n_it = params.max_iterations
        extra = dict(ms_per_iteration=wall / (coarse + n_it),
                     max_d_rmse=max(x["d_rmse"] for x in bands),
                     max_d_nn_rmse=max(x["d_nn_rmse"] for x in bands),
                     max_abs_T_vs_kdtree=max(x["max_abs_T_vs_kdtree"]
                                             for x in bands),
                     max_abs_T_vs_gt=max(x["max_abs_T_vs_gt"]
                                         for x in bands))
        if name != "scene4x":  # device time of one polish iteration
            p1 = device_profile(torch, lambda: engine.register_pairs(
                pairs, params._replace(max_iterations=1)))
            p2 = device_profile(torch, lambda: engine.register_pairs(
                pairs, params._replace(max_iterations=2)))
            extra.update(
                device_kernels_per_polish_iter=(
                    None if p1[0] is None or p2[0] is None
                    else p2[0] - p1[0]),
                host_launches_per_polish_iter=p2[2] - p1[2],
                device_busy_ms_per_polish_iter=(
                    None if p1[1] is None or p2[1] is None
                    else p2[1] - p1[1]))
        record(name, launches,
               dict(nn_search=coarse,
                    candidate_sweep=0 if params.fused else n_it,
                    fused_moment_sweep=n_it if params.fused else 0),
               wall, iters, len(triples), extra)

    # One iteration of each chain at B=1 (registration_latency.py's
    # Table-IV analogue): brute kernel + Kabsch, grid kernel + Kabsch,
    # fused pass + moment solve.
    dev = torch.device("cuda")
    batch = collate_pairs([(src, dst)])
    s_t = torch.as_tensor(batch.src[0], device=dev)
    d_t = torch.as_tensor(batch.dst[0], device=dev)
    dv = torch.as_tensor(batch.dst_valid[0], device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    state = ICPState(T=torch.as_tensor(T_gt, device=dev), delta=inf,
                     rmse=inf, iteration=torch.tensor(0, device=dev),
                     inlier_frac=torch.tensor(0.0, device=dev),
                     degenerate=torch.tensor(False, device=dev))
    grid = build_voxel_grid(d_t, 1.0, DEFAULT_GRID_DIMS, valid=dv)
    brute = _default_correspond_fn(d_t, P, resident_nn_fn(
        _mask_invalid(d_t, dv)), None)
    grid_nn = grid_nn_fn(grid, max_per_cell=GRID_K)

    def grid_corr(s):
        d2, _, matched = grid_nn(s)
        return d2, matched

    fused_fn = make_fused_fn(grid, P, max_per_cell=GRID_K)
    chains = {
        "brute+kabsch": lambda: _icp_iteration(s_t, state, P, brute),
        "grid+kabsch": lambda: _icp_iteration(s_t, state, P, grid_corr),
        "fused+moments": lambda: _fused_icp_iteration(s_t, state, P,
                                                      fused_fn),
    }
    out["chains"] = {}
    for name, fn in chains.items():
        ms = time_ms(torch, fn)
        k, busy, launches = device_profile(torch, fn)
        out["chains"][name] = dict(ms=ms, device_kernels=k,
                                   host_launches=launches,
                                   device_busy_ms=busy)
        log(f"phase5 chain {name}: {ms:.3f} ms per iteration (CUDA events) |"
            + (" device not measured" if k is None else
               f" {k} device kernels ({launches} host launch calls), "
               f"{busy:.3f} ms device-busy (profiler)"))
    out["launch_totals"] = totals
    return out


# Slice 3: the normals moment sweep and the 45-plane fused pass with its
# bf16 prune.
MOMENT_RTOL = 1e-5          # the ten sums, relative to their magnitude
NORMAL_ATOL = 1e-4          # normals valid in both (tests/test_normals.py)
MOMENT_FLOPS_PER_SLOT = 9   # d and d² and the gate on every slot
MOMENT_FLOPS_PER_HIT = 19   # 9 products and 10 sums on an in-radius slot
FUSED_PLANE_EPILOGUE_FLOPS = 160   # per query: residual, a, 45 planes


def bits_equal(torch, a, b):
    """The same shape and the same bits (-0 and +0 differ)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def bytes_bound(nbytes, flops):
    """(ms, "bytes" | "operations") of the least time for ``nbytes`` moved
    and ``flops`` fp32 operations."""
    bytes_s, ops_s = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def phase6(torch, np, scenes):
    """The normals moment sweep and the 45-plane fused pass (with and
    without prune) vs their plain versions on the card."""
    from repro_torch.core.nn_search_grid import (DEFAULT_GRID_DIMS,
                                                 gather_candidate_points,
                                                 grid_order)
    from repro_torch.core.transform import transform_points
    from repro_torch.data.collate import collate_pairs
    from repro_torch.data.normals import (NormalParams, estimate_normals,
                                          moments_to_normals, orient_normals,
                                          split_moments)
    from repro_torch.data.voxelize import build_voxel_grid
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_icp import P2PLANE_MOMENTS, moment_planes
    from repro_torch.kernels.normals import moment_sweep

    dev = torch.device("cuda")
    radius = NormalParams(neighborhood="radius")   # 1 m, 1 m voxels, K=32

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    def normals_of(m, q):
        n, v = moments_to_normals(*split_moments(m))
        return orient_normals(q, n), v

    pairs = scenes["seq0"]
    src0, dst0, T0 = pairs[0]
    base = dst0[:10240]
    batch = collate_pairs([(s, d) for s, d, _ in pairs])
    out = dict(moment_sweep=[], fused_plane=[])

    # -- moment sweep: the queries are the target cloud itself -------------
    def sweep_case(points, valid=None, shift=(0.0, 0.0, 0.0)):
        pts = tensor(points)
        v = None if valid is None else tensor(valid, torch.bool)
        grid = build_voxel_grid(pts, radius.voxel_size, radius.grid_dims,
                                valid=v)
        q = pts + tensor(shift)
        return q, gather_candidate_points(q, grid, radius.max_per_cell)

    cases = {
        "seq0_b1": lambda: sweep_case(dst0),
        "seq0_b8": lambda: sweep_case(batch.dst, batch.dst_valid),
        "scene4x_b1": lambda: sweep_case(scenes["scene4x"][1]),
        "ragged": lambda: sweep_case(dst0[:20001]),
        "ties": lambda: sweep_case(np.concatenate([base] * 3)),
        "outside": lambda: sweep_case(dst0, shift=(500.0, 0.0, 0.0)),
    }
    for name, make in cases.items():
        q, cand = make()
        rows, ck = q.numel() // 3, cand.shape[-2]
        m_k = moment_sweep(q, cand, radius.radius)
        torch.cuda.synchronize()
        m_k2 = moment_sweep(q, cand, radius.radius)
        m_p = ref.normal_moments(q, cand, radius.radius)
        same = bits_equal(torch, m_k, m_p)
        rel = float(((m_k - m_p).abs() / m_p.abs().amax(
            dim=tuple(range(m_p.dim() - 1))).clamp_min(1e-30)).max())
        max_abs = float((m_k - m_p).abs().max())
        check(bits_equal(torch, m_k, m_k2), f"moment sweep {name}: two "
              "kernel runs differ")
        check(same, f"moment sweep {name}: sums differ from the plain "
              f"version, which mirrors the kernel's lane order (max abs "
              f"{float((m_k - m_p).abs().max())})")
        check(rel <= MOMENT_RTOL, f"moment sweep {name}: a sum is off its "
              f"plain version by {rel} > {MOMENT_RTOL} of its magnitude")
        n_k, v_k = normals_of(m_k, q)
        n_p, v_p = normals_of(m_p, q)
        both = v_k & v_p
        mask_diff = int((v_k != v_p).sum())
        n_err = float((n_k - n_p).abs()[both].max()) if bool(both.any()) \
            else 0.0
        check(n_err <= NORMAL_ATOL, f"moment sweep {name}: normals off by "
              f"{n_err} > {NORMAL_ATOL}")
        if name == "outside":
            check(bool((m_k == 0).all()), "outside: a non-zero moment")
        hits = float(m_k[..., 0].sum())
        kern = device_ms(torch, lambda: moment_sweep(q, cand, radius.radius))
        plain = device_ms(torch, lambda: ref.normal_moments(
            q, cand, radius.radius))
        bound_ms, bound_by = bytes_bound(
            rows * ck * 12 + rows * 12 + rows * 40,
            rows * ck * MOMENT_FLOPS_PER_SLOT + hits * MOMENT_FLOPS_PER_HIT)
        row = dict(case=name, shape=list(q.shape[:-1]) + [ck],
                   bit_equal=same, max_rel_sum=rel, max_abs_err=max_abs,
                   normal_max_abs_err=n_err, valid_mask_diff=mask_diff,
                   valid_frac=float(v_k.float().mean()),
                   mean_neighbours=hits / rows, ms=kern[0],
                   ms_spread=kern[1:3], plain_ms=plain[0],
                   plain_ahead=plain[3], bound_ms=bound_ms,
                   bound_by=bound_by)
        out["moment_sweep"].append(row)
        log(f"phase6 moment_sweep {name}: rows={rows} CK={ck} bit_equal="
            f"{same} max rel sum {rel:.3g} | normals max|d| {n_err:.3g}, "
            f"valid-mask disagreements {mask_diff}, valid "
            f"{row['valid_frac']:.4f}, {hits / rows:.1f} neighbours/row | "
            f"kernel {fmt_ms(kern)} ms, plain {fmt_ms(plain)} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}); {bound_ms / kern[0]:.1%} of "
            f"bound")
        del q, cand, m_k, m_k2, m_p

    # -- 45-plane fused pass with knn normals of the seq-0 targets ----------
    def fused_case(b, shift=(0.0, 0.0, 0.0)):
        sub = collate_pairs([(s, d) for s, d, _ in pairs[:b]])
        dst = tensor(sub.dst)
        dv = tensor(sub.dst_valid, torch.bool)
        grid = build_voxel_grid(dst, 1.0, DEFAULT_GRID_DIMS, valid=dv)
        normals, _ = estimate_normals(dst, NormalParams(), valid=dv,
                                      grid=grid)
        q = transform_points(tensor(np.stack([T for _, _, T in pairs[:b]])),
                             tensor(np.stack([s for s, _, _ in pairs[:b]])))
        q = q + tensor(shift)
        cand, cand_n = gather_candidate_points(
            q, grid, GRID_K, payload=grid_order(grid, normals))
        return q, cand, cand_n

    fcases = (("seq0_b1", 1, (0.0, 0.0, 0.0)), ("seq0_b8", 8, (0.0, 0.0, 0.0)),
              ("outside", 1, (500.0, 0.0, 0.0)))
    for name, b, shift in fcases:
        q, cand, cand_n = fused_case(b, shift)
        rows, ck = q.numel() // 3, cand.shape[-2]
        sv = torch.ones(q.shape[:-1], dtype=torch.float32, device=dev)
        results = []
        for robust, scale in (("none", 0.5), ("huber", 0.3), ("tukey", 0.8)):
            kw = dict(gate=1.0, robust_kernel=robust, robust_scale=scale)
            pl_k = moment_planes(q, cand, sv, cand_n, **kw)
            pl_kp = moment_planes(q, cand, sv, cand_n, prune=True, **kw)
            torch.cuda.synchronize()
            pl_p = ref.fused_moment_planes(q, cand, sv, cand_n, **kw)
            pl_pp = ref.fused_moment_planes(q, cand, sv, cand_n, prune=True,
                                            **kw)
            same = bits_equal(torch, pl_k, pl_p)
            prune_same = (bits_equal(torch, pl_kp, pl_k)
                          and bits_equal(torch, pl_pp, pl_p))
            s_k, s_p = pl_k.sum(-1), pl_p.sum(-1)
            sum_rel = float(((s_k - s_p).abs()
                             / s_p.abs().clamp_min(1e-30)).max())
            max_abs = float((pl_k - pl_p).abs().max())
            check(same, f"fused plane {name} {robust}: planes differ from "
                  f"the plain version (max abs {max_abs})")
            check(bool(((s_k - s_p).abs()
                        <= SUM_RTOL * s_p.abs() + SUM_RTOL).all()),
                  f"fused plane {name} {robust}: a sum is off by more than "
                  f"{SUM_RTOL} relative")
            check(prune_same, f"fused plane {name} {robust}: prune changed "
                  "the planes")
            if name == "outside":
                check(bool((pl_kp == 0).all()) and bool((pl_k == 0).all()),
                      "outside: non-zero planes")
            results.append(dict(
                robust=robust, bit_equal=same, prune_bit_equal=prune_same,
                max_abs_plane=max_abs, max_rel_sum=sum_rel,
                weight_sum=[float(x) for x in
                            s_k[..., P2PLANE_MOMENTS.index("w")].reshape(-1)]))
        kern = device_ms(torch, lambda: moment_planes(q, cand, sv, cand_n,
                                                      gate=1.0))
        kern_p = device_ms(torch, lambda: moment_planes(
            q, cand, sv, cand_n, gate=1.0, prune=True))
        plain = device_ms(torch, lambda: ref.fused_moment_planes(
            q, cand, sv, cand_n, gate=1.0))
        bound_ms, bound_by = bytes_bound(
            rows * ck * 12 + rows * (12 + 4 + 12) + rows * 4 * 45,
            rows * ck * GRID_FLOPS_PER_SLOT
            + rows * FUSED_PLANE_EPILOGUE_FLOPS)
        row = dict(case=name, shape=list(q.shape[:-1]) + [ck],
                   robust=results, ms=kern[0], ms_spread=kern[1:3],
                   prune_ms=kern_p[0], prune_ms_spread=kern_p[1:3],
                   plain_ms=plain[0], plain_ahead=plain[3],
                   bound_ms=bound_ms, bound_by=bound_by)
        out["fused_plane"].append(row)
        log(f"phase6 fused 45-plane {name}: B={b} N={q.shape[-2]} CK={ck} "
            f"bit-equal to plain and prune on = off for "
            f"{[r['robust'] for r in results]} | max rel sum "
            f"{max(r['max_rel_sum'] for r in results):.3g} | kernel "
            f"{fmt_ms(kern)} ms, with prune {fmt_ms(kern_p)} ms, plain "
            f"{fmt_ms(plain)} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"{bound_ms / kern[0]:.1%} of bound")
        del q, cand, cand_n
    return out


def phase7(torch, np, scenes):
    """The point-to-plane paths at the Table-I protocol on seq 0 frame 0."""
    from repro_torch.core import FppsICP, ICPParams, get_engine, icp
    from repro_torch.core.baseline import kdtree_icp
    from repro_torch.data.collate import collate_pairs
    from repro_torch.data.normals import default_target_normals
    from repro_torch.kernels.normals import estimate_normals_radius
    from repro_torch.kernels.ops import resident_nn_fn

    coarse = 6  # core.pyramid.DEFAULT_LEVELS: one 4 m level, 6 iterations
    P = ICPParams(max_iterations=50, max_correspondence_distance=1.0,
                  transformation_epsilon=1e-5, minimizer="point_to_plane")
    src, dst, T_gt = scenes["seq0"][0]
    base = kdtree_icp(src, dst, 50, 1.0, 1e-5)
    dev = torch.device("cuda")
    out, totals = {}, dict(nn_search=0, candidate_sweep=0,
                           fused_moment_sweep=0, moment_sweep=0)

    def hold(name, T, s, d, Tg, b):
        true_rmse = nn_rmse(np, T, s, d)
        d_true = abs(true_rmse - b.rmse)
        d_gt = float(np.abs(T - Tg).max())
        check(np.all(np.isfinite(T)), f"{name}: non-finite transform")
        check(d_gt <= T_VS_GT, f"{name}: transform off T_gt by {d_gt}")
        check(d_true <= RMSE_VS_KDTREE, f"{name}: nearest-neighbour rmse "
              f"{true_rmse} off the k-d tree's {b.rmse} by {d_true}")
        return dict(nn_rmse=true_rmse, kdtree_rmse=b.rmse, d_nn_rmse=d_true,
                    max_abs_T_vs_gt=d_gt,
                    max_abs_T_vs_kdtree=float(np.abs(T - b.T).max()))

    def record(name, fn, expect, frames=1):
        fn()  # warm-up: first-call allocations, not counted
        (T, res), wall, launches = counted(torch, fn)
        expect = dict(dict(nn_search=0, candidate_sweep=0,
                           fused_moment_sweep=0, moment_sweep=0),
                      **expect(res))
        check(launches == expect, f"{name}: launches {launches}, expected "
              f"{expect}")
        for k, v in launches.items():
            totals[k] += v
        return T, res, wall, launches

    def align(engine):
        def run():
            reg = FppsICP(engine=engine)
            reg.hardwareInitialize()
            reg.setInputSource(src)
            reg.setInputTarget(dst)
            reg.setMaxCorrespondenceDistance(1.0)
            reg.setMaxIterationCount(50)
            reg.setTransformationEpsilon(1e-5)
            reg.setMinimizer("point_to_plane")
            T = reg.align()
            return T, reg.last_result
        return run

    def fused(engine):  # FppsICP has no fused switch: the engine's API
        def run():
            res = engine.register(src, dst, P._replace(fused=True))
            return res.T.cpu().numpy(), res
        return run

    def radius_run():
        s = torch.as_tensor(src, device=dev)
        d = torch.as_tensor(dst, device=dev)
        normals, _ = estimate_normals_radius(d)
        res = icp(s, d, P, nn_fn=resident_nn_fn(d), target_normals=normals)
        return res.T.cpu().numpy(), res

    singles = (
        ("align_cuda", align("cuda"),
         lambda r: dict(nn_search=int(r.iterations))),
        ("cuda_fused", fused(get_engine("cuda")),
         lambda r: dict(fused_moment_sweep=int(r.iterations))),
        ("align_pyramid", align("pyramid"),
         lambda r: dict(nn_search=coarse,
                        candidate_sweep=int(r.iterations))),
        ("pyramid_fused", fused(get_engine("pyramid")),
         lambda r: dict(nn_search=coarse,
                        fused_moment_sweep=int(r.iterations))),
        ("radius_normals_icp", radius_run,
         lambda r: dict(nn_search=int(r.iterations), moment_sweep=1)),
    )
    for name, fn, expect in singles:
        T, res, wall, launches = record(name, fn, expect)
        it = int(res.iterations)
        row = dict(launches=launches, iterations=it, wall_ms=wall,
                   per_frame_ms=wall, converged=bool(res.converged),
                   **hold(name, T, src, dst, T_gt, base))
        out[name] = row
        log(f"phase7 {name}: iterations {it}, launches {launches} | wall "
            f"{wall:.2f} ms/frame | nn_rmse {row['nn_rmse']:.6f} (k-d tree "
            f"{base.rmse:.6f}, |d| {row['d_nn_rmse']:.2e}) | max|T-T_gt| "
            f"{row['max_abs_T_vs_gt']:.2e}, max|T-T_kdtree| "
            f"{row['max_abs_T_vs_kdtree']:.2e}")

    # register_pairs on the 8 seq-0 pairs through the "cuda" engine.
    triples = scenes["seq0"]
    pairs = [(s, d) for s, d, _ in triples]
    engine = get_engine("cuda")
    bases = [kdtree_icp(s, d, 50, 1.0, 1e-5) for s, d in pairs]
    for name, params in (("pairs_b8", P), ("pairs_b8_fused",
                                           P._replace(fused=True))):
        def run(params=params):
            res, _ = engine.register_pairs(pairs, params)
            return res.T.cpu().numpy(), res
        key = "fused_moment_sweep" if params.fused else "nn_search"
        Ts, res, wall, launches = record(
            name, run, lambda r, key=key: {key: P.max_iterations})
        bands = [hold(f"{name}[{k}]", Ts[k], s, d, Tg, bases[k])
                 for k, (s, d, Tg) in enumerate(triples)]
        p1 = device_profile(torch, lambda: engine.register_pairs(
            pairs, params._replace(max_iterations=1)))
        p2 = device_profile(torch, lambda: engine.register_pairs(
            pairs, params._replace(max_iterations=2)))
        row = dict(launches=launches, wall_ms=wall,
                   per_frame_ms=wall / len(pairs),
                   iterations=[int(x) for x in res.iterations.cpu()],
                   ms_per_iteration=wall / P.max_iterations,
                   max_d_nn_rmse=max(x["d_nn_rmse"] for x in bands),
                   max_abs_T_vs_gt=max(x["max_abs_T_vs_gt"] for x in bands),
                   device_kernels_per_iter=(
                       None if p1[0] is None or p2[0] is None
                       else p2[0] - p1[0]),
                   host_launches_per_iter=p2[2] - p1[2],
                   device_busy_ms_per_iter=(
                       None if p1[1] is None or p2[1] is None
                       else p2[1] - p1[1]))
        out[name] = row
        log(f"phase7 {name}: iterations {row['iterations']}, launches "
            f"{launches} | wall {wall:.2f} ms = {row['per_frame_ms']:.2f} "
            f"ms/frame, {row['ms_per_iteration']:.3f} ms/iteration | max "
            f"|d nn_rmse| {row['max_d_nn_rmse']:.2e}, max|T-T_gt| "
            f"{row['max_abs_T_vs_gt']:.2e} | per iteration "
            f"{row['device_kernels_per_iter']} device kernels "
            f"({row['host_launches_per_iter']} host launch calls), "
            f"{row['device_busy_ms_per_iter']} ms device-busy (profiler)")

    # The per-frame normals of the plane path (knn, the engines' default)
    # at the batch's shape: their device kernels and busy time.
    batch = collate_pairs(pairs)
    d_b = torch.as_tensor(batch.dst, device=dev)
    dv_b = torch.as_tensor(batch.dst_valid, device=dev)
    default_target_normals(d_b, dv_b)  # warm-up
    k, busy, launches = device_profile(
        torch, lambda: default_target_normals(d_b, dv_b))
    wall = time_ms(torch, lambda: default_target_normals(d_b, dv_b),
                   warmup=1, reps=3)
    out["knn_normals_b8"] = dict(device_kernels=k, host_launches=launches,
                                 device_busy_ms=busy, ms=wall)
    log(f"phase7 knn normals of the 8 targets (B=8, M=32768): {wall:.2f} ms "
        f"(CUDA events) | " + ("device not measured" if k is None else
                               f"{k} device kernels ({launches} host launch "
                               f"calls), {busy:.3f} ms device-busy"))
    del d_b, dv_b
    out["launch_totals"] = totals
    return out


# Slice 4: streaming scan-to-map odometry. The stream is seq 0, frames
# 0-14, default SceneConfig (~32.5k points a scan), through
# OdometryConfig(scan_budget=16384): the default budget of 8192 would drop
# about a third of every scan's occupied voxels from the +x end.
ODOM_FRAMES = 15
ODOM_SCAN_BUDGET = 16384
ODOM_BAND_M = 0.05      # port vs the JAX reference, and runs (b)-(c) vs (a)
FAIL_ERR_M = 1.0        # benchmarks/robustness.py: a failed frame
BURST = (5, 6, 7, 8)    # benchmarks/robustness.py: the fault window
BURST_SPEC = "crop:0.15"
TIER_FRAME = 10         # run (e): every retry tier on this frame
# The JAX reference on the same streams and configuration: CPU runs of
# src/repro (about 10 minutes each on one CPU host), e.g. for run (a):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import repro.core
#   from repro.core.odometry import OdometryConfig, OdometryPipeline
#   from repro.data.pointcloud import sequence_scans
#   p = OdometryPipeline(OdometryConfig(scan_budget=16384))
#   P, D = p.run(sequence_scans(0, 15))
#   print(P[:, :3, 3].tolist(), [(d.recovery_tier, d.health,
#         d.quarantined) for d in D])"
# (b): the same with submap=OdometryConfig().submap._replace(
# storage="fp16"); (d): frames 5-8 as apply_faults(scan, "crop:0.15",
# seed=0, frame=f), fed as process(points, valid); (e): a pipeline with
# recovery_tiers=() over frames 0-9, then _tier_attempt(name, ...) on
# frame 10's prepare_frame. On this stream every frame from 2 on reads
# SUSPECT on one signal, the scan's own conditioning (above
# suspect_condition, 6e3), so the whole retry ladder runs on every such
# frame and each is quarantined: the map holds frames 0-1. With fp16
# storage the ladder's least-bad pick goes to the fallback at frame 8 and
# the pose stalls near x = 5.9 m; the crop burst drifts sideways; no tier
# of (e) is within phase 2's band of T_gt (ROADMAP queue 3). Phase 8
# holds the port to these reference runs.
def _suspect(tier):
    """A quarantined SUSPECT frame settled at ``tier``."""
    return (tier, "suspect", True)


ODOM_REF_POSITIONS = (
    (0.0, 0.0, 0.0),
    (0.6667771339416504, 0.008197959512472153, -0.02172049507498741),
    (1.4953176975250244, 0.014090917073190212, -0.03360100835561752),
    (2.308595895767212, 0.04017041251063347, -0.036207426339387894),
    (3.1222050189971924, 0.0702730119228363, -0.03479393944144249),
    (4.131154537200928, 0.09675219655036926, -0.03639424964785576),
    (4.77844762802124, 0.02108917385339737, -0.03721485286951065),
    (5.36024284362793, 0.13415202498435974, -0.03023221157491207),
    (6.351857662200928, 0.22478245198726654, -0.03180050849914551),
    (7.198241710662842, 0.2878466546535492, -0.03130114823579788),
    (7.957455635070801, 0.35212284326553345, -0.03233321011066437),
    (8.706999778747559, 0.4295709729194641, -0.03261230140924454),
    (9.499418258666992, 0.4400230646133423, -0.03745533153414726),
    (10.51879596710205, 0.560815691947937, -0.0358121320605278),
    (11.17430591583252, 0.7355125546455383, -0.05730961263179779))
ODOM_REF_VERDICTS = ((0, "ok", False),) * 2 + (_suspect(0),) * 12 + (
    _suspect(1),)
ODOM_REF_FP16_POSITIONS = (
    (0.0, 0.0, 0.0),
    (0.6684854030609131, 0.000841801636852324, -0.02176314778625965),
    (1.484809160232544, 0.005133369006216526, -0.0328214168548584),
    (2.2974696159362793, 0.015920445322990417, -0.03670806810259819),
    (3.1036486625671387, 0.049076054245233536, -0.03357749432325363),
    (4.125152587890625, 0.08711647987365723, -0.034964967519044876),
    (4.931788444519043, 0.0016852945555001497, -0.03695038706064224),
    (5.518484115600586, 0.10324962437152863, -0.031110312789678574),
    (5.948678016662598, 0.20575310289859772, -0.04067611321806908),
    (5.951381683349609, 0.21384850144386292, -0.042684514075517654),
    (5.973917484283447, 0.22304439544677734, -0.03636641800403595),
    (5.968040943145752, 0.24299554526805878, -0.036988481879234314),
    (5.959799766540527, 0.2760457694530487, -0.04089844226837158),
    (5.901825904846191, 0.2958005666732788, -0.04099871218204498),
    (5.86751127243042, 0.2929964065551758, -0.04348461702466011))
ODOM_REF_FP16_VERDICTS = (
    ((0, "ok", False),) * 2 + (_suspect(0),) * 6 + (_suspect(2),) * 2
    + (_suspect(0),) * 3 + (_suspect(2), _suspect(0)))
ODOM_REF_BURST_ERR_M = (
    0.0, 0.13503400563122409, 0.1098577915989094, 0.09806846819844499,
    0.08467646472155216, 0.20103910082995124, 0.4846659579820842,
    0.9395909827396173, 1.4550796212996102, 1.7554041779252576,
    2.0650022956534615, 2.3966889781994576, 2.7194988348431113,
    2.9371225103472347, 3.1351783565033937)
ODOM_REF_TIER_T = {
    'widen': (8.211092948913574, 0.009980802424252033,
               -0.06333081424236298),
    'fallback': (7.56333065032959, 0.34473717212677,
                  -0.03692774474620819),
    'wide_basin': (-0.060447338968515396, 0.22749915719032288,
                    -0.1051475778222084),
}
ODOM_REF_TIER_D_GT = {"widen": 0.3896859753336823,
                      "fallback": 0.42334268141666254,
                      "wide_basin": 8.047120670714769}


def record_registrations(torch, timed=False, tag=None):
    """Wrap ``RegistrationEngine.register`` (every engine of the odometry
    path) to keep each registration's engine, coarse levels, ``fused``
    flag, result and ``tag()`` (the frame), and with ``timed`` its ms
    between two syncs. Returns ``(log, restore)``."""
    from repro_torch.core.engine import RegistrationEngine
    log, orig = [], RegistrationEngine.register

    def register(self, source, target, params=None, *args, **kwargs):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(self, source, target, params, *args, **kwargs)
        if timed:
            torch.cuda.synchronize()
        log.append(dict(engine=self.name, levels=getattr(self, "_levels", ()),
                        fused=params.fused, res=res,
                        tag=None if tag is None else tag(),
                        ms=(time.perf_counter() - t0) * 1e3 if timed
                        else None))
        return res

    RegistrationEngine.register = register
    return log, lambda: setattr(RegistrationEngine, "register", orig)


def expected_launches(log):
    """Kernel launches the registrations in ``log`` must have made: a
    pyramid runs its fixed coarse iterations through ``nn_search`` and one
    polish launch per iteration (``fused_moment_sweep`` if fused, else
    ``candidate_sweep``); the ``"cuda"`` engine one launch per iteration."""
    out = dict(nn_search=0, candidate_sweep=0, fused_moment_sweep=0,
               moment_sweep=0)
    for r in log:
        it = int(r["res"].iterations)
        key = "fused_moment_sweep" if r["fused"] else (
            "candidate_sweep" if r["engine"] == "pyramid" else "nn_search")
        out[key] += it
        out["nn_search"] += sum(int(lv[1]) for lv in r["levels"])
    return out


# Where the odometry path calls each kernel's wrapper: (module, name there,
# kernel). Phase 8 wraps these to keep one frame's operands.
KERNEL_SITES = (("repro_torch.kernels.ops", "nn_search_kernel", "nn_search"),
                ("repro_torch.core.nn_search_grid", "candidate_sweep_kernel",
                 "candidate_sweep"),
                ("repro_torch.kernels.fused_icp", "moment_planes",
                 "fused_moment_sweep"))


def capture_operands(torch, regs, want, kernels):
    """Wrap each of ``kernels``' call sites; while ``want()`` holds, keep a
    copy of the operands and of the result of the first call at each shape
    in each registration (``len(regs)``: the one in progress, as
    :func:`record_registrations` appends a registration when it ends).
    Returns ``(captured, restore)``."""
    import importlib
    captured, restores = {}, []
    for module, attr, kernel in KERNEL_SITES:
        if kernel not in kernels:
            continue
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)

        def wrapper(*args, _orig=orig, _kernel=kernel, **kwargs):
            out = _orig(*args, **kwargs)
            if want():
                key = (len(regs), _kernel, tuple(
                    tuple(a.shape) for a in args if torch.is_tensor(a)))
                if key not in captured:
                    captured[key] = dict(
                        args=[a.clone() if torch.is_tensor(a) else a
                              for a in args], kwargs=dict(kwargs),
                        out=[o.clone() for o in (out if isinstance(out, tuple)
                                                 else (out,))])
            return out
        setattr(mod, attr, wrapper)
        restores.append(lambda m=mod, a=attr, o=orig: setattr(m, a, o))
    return captured, lambda: [r() for r in restores]


def hold_captured(torch, run, captured, regs):
    """Each captured call against the plain version on the same operands:
    the main path's result and a second launch of the wrapper must both
    give the plain version's bits. Returns one row per call."""
    from repro_torch.core.odometry import _WIDE_BASIN_LEVELS, _WIDEN_LEVELS
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_icp import moment_planes
    from repro_torch.kernels.nn_search import nn_search_kernel
    from repro_torch.kernels.nn_search_grid import candidate_sweep_kernel
    tiers = {(): "primary", _WIDEN_LEVELS: "widen",
             _WIDE_BASIN_LEVELS: "wide_basin"}
    rows = []
    for (i, kernel, shapes), c in sorted(captured.items(),
                                         key=lambda kv: kv[0][:2]):
        r = regs[i]
        label = ("fallback" if r["engine"] == "cuda"
                 else tiers.get(tuple(r["levels"]), str(r["levels"])))
        args, kw, main = c["args"], c["kwargs"], c["out"]
        if kernel == "nn_search":
            again = nn_search_kernel(*args)
            plain = ref.blocked_argmin(*args)
            keep = args[0][..., 3, :] == 1  # the wrapper slices padding off
            main, again, plain = ([x[keep] for x in o]
                                  for o in (main, again, plain))
        elif kernel == "candidate_sweep":
            again = candidate_sweep_kernel(*args)
            plain = ref.candidate_sweep(*args)
        else:
            again = (moment_planes(*args, **kw),)
            plain = (ref.fused_moment_planes(*args, **kw),)
        torch.cuda.synchronize()
        same = all(bits_equal(torch, a, p) for o in (main, again)
                   for a, p in zip(o, plain))
        row = dict(run=run, registration=i, tier=label, kernel=kernel,
                   shapes=[list(s) for s in shapes], bit_equal=same,
                   max_abs_err=float((main[0] - plain[0]).abs().max()))
        if kernel != "fused_moment_sweep":  # index or slot mismatches
            row["mismatch"] = int((main[1] != plain[1]).sum()
                                  + (again[1] != plain[1]).sum())
        rows.append(row)
        log(f"phase8 {run} frame {TIER_FRAME} {label} {kernel} {shapes}: "
            f"main path and relaunch bit-equal to plain {same}, "
            f"{row.get('mismatch', '-')} index/slot mismatches, max |main "
            f"- plain| {row['max_abs_err']}")
        check(same, f"phase8 {run} {label} {kernel} {shapes}: the kernel "
              f"differs from its plain version on the main path's operands")
    return rows


def hold_to_reference(name, np, poses, diags, row, positions, verdicts):
    """Check a phase-8 run against a JAX reference run of the same stream:
    every position within ``ODOM_BAND_M``, and per frame the same (tier,
    health, quarantined), every frame accepted."""
    d_ref = np.linalg.norm(poses[:, :3, 3].astype(np.float64)
                           - np.asarray(positions), axis=1)
    row["max_d_ref_m"] = float(d_ref.max())
    got = tuple((d.recovery_tier, d.health, d.quarantined) for d in diags)
    check(got == tuple(verdicts) and all(d.accepted for d in diags),
          f"phase8 {name}: (tier, health, quarantined) per frame {got} "
          f"differ from the JAX reference's {verdicts}")
    check(float(d_ref.max()) <= ODOM_BAND_M, f"phase8 {name}: positions off "
          f"the JAX reference by up to {d_ref.max()} m: "
          f"{np.round(d_ref, 4).tolist()}")
    log(f"phase8 {name}: verdicts as the JAX reference's; max |t - t_ref| "
        f"{d_ref.max():.4f} m (band {ODOM_BAND_M})")


def phase8(torch, np):
    """Streaming scan-to-map odometry at full size on the card."""
    from repro_torch.core.engine import get_engine
    from repro_torch.core.icp import scrub_nonfinite
    from repro_torch.core.odometry import (DEFAULT_RECOVERY_TIERS,
                                           OdometryConfig, OdometryPipeline)
    from repro_torch.data.corruption import apply_faults
    from repro_torch.data.pointcloud import gt_pose, sequence_scans
    from repro_torch.data.voxelize import voxel_downsample

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    scans = [(s, None) for s in sequence_scans(0, ODOM_FRAMES)]
    gt = gt_pose(0)
    gt_t = np.stack([gt(f)[:3, 3] for f in range(ODOM_FRAMES)])
    cfg = OdometryConfig(scan_budget=ODOM_SCAN_BUDGET)
    cells = []
    for scan, _ in scans:  # the scan downsample must drop no cell
        pts, v = scrub_nonfinite(torch.as_tensor(scan, device=dev))
        _, sv, dropped = voxel_downsample(pts, cfg.scan_voxel,
                                          max_points=cfg.scan_budget,
                                          valid=v, with_stats=True)
        cells.append(int(sv.sum()))
        check(int(dropped) == 0, f"phase8: the scan downsample dropped "
              f"{int(dropped)} cells at scan_budget={cfg.scan_budget}")
    log(f"phase8 stream: seq 0 frames 0-{ODOM_FRAMES - 1}, "
        f"{min(len(s) for s, _ in scans)}-{max(len(s) for s, _ in scans)} "
        f"points, {min(cells)}-{max(cells)} occupied {cfg.scan_voxel} m "
        f"voxels a scan (budget {cfg.scan_budget}, 0 dropped) in "
        f"{time.perf_counter() - t0:.1f} s")
    out, totals = {}, dict(nn_search=0, candidate_sweep=0,
                           fused_moment_sweep=0, moment_sweep=0)

    def drive(name, config, stream, split=False, capture=()):
        """One counted run of a fresh pipeline over ``stream``; every kernel
        count set to 0 just before it and read just after. The operands of
        ``capture``'s kernels on frame ``TIER_FRAME`` are held to their plain
        versions after the run."""
        pipe = OdometryPipeline(config, device=dev)
        stages = {}
        if split:  # wall ms of each stage of a frame, between syncs
            def timed(stage, fn):
                def run(*a, **kw):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    r = fn(*a, **kw)
                    torch.cuda.synchronize()
                    stages.setdefault(stage, []).append(
                        (len(pipe.poses), (time.perf_counter() - t) * 1e3))
                    return r
                return run
            pipe.prepare_frame = timed("prepare", pipe.prepare_frame)
            pipe._scan_condition = timed("probe", pipe._scan_condition)
            pipe._out_of_lattice_frac = timed("health",
                                              pipe._out_of_lattice_frac)
            pipe.submap.insert = timed("fuse", pipe.submap.insert)
        attempts = []  # every health verdict of the cascade, in order
        assess = pipe._assess

        def recorded(res, *a, **kw):
            h = assess(res, *a, **kw)
            attempts.append((len(pipe.poses), h.verdict, h.reasons,
                             h.pose_jump_m, h.condition,
                             int(res.iterations)))
            return h
        pipe._assess = recorded
        regs, restore = record_registrations(
            torch, timed=split, tag=lambda: len(pipe.poses))
        captured, uncapture = capture_operands(
            torch, regs, lambda: len(pipe.poses) == TIER_FRAME, capture)
        frame_ms = []

        def run():
            for scan, valid in stream:
                t = time.perf_counter()
                pipe.process(scan, valid)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t) * 1e3)
        try:
            _, wall, launches = counted(torch, run)
        finally:
            restore()
            uncapture()
        expect = expected_launches(regs)
        check(launches == expect, f"phase8 {name}: launches {launches}, "
              f"expected {expect}")
        for k, v in launches.items():
            totals[k] += v
        poses = np.stack(pipe.poses)
        diags = pipe.diagnostics
        err = np.linalg.norm(poses[:, :3, 3].astype(np.float64) - gt_t,
                             axis=1)
        check(np.all(np.isfinite(poses)), f"phase8 {name}: non-finite pose")
        check(pipe.submap.dropped_cells == 0, f"phase8 {name}: the submap "
              f"dropped {pipe.submap.dropped_cells} cells")
        steady = statistics.median(frame_ms[3:])
        row = dict(
            launches=launches, wall_ms=wall, frame_ms=frame_ms,
            median_frame_ms=steady, fps=1e3 / steady,
            registrations=len(regs),
            tiers=[d.recovery_tier for d in diags],
            health=[d.health for d in diags],
            quarantined=[d.quarantined for d in diags],
            iterations=[d.iterations for d in diags],
            max_err_m=float(err.max()), err_m=err.tolist(),
            positions=poses[:, :3, 3].tolist(),
            map_occupancy=diags[-1].map_occupancy,
            tier_counts=pipe.tier_counts(), health_counts=pipe.health_counts())
        if split:
            stages["registration"] = [(r["tag"], r["ms"]) for r in regs]
            split = {}
            for stage, rows in stages.items():
                per = {}
                for f, ms in rows:
                    per[f] = per.get(f, 0.0) + ms
                split[stage] = statistics.median(
                    [per.get(f, 0.0) for f in range(3, len(stream))])
            split["rest"] = steady - sum(split.values())
            row["split_ms"] = split
        out[name] = row
        log(f"phase8 {name}: {len(regs)} registrations, launches "
            f"{launches} | median frame (3-{len(stream) - 1}) "
            f"{steady:.1f} ms ({1e3 / steady:.2f} fps; scan period 100 ms) "
            f"| max |t - t_gt| {err.max():.3f} m | tiers {row['tiers']} | "
            f"health {row['health_counts']} | quarantined "
            f"{sum(row['quarantined'])}")
        row["attempts"] = [[f, v, list(r)] for f, v, r, *_ in attempts]
        if capture:
            row["kernel_checks"] = hold_captured(torch, name, captured, regs)
        cond = [a[4] for a in attempts if a[0] >= config.warmup_frames]
        row["condition_range"] = [min(cond), max(cond)] if cond else None
        log(f"phase8 {name}: |t - t_gt| per frame "
            f"{np.round(err, 3).tolist()} m; scan condition (frames "
            f">= {config.warmup_frames}) {row['condition_range']}")
        for f, d in enumerate(diags):  # why the ladder settled off tier 0
            if d.recovery_tier > 0:
                log(f"phase8 {name} frame {f} settled at tier "
                    f"{d.recovery_tier}; attempts (verdict, reasons, jump "
                    f"m, iterations): " + " | ".join(
                        f"{v} {list(r)} {j:.3f} {it}"
                        for g, v, r, j, _, it in attempts if g == f))
        return pipe, poses, diags, row

    # (a) the clean fp32 stream, twice: the same bits.
    pa, poses_a, diags_a, row_a = drive(
        "a_fp32", cfg, scans, capture=("nn_search", "candidate_sweep"))
    pa2, poses_a2, diags_a2, row_a2 = drive("a_fp32_rerun", cfg, scans,
                                            split=True)
    check(np.array_equal(poses_a, poses_a2)
          and [repr(tuple(d)) for d in diags_a]
          == [repr(tuple(d)) for d in diags_a2],
          "phase8 a: two runs of the clean stream differ")
    row_a.update(bit_identical_rerun=True, split_ms=row_a2["split_ms"])
    hold_to_reference("a_fp32", np, poses_a, diags_a, row_a,
                      ODOM_REF_POSITIONS, ODOM_REF_VERDICTS)
    check(row_a["max_err_m"] <= FAIL_ERR_M, f"phase8 a: a frame is "
          f"{row_a['max_err_m']} m off the ground truth")
    log(f"phase8 a: bit-identical rerun; frame split of the rerun (median "
        f"of frames 3-14, ms, a sync around each stage): " + ", ".join(
            f"{k} {v:.1f}" for k, v in row_a2["split_ms"].items()))

    # (b) fp16 submap storage: held to the reference's fp16 run, which
    # leaves run a's path at frame 8 (ROADMAP queue 3); its distance from
    # run a is logged. (c) the fused polish: within the band of (a) on every
    # frame, with its tiers.
    _, poses_b, diags_b, row_b = drive("b_fp16", cfg._replace(
        submap=cfg.submap._replace(storage="fp16")), scans)
    hold_to_reference("b_fp16", np, poses_b, diags_b, row_b,
                      ODOM_REF_FP16_POSITIONS, ODOM_REF_FP16_VERDICTS)
    _, poses_c, _, row_c = drive("c_fused", cfg._replace(
        params=cfg.params._replace(fused=True)), scans,
        capture=("fused_moment_sweep",))
    for name, poses, row in (("b_fp16", poses_b, row_b),
                             ("c_fused", poses_c, row_c)):
        d_a = np.linalg.norm(poses[:, :3, 3].astype(np.float64)
                             - poses_a[:, :3, 3], axis=1)
        row["max_d_a_m"] = float(d_a.max())
        log(f"phase8 {name}: max |t - t_a| {d_a.max():.4f} m, per frame "
            f"{np.round(d_a, 3).tolist()}")
    check(row_c["max_d_a_m"] <= ODOM_BAND_M, f"phase8 c_fused: off run a by "
          f"up to {row_c['max_d_a_m']} m")
    check(row_c["tiers"] == row_a["tiers"], f"phase8 c_fused: tiers "
          f"{row_c['tiers']} differ from run a's {row_a['tiers']}")
    check(row_c["max_err_m"] <= FAIL_ERR_M, f"phase8 c_fused: a frame is "
          f"{row_c['max_err_m']} m off the ground truth")
    check(row_c["launches"]["fused_moment_sweep"] > 0,
          "phase8 c: the fused kernel never ran")

    # (d) a burst of low-overlap crops on frames 5-8. The reference drifts
    # past FAIL_ERR_M from frame 8 on this stream (ROADMAP queue 3): the
    # port is held to the reference's error on every frame + the band.
    burst = [apply_faults(s, BURST_SPEC, seed=0, frame=f) if f in BURST
             else (s, None) for f, (s, _) in enumerate(scans)]
    _, poses_d, diags_d, row_d = drive("d_burst", cfg, burst)

    def ladder(row, f):  # a frame's tier and its attempts' verdicts
        return (row["tiers"][f], [a[1:] for a in row["attempts"]
                                  if a[0] == f])
    acted = [f for f in BURST if ladder(row_d, f) != ladder(row_a, f)]
    row_d["burst_frames_unlike_a"] = acted
    check(len(acted) > 0, "phase8 d: on every burst frame the cascade "
          "settled and reasoned as on the clean stream")
    worse = np.asarray(row_d["err_m"]) - np.asarray(ODOM_REF_BURST_ERR_M)
    row_d["max_err_over_ref_m"] = float(worse.max())
    check(float(worse.max()) <= ODOM_BAND_M, f"phase8 d: per-frame error "
          f"{np.round(row_d['err_m'], 3).tolist()} exceeds the reference's "
          f"{np.round(ODOM_REF_BURST_ERR_M, 3).tolist()} + {ODOM_BAND_M}")
    check(row_d["launches"]["nn_search"] > 0,
          "phase8 d: no retry tier launched nn_search")
    log(f"phase8 d: error per frame {np.round(row_d['err_m'], 3).tolist()} "
        f"m (reference {np.round(ODOM_REF_BURST_ERR_M, 3).tolist()}); tier "
        f"histogram {row_d['tier_counts']}, health {row_d['health_counts']}; "
        f"burst frames whose tier or attempt reasons differ from run a: "
        f"{acted}")

    # (e) each retry tier once on frame 10's prepared frame, against the map
    # as it stands after frames 0-9 (driven primary-only: tiers of no use
    # to (e) cost nothing there), each held to the reference's attempt.
    pe = OdometryPipeline(cfg._replace(recovery_tiers=()), device=dev)
    regs, restore = record_registrations(torch)
    prefix_ms = []

    def prefix():
        for scan, _ in scans[:TIER_FRAME]:
            t = time.perf_counter()
            pe.process(scan)
            torch.cuda.synchronize()
            prefix_ms.append((time.perf_counter() - t) * 1e3)
    try:
        _, _, launches_e = counted(torch, prefix)
    finally:
        restore()
    check(launches_e == expected_launches(regs), f"phase8 e prefix: "
          f"launches {launches_e}, expected {expected_launches(regs)}")
    for k, v in launches_e.items():
        totals[k] += v
    primary_ms = statistics.median(prefix_ms[3:])
    out["e_prefix"] = dict(launches=launches_e, frame_ms=prefix_ms,
                           median_frame_ms=primary_ms)
    log(f"phase8 e prefix (frames 0-{TIER_FRAME - 1}, primary only): "
        f"launches {launches_e}, median frame (3-{TIER_FRAME - 1}) "
        f"{primary_ms:.1f} ms")
    prep = pe.prepare_frame(scans[TIER_FRAME][0])
    map_pts, map_valid = pe.submap.target()
    out["e_tiers"] = {}
    for name in DEFAULT_RECOVERY_TIERS:
        regs, restore = record_registrations(torch)
        try:
            res, wall, launches = counted(torch, lambda: pe._tier_attempt(
                name, prep.src, prep.sv, map_pts, map_valid, prep.T0))
        finally:
            restore()
        expect = expected_launches(regs)
        check(launches == expect, f"phase8 e {name}: launches {launches}, "
              f"expected {expect}")
        for k, v in launches.items():
            totals[k] += v
        T = np.asarray(res.T, np.float64)
        d_gt = float(np.abs(T - gt(TIER_FRAME)).max())
        d_ref = float(np.linalg.norm(T[:3, 3] - ODOM_REF_TIER_T[name]))
        check(np.all(np.isfinite(T)), f"phase8 e {name}: non-finite T")
        check(d_ref <= ODOM_BAND_M, f"phase8 e {name}: t off the JAX "
              f"reference's by {d_ref} m")
        out["e_tiers"][name] = dict(launches=launches, wall_ms=wall,
                                    iterations=int(res.iterations),
                                    max_abs_T_vs_gt=d_gt, d_ref_m=d_ref)
        log(f"phase8 e {name} on frame {TIER_FRAME}: iterations "
            f"{int(res.iterations)}, launches {launches}, {wall:.1f} ms, "
            f"|t - t_ref| {d_ref:.4f} m, max|T - T_gt| {d_gt:.4f} "
            f"(the reference's {ODOM_REF_TIER_D_GT[name]:.4f})")

    # Why the fallback lands centimetres from the reference's attempt
    # (recorded, not gated): the brute engine at other iteration caps, and
    # from the reference's frame-9 position in place of the port's (the
    # rotation stays the port's). The fallback's init is poses[9], which
    # the primary-only prefix set; the reference's prefix is its run (a).
    brute = get_engine("cuda", device=dev)
    init_ref = pe.poses[-1].copy()
    init_ref[:3, 3] = ODOM_REF_POSITIONS[TIER_FRAME - 1]
    fallback = []
    inits = dict(port=pe.poses[-1], ref_t9=init_ref)
    for label, cap in (("port", 10), ("port", 20), ("port", 29),
                       ("port", 30), ("port", 60), ("port", 120),
                       ("ref_t9", 30), ("ref_t9", 120)):
        r = brute.register(prep.src, map_pts,
                           cfg.params._replace(max_iterations=cap),
                           initial_transform=inits[label],
                           src_valid=prep.sv, dst_valid=map_valid)
        t = torch.as_tensor(r.T).double().cpu().numpy()[:3, 3]
        fallback.append(dict(init=label, cap=cap,
                             iterations=int(r.iterations), t=t.tolist(),
                             d_ref_m=float(np.linalg.norm(
                                 t - ODOM_REF_TIER_T["fallback"]))))
    t9 = pe.poses[-1][:3, 3].astype(np.float64)
    out["e_fallback_caps"] = dict(
        d_init_m=float(np.linalg.norm(
            t9 - ODOM_REF_POSITIONS[TIER_FRAME - 1])), runs=fallback)
    log(f"phase8 e fallback: port's frame-9 position "
        f"{out['e_fallback_caps']['d_init_m']:.4f} m from the reference's; "
        + "; ".join(f"init {f['init']} cap {f['cap']}: {f['iterations']} "
                    f"iterations, |t - t_ref fallback| {f['d_ref_m']:.4f} m, "
                    f"t {np.round(f['t'], 4).tolist()}" for f in fallback))

    # Device kernels and busy time of one primary-only frame (frame 10),
    # against that frame's own wall time under the profiler.
    frame_wall = []

    def profiled_frame():
        t = time.perf_counter()
        pe.process(scans[TIER_FRAME][0])
        torch.cuda.synchronize()
        frame_wall.append((time.perf_counter() - t) * 1e3)
    k, busy, host_launches = device_profile(torch, profiled_frame)
    out["profile_frame"] = dict(
        frame=TIER_FRAME, device_kernels=k, device_busy_ms=busy,
        host_launches=host_launches, wall_ms_profiled=frame_wall[0],
        idle_share=None if busy is None else 1.0 - busy / frame_wall[0])
    log(f"phase8 profile of frame {TIER_FRAME}, primary only: " + (
        "device not measured" if k is None else
        f"{k} device kernels ({host_launches} host launch calls), "
        f"{busy:.2f} ms device-busy, idle {1.0 - busy / frame_wall[0]:.1%} "
        f"of the frame's own {frame_wall[0]:.1f} ms under the profiler "
        f"(unprofiled primary-only frames 3-{TIER_FRAME - 1}: median "
        f"{primary_ms:.1f} ms)"))
    out["launch_totals"] = totals
    out["kernel_checks"] = row_a["kernel_checks"] + row_c["kernel_checks"]
    for name in ("nn_search", "candidate_sweep", "fused_moment_sweep"):
        check(totals[name] > 0, f"phase8: the odometry path never launched "
              f"{name}")
        check(any(r["kernel"] == name for r in out["kernel_checks"]),
              f"phase8: no {name} call of frame {TIER_FRAME} was held to its "
              f"plain version")
    return out


def compare_minimizers(report):
    """Log each point-to-plane run of phase 7 beside the point-to-point run
    of the same path (phases 2, 3 and 5): iterations and wall ms per
    frame."""
    p2, p3, p5, p7 = (report[f"phase{k}"] for k in (2, 3, 5, 7))
    pairs = (("align_cuda", p2, "FppsICP(engine='cuda').align"),
             ("cuda_fused", p5["cuda_fused"], "fused 'cuda'"),
             ("align_pyramid", p5["align_pyramid"], "pyramid align"),
             ("pyramid_fused", p5["pyramid_fused"], "fused pyramid"),
             ("pairs_b8", p3["seq0_b8"], "'cuda' register_pairs B=8"),
             ("pairs_b8_fused", None, "fused 'cuda' register_pairs B=8"))
    for name, p2p, label in pairs:
        plane = p7[name]
        line = (f"phase7 vs point-to-point, {label}: plane iterations "
                f"{plane['iterations']}, {plane['per_frame_ms']:.2f} ms/frame")
        if p2p is not None:
            line += (f" | point-to-point iterations {p2p['iterations']}, "
                     f"{p2p.get('per_frame_ms', p2p['wall_ms']):.2f} "
                     f"ms/frame")
        log(line)


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
    nn_sass = sass_loop_mix(build.library_path("nn_search"),
                            "nn_search_kernel")
    if nn_sass is None:
        log("phase0 nn_search SASS: not available (no cuobjdump output)")
    else:
        fma = nn_sass.get("FFMA", 0) + nn_sass.get("FMUL", 0)
        total = sum(nn_sass.values())
        log(f"phase0 nn_search SASS, innermost loop with the most FMA-pipe "
            f"instructions: {total} instructions, {fma} FFMA+FMUL "
            f"({fma / total:.1%} of issue slots) | " + ", ".join(
                f"{k} {v}" for k, v in nn_sass.most_common()))

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

    report = dict(device=kind, card=card, build_s=build_s,
                  nn_search_sass_loop=nn_sass)
    cases = {r["case"]: r for r in phase1(torch, np, scenes)}
    report["phase1"] = list(cases.values())
    report["phase2"] = phase2(torch, np, scenes)
    report["phase3"] = phase3(torch, np, scenes,
                              {k: v["kernel_ms"] for k, v in cases.items()})
    grid_cases = {r["case"]: r for r in phase4(torch, np, scenes)}
    report["phase4"] = list(grid_cases.values())
    report["phase5"] = phase5(torch, np, scenes)
    report["phase6"] = phase6(torch, np, scenes)
    report["phase7"] = phase7(torch, np, scenes)
    compare_minimizers(report)
    report["phase8"] = phase8(torch, np)
    totals = {k: v + report["phase7"]["launch_totals"][k]
              + report["phase8"]["launch_totals"][k]
              for k, v in report["phase5"]["launch_totals"].items()}
    main_case = cases["seq0_b1"]
    launches = report["phase2"]["launches"] + sum(
        v.get("launches", 0) for v in report["phase3"].values()) \
        + totals["nn_search"]
    check(launches > 0, "the main path never launched nn_search")
    for name in ("candidate_sweep", "fused_moment_sweep", "moment_sweep"):
        check(totals[name] > 0, f"the main path never launched {name}")
    g = grid_cases["seq0_b1"]
    sweeps = {r["case"]: r for r in report["phase6"]["moment_sweep"]}
    planes = {r["case"]: r for r in report["phase6"]["fused_plane"]}
    ms6 = sweeps["seq0_b1"]
    odom = report["phase8"]["kernel_checks"]

    def odom_err(kernel):  # phase 8: frame 10's calls against plain
        return max(r["max_abs_err"] for r in odom if r["kernel"] == kernel)
    report["kernels"] = [dict(
        name="nn_search", route="cuda",
        source="src/repro_torch/kernels/csrc/nn_search.cu",
        replaces="src/repro/kernels/nn_search.py:49",
        replaces_wrapper="src/repro/kernels/nn_search.py::nn_search_kernel",
        launches=launches,
        max_abs_err=max(max(r["max_abs_d2"] for r in cases.values()),
                        odom_err("nn_search")),
        ms=main_case["kernel_ms"], ms_spread=main_case["kernel_ms_spread"],
        plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        bound5_ms=main_case["bound5_ms"],
        library_ms=main_case["library_ms"], shape=main_case["shape"],
        idx_mismatch=sum(r["idx_mismatch"] for r in cases.values()),
        max_abs_d2=max(r["max_abs_d2"] for r in cases.values()),
        kernel_ms=main_case["kernel_ms"]), dict(
        name="candidate_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/nn_search_grid.cu",
        replaces="src/repro/kernels/nn_search_grid.py:40",
        replaces_wrapper=("src/repro/kernels/nn_search_grid.py::"
                          "candidate_sweep_kernel"),
        launches=totals["candidate_sweep"],
        max_abs_err=max(max(r["max_abs_d2"] for r in grid_cases.values()),
                        odom_err("candidate_sweep")),
        ms=g["sweep_ms"], ms_spread=g["sweep_ms_spread"],
        plain_ms=g["sweep_plain_ms"],
        bound_ms=g["sweep_bound_ms"], bound_by=g["sweep_bound_by"],
        library_ms=None, shape=g["shape"],
        slot_mismatch=sum(r["slot_mismatch"] for r in grid_cases.values())),
        dict(
        name="fused_moment_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_icp.cu",
        replaces="src/repro/kernels/fused_icp.py:104",
        replaces_wrapper=("src/repro/kernels/fused_icp.py::"
                          "fused_moment_sweep"),
        launches=totals["fused_moment_sweep"],
        max_abs_err=max(max(f["max_abs_plane"] for r in grid_cases.values()
                            for f in r["fused"]),
                        odom_err("fused_moment_sweep")),
        ms=g["fused_ms"], ms_spread=g["fused_ms_spread"],
        plain_ms=g["fused_plain_ms"],
        bound_ms=g["fused_bound_ms"], bound_by=g["fused_bound_by"],
        library_ms=None, shape=g["shape"],
        max_rel_sum=max(f["max_rel_sum"] for r in grid_cases.values()
                        for f in r["fused"]),
        plane_max_abs_err=max(f["max_abs_plane"] for r in planes.values()
                              for f in r["robust"]),
        plane_max_rel_sum=max(f["max_rel_sum"] for r in planes.values()
                              for f in r["robust"]),
        prune_bit_equal=all(f["prune_bit_equal"] for r in planes.values()
                            for f in r["robust"]),
        plane_ms=planes["seq0_b1"]["ms"],
        plane_prune_ms=planes["seq0_b1"]["prune_ms"],
        plane_plain_ms=planes["seq0_b1"]["plain_ms"],
        plane_bound_ms=planes["seq0_b1"]["bound_ms"]), dict(
        name="moment_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/normals.cu",
        replaces="src/repro/kernels/normals.py:47",
        replaces_wrapper=("src/repro/kernels/normals.py::"
                          "moment_sweep_kernel"),
        launches=totals["moment_sweep"],
        max_abs_err=max(r["max_abs_err"] for r in sweeps.values()),
        ms=ms6["ms"], ms_spread=ms6["ms_spread"], plain_ms=ms6["plain_ms"],
        bound_ms=ms6["bound_ms"], bound_by=ms6["bound_by"],
        library_ms=None, shape=ms6["shape"],
        bit_equal=all(r["bit_equal"] for r in sweeps.values()),
        max_rel_sum=max(r["max_rel_sum"] for r in sweeps.values()),
        normal_max_abs_err=max(r["normal_max_abs_err"]
                               for r in sweeps.values()),
        valid_mask_diff=sum(r["valid_mask_diff"] for r in sweeps.values()))]
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
