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
     on seq 0 frames 0-10 (default ``SceneConfig``, ~32.5k points a scan)
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
  9. The multi-stream registration service: ``RegistrationService(
     ServiceConfig(slots=8), device="cuda")`` over a fleet of eight
     full-size streams (seqs 0-7, default ``SceneConfig``, phase 8's
     ``OdometryConfig(scan_budget=16384)``; one NN-kernel launch a loop
     step for all 8 lanes, 16,384 x 24,576). (a) recovery on, 5 frames, a
     ``crop:0.15`` burst on stream 0's frames 2-3: stream 0 and a clean
     peer give the bits of standalone ``OdometryPipeline(svc.
     stream_config)`` replays of their staged frames. (b) recovery off, 8
     frames: every stream the bits of its standalone replay; the fleet
     admitted in reverse order (every stream in another slot) and three
     streams beside five idle lanes give (b)'s bits again; stream 0 within
     0.05 m of a JAX reference run (constants below) with its verdicts.
     The NN-kernel calls of a (b) round and of a round with idle lanes and
     the grid sweeps of stream 0's retry tiers in (a) are held to the plain
     versions' bits. Recorded: per-round wall ms, frames/s, p50/p99 frame
     latency, the sequential replays' frames/s and the fleet/sequential
     ratio, iterations and launches a round, one profiled round's device
     kernels, busy ms and idle share, and the split of a round into
     prepare, classify, register, probe+fetch, complete and fuse. Then the
     launcher, ``repro_torch.launch.registration.main`` in ``serve`` and
     ``pairwise`` mode.
 10. Stream-sharded and point-sharded registration (``core.distributed``)
     on the one card: phase 9 (b)'s fleet through the sharded service,
     (a) ``ServiceConfig(slots=8, devices=1)`` on ``cuda:0``, every stream
     the bits of phase 9 (b); (b) ``devices=2`` over ``["cuda:0",
     "cuda:0"]`` (two blocks of 4 lanes in lockstep), every stream the
     bits of its standalone replay on ``"sharded-slots"``
     (``lanes_per_device=4, devices=1``), (a)'s verdicts on every frame,
     round 1 (the same inputs as (a)'s, another block width) within 1e-3 m
     of (a), seq 0 within 0.05 m of the JAX reference run of phase 9 (the
     gap to (a) on later frames recorded: an ICP that stops at the epsilon
     can stop elsewhere for a last-bit change; the stream that drifts most
     gives (b)'s bits alone through the single-device ``"slots"`` engine
     at width 4), a round's NN-kernel calls held to the
     plain version's bits, the NN launches of every round equal to the
     blocks' loop steps, one profiled round's device kernels and busy ms;
     (c) the ``"distributed"`` engine on phase 3's 8 seq-0 pairs over a
     1 x 2 ``("data", "model")`` mesh of ``cuda:0`` (8 frames, 2 target
     shards), the bits of the ``"cuda"`` engine's ``register_pairs``, and
     over a 2 x 2 mesh (2 blocks of 4 frames), the bits of the ``"cuda"``
     engine on each block's frames (its gap to the B=8 run recorded beside
     the ``"cuda"`` engine's own B=4-vs-B=8 gap); (d)
     ``distributed_nn_search`` at 4096 x 32768 over 4 target shards
     against one NN-kernel call (expected: the same bits; d² held to 1e-4).
     Recorded, no speed claimed (the blocks share one card): round ms of
     (a) and (b) beside phase 9 (b)'s, wall ms of (c), (d) against one call.
 11. The drivers (slice 7): (a) each example's ``main`` at its own
     defaults (``repro_torch.examples``: quickstart; odometry over 30
     frames, scan-to-map and frame-to-frame; the fleet on the ``cuda``,
     ``distributed`` and ``pyramid`` engines), each must print ``OK``:
     wall ms per frame (host clock, first-call setup included, as the
     examples print it) and launches; (b) the fused kernel's autotune sweep
     (``repro_torch.tools.autotune_fused.sweep``) at the tool's default
     shape: every launch setting (2, 4, 8, 16 warps a block, prune off and
     on) must give the plain version's planes and the default setting's T,
     bit for bit; each setting's device ms (the pass, and the whole
     iteration), the winner, and each variant's registers, spills and
     occupancy, which must agree with phase 0's ptxas log; (c)
     ``make_frame_engine`` with a ``T`` at B=1, 4096 x 32768 (the seq-0
     frame-0 pair, target padded with far-sentinel rows): the bits of
     ``nn_search_cuda``.
 12. The LM serving path (slice 8) at qwen2-0.5b's full width (494.03 M
     parameters, random weights from ``lm.init_params_numpy(cfg, 0)``): (a)
     the weights on the card, their bytes and ``max_memory_allocated``;
     (b) the teacher-forced logits of 2 x 64 seeded tokens, on the card and
     through the port's CPU path, held to a pasted JAX CPU run of the
     reference on the same weights (constants below): max |logit diff| at
     the pasted coordinates within 5e-2, the argmax equal wherever the
     reference's top-2 gap exceeds it; (c) ``Engine.generate`` greedy at
     the launcher's defaults (4 prompts of 32 tokens, 32 generated) and on
     2 prompts of 1024 tokens (the ``q_block`` path, two blocks of 512), 16
     generated: two engines the same tokens, the decode-vs-forward logit
     difference within 0.1, the tokens the teacher-forced argmax of
     ``forward`` except where its top-2 gap is under that difference;
     prefill ms, decode ms a step, the host's ms to queue a step and
     tokens/s, one decode step's device kernels, busy ms and idle share
     (profiler) beside its byte bound (the bf16 weights, the KV cache and
     the logits at HBM peak); the launcher ``repro_torch.launch.serve`` at
     its defaults must print its tok/s line and the engine's tokens; (d)
     ``vq_encode`` of 65,536 3-D latents against 8,192 codes through the
     NN kernel: one launch, the plain version's indices and d², bit for
     bit; ``rvq_encode`` at D=128 (4 books of 2,048) on the card, level-0
     codes the CPU path's except on near-ties.
 13. The recurrent block kinds (slice 9, ``models/ssm.py``) at full width,
     random weights from ``lm.init_params_numpy(cfg, 0)``: mamba2-780m (48
     SSD layers, 780.15 M parameters) and recurrentgemma-9b cut from 38 to
     5 layers (rglru, rglru, local_attn, rglru, rglru; 2,174.92 M
     parameters). For each: (a) the weights on the card, their bytes and
     ``max_memory_allocated``; (b) the teacher-forced logits of 2 x 64
     seeded tokens, on the card and through the port's CPU path, held to
     a pasted JAX CPU run of the reference (constants below) within a bar
     fixed before the first card run (0.3 and 0.15), the argmax equal
     wherever the reference's top-2 gap exceeds it; (c) ``Engine.generate``
     at the launcher's defaults (4 x 32 + 32) and on 2 x 1024 + 16
     (mamba2: four SSD chunks) or 2 x 2040 + 16 (recurrentgemma: past the
     2048-slot ring of its local_attn layer, whose positions are checked),
     held as in phase 12 with decode-vs-forward bars 0.4 and 0.25; prefill
     ms, decode ms a step, tokens/s, one decode step's device kernels,
     busy ms and idle share beside its byte bound (the weights, the
     recurrent states read and written, the KV ring, the logits); peak
     memory; then the launcher at its defaults (``--arch``, the full
     config cut to keep the script in its time limit,
     ``P13_LAUNCH_LAYERS``: mamba2-780m to 8 layers, recurrentgemma-9b to
     the phase's 5, whose tokens must be the engine's on the same
     weights), which must print its tok/s line. No port
     kernel runs on this path (the reference's SSD and RG-LRU are XLA ops):
     every count must stay 0.
 14. MLA and the single-device MoE FFN (slice 10, ``models/attention.py``
     and ``models/moe.py``) at full width, random weights from
     ``lm.init_params_numpy(cfg, 0)``: minicpm3-4b (62 MLA layers,
     4,261.90 M parameters), deepseek-moe-16b cut from 28 to 4 layers (the
     dense first layer and 3 MoE layers; 2,267.04 M) and
     qwen3-moe-235b-a22b cut from 94 to 2 layers (6,220.17 M). For each:
     (a) the weights on the card (the MoE router and MLA's ``wuk`` /
     ``wuv`` fp32, the experts bf16), their bytes and
     ``max_memory_allocated``; (b) the teacher-forced logits of 2 x 64
     seeded tokens and the MoE archs' summed aux, on the card and through
     the port's CPU path, held to a pasted JAX CPU run of the reference
     (constants below) within bars fixed before the first card run, the
     argmax equal wherever the reference's top-2 gap exceeds the bar; the
     (token, layer) routes the card and the CPU path choose differently;
     (c) ``Engine.generate`` at the launcher's defaults (4 x 32 + 32) and
     on 2 x 1024 + 16 (minicpm3-4b: two q_blocks of 512), held as in phase
     12, a MoE token only where no layer dropped one of its pairs in either
     call and both routed it alike (the others counted; a route that
     differs on an undropped token must be a near-tie); prefill ms, decode
     ms a step, tokens/s, the prefill's ``dropped_frac``, one decode step's
     device kernels, busy ms and idle share beside its byte bound (every
     weight read once: the MoE buffer runs every expert; the caches; the
     logits); peak memory; then the launcher at its defaults for
     minicpm3-4b and deepseek-moe-16b, their configs cut to keep the script
     in its time limit (``P14_LAUNCH_LAYERS``: minicpm3-4b to 8 layers,
     deepseek-moe-16b to the phase's 4, whose tokens must be the engine's;
     all 28 took 113-126 s, most of it numpy init), and with ``--smoke``
     for qwen3-moe. No port kernel
     runs on this path (the reference's MLA and MoE are XLA ops): every
     count must stay 0.

 15. The LM training path (slice 11: ``models/lm.py``'s trainable model
     and ``loss_fn``, ``optim/``, ``train/``, ``launch/train.py``) at
     qwen2-0.5b's full width and depth, 494.03 M fp32 ``nn.Parameter``s
     from ``lm.init_params_numpy(cfg, 0)``: (a) the trainable model's
     logits the serving model's bits on 2 x 64 seeded tokens; three
     ``make_train_step`` steps (AdamW, ``cosine_schedule(3e-4, 20, 21)``,
     remat none, the same batch) and two Adafactor steps held to a pasted
     JAX CPU run of the reference on the same weights (each step's loss,
     step 1's gradient norm, the parameters at 168 coordinates) within
     bars fixed before the first card run; the bytes of the parameters,
     gradients and AdamW state, ``max_memory_allocated``; the step's
     device ms (CUDA events), tokens/s, device kernels, busy ms and idle
     share (profiler) at 2 x 64 and 8 x 128 beside its bound (the
     products at the bf16 peak plus AdamW's bytes at HBM peak); (b) remat
     ``full`` and ``dots`` give ``none``'s bits, each mode's peak memory;
     ``accum_steps=2`` on 4 x 64 against one batch; (c) a second run of
     the three steps the same bits, and the state saved after step 2
     (``checkpoint.save``, ~5.9 GB under the git-ignored ``build/``,
     removed after) and restored onto ``train_step.abstract_state``: its
     step 3 the uninterrupted step 3's bits; (d) mamba2-780m,
     recurrentgemma-9b, minicpm3-4b, deepseek-moe-16b and qwen3-moe (also
     under Adafactor) at smoke size: 3 steps on the card against the
     port's CPU path, two card runs the same bits; (e) the launcher
     ``repro_torch.launch.train`` at its defaults (qwen2-0.5b at full
     width, 100 steps of 8 x 128): its loss falls and it prints its lines;
     ``--smoke`` stopped at step 6 and resumed to 12: the uninterrupted
     run's bits; the example ``repro_torch.examples.train_lm`` prints
     ``OK``. No port kernel runs on this path (the reference trains
     through XLA's autodiff of XLA ops): every count must stay 0.

 16. Partitioning, the expert-parallel MoE, the compressed data-parallel
     mean and the dry-run (slice 12: ``launch/{mesh,partition,specs,
     dryrun}.py``, ``models/moe_ep.py``, ``optim/compression.py``,
     ``roofline/report.py``): (a) ``moe_forward_ep`` at deepseek-moe-16b's
     full width (phase 14's layer-1 weights, capacity factor 1.25) on a
     (2, 4) ("data", "model") mesh of ``cuda:0`` repeated 8 times, 4 x 64
     seeded bf16 tokens (2 x 16 a device): the output at 168 coordinates,
     the aux losses and each shard's dropped pairs held to a pasted JAX
     CPU run of the reference's 8-device ``moe_forward_ep`` (constants
     below) within bars fixed before the first card run, on the card and
     through the port's CPU path (the card's routes the CPU path's but on
     near-ties); ``dropped_frac`` 0 as the reference reports it; the
     forward's device ms and the bytes each all-to-all moves; at capacity
     factor E / k the single-program ``moe_forward``'s output where both
     route alike; one backward pass through both all-to-alls with a finite,
     non-zero gradient norm; phase 14's 4-layer model under
     ``partitioning(mesh, {"moe_impl": "shard_map_ep", ...})`` (its MoE
     layers on the EP path) against the same forward without a context.
     (b) ``compressed_grad_reduce`` over qwen2-0.5b's 290 gradient leaves
     (494.03 M values, Gaussian, drawn on the card) on a 4-replica
     ("data",) mesh of ``cuda:0``: one reduction within 2% of the exact
     mean, 20 steps of error feedback within 2% accumulated, the device
     ms of a reduction and its wire bytes against an fp32 ring; on 25
     leaves (the first and last layer's, the final norm) the int8 codes,
     means and residuals the bits of the port's CPU path. (c) the dry-run CLI
     (``repro_torch.launch.dryrun``, ``meta`` devices) on qwen2-0.5b /
     decode_32k / single and fpps-icp / fleet_130k / multi: each record's
     per-device bytes, FLOPs and dominant term. No
     port kernel runs on these paths: every count must stay 0. Phase 16
     runs right after phase 14, on its model, which it frees before phase
     15.

Every kernel count is set to 0 just before each main-path run (phases 2, 3,
5, 7, 8, 9, 10, 11, 12, 13, 14, 15 and 16) and read just after. The last lines are
the ``{"kernels": [...]}`` report, the card line from ``nvidia-smi`` and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # dense, tensor cores
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
    from repro_torch.device import card_line as line
    return line()


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


def device_ms(torch, fn, reps=20, blocks=5, warmup=3):
    """``repro_torch.device.device_ms``: ``(median, min, max, ahead)`` ms of
    one call of ``fn`` on the device alone (CUDA events around back-to-back
    calls queued behind a busy-wait)."""
    from repro_torch.device import device_ms as timed
    return timed(fn, reps=reps, blocks=blocks, warmup=warmup)


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
# 0-10, default SceneConfig (~32.5k points a scan), through
# OdometryConfig(scan_budget=16384): the default budget of 8192 would drop
# about a third of every scan's occupied voxels from the +x end.
# The reference runs below cover frames 0-14; the stream is cut to 0-10
# (the clean frames 0-1, the burst 5-8, run (e)'s frame 10; the run is
# causal, so its first 11 frames are an 11-frame run's): five runs of
# 2.6-3.6 s frames are the script's longest phase, and the whole script
# took 1154-1249 s of its 1200 s limit on slower cards with phase 15
ODOM_FRAMES = 11
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
    """Wrap ``RegistrationEngine.register`` and ``register_batch`` (every
    engine of the odometry and service paths) to keep each registration's
    engine, coarse levels, ``fused`` flag, result and ``tag()`` (the frame
    or round), and with ``timed`` its ms between two syncs. Returns
    ``(log, restore)``."""
    from repro_torch.core.engine import RegistrationEngine
    log = []
    origs = {k: getattr(RegistrationEngine, k)
             for k in ("register", "register_batch")}

    def wrap(orig):
        def register(self, source, target, params=None, *args, **kwargs):
            if timed:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = orig(self, source, target, params, *args, **kwargs)
            if timed:
                torch.cuda.synchronize()
            log.append(dict(engine=self.name,
                            levels=getattr(self, "_levels", ()),
                            fused=params.fused, res=res,
                            tag=None if tag is None else tag(),
                            ms=(time.perf_counter() - t0) * 1e3 if timed
                            else None))
            return res
        return register

    for k, orig in origs.items():
        setattr(RegistrationEngine, k, wrap(orig))
    return log, lambda: [setattr(RegistrationEngine, k, o)
                         for k, o in origs.items()]


def expected_launches(log):
    """Kernel launches the registrations in ``log`` must have made: a
    pyramid runs its fixed coarse iterations through ``nn_search`` and one
    polish launch per iteration (``fused_moment_sweep`` if fused, else
    ``candidate_sweep``); the ``"cuda"`` engine one launch per iteration;
    the ``"slots"`` engine one per step of its stop-early loop over the
    lanes, which is its lanes' most iterations (a single-frame call's lane
    0, the others freezing after one)."""
    out = dict(nn_search=0, candidate_sweep=0, fused_moment_sweep=0,
               moment_sweep=0)
    for r in log:
        it = int(r["res"].iterations.max())
        key = "fused_moment_sweep" if r["fused"] else (
            "candidate_sweep" if r["engine"] == "pyramid" else "nn_search")
        out[key] += it
        out["nn_search"] += sum(int(lv[1]) for lv in r["levels"])
    return out


# Where the odometry path calls each kernel's wrapper: (module, name there,
# kernel). Phases 8 and 9 wrap these to keep one frame's (or round's)
# operands.
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


def hold_captured(torch, run, captured, regs,
                  where=f"phase8 {{run}} frame {TIER_FRAME}"):
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
        label = {"cuda": "fallback", "slots": "fleet",
                 "sharded-slots": "fleet"}.get(
            r["engine"], tiers.get(tuple(r["levels"]), str(r["levels"])))
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
        else:  # the launch setting does not apply to the plain version
            again = (moment_planes(*args, **kw),)
            plain = (ref.fused_moment_planes(*args, **{
                k: v for k, v in kw.items() if k != "warps_per_block"}),)
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
        at = where.format(run=run)
        log(f"{at} {label} {kernel} {shapes}: "
            f"main path and relaunch bit-equal to plain {same}, "
            f"{row.get('mismatch', '-')} index/slot mismatches, max |main "
            f"- plain| {row['max_abs_err']}")
        check(same, f"{at} {label} {kernel} {shapes}: the kernel "
              f"differs from its plain version on the main path's operands")
    return rows


def hold_to_reference(name, np, poses, diags, row, positions, verdicts,
                      phase="phase8"):
    """Check a phase-8 (or 9) run against a JAX reference run of the same
    stream: every position within ``ODOM_BAND_M``, and per frame the same
    (tier, health, quarantined), every frame accepted."""
    d_ref = np.linalg.norm(poses[:, :3, 3].astype(np.float64)
                           - np.asarray(positions), axis=1)
    row["max_d_ref_m"] = float(d_ref.max())
    got = tuple((d.recovery_tier, d.health, d.quarantined) for d in diags)
    check(got == tuple(verdicts) and all(d.accepted for d in diags),
          f"{phase} {name}: (tier, health, quarantined) per frame {got} "
          f"differ from the JAX reference's {verdicts}")
    check(float(d_ref.max()) <= ODOM_BAND_M, f"{phase} {name}: positions off "
          f"the JAX reference by up to {d_ref.max()} m: "
          f"{np.round(d_ref, 4).tolist()}")
    log(f"{phase} {name}: verdicts as the JAX reference's; max |t - t_ref| "
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
                      ODOM_REF_POSITIONS[:ODOM_FRAMES],
                      ODOM_REF_VERDICTS[:ODOM_FRAMES])
    check(row_a["max_err_m"] <= FAIL_ERR_M, f"phase8 a: a frame is "
          f"{row_a['max_err_m']} m off the ground truth")
    log(f"phase8 a: bit-identical rerun; frame split of the rerun (median "
        f"of frames 3-{ODOM_FRAMES - 1}, ms, a sync around each stage): "
        + ", ".join(
            f"{k} {v:.1f}" for k, v in row_a2["split_ms"].items()))

    # (b) fp16 submap storage: held to the reference's fp16 run, which
    # leaves run a's path at frame 8 (ROADMAP queue 3); its distance from
    # run a is logged. (c) the fused polish: within the band of (a) on every
    # frame, with its tiers.
    _, poses_b, diags_b, row_b = drive("b_fp16", cfg._replace(
        submap=cfg.submap._replace(storage="fp16")), scans)
    hold_to_reference("b_fp16", np, poses_b, diags_b, row_b,
                      ODOM_REF_FP16_POSITIONS[:ODOM_FRAMES],
                      ODOM_REF_FP16_VERDICTS[:ODOM_FRAMES])
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
    ref_err = ODOM_REF_BURST_ERR_M[:ODOM_FRAMES]
    worse = np.asarray(row_d["err_m"]) - np.asarray(ref_err)
    row_d["max_err_over_ref_m"] = float(worse.max())
    check(float(worse.max()) <= ODOM_BAND_M, f"phase8 d: per-frame error "
          f"{np.round(row_d['err_m'], 3).tolist()} exceeds the reference's "
          f"{np.round(ref_err, 3).tolist()} + {ODOM_BAND_M}")
    check(row_d["launches"]["nn_search"] > 0,
          "phase8 d: no retry tier launched nn_search")
    log(f"phase8 d: error per frame {np.round(row_d['err_m'], 3).tolist()} "
        f"m (reference {np.round(ref_err, 3).tolist()}); tier "
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


# Slice 5: the multi-stream registration service. The fleet is
# sequence_scans(s, 8) for s = 0..7 (default SceneConfig: distinct worlds,
# each sequence at its own speed; seq 1 is the 2.5 m/frame highway
# outlier) through ServiceConfig(slots=8) and phase 8's
# OdometryConfig(scan_budget=16384); staged at the bucket of the fleet's
# largest scan.
FLEET_SLOTS = 8
FLEET_FRAMES_A = 5          # (a): recovery on, a crop burst on stream 0
FLEET_FRAMES_B = 8          # (b): recovery off
FLEET_CROP = (2, 3)         # (a): crop:0.15 on stream 0, these frames
FLEET_PEER = "seq2"         # (a): the clean peer replayed beside stream 0
FLEET_CAPTURE_ROUND = 4     # (b): rounds whose NN-kernel operands are held
FLEET_PROFILE_ROUND = 5     # (b) reversed: the profiled round
FLEET_STEADY = 3            # medians over rounds 3 and later
# The JAX reference on stream 0 of run (b), through the reference's "xla"
# engine (the function of one slot lane): a CPU run of src/repro, about
# 2 minutes on an 8-core CPU host:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import repro.core
#   from repro.core.odometry import OdometryConfig, OdometryPipeline
#   from repro.data.collate import pad_cloud
#   from repro.data.pointcloud import sequence_scans
#   p = OdometryPipeline(OdometryConfig(engine='xla', scan_budget=16384,
#                                       recovery=False))
#   for s in sequence_scans(0, 8): p.process(*pad_cloud(s, 49152))
#   print([x[:3, 3].tolist() for x in p.poses], [(d.recovery_tier,
#         d.health, d.quarantined, d.iterations) for d in p.diagnostics])"
# Every frame is OK and accepted, at 0/30/15/7/1/2/3/6 iterations.
FLEET_REF_POSITIONS = (
    (0.0, 0.0, 0.0),
    (0.6667321920394897, 0.008237309753894806, -0.02172265760600567),
    (1.4952950477600098, 0.013984539546072483, -0.03363744542002678),
    (2.271655797958374, 0.03660059720277786, -0.03952847048640251),
    (3.0485291481018066, 0.06239581108093262, -0.04566542059183121),
    (3.829115867614746, 0.08888494968414307, -0.04704217240214348),
    (4.608298301696777, 0.11293573677539825, -0.056114885956048965),
    (5.390973091125488, 0.10896036773920059, -0.05241825059056282))
FLEET_REF_VERDICTS = ((0, "ok", False),) * FLEET_FRAMES_B


def same_stream(np, a, b):
    """Two runs' ``[(pose, diag), ...]`` of one stream: the same bits."""
    return len(a) == len(b) and all(
        np.array_equal(pa, pb) and repr(tuple(da)) == repr(tuple(db))
        for (pa, da), (pb, db) in zip(a, b))


def instrument_service(torch, svc, stages):
    """Time each stage of ``svc``'s rounds between two syncs, into
    ``stages[stage][round]`` (ms): prepare, classify, register,
    probe+fetch, complete (the host cascade) and fuse. Returns the
    restore."""
    import repro_torch.serve.registration_service as rs

    def timed(stage, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            per = stages.setdefault(stage, {})
            per[svc.rounds - 1] = (per.get(svc.rounds - 1, 0.0)
                                   + (time.perf_counter() - t) * 1e3)
            return r
        return run
    names = dict(_prepare_batch="prepare", out_of_lattice_frac="probe+fetch",
                 host_result="probe+fetch", _fuse_batch="fuse")
    origs = {k: getattr(rs, k) for k in names}
    for k, stage in names.items():
        setattr(rs, k, timed(stage, origs[k]))
    svc.engine.register_batch = timed("register", svc.engine.register_batch)
    for stream in svc._streams.values():
        stream.pipe.prepare_frame = timed("classify",
                                          stream.pipe.prepare_frame)
        stream.pipe.complete_frame = timed("complete",
                                           stream.pipe.complete_frame)

    def restore():
        for k, f in origs.items():
            setattr(rs, k, f)
        del svc.engine.register_batch
    return restore


def phase9(torch, np):
    """The multi-stream registration service at full size on the card."""
    from repro_torch.core.icp import scrub_nonfinite
    from repro_torch.core.odometry import OdometryConfig, OdometryPipeline
    from repro_torch.data.collate import bucket_size
    from repro_torch.data.corruption import apply_faults
    from repro_torch.data.pointcloud import gt_pose, sequence_scans
    from repro_torch.data.voxelize import voxel_downsample
    from repro_torch.kernels.nn_search import nn_search_kernel
    from repro_torch.launch.registration import main as launcher
    from repro_torch.serve import RegistrationService, ServiceConfig

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    frames_n = max(FLEET_FRAMES_A, FLEET_FRAMES_B)
    scans = {f"seq{s}": sequence_scans(s, frames_n)
             for s in range(FLEET_SLOTS)}
    sizes = [len(x) for v in scans.values() for x in v]
    cap = bucket_size(max(sizes))
    odo = OdometryConfig(scan_budget=ODOM_SCAN_BUDGET)
    cells = []
    for sid, stream in scans.items():  # the scan downsample drops no cell
        for f, scan in enumerate(stream):
            pts, v = scrub_nonfinite(torch.as_tensor(scan, device=dev))
            _, sv, dropped = voxel_downsample(pts, odo.scan_voxel,
                                              max_points=odo.scan_budget,
                                              valid=v, with_stats=True)
            cells.append(int(sv.sum()))
            check(int(dropped) == 0, f"phase9: the downsample of {sid} "
                  f"frame {f} dropped {int(dropped)} cells")
    log(f"phase9 fleet: seqs 0-{FLEET_SLOTS - 1} x {frames_n} frames, "
        f"{min(sizes)}-{max(sizes)} points a scan, staged at "
        f"scan_capacity {cap}; {min(cells)}-{max(cells)} occupied "
        f"{odo.scan_voxel} m voxels (budget {odo.scan_budget}, 0 dropped); "
        f"map capacity {odo.submap.capacity}; "
        f"{time.perf_counter() - t0:.1f} s")
    out, totals = {}, dict(nn_search=0, candidate_sweep=0,
                           fused_moment_sweep=0, moment_sweep=0)
    kernel_checks = []

    def service(config):
        return RegistrationService(ServiceConfig(
            slots=FLEET_SLOTS, scan_capacity=cap, odometry=config),
            device=dev)

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    def fleet_run(name, config, frames, order, capture=None, split=False,
                  profile_round=None, setup=None):
        """One counted run of a fresh service: the streams of ``order``
        admitted in that order (then ``setup(svc)``), ``frames[sid]``
        submitted wave by wave, every kernel count set to 0 just before and
        read just after. ``capture = (want(svc), kernels)`` keeps kernel
        operands for :func:`hold_captured`."""
        svc = service(config)
        for sid in order:
            svc.admit(sid)
        if setup is not None:
            setup(svc)
        regs, restore = record_registrations(torch, tag=lambda: svc.rounds)
        want, kernels, at_round = capture or (lambda _svc: False, (), None)
        captured, uncapture = capture_operands(torch, regs,
                                               lambda: want(svc), kernels)
        stages = {}
        unsplit = (instrument_service(torch, svc, stages) if split
                   else (lambda: None))
        outputs = {sid: [] for sid in order}
        rounds, profile = [], {}
        n_rounds = len(next(iter(frames.values())))

        def one_round(f):
            t = time.perf_counter()
            n0 = nn_search_kernel.launches
            for sid in order:
                svc.submit(sid, *frames[sid][f])
            res = svc.step()
            t_out = time.perf_counter()
            svc.sync()
            t_end = time.perf_counter()
            for sid, r in res.items():
                outputs[sid].append(r)
            rounds.append(dict(
                round=f, wall_ms=(t_end - t) * 1e3,
                latency_ms=(t_out - t) * 1e3,
                nn_launches=nn_search_kernel.launches - n0,
                iterations=max(d.iterations for _, d in res.values()),
                tiers=[res[sid][1].recovery_tier for sid in order
                       if sid in res]))

        def run():
            for f in range(n_rounds):
                if f == profile_round:
                    k, busy, host = device_profile(torch,
                                                   lambda: one_round(f))
                    wall = rounds[-1]["wall_ms"]
                    profile.update(round=f, device_kernels=k,
                                   device_busy_ms=busy, host_launches=host,
                                   wall_ms_profiled=wall,
                                   idle_share=(None if busy is None
                                               else 1.0 - busy / wall))
                else:
                    one_round(f)
        try:
            _, wall, launches = counted(torch, run)
        finally:
            restore()
            uncapture()
            unsplit()
        expect = expected_launches(regs)
        check(launches == expect, f"phase9 {name}: launches {launches}, "
              f"expected {expect}")
        add(launches)
        steady = [r for r in rounds if r["round"] >= FLEET_STEADY
                  and r["round"] != profile_round]
        lat = sorted(r["latency_ms"] for r in steady
                     for _ in range(len(order)))
        round_ms = statistics.median(r["wall_ms"] for r in steady)
        fps = (len(order) * len(steady)
               / (sum(r["wall_ms"] for r in steady) / 1e3))
        row = dict(
            launches=launches, wall_ms=wall, rounds=rounds,
            median_round_ms=round_ms, fps=fps,
            latency_p50_ms=float(np.percentile(lat, 50)),
            latency_p99_ms=float(np.percentile(lat, 99)),
            registrations=len(regs),
            batch_shapes=svc.service_report()["batch_shapes"],
            service_report=svc.service_report())
        for sid in order:
            poses = np.stack([p for p, _ in outputs[sid]])
            check(np.all(np.isfinite(poses)), f"phase9 {name} {sid}: "
                  f"non-finite pose")
        # Saturation of the 24,576-row map, a property of the
        # configuration (recorded; the replays hold it to the bit).
        row["dropped_cells"] = {sid: svc._streams[sid].pipe.submap
                                .dropped_cells for sid in order}
        if profile:
            row["profile_round"] = profile
        if split:
            split_ms = {stage: statistics.median(
                per.get(r["round"], 0.0) for r in steady)
                for stage, per in stages.items()}
            split_ms["rest"] = statistics.median(
                r["wall_ms"] - sum(per.get(r["round"], 0.0)
                                   for per in stages.values())
                for r in steady)
            row["split_ms"] = split_ms
        if captured:
            row["kernel_checks"] = hold_captured(
                torch, name, captured, regs,
                where=f"phase9 {{run}} round {at_round}")
            kernel_checks.extend(row["kernel_checks"])
        check(row["batch_shapes"] == 1, f"phase9 {name}: the slot engine "
              f"ran {row['batch_shapes']} batch shapes, not 1")
        log(f"phase9 {name}: {len(order)} streams x {n_rounds} rounds, "
            f"{len(regs)} registrations, launches {launches} | median "
            f"round (>= {FLEET_STEADY}) {round_ms:.1f} ms, {fps:.2f} "
            f"frames/s, frame latency p50 {row['latency_p50_ms']:.1f} / "
            f"p99 {row['latency_p99_ms']:.1f} ms | per round: iterations "
            f"{[r['iterations'] for r in rounds]}, nn_search launches "
            f"{[r['nn_launches'] for r in rounds]}, wall ms "
            f"{[round(r['wall_ms'], 1) for r in rounds]} | submap cells "
            f"dropped {row['dropped_cells']}")
        out[name] = row
        return svc, outputs, row

    def replay(name, config, staged, sids):
        """Standalone ``OdometryPipeline(config)`` replays of
        ``staged[sid]``, one pipeline a stream, frame by frame across the
        streams in a host loop (counted; each call timed between syncs)."""
        res, frame_ms = {sid: [] for sid in sids}, {sid: [] for sid in sids}
        regs, restore = record_registrations(torch)

        def run():
            pipes = {sid: OdometryPipeline(config, device=dev)
                     for sid in sids}
            for f in range(len(staged[sids[0]])):
                for sid in sids:
                    t = time.perf_counter()
                    res[sid].append(pipes[sid].process(*staged[sid][f]))
                    torch.cuda.synchronize()
                    frame_ms[sid].append((time.perf_counter() - t) * 1e3)
        try:
            _, wall, launches = counted(torch, run)
        finally:
            restore()
        check(launches == expected_launches(regs), f"phase9 {name}: "
              f"launches {launches}, expected {expected_launches(regs)}")
        add(launches)
        steady = [ms for sid in sids for ms in frame_ms[sid][FLEET_STEADY:]]
        row = dict(streams=list(sids), launches=launches, wall_ms=wall,
                   frame_ms=frame_ms, fps=len(steady) / (sum(steady) / 1e3))
        return res, row

    def slot_config(config):  # the service's stream_config
        return config._replace(engine="slots",
                               engine_kwargs=(("slots", FLEET_SLOTS),))

    # (a) recovery on: a crop burst on stream 0, frames 2-3.
    frames_a = {sid: [(scan, None) for scan in v[:FLEET_FRAMES_A]]
                for sid, v in scans.items()}
    frames_a["seq0"] = [apply_faults(scan, BURST_SPEC, seed=0, frame=f)
                        if f in FLEET_CROP else (scan, None)
                        for f, (scan, _) in enumerate(frames_a["seq0"])]
    in_tier = [False]

    def want_a(svc):  # the retry tiers of stream 0 on the first crop frame
        return in_tier[0] and svc.rounds - 1 == FLEET_CROP[0]

    def flag_tiers(svc):
        pipe = svc._streams["seq0"].pipe
        attempt = pipe._tier_attempt

        def flagged(*a, **kw):
            in_tier[0] = True
            try:
                return attempt(*a, **kw)
            finally:
                in_tier[0] = False
        pipe._tier_attempt = flagged

    order = list(scans)
    t_a = time.perf_counter()
    svc_a, out_a, row_a = fleet_run(
        "a_recovery", odo, frames_a, order,
        capture=(want_a, ("candidate_sweep",), FLEET_CROP[0]),
        setup=flag_tiers)
    log(f"phase9 a_recovery: {time.perf_counter() - t_a:.1f} s, mostly each "
        f"stream's retry ladder (recovery on; the condition probe reads "
        f"full-size scans SUSPECT, ROADMAP queue 3)")
    for sid in order:
        log(f"phase9 a_recovery {sid}: tiers "
            f"{[d.recovery_tier for _, d in out_a[sid]]} health "
            f"{[d.health for _, d in out_a[sid]]} quarantined "
            f"{[int(d.quarantined) for _, d in out_a[sid]]}")
    staged_a = {sid: [svc_a.stage_scan(*fr) for fr in frames_a[sid]]
                for sid in ("seq0", FLEET_PEER)}
    rep_a, rep_row_a = replay("a_replay", slot_config(odo), staged_a,
                              list(staged_a))
    for sid in staged_a:
        check(same_stream(np, out_a[sid], rep_a[sid]), f"phase9 a: {sid} "
              f"through the service differs from its standalone replay")
    row_a["replay"] = rep_row_a
    check(any(r["kernel"] == "candidate_sweep"
              for r in row_a.get("kernel_checks", ())),
          "phase9 a: no retry tier's grid sweep of stream 0 was held")
    log("phase9 a: seq0 (crop) and its clean peer "
        f"{FLEET_PEER} bit-identical to standalone replays")

    # (b) recovery off, the reference's service benchmark regime.
    odo_b = odo._replace(recovery=False)
    frames_b = {sid: [(scan, None) for scan in v[:FLEET_FRAMES_B]]
                for sid, v in scans.items()}

    def want_b(svc):
        return svc.rounds - 1 == FLEET_CAPTURE_ROUND

    _, out_b, row_b = fleet_run(
        "b_fleet", odo_b, frames_b, order,
        capture=(want_b, ("nn_search",), FLEET_CAPTURE_ROUND))
    staged_b = {sid: [svc_a.stage_scan(scan) for scan, _ in v]
                for sid, v in frames_b.items()}
    rep_b, rep_row_b = replay("b_replay", slot_config(odo_b), staged_b,
                              order)
    for sid in order:
        check(same_stream(np, out_b[sid], rep_b[sid]), f"phase9 b: {sid} "
              f"through the service differs from its standalone replay")
    row_b["replay"] = rep_row_b
    # The reference's sequential baseline (_run_sequential of
    # benchmarks/service_throughput.py): each stream alone through the
    # plain single-pair engine, the "cuda" kernel engine here.
    seq_b, seq_row_b = replay("b_sequential", odo_b._replace(
        engine="cuda", engine_kwargs=()), staged_b, order)
    seq_row_b["max_position_gap_m"] = {sid: float(max(
        np.abs(p[:3, 3] - q[:3, 3]).max()
        for (p, _), (q, _) in zip(seq_b[sid], out_b[sid]))) for sid in order}
    for sid in order:
        check(all(np.all(np.isfinite(p)) for p, _ in seq_b[sid]),
              f"phase9 b_sequential {sid}: non-finite pose")
    row_b["sequential"] = seq_row_b
    row_b["fps_ratio"] = row_b["fps"] / seq_row_b["fps"]
    row_b["fps_over_slot_replays"] = row_b["fps"] / rep_row_b["fps"]
    log(f"phase9 b: every stream bit-identical to its standalone replay "
        f"(slot engine, {rep_row_b['fps']:.2f} frames/s: fleet/replays "
        f"{row_b['fps_over_slot_replays']:.2f}x); sequential baseline "
        f"(one 'cuda'-engine pipeline a stream) {seq_row_b['fps']:.2f} "
        f"frames/s, fleet {row_b['fps']:.2f} (frames >= {FLEET_STEADY}): "
        f"fps_ratio {row_b['fps_ratio']:.2f}x; sequential positions within "
        f"{max(seq_row_b['max_position_gap_m'].values()):.4f} m of the "
        f"fleet's")
    poses0 = np.stack([p for p, _ in out_b["seq0"]])
    hold_to_reference("b_fleet seq0", np, poses0,
                      [d for _, d in out_b["seq0"]], row_b,
                      FLEET_REF_POSITIONS, FLEET_REF_VERDICTS, phase="phase9")
    gt = gt_pose(0)
    row_b["seq0_err_m"] = np.linalg.norm(
        poses0[:, :3, 3] - np.stack([gt(f)[:3, 3] for f in range(
            FLEET_FRAMES_B)]), axis=1).tolist()

    _, out_r, row_r = fleet_run("b_reversed", odo_b, frames_b, order[::-1],
                                split=True, profile_round=FLEET_PROFILE_ROUND)
    _, out_3, _ = fleet_run(
        "b_three", odo_b, frames_b, order[:3],
        capture=(want_b, ("nn_search",), FLEET_CAPTURE_ROUND))
    for sid in order:
        check(same_stream(np, out_r[sid], out_b[sid]), f"phase9 b_reversed: "
              f"{sid} in another slot gave other bits")
    for sid in order[:3]:
        check(same_stream(np, out_3[sid], out_b[sid]), f"phase9 b_three: "
              f"{sid} beside five idle lanes gave other bits")
    p = row_r["profile_round"]
    log("phase9 b: reversed admission (every stream in another slot) and "
        "three streams beside five idle lanes: the same bits as b_fleet; "
        "split of a reversed round (median of rounds >= "
        f"{FLEET_STEADY}, ms, a sync around each stage): " + ", ".join(
            f"{k} {v:.1f}" for k, v in row_r["split_ms"].items())
        + f" | profiled round {p['round']}: " + (
            "device not measured" if p["device_kernels"] is None else
            f"{p['device_kernels']} device kernels ({p['host_launches']} "
            f"host launch calls), {p['device_busy_ms']:.2f} ms busy, idle "
            f"{p['idle_share']:.1%} of its own {p['wall_ms_profiled']:.1f} "
            f"ms"))

    # The launcher on the card.
    for argv in (["--mode", "serve", "--streams", "4", "--frames", "4"],
                 ["--mode", "pairwise", "--frames", "2"]):
        _, wall, launches = counted(torch, lambda: launcher(argv))
        add(launches)
        out["launcher " + " ".join(argv)] = dict(wall_ms=wall,
                                                  launches=launches)
        log(f"phase9 launcher {' '.join(argv)}: {wall:.0f} ms, launches "
            f"{launches}")
        check(launches["nn_search"] > 0, f"phase9 launcher {argv}: "
              f"nn_search never launched")
    out["launch_totals"] = totals
    out["kernel_checks"] = kernel_checks
    for name in ("nn_search", "candidate_sweep"):
        check(totals[name] > 0, f"phase9: the service path never launched "
              f"{name}")
        check(any(r["kernel"] == name for r in kernel_checks),
              f"phase9: no {name} call was held to its plain version")
    return out, dict(outputs=out_b, frames=frames_b, order=order, cap=cap,
                     odo=odo_b, round_ms=row_b["median_round_ms"])


# Slice 6: stream-sharded and point-sharded registration. Phase 9 (b)'s
# fleet (seqs 0-7, 8 frames, recovery off) through the sharded service: (a)
# one block of 8 lanes, (b) two blocks of 4 lanes on the one card; then the
# "distributed" engine and the point-sharded NN search on phase 3's pairs.
SHARD_BLOCKS = 2            # (b): blocks on cuda:0
SHARD_TOL = 1e-4            # (d): tests/multidevice_worker.py's band
WIDTH_TOL_M = 1e-3          # (b) vs (a), round 1: the port-vs-reference bar


def phase10(torch, np, scenes, fleet, dev=None):
    """The sharded registration paths at full size on one card (``dev``,
    default ``cuda:0``)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.engine import ShardedSlotEngine, get_engine
    from repro_torch.core.odometry import OdometryPipeline
    from repro_torch.data.collate import PAD_SENTINEL
    from repro_torch.kernels.nn_search import nn_search_kernel
    from repro_torch.kernels.ops import nn_search_cuda
    from repro_torch.serve import RegistrationService, ServiceConfig

    dev = torch.device("cuda", 0) if dev is None else dev
    t_phase = time.perf_counter()
    frames, order, odo = fleet["frames"], fleet["order"], fleet["odo"]
    n_rounds = len(frames[order[0]])
    out, kernel_checks = {}, []
    totals = dict(nn_search=0, candidate_sweep=0, fused_moment_sweep=0,
                  moment_sweep=0)

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    def record_blocks(regs, tag):
        """Log each block of every ``register_blocks`` call as one
        registration of ``regs`` (expected launches: each block's loop
        steps, its lanes' most iterations). Returns the restore."""
        orig = ShardedSlotEngine.register_blocks

        def register_blocks(self, *args, **kwargs):
            res = orig(self, *args, **kwargs)
            params = args[2] if len(args) > 2 else kwargs.get("params")
            for block in res:
                regs.append(dict(engine=self.name, levels=(),
                                 fused=params.fused, res=block, tag=tag(),
                                 ms=None))
            return res
        ShardedSlotEngine.register_blocks = register_blocks
        return lambda: setattr(ShardedSlotEngine, "register_blocks", orig)

    def sharded_run(name, devices, capture_round=None, profile_round=None):
        """The fleet through a fresh sharded service on ``devices`` (one
        block a list entry), counted; ``capture_round`` keeps the NN-kernel
        operands of that round for :func:`hold_captured`."""
        svc = RegistrationService(ServiceConfig(
            slots=FLEET_SLOTS, scan_capacity=fleet["cap"], odometry=odo,
            devices=len(devices)), device=devices)
        for sid in order:
            svc.admit(sid)
        regs, restore = record_registrations(torch, tag=lambda: svc.rounds)
        unblock = record_blocks(regs, tag=lambda: svc.rounds)
        captured, uncapture = capture_operands(
            torch, regs, lambda: svc.rounds - 1 == capture_round,
            ("nn_search",) if capture_round is not None else ())
        outputs = {sid: [] for sid in order}
        rounds, profile = [], {}

        def one_round(f):
            t = time.perf_counter()
            n0, r0 = nn_search_kernel.launches, len(regs)
            for sid in order:
                svc.submit(sid, *frames[sid][f])
            res = svc.step()
            svc.sync()
            for sid, r in res.items():
                outputs[sid].append(r)
            steps = [int(r["res"].iterations.max()) for r in regs[r0:]]
            rounds.append(dict(round=f, wall_ms=(time.perf_counter() - t)
                               * 1e3, nn_launches=nn_search_kernel.launches
                               - n0, block_steps=steps))

        def run():
            for f in range(n_rounds):
                if f == profile_round:
                    k, busy, host = device_profile(torch,
                                                   lambda: one_round(f))
                    wall = rounds[-1]["wall_ms"]
                    profile.update(round=f, device_kernels=k,
                                   device_busy_ms=busy, host_launches=host,
                                   wall_ms_profiled=wall,
                                   idle_share=(None if busy is None
                                               else 1.0 - busy / wall))
                else:
                    one_round(f)
        try:
            _, wall, launches = counted(torch, run)
        finally:
            restore()
            unblock()
            uncapture()
        expect = expected_launches(regs)
        check(launches == expect, f"phase10 {name}: launches {launches}, "
              f"expected {expect} (the blocks' loop steps)")
        for r in rounds:
            check(r["nn_launches"] == sum(r["block_steps"]),
                  f"phase10 {name} round {r['round']}: {r['nn_launches']} "
                  f"NN launches, blocks' loop steps {r['block_steps']}")
        add(launches)
        steady = [r for r in rounds if r["round"] >= FLEET_STEADY
                  and r["round"] != profile_round]
        row = dict(devices=[str(d) for d in devices], launches=launches,
                   wall_ms=wall, rounds=rounds,
                   median_round_ms=statistics.median(
                       r["wall_ms"] for r in steady),
                   fps=len(order) * len(steady)
                   / (sum(r["wall_ms"] for r in steady) / 1e3),
                   service_report=svc.service_report())
        check(row["service_report"]["devices"] == len(devices)
              and row["service_report"]["batch_shapes"] == 1,
              f"phase10 {name}: service report {row['service_report']}")
        if profile:
            row["profile_round"] = profile
        if captured:
            row["kernel_checks"] = hold_captured(
                torch, name, captured, regs,
                where=f"phase10 {{run}} round {capture_round}")
            kernel_checks.extend(row["kernel_checks"])
        log(f"phase10 {name}: {len(devices)} block(s) of "
            f"{FLEET_SLOTS // len(devices)} lanes on {row['devices']}, "
            f"launches {launches} | median round (>= {FLEET_STEADY}) "
            f"{row['median_round_ms']:.1f} ms, {row['fps']:.2f} frames/s | "
            f"per round: NN launches {[r['nn_launches'] for r in rounds]} "
            f"= the blocks' loop steps {[r['block_steps'] for r in rounds]}"
            f", wall ms {[round(r['wall_ms'], 1) for r in rounds]}")
        out[name] = row
        return svc, outputs, row

    # (a) one block of 8 lanes: phase 9 (b)'s program, its bits.
    _, out_a, row_a = sharded_run("a_one_block", [str(dev)])
    for sid in order:
        check(same_stream(np, out_a[sid], fleet["outputs"][sid]),
              f"phase10 a: {sid} differs from phase 9 (b)")
    log(f"phase10 a: every stream bit-identical to phase 9 (b) (the "
        f"single-device service at slots={FLEET_SLOTS}); round "
        f"{row_a['median_round_ms']:.1f} ms against phase 9 (b)'s "
        f"{fleet['round_ms']:.1f} ms in this call")

    # (b) two blocks of 4 lanes on one card.
    svc_b, out_b, row_b = sharded_run(
        "b_two_blocks", [str(dev)] * SHARD_BLOCKS,
        capture_round=FLEET_CAPTURE_ROUND, profile_round=FLEET_PROFILE_ROUND)
    lanes = FLEET_SLOTS // SHARD_BLOCKS
    replay_cfg = odo._replace(engine="sharded-slots", engine_kwargs=(
        ("lanes_per_device", lanes), ("devices", 1)))
    regs, restore = record_registrations(torch)

    def replays():
        res = {}
        for sid in order:
            pipe = OdometryPipeline(replay_cfg, device=dev)
            res[sid] = [pipe.process(*svc_b.stage_scan(*fr))
                        for fr in frames[sid]]
        return res
    try:
        rep, wall, launches = counted(torch, replays)
    finally:
        restore()
    check(launches == expected_launches(regs), f"phase10 b_replay: launches "
          f"{launches}, expected {expected_launches(regs)}")
    add(launches)
    row_b["replay"] = dict(launches=launches, wall_ms=wall)
    gaps = {}
    for sid in order:
        check(same_stream(np, out_b[sid], rep[sid]), f"phase10 b: {sid} "
              f"differs from its standalone replay (sharded-slots, "
              f"lanes_per_device={lanes}, devices=1)")
        gaps[sid] = [float(np.linalg.norm(p[:3, 3] - q[:3, 3]))
                     for (p, _), (q, _) in zip(out_b[sid], out_a[sid])]
        log(f"phase10 b vs a {sid}: |t_b - t_a| per frame "
            f"{np.round(gaps[sid], 4).tolist()} m; iterations b "
            f"{[d.iterations for _, d in out_b[sid]]} a "
            f"{[d.iterations for _, d in out_a[sid]]}")
    row_b["position_gap_to_a_m"] = gaps
    worst = max(max(g) for g in gaps.values())
    first = max(g[1] for g in gaps.values())
    row_b["max_position_gap_to_a_m"] = worst
    row_b["round1_position_gap_to_a_m"] = first
    for sid in order:
        verdicts = [(x.recovery_tier, x.health, x.quarantined, x.accepted)
                    for _, x in out_b[sid]]
        check(verdicts == [(x.recovery_tier, x.health, x.quarantined,
                            x.accepted) for _, x in out_a[sid]],
              f"phase10 b: {sid}'s verdicts differ from (a)'s")
    # Round 1 registers the same inputs in (a) and (b) (the bootstrap maps
    # are the same bits): one registration's float tolerance across block
    # widths. Later frames start from the stream's own earlier poses, and an
    # ICP that stops where its step falls under the epsilon can stop at
    # another iteration for a last-bit change: the gap is recorded, and the
    # same spread shows between lane widths of the single-device slot
    # engine (ROADMAP queue 3).
    check(first <= WIDTH_TOL_M, f"phase10 b: round 1 off (a) by {first} m "
          f"(band {WIDTH_TOL_M})")
    # The stream that drifts most, alone through the single-device slot
    # engine at (b)'s block width: no sharding, and (b)'s bits.
    far = max(order, key=lambda sid: max(gaps[sid]))
    pipe = OdometryPipeline(odo._replace(
        engine="slots", engine_kwargs=(("slots", lanes),)), device=dev)
    alone = [pipe.process(*svc_b.stage_scan(*fr)) for fr in frames[far]]
    check(same_stream(np, alone, out_b[far]), f"phase10 b: {far} through "
          f"the single-device slots engine at width {lanes} differs from (b)")
    row_b["drift_stream"] = far
    hold_to_reference("b_two_blocks seq0", np,
                      np.stack([p for p, _ in out_b["seq0"]]),
                      [d for _, d in out_b["seq0"]], row_b,
                      FLEET_REF_POSITIONS, FLEET_REF_VERDICTS,
                      phase="phase10")
    check(any(r["kernel"] == "nn_search"
              for r in row_b.get("kernel_checks", ())),
          "phase10 b: no NN-kernel call of the fleet was held to plain")
    p = row_b["profile_round"]
    log(f"phase10 b: every stream bit-identical to its standalone replay "
        f"on sharded-slots (lanes_per_device={lanes}, devices=1; {launches} "
        f"launches); (a)'s verdicts on every frame; round 1 within "
        f"{first:.2e} m of (a) (band {WIDTH_TOL_M}), every frame within "
        f"{worst:.4f} m ({far}; alone through the single-device slots engine "
        f"at width {lanes}: (b)'s bits, so the drift is the width's) | "
        f"profiled round {p['round']}: " + (
            "device not measured" if p["device_kernels"] is None else
            f"{p['device_kernels']} device kernels ({p['host_launches']} "
            f"host launch calls), {p['device_busy_ms']:.2f} ms busy, idle "
            f"{p['idle_share']:.1%} of its own {p['wall_ms_profiled']:.1f} "
            f"ms"))

    # (c) the "distributed" engine over 2 x 2 and 1 x 2 meshes of the card
    pairs = [(s, d) for s, d, _ in scenes["seq0"]]

    def mesh(shape):
        return dist.Mesh(np.array([str(dev)] * int(np.prod(shape)),
                                  dtype=object).reshape(shape),
                         ("data", "model"))
    single = get_engine("cuda", device=dev)
    grid = get_engine("distributed", device=dev, mesh=mesh((2, 2)))
    row = get_engine("distributed", device=dev, mesh=mesh((1, 2)))
    for eng in (single, grid, row):
        eng.register_pairs(pairs)  # warm-up
    (res_1, _), wall_1, launches_1 = counted(
        torch, lambda: single.register_pairs(pairs))
    (res_g, batch), wall_g, launches_g = counted(
        torch, lambda: grid.register_pairs(pairs))
    (res_r, _), wall_r, launches_r = counted(
        torch, lambda: row.register_pairs(pairs))
    halves = [single.register_pairs(pairs[:4])[0],
              single.register_pairs(pairs[4:])[0]]
    for launches in (launches_1, launches_g, launches_r):
        add(launches)
    check((launches_1["nn_search"], launches_g["nn_search"],
           launches_r["nn_search"]) == (50, 200, 100),
          f"phase10 c: NN launches {launches_1['nn_search']}, "
          f"{launches_g['nn_search']}, {launches_r['nn_search']}; expected "
          f"50 iterations x 1, x 2 frame blocks x 2 shards, x 2 shards")

    def bits(a, b):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))
    T_half = torch.cat([h.T for h in halves])
    halves_res = [torch.cat(x) for x in zip(*halves)]
    # Equal batch width, the same bits: the sharded search is one search's.
    check(bits(res_r, res_1), "phase10 c: the 1 x 2 mesh (one block of 8 "
          "frames, 2 target shards) differs from the cuda engine's bits")
    check(bits(res_g, halves_res), "phase10 c: the 2 x 2 mesh differs from "
          "the cuda engine's bits on each block's 4 frames")
    errs = [rt_err(a, b) for a, b in zip(res_g.T.cpu().numpy(),
                                         res_1.T.cpu().numpy())]
    rot, trans = max(e[0] for e in errs), max(e[1] for e in errs)
    own = [rt_err(a, b) for a, b in zip(T_half.cpu().numpy(),
                                        res_1.T.cpu().numpy())]
    out["c_distributed"] = dict(
        buckets=[batch.src.shape[1], batch.dst.shape[1]],
        wall_ms_2x2=wall_g, wall_ms_1x2=wall_r, cuda_wall_ms=wall_1,
        launches_2x2=launches_g, launches_1x2=launches_r,
        max_rot_rad_vs_b8=rot, max_trans_m_vs_b8=trans,
        cuda_b4_vs_b8=[max(e[0] for e in own), max(e[1] for e in own)],
        iterations_2x2=res_g.iterations.tolist(),
        iterations_b8=res_1.iterations.tolist())
    log(f"phase10 c: 'distributed' on phase 3's 8 seq-0 pairs "
        f"(N={batch.src.shape[1]}, M={batch.dst.shape[1]}): the 1 x 2 mesh "
        f"(8 frames, 2 target shards) the 'cuda' engine's bits, the 2 x 2 "
        f"mesh (2 blocks of 4 frames) the bits of the 'cuda' engine on each "
        f"block's frames; the 2 x 2 mesh {rot:.2e} rad / {trans:.2e} m from "
        f"the 'cuda' engine's B=8 run (iterations "
        f"{res_g.iterations.tolist()} against {res_1.iterations.tolist()}),"
        f" as the 'cuda' engine's own B=4 halves are ({max(e[1] for e in own):.2e} m) "
        f"| wall {wall_g:.1f} ms (2 x 2, {launches_g['nn_search']} NN "
        f"launches), {wall_r:.1f} ms (1 x 2, {launches_r['nn_search']}), "
        f"{wall_1:.1f} ms ('cuda', {launches_1['nn_search']})")

    # (d) the point-sharded NN search against one kernel call
    src, dst, _ = scenes["seq0"][0]
    src = torch.as_tensor(src, device=dev)
    target = torch.full((32768, 3), PAD_SENTINEL, device=dev)
    target[:len(dst)] = torch.as_tensor(dst, device=dev)
    mesh4 = dist.Mesh(np.array([str(dev)] * 4, dtype=object), ("model",))
    (d2, idx), _, launches_s = counted(
        torch, lambda: dist.distributed_nn_search(mesh4, src, target))
    add(launches_s)
    d2_1, idx_1 = nn_search_cuda(src, target)
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(d2, d2_1) and torch.equal(idx, idx_1))
    max_d2 = float((d2 - d2_1).abs().max())
    mism = int((idx != idx_1).sum())
    check(launches_s["nn_search"] == 4, f"phase10 d: "
          f"{launches_s['nn_search']} NN launches, expected 4")
    check(max_d2 <= SHARD_TOL, f"phase10 d: d2 off one kernel call by "
          f"{max_d2}")
    if not bit_equal:
        log(f"phase10 d: MISMATCH against one kernel call: {mism} indices, "
            f"max |d2| {max_d2} (within {SHARD_TOL})")
    ms_s = time_ms(torch, lambda: dist.distributed_nn_search(mesh4, src,
                                                             target))
    ms_1 = time_ms(torch, lambda: nn_search_cuda(src, target))
    shape = [src.shape[0], target.shape[0]]
    out["d_nn_search"] = dict(shards=4, shape=shape,
                              bit_equal=bit_equal, idx_mismatch=mism,
                              max_abs_d2=max_d2, ms=ms_s, single_ms=ms_1)
    log(f"phase10 d: distributed_nn_search, {shape[0]} x {shape[1]} over 4 "
        f"target shards of {dev}: bit-equal to one NN-kernel call {bit_equal} "
        f"({mism} index mismatches, max |d2| {max_d2}) | {ms_s:.3f} ms "
        f"against {ms_1:.3f} ms for the one call (host and device, CUDA "
        f"events)")
    out["launch_totals"] = totals
    out["kernel_checks"] = kernel_checks
    check(totals["nn_search"] > 0, "phase10: the sharded paths never "
          "launched nn_search")
    log(f"phase10: {time.perf_counter() - t_phase:.1f} s")
    return out


EXAMPLE_RUNS = (
    ("quickstart", "quickstart", [], 1),
    ("odometry_scan_to_map", "odometry", ["--frames", "30"], 30),
    ("odometry_frame_to_frame", "odometry",
     ["--frames", "30", "--mode", "frame_to_frame"], 30),
    ("fleet_cuda", "fleet_registration", ["--engine", "cuda"], 4),
    ("fleet_distributed", "fleet_registration", ["--engine", "distributed"],
     4),
    ("fleet_pyramid", "fleet_registration", ["--engine", "pyramid"], 4))


def ptxas_resources(log_text):
    """``{(warps, plane, prune): (registers, stack frame bytes)}`` of each
    fused-kernel instantiation in ptxas's ``-v`` report."""
    import re
    out, key = {}, None
    for line in log_text.splitlines():
        m = re.search(r"fused_kernelILi(\d+)ELb([01])ELb([01])E", line)
        if m and "Compiling entry function" in line:
            key = (int(m.group(1)), m.group(2) == "1", m.group(3) == "1")
            out[key] = [None, None]
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[key][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key][0] = int(m.group(1))
            key = None
    return {k: tuple(v) for k, v in out.items()}


def phase11(torch, np, scenes, fused_log):
    """The drivers: the examples at their defaults, the autotune sweep of
    the fused kernel's launch settings, and ``make_frame_engine``."""
    import contextlib
    import importlib
    import io

    from repro_torch.data.collate import PAD_SENTINEL
    from repro_torch.kernels.fused_icp import DEFAULT_CONFIG
    from repro_torch.kernels.ops import make_frame_engine, nn_search_cuda
    from repro_torch.tools import autotune_fused

    t_phase = time.perf_counter()
    out = dict(examples={})
    totals = dict(nn_search=0, candidate_sweep=0, fused_moment_sweep=0,
                  moment_sweep=0)

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    # (a) the examples, each through its main at its own defaults
    for name, module, argv, frames in EXAMPLE_RUNS:
        example = importlib.import_module(f"repro_torch.examples.{module}")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            result, wall, launches = counted(torch, lambda: example.main(argv))
        add(launches)
        lines = text.getvalue().strip().splitlines()
        check(lines and lines[-1] == "OK", f"phase11 a {name}: the example "
              f"did not print OK (last line {lines[-1:] or None})")
        summary = [ln for ln in lines if ln.strip()][-2]
        row = dict(argv=argv, frames=frames, wall_ms=wall,
                   per_frame_ms=wall / frames, launches=launches,
                   summary=summary)
        if module == "odometry":
            row["final_drift_m"] = float(result[-1])
        elif module == "fleet_registration":
            row["max_err"] = max(result)
        out["examples"][name] = row
        log(f"phase11 a {name} ({' '.join(argv) or 'defaults'}): OK | "
            f"{wall:.1f} ms, {wall / frames:.2f} ms per frame (host clock, "
            f"first-call setup included) | launches nn "
            f"{launches['nn_search']} / sweep {launches['candidate_sweep']} "
            f"/ fused {launches['fused_moment_sweep']} | {summary.strip()}")
    check(out["examples"]["quickstart"]["launches"]["nn_search"] > 0,
          "phase11 a: quickstart never launched nn_search")
    check(out["examples"]["odometry_scan_to_map"]["launches"][
        "candidate_sweep"] > 0, "phase11 a: odometry never launched the "
          "grid sweep")

    # (b) the autotune sweep at the tool's default shape
    report, wall, launches = counted(
        torch, lambda: autotune_fused.sweep(device=torch.device("cuda", 0)))
    add(launches)
    ptxas = ptxas_resources(fused_log)
    check(len(ptxas) == 16, f"phase11 b: ptxas reported {len(ptxas)} fused "
          f"instantiations, expected 16")
    for r in report["configs"]:
        key = (r["warps_per_block"], False, r["prune"])
        tag = f"warps={key[0]} prune={int(key[2])}"
        check(r["planes_bit_equal"], f"phase11 b {tag}: planes differ from "
              f"the plain version's bits")
        check(r["T_bit_equal"], f"phase11 b {tag}: T differs from the "
              f"default setting's bits")
        check(r["parity_ok"], f"phase11 b {tag}: failed the parity gate")
        card = r["resources"]["card"]
        check((card["registers"], card["local_bytes"]) == ptxas[key],
              f"phase11 b {tag}: registers/local bytes {card['registers']}/"
              f"{card['local_bytes']} disagree with ptxas {ptxas[key]}")
        log(f"phase11 b {tag}: pass {r['pass_ms']:.4f} ms "
            f"[{r['pass_ms_min']:.4f}-{r['pass_ms_max']:.4f}]"
            f"{'' if r['pass_device_only'] else ' host'}, iteration "
            f"{r['iter_ms']:.4f} ms [{r['iter_ms_min']:.4f}-"
            f"{r['iter_ms_max']:.4f}]"
            f"{'' if r['iter_device_only'] else ' host'} | registers "
            f"{card['registers']} (ptxas {ptxas[key][0]}), local bytes "
            f"{card['local_bytes']}, {card['blocks_per_sm']} blocks/SM, "
            f"occupancy {card['occupancy']:.0%} | planes and T bit-equal")
    best, noise = report["best"], report["best_within_noise_of_default"]
    out["autotune"] = report
    out["autotune_wall_ms"] = wall
    out["autotune_launches"] = launches
    log(f"phase11 b autotune ({report['n']} x {report['m']}, CK="
        f"{report['ck']}; {report['card']}): winner warps="
        f"{best['warps_per_block']} prune={best['prune']} (iteration "
        f"{best['iter_ms']:.4f} ms, pass {best['pass_ms']:.4f} ms"
        f"{'; within noise of the default' if noise else ''}); "
        f"default {tuple(DEFAULT_CONFIG)} is best: {report['default_is_best']}"
        f" | {launches['fused_moment_sweep']} fused launches, {wall / 1e3:.1f}"
        f" s")

    # (c) make_frame_engine with a T against nn_search_cuda
    dev = torch.device("cuda", 0)
    src, dst, T_gt = scenes["seq0"][0]
    src = torch.as_tensor(src, device=dev)
    target = torch.full((32768, 3), PAD_SENTINEL, device=dev)
    target[:len(dst)] = torch.as_tensor(dst, device=dev)
    T = torch.as_tensor(T_gt, dtype=torch.float32, device=dev)
    nn_fn = make_frame_engine(target)
    (d2, idx), _, launches = counted(torch, lambda: nn_fn(src, T))
    add(launches)
    check(launches["nn_search"] == 1, f"phase11 c: {launches['nn_search']} "
          f"NN launches, expected 1")
    d2_1, idx_1 = nn_search_cuda(src, target, T)
    torch.cuda.synchronize()
    bit_equal = bool(torch.equal(d2, d2_1) and torch.equal(idx, idx_1))
    check(bit_equal, "phase11 c: make_frame_engine differs from "
          "nn_search_cuda's bits")
    out["c_frame_engine"] = dict(shape=[src.shape[0], target.shape[0]],
                                 bit_equal=bit_equal)
    log(f"phase11 c: make_frame_engine(target)(src, T), {src.shape[0]} x "
        f"{target.shape[0]}: the bits of nn_search_cuda")
    out["launch_totals"] = totals
    log(f"phase11: {time.perf_counter() - t_phase:.1f} s")
    return out


# Slice 8: the LM serving path at qwen2-0.5b's full width (24 layers,
# d_model 896, 14 query and 2 KV heads of 64, d_ff 4864, vocab 151,936,
# QKV bias, tied embeddings, rope theta 1e6, q_block 512), random weights
# from lm.init_params_numpy(cfg, 0), and the VQ frontends through the NN
# kernel. (b) holds the teacher-forced logits of 2 x 64 tokens from
# np.random.default_rng(P12_SEED) to a JAX CPU run of the reference on the
# same numpy weights (about 25 s and 5 GB on an 8-core CPU host):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import jax, numpy as np
#   import jax.numpy as jnp; from repro.configs import get_config
#   from repro.models import lm; from repro_torch.models.lm import (
#   init_params_numpy); cfg = get_config('qwen2-0.5b')
#   p = jax.tree_util.tree_map(jnp.asarray, init_params_numpy(cfg, 0))
#   t = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 64),
#       dtype=np.int32)
#   x = np.asarray(jax.jit(lm.forward, static_argnums=1)(p, cfg,
#       jnp.asarray(t))[0]); s = np.sort(x, -1)
#   print(x.argmax(-1).ravel().tolist(), (s[..., -1] - s[..., -2]).ravel()
#         .tolist(), [float(x[c]) for c in p12_coords(x.argmax(-1))])"
# with p12_coords below. The logits are fp32 casts of a bf16 product, so
# top-2 ties are common (4 of the 128 positions here, 40 under 5e-2): the
# argmax is held only where the reference's gap exceeds the tolerance.
P12_ARCH = "qwen2-0.5b"
P12_SEED = 12
P12_B, P12_S = 2, 64
P12_FIXED_S = (0, 21, 42, 63)
P12_FIXED_V = (0, 1, 4096, 65536, 151935)
P12_TOL = 5e-2      # max |logit - reference| at the pasted coordinates
# max |decode-step logit - teacher-forced forward logit| in (c), 0.057-0.063
# on an H100 80GB HBM3 at 700 W; a fixed bar, so a wrong decode cannot widen
# the near-tie allowance it is checked with
P12_DECODE_TOL = 0.1
P12_VQ = (65536, 8192)     # 3-D latents x codebook entries
P12_RVQ = (4, 1024, 128, 4, 2048)  # batch, frames, D, books, entries
RVQ_NEAR_TIE = 1e-3
P12_REF_ARGMAX = (
    109405, 19066, 4080, 4080, 74787, 74787, 9463, 11462, 33357, 63450, 74787,
    21722, 67348, 63450, 100387, 12963, 11462, 102321, 18326, 18326, 18326,
    24876, 6183, 18326, 11462, 51311, 6183, 18326, 13737, 36331, 61019, 124715,
    36331, 64611, 136301, 27072, 36331, 61019, 36331, 96367, 61019, 136751,
    96367, 36331, 31312, 51311, 61019, 136751, 36331, 51311, 19262, 51311,
    7977, 49552, 150801, 31810, 68837, 61888, 12875, 138894, 51311, 12875,
    136751, 107243, 58074, 117884, 66617, 39265, 5767, 5767, 103537, 113098,
    103537, 103537, 151911, 24979, 55308, 63368, 110636, 151372, 103765, 72269,
    5906, 147898, 41710, 112488, 151372, 103765, 88571, 82993, 7202, 38228,
    52590, 41710, 41710, 48701, 48701, 31356, 89676, 31356, 9930, 7202, 143791,
    103765, 150530, 150530, 62487, 62487, 31356, 133818, 23189, 31356, 67490,
    31356, 92405, 89136, 136009, 92405, 80624, 97181, 38194, 2072, 6389, 70480,
    28633, 47382, 63368, 92405)
P12_REF_GAP = (
    0.03125, 0.09375, 0.078125, 0.015625, 0.015625, 0.03125, 0.125, 0.03125,
    0.03125, 0.171875, 0.34375, 0.0625, 0.046875, 0.09375, 0.078125, 0.15625,
    0.21875, 0.03125, 0.046875, 0.25, 0.359375, 0.046875, 0.140625, 0.21875,
    0.078125, 0.140625, 0.015625, 0.140625, 0.03125, 0.125, 0.015625, 0.140625,
    0.203125, 0.078125, 0.03125, 0.125, 0.046875, 0.0625, 0.109375, 0.15625,
    0.15625, 0.15625, 0.09375, 0.125, 0.03125, 0.078125, 0.140625, 0.03125,
    0.109375, 0.25, 0.296875, 0.109375, 0.03125, 0.171875, 0.0625, 0.0625,
    0.0625, 0.15625, 0.09375, 0.015625, 0.046875, 0.109375, 0.3125, 0.046875,
    0.0625, 0.015625, 0.296875, 0.0625, 0.046875, 0.09375, 0.140625, 0.0625,
    0.015625, 0.15625, 0.078125, 0.09375, 0.09375, 0.0625, 0, 0.125, 0.109375,
    0, 0.4375, 0.109375, 0.125, 0.109375, 0.03125, 0.171875, 0.03125, 0.03125,
    0.34375, 0.0625, 0.09375, 0.34375, 0.25, 0.25, 0.09375, 0.078125, 0.15625,
    0.09375, 0.125, 0, 0.03125, 0.03125, 0.265625, 0.015625, 0.59375, 0.0625,
    0.171875, 0.1875, 0.09375, 0.09375, 0.109375, 0.078125, 0.171875, 0.046875,
    0.109375, 0.140625, 0.21875, 0.015625, 0.25, 0, 0.015625, 0.03125, 0.09375,
    0.015625, 0.046875, 0.25)
P12_REF_LOGITS = (
    2.515625, 2.765625, 2.578125, 2.5625, 2.515625, 2.546875, 2.734375,
    2.453125, 2.46875, 2.671875, 2.84375, 2.765625, 2.53125, 2.703125, 2.5,
    2.5625, 2.796875, 2.734375, 2.609375, 2.78125, 3.109375, 2.6875, 2.71875,
    2.578125, 2.59375, 2.703125, 2.578125, 2.59375, 2.53125, 2.703125,
    2.703125, 2.6875, 2.75, 2.671875, 2.546875, 2.59375, 2.578125, 2.5625,
    2.6875, 2.71875, 2.640625, 2.578125, 2.609375, 2.703125, 2.4375, 2.671875,
    2.78125, 2.625, 2.59375, 2.734375, 2.734375, 2.65625, 2.703125, 2.65625,
    2.4375, 2.625, 2.421875, 2.640625, 2.75, 2.515625, 2.546875, 2.671875,
    2.828125, 2.53125, 2.609375, 2.515625, 3.125, 2.578125, 2.46875, 2.578125,
    2.609375, 2.53125, 2.796875, 2.734375, 2.640625, 2.578125, 2.59375,
    2.546875, 2.640625, 2.609375, 2.515625, 2.625, 2.921875, 2.546875,
    2.578125, 2.59375, 2.421875, 2.75, 2.5, 2.40625, 2.78125, 2.484375, 2.5,
    2.8125, 2.828125, 2.703125, 2.546875, 2.609375, 2.671875, 2.484375,
    2.515625, 2.5625, 2.46875, 2.453125, 2.78125, 2.46875, 3.09375, 2.4375,
    2.84375, 2.609375, 2.65625, 2.453125, 2.625, 2.578125, 2.578125, 2.453125,
    2.625, 2.625, 2.671875, 2.375, 2.765625, 2.625, 2.515625, 2.53125,
    2.703125, 2.375, 2.53125, 2.75, -0.6015625, -0.59375, -0.353515625,
    -0.19921875, 0.5625, -0.5234375, 0.423828125, -0.291015625, -0.271484375,
    0.4140625, -0.30078125, -0.138671875, 0.57421875, -0.474609375, 1,
    -0.80078125, -0.07421875, -0.0164794922, -0.4296875, 0.115234375,
    0.8984375, -0.241210938, 0.9453125, 0.00531005859, -0.71484375,
    -0.0524902344, 0.2109375, 0.213867188, 0.82421875, -0.279296875, -1.125,
    1.1171875, -0.39453125, 0.330078125, 0.2421875, -0.63671875, 1.046875,
    0.0471191406, 0.396484375, 0.158203125)


def p12_coords(argmax, fixed_v=P12_FIXED_V):
    """The (b, s, v) coordinates whose reference logits are pasted: the
    reference's argmax at every position, then ``fixed_v`` at the
    positions ``P12_FIXED_S``."""
    b, s = argmax.shape
    return ([(i, j, int(argmax[i, j])) for i in range(b) for j in range(s)]
            + [(i, j, v) for i in range(b) for j in P12_FIXED_S
               for v in fixed_v])


P12_REF = dict(tag="phase12 b", tol=P12_TOL, argmax=P12_REF_ARGMAX,
               gap=P12_REF_GAP, logits=P12_REF_LOGITS, fixed_v=P12_FIXED_V)


def hold_logits(np, name, logits, ref=P12_REF):
    """(b): ``logits`` (B, S, V) against a pasted reference (``ref``: its
    argmax, top-2 gaps and logits at ``p12_coords``, the tolerance and the
    log tag): max |diff| at the pasted coordinates within the tolerance,
    the argmax equal wherever the reference's top-2 gap exceeds it."""
    x = logits.float().cpu().numpy()
    tag, tol = ref["tag"], ref["tol"]
    ref_argmax = np.array(ref["argmax"]).reshape(P12_B, P12_S)
    ref_gap = np.array(ref["gap"]).reshape(P12_B, P12_S)
    idx = tuple(np.array(p12_coords(ref_argmax, ref["fixed_v"])).T)
    err = float(np.abs(x[idx] - np.array(ref["logits"])).max())
    decided = ref_gap > tol
    flips = x.argmax(-1) != ref_argmax
    bad = int((flips & decided).sum())
    check(err <= tol, f"{tag} {name}: max |logit - reference| {err} > {tol}")
    check(bad == 0, f"{tag} {name}: argmax differs from the reference at "
          f"{bad} positions whose reference top-2 gap exceeds {tol}")
    log(f"{tag} {name}: max |logit - JAX reference| {err:.6f} over "
        f"{len(ref['logits'])} coordinates (tolerance {tol}); argmax "
        f"equal at all {int(decided.sum())} positions whose reference gap "
        f"exceeds it ({int(flips.sum())} of {flips.size} flips, all on "
        f"near-ties)")
    return dict(max_abs_logit_err=err, argmax_flips=int(flips.sum()),
                decided=int(decided.sum()))


def serve_logits(torch, lm, engine, prompts, gen):
    """``engine.generate(prompts, gen)`` with the logits of its prefill and
    of each decode step kept (the module functions the engine calls are
    wrapped for the call): -> (tokens (B, gen), logits (B, gen, V))."""
    kept = []
    originals = lm.prefill, lm.decode_step

    def keep(fn):
        def wrapped(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            kept.append(logits.float())
            return logits, cache
        return wrapped

    lm.prefill, lm.decode_step = (keep(f) for f in originals)
    try:
        tokens = engine.generate(prompts, gen)
    finally:
        lm.prefill, lm.decode_step = originals
    return tokens, torch.stack(kept, dim=1)


def teacher_forced(torch, lm, model, cfg, name, prompts, tokens, steps,
                   tol=P12_DECODE_TOL, tag="phase12 c", logits=None,
                   held=None):
    """The reference's contract: generated tokens are the argmax of
    ``forward`` over prompt + generated tokens, except where that forward's
    top-2 gap is under the decode-vs-forward logit difference, which must
    be within ``tol``. ``logits``: that forward's, if already computed;
    ``held``: a (B, gen) mask of the tokens held (default all; phase 14
    leaves out MoE tokens that were dropped or routed otherwise)."""
    s = prompts.shape[1]
    if logits is None:
        logits, _ = lm.forward(model, cfg,
                               tokens=torch.cat([prompts, tokens], dim=1))
    tf = logits[:, s - 1:-1]
    if held is None:
        held = torch.ones(tokens.shape, dtype=torch.bool,
                          device=tokens.device)
    gaps = (steps - tf).abs().amax(-1)
    diff = float(gaps[held].max()) if bool(held.any()) else 0.0
    top2 = tf.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    check(diff <= tol, f"{tag} {name}: max |decode - forward logit| {diff} "
          f"> {tol}")
    mism = tf.argmax(-1) != tokens
    unexplained = int((mism & held & (gap >= diff)).sum())
    where = [(int(b), int(i), float(gap[b, i]))
             for b, i in mism.nonzero().tolist()]
    check(unexplained == 0, f"{tag} {name}: {unexplained} generated "
          f"tokens differ from the teacher-forced argmax where its top-2 gap "
          f"is >= the decode-vs-forward difference {diff}")
    log(f"{tag} {name}: tokens = teacher-forced argmax except at "
        f"{len(where)} positions (b, step, gap) {where}, each gap under the "
        f"decode-vs-forward logit difference {diff:.6f} (bar {tol})")
    return dict(decode_vs_forward=diff, mismatches=where)


def decode_timing(torch, lm, model, cfg, prompts, steps):
    """(prefill ms, decode ms a step, host issue ms a step, the cache) of
    ``steps`` decode steps after a prefill: CUDA events around the loop,
    and the host clock from its start to the last step's return (before
    the sync), the time the host takes to queue a step."""
    b, s = prompts.shape
    max_len = s + steps + 1
    prefill_ms = time_ms(torch, lambda: lm.prefill(
        model, cfg, tokens=prompts, max_len=max_len), warmup=1, reps=5)
    logits, cache = lm.prefill(model, cfg, tokens=prompts, max_len=max_len)
    tok = logits.argmax(-1)
    lm.decode_step(model, cfg, s, [dict(c) if isinstance(c, dict) else c
                                   for c in cache], token=tok)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = lm.decode_step(model, cfg, s + i, cache, token=tok)
        tok = logits.argmax(-1)
    issue_ms = (time.perf_counter() - t0) * 1e3 / steps
    end.record()
    end.synchronize()
    return prefill_ms, start.elapsed_time(end) / steps, issue_ms, cache


def phase12(torch, np):
    """The LM serving path at full width and the VQ frontends (slice 8)."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.nn_search import nn_search_kernel
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import lm
    from repro_torch.serve import modality
    from repro_torch.serve.engine import Engine

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = get_config(P12_ARCH)
    out = dict(arch=P12_ARCH)
    totals = dict(nn_search=0, candidate_sweep=0, fused_moment_sweep=0,
                  moment_sweep=0)

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    # (a) weights
    t0 = time.perf_counter()
    tree = lm.init_params_numpy(cfg, 0)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    model = lm.params_from_reference(tree, cfg, dev)
    n_params, w_bytes = lm.param_count(model), lm.param_bytes(model)
    check(round(n_params / 1e6, 2) == 494.03, f"phase12 a: {n_params} "
          f"parameters, expected 494.03 M")
    out["a"] = dict(params=n_params, weight_bytes=w_bytes, init_s=init_s,
                    load_peak_bytes=torch.cuda.max_memory_allocated(dev))
    log(f"phase12 a: {P12_ARCH} at full width, {n_params / 1e6:.2f} M "
        f"parameters, {w_bytes / 1e9:.4f} GB of weights on the card (bf16 "
        f"kernels, biases and table, fp32 norm scales); numpy init "
        f"{init_s:.1f} s; max_memory_allocated "
        f"{out['a']['load_peak_bytes'] / 1e9:.4f} GB")

    # (b) teacher-forced logits against the JAX reference, card and CPU
    tokens = np.random.default_rng(P12_SEED).integers(
        0, cfg.vocab_size, (P12_B, P12_S), dtype=np.int32)
    tok = torch.from_numpy(tokens)
    logits_card, _ = lm.forward(model, cfg, tokens=tok.to(dev))
    out["b_cuda"] = hold_logits(np, "cuda", logits_card)
    cpu_model = lm.params_from_reference(tree, cfg, "cpu")
    del tree
    t0 = time.perf_counter()
    logits_cpu, _ = lm.forward(cpu_model, cfg, tokens=tok)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    del cpu_model
    out["b_cpu"] = hold_logits(np, "cpu", logits_cpu)
    card_vs_cpu = float((logits_card.cpu() - logits_cpu).abs().max())
    out["b_cpu"].update(forward_ms=cpu_ms, card_vs_cpu=card_vs_cpu)
    log(f"phase12 b: card vs the port's CPU path, max |logit diff| over all "
        f"{logits_cpu.numel()} logits {card_vs_cpu:.6f}; the CPU forward "
        f"took {cpu_ms:.0f} ms (host clock)")
    del logits_card, logits_cpu

    # (c) serving: the launcher's defaults, then 2 x 1024-token prompts
    runs = (("b4_p32_g32", serve_launch.prompt_tokens(1, 4, 32,
                                                      cfg.vocab_size), 32),
            ("b2_p1024_g16", np.random.default_rng(P12_SEED + 1).integers(
                0, cfg.vocab_size, (2, 1024), dtype=np.int32), 16))
    out["c"], served = {}, {}
    for name, prompts, gen in runs:
        prompts = torch.from_numpy(prompts).to(dev)
        b, s = prompts.shape
        engine = Engine(cfg, model, max_len=s + gen, device=dev)
        (toks, steps), wall, launches = counted(
            torch, lambda: serve_logits(torch, lm, engine, prompts, gen))
        add(launches)
        check(sum(launches.values()) == 0, f"phase12 c {name}: the LM path "
              f"launched port kernels {launches}")
        again = Engine(cfg, model, max_len=s + gen, device=dev).generate(
            prompts, gen)
        check(bool(torch.equal(toks, again)), f"phase12 c {name}: two "
              f"engines gave different tokens")
        served[name] = toks
        row = teacher_forced(torch, lm, model, cfg, name, prompts, toks,
                             steps)
        prefill_ms, step_ms, issue_ms, cache = decode_timing(
            torch, lm, model, cfg, prompts, gen - 1)
        row.update(batch=b, prompt=s, gen=gen, wall_ms=wall,
                   tokens_per_s=b * gen / wall * 1e3, prefill_ms=prefill_ms,
                   decode_ms_per_token=step_ms, decode_issue_ms=issue_ms,
                   decode_tokens_per_s=b / step_ms * 1e3,
                   q_block=s > cfg.q_block and s % cfg.q_block == 0)
        # one decode step: profiler kernels and busy ms, and its byte bound
        pos = s + gen - 1
        nxt = toks[:, -1]
        kernels, busy, host_launches = device_profile(
            torch, lambda: lm.decode_step(model, cfg, pos, cache, token=nxt))
        kv_bytes = sum(c[k].numel() * c[k].element_size() for c in cache
                       for k in ("k", "v"))
        step_bytes = w_bytes + kv_bytes + b * cfg.vocab_size * 4
        bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
        idle = None if busy is None else 1 - busy / step_ms
        row.update(step_kernels=kernels, step_busy_ms=busy,
                   step_host_launches=host_launches, step_idle=idle,
                   step_bytes=step_bytes, step_bound_ms=bound_ms)
        out["c"][name] = row
        blocks = (f" ({s // cfg.q_block} q_blocks of {cfg.q_block})"
                  if row["q_block"] else "")
        profiled = ("no device activity recorded" if busy is None else
                    f"{busy:.4f} ms busy, idle {idle:.1%}")
        log(f"phase12 c {name}: B={b} prompt {s}{blocks} gen {gen} | "
            f"generate {wall:.1f} ms wall, {row['tokens_per_s']:.1f} tok/s | "
            f"prefill {prefill_ms:.3f} ms | decode {step_ms:.3f} ms a step "
            f"({row['decode_tokens_per_s']:.1f} tok/s; the host queues a "
            f"step in {issue_ms:.3f} ms) | one step: "
            f"{kernels} device kernels ({host_launches} host launches), "
            f"{profiled} | byte bound {bound_ms:.4f} ms "
            f"({step_bytes / 1e9:.4f} GB: weights {w_bytes / 1e9:.4f} GB, KV "
            f"{kv_bytes / 1e6:.2f} MB), {bound_ms / step_ms:.1%} of the "
            f"step")
        del cache, steps
    out["c_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"phase12 c: max_memory_allocated over (a)-(c) "
        f"{out['c_peak_bytes'] / 1e9:.4f} GB")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        launched, wall, launches = counted(torch, lambda: serve_launch.main(
            ["--device", "cuda:0"]))
    add(launches)
    lines = [ln for ln in text.getvalue().splitlines() if "tok/s" in ln]
    check(len(lines) == 1, f"phase12 c launcher: no tok/s line in "
          f"{text.getvalue()!r}")
    check(bool(torch.equal(launched, served["b4_p32_g32"])), "phase12 c "
          "launcher: its tokens differ from the engine's on the same weights "
          "and prompts")
    out["c"]["launcher"] = dict(line=lines[0], wall_ms=wall)
    log(f"phase12 c launcher (repro_torch.launch.serve at its defaults): "
        f"{lines[0].strip()} | {wall:.0f} ms with its weight init")

    # (d) VQ through the NN kernel: 3-D latents, then RVQ at D=128
    n, k = P12_VQ
    book, lat = modality.stub_normals(P12_SEED, (k, 3), (n, 3), device=dev)
    captured = []
    orig = ops.nn_search_kernel

    def kernel_site(src_aug, dst_aug):
        res = orig(src_aug, dst_aug)
        captured.append((src_aug.clone(), dst_aug.clone(),
                         [r.clone() for r in res]))
        return res

    ops.nn_search_kernel = kernel_site
    try:
        (codes, quant), wall, launches = counted(
            torch, lambda: modality.vq_encode(lat, book, use_kernel=True))
    finally:
        ops.nn_search_kernel = orig
    add(launches)
    check(launches["nn_search"] == 1 and len(captured) == 1,
          f"phase12 d: vq_encode launched nn_search {launches['nn_search']} "
          f"times, expected 1")
    src_aug, dst_aug, (d2_k, idx_k) = captured[0]
    d2_p, idx_p = ref.blocked_argmin(src_aug, dst_aug)
    mism = int((idx_k != idx_p).sum())
    max_d2 = float((d2_k - d2_p).abs().max())
    check(mism == 0 and max_d2 == 0.0, f"phase12 d: the NN kernel's indices "
          f"and d2 differ from the plain version's ({mism} indices, max "
          f"|d2| {max_d2})")
    check(bool(torch.equal(codes, idx_p[:n])), "phase12 d: vq_encode's "
          "codes are not the plain version's indices")
    check(bool(torch.equal(quant, book[idx_p[:n].long()])), "phase12 d: "
          "vq_encode's quantised latents are not the codebook rows")
    codes_cpu, _ = modality.vq_encode(lat.cpu(), book.cpu(), use_kernel=True)
    cpu_mism = int((codes_cpu != codes.cpu()).sum())
    np_, mp_ = src_aug.shape[-1], dst_aug.shape[-1]
    kern = device_ms(torch, lambda: nn_search_kernel(src_aug, dst_aug))
    plain = device_ms(torch, lambda: ref.blocked_argmin(src_aug, dst_aug))
    lib = device_ms(torch, lambda: torch.matmul(src_aug.mT,
                                                dst_aug).min(dim=-1))
    bound_ms, bound_by = bound(1, np_, mp_)
    out["d_vq"] = dict(shape=[n, k], padded=[np_, mp_], launches=launches,
                       idx_mismatch=mism, max_abs_d2=max_d2,
                       cpu_code_mismatch=cpu_mism, wall_ms=wall,
                       kernel_ms=kern[0], kernel_ms_spread=kern[1:3],
                       plain_ms=plain[0], library_ms=lib[0],
                       bound_ms=bound_ms, bound_by=bound_by)
    log(f"phase12 d vq_encode: {n} 3-D latents x {k} codes (padded {np_} x "
        f"{mp_}) | {launches['nn_search']} NN launch, indices and d2 the "
        f"plain version's bits ({mism} mismatches, max |d2| {max_d2}); "
        f"codes = plain indices; {cpu_mism} codes differ from the CPU plain "
        f"path | kernel {fmt_ms(kern)} ms, plain {fmt_ms(plain)} ms, "
        f"matmul+min {fmt_ms(lib)} ms, bound {bound_ms:.4f} ms ({bound_by}),"
        f" {bound_ms / kern[0]:.1%} of bound | vq_encode {wall:.3f} ms wall")
    bsz, frames, d, books, entries = P12_RVQ
    (rcodes, recon), wall, launches = counted(
        torch, lambda: modality.musicgen_frame_stub(
            P12_SEED, bsz, frames, d_latent=d, n_books=books,
            codebook_size=entries, device=dev))
    add(launches)
    check(tuple(rcodes.shape) == (books, bsz, frames) and bool(
        torch.isfinite(recon).all()) and int(rcodes.min()) >= 0
          and int(rcodes.max()) < entries, "phase12 d rvq: bad codes or "
          "reconstruction")
    books_t, lat_t = modality.stub_normals(P12_SEED, (books, entries, d),
                                           (bsz, frames, d), device="cpu")
    first, _ = modality.vq_encode(lat_t, books_t[0])
    diff = (first != rcodes[0].cpu()).flatten().nonzero()[:, 0]
    lat64 = lat_t.reshape(-1, d).double()
    b64 = books_t[0].double()
    a, c = first.flatten()[diff].long(), rcodes[0].cpu().flatten()[diff].long()
    gaps = ((lat64[diff] - b64[a]) ** 2).sum(-1) - ((lat64[diff] - b64[c])
                                                    ** 2).sum(-1)
    worst = float(gaps.abs().max()) if len(diff) else 0.0
    check(worst <= RVQ_NEAR_TIE, f"phase12 d rvq: level-0 codes differ from "
          f"the CPU's beyond near-ties (d2 gap {worst})")
    out["d_rvq"] = dict(shape=list(rcodes.shape), wall_ms=wall,
                        level0_cpu_mismatch=len(diff), worst_gap=worst)
    log(f"phase12 d rvq_encode: {bsz} x {frames} latents, D={d}, {books} "
        f"books of {entries} on the card (plain matmul expansion, no port "
        f"kernel) | {wall:.1f} ms wall | level-0 codes vs the CPU path: "
        f"{len(diff)} differ (largest d2 gap {worst:.2e}, near-tie bound "
        f"{RVQ_NEAR_TIE})")
    out["launch_totals"] = totals
    check(totals["nn_search"] > 0, "phase12: never launched nn_search")
    log(f"phase12: {time.perf_counter() - t_phase:.1f} s")
    return out


# Slice 9: the recurrent block kinds (models/ssm.py) at full width, random
# weights from lm.init_params_numpy(cfg, 0): mamba2-780m at full depth (48
# SSD layers, d_model 1536, d_inner 3072, 48 heads of 64, d_state 128,
# chunk 256, conv 4, vocab 50,280, tied; 780.15 M parameters) and
# recurrentgemma-9b at full width (d_model 4096, lru_width 4096, 16 MQA
# heads of 256, GeGLU d_ff 12,288, vocab 256,000 tied, window 2048, soft
# cap 30) with its depth cut from 38 to 5 layers: one rglru, rglru,
# local_attn period and the two-layer rglru suffix, the plan of the full
# 38 = 12 x 3 + 2 (2,174.92 M parameters; the 38 layers' 37.6 GB of fp32
# numpy weights put the JAX CPU reference run below out of reach; the
# launcher in (c) serves the same 5). (b) holds the teacher-forced
# logits of 2 x 64 tokens from np.random.default_rng(P13_SEED) to a JAX
# CPU run of the reference on the same numpy weights, the leaves it casts
# to bf16 at use handed over as bf16 (the same bits; 25-40 s and up to
# ~14 GB on an 8-core CPU host), for arch in P13_ARCHS:
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python -c "import dataclasses, jax
#   import numpy as np, jax.numpy as jnp; from chip_smoke import *
#   from repro.configs import get_config; from repro.models import lm
#   from repro_torch.models.lm import init_params_numpy
#   arch = 'mamba2-780m'; cfg = dataclasses.replace(get_config(arch),
#       n_layers=P13_LAYERS[arch])
#   def leaf(path, a):
#       n = [k.key for k in path]; bf = n[-1] in ('kernel', 'bias',
#           'table') and not {'w_a', 'w_i'} & set(n)
#       return jnp.asarray(a, jnp.bfloat16 if bf else jnp.float32)
#   p = jax.tree_util.tree_map_with_path(leaf, init_params_numpy(cfg, 0))
#   t = np.random.default_rng(P13_SEED).integers(0, cfg.vocab_size,
#       (2, 64), dtype=np.int32)
#   x = np.asarray(jax.jit(lm.forward, static_argnums=1)(p, cfg,
#       jnp.asarray(t))[0]); s = np.sort(x, -1)
#   print(x.argmax(-1).ravel().tolist(), (s[..., -1] - s[..., -2]).ravel()
#         .tolist(), [float(x[c]) for c in p12_coords(x.argmax(-1),
#         P13_FIXED_V[arch])])"
# The bars were fixed before the first card run, from the port's CPU path
# on the same weights and tokens against these constants (the forward of
# lm.params_from_reference(tree, cfg, "cpu")): mamba2-780m 0.15625 at the
# coordinates (0.25391 over all logits, whose largest is 4.125; the
# reference itself moves by 0.13281 when its chunk is 16 in place of 256,
# the same function, and its per-layer outputs on one input agree with the
# port's to 0.33-0.80 bf16 ulp: 48 layers compound the float order),
# recurrentgemma-9b 0.06056 (0.14453 over all; the reference moves by
# 0.03898 between q_block 16 and its default). The decode-vs-forward bars
# are about twice the port's CPU readings at 2 x 256 + 16 tokens (0.18945
# and 0.08555). The pasted logits are bf16 products cast to fp32 (soft-
# capped for recurrentgemma), so the argmax is held only where the
# reference's top-2 gap exceeds the bar.
P13_ARCHS = ("mamba2-780m", "recurrentgemma-9b")
P13_SEED = 13
P13_LAYERS = {"mamba2-780m": 48, "recurrentgemma-9b": 5}
# the launcher's depth (the whole script's time limit; its full configs
# took 13-14 s and 39-45 s with their numpy init): recurrentgemma-9b at
# the phase's 5 layers, so its tokens are held to the engine's;
# mamba2-780m at 8 of 48
P13_LAUNCH_LAYERS = {"recurrentgemma-9b": 5, "mamba2-780m": 8}
P13_PARAMS_M = {"mamba2-780m": 780.15, "recurrentgemma-9b": 2174.92}
P13_FIXED_V = {"mamba2-780m": (0, 1, 4096, 32768, 50279),
               "recurrentgemma-9b": (0, 1, 4096, 65536, 255999)}
P13_TOL = {"mamba2-780m": 0.3, "recurrentgemma-9b": 0.15}
P13_DECODE_TOL = {"mamba2-780m": 0.4, "recurrentgemma-9b": 0.25}
# (c)'s long requests (batch, prompt, generated): four SSD chunks; past
# the 2048-slot ring of recurrentgemma's local_attn layer
P13_LONG = {"mamba2-780m": (2, 1024, 16), "recurrentgemma-9b": (2, 2040, 16)}
P13_REF = {
    "mamba2-780m": dict(
        argmax=(
            42660, 38790, 39036, 20603, 11672, 21003, 45162, 36962, 2007,
            41402, 27454, 7468, 5534, 21452, 3360, 30864, 46055, 40298, 23045,
            42859, 34367, 10037, 49784, 34717, 37568, 23406, 43567, 35410,
            5613, 7666, 40391, 10081, 15490, 43028, 23418, 3591, 22833, 17412,
            32197, 15094, 22262, 22319, 43389, 30027, 22845, 1525, 46896,
            14927, 25436, 8235, 34230, 30055, 28600, 19948, 24371, 28713,
            47931, 24860, 23882, 11509, 49865, 37379, 46394, 49677, 3283,
            40993, 2512, 29499, 3624, 20749, 49696, 25352, 24237, 14126,
            39316, 49582, 48541, 45397, 40588, 36524, 4184, 13150, 23640,
            27292, 35922, 29390, 1516, 32918, 42627, 898, 24148, 5879, 34756,
            8157, 6791, 36474, 29598, 35722, 29194, 46290, 22122, 41707,
            49964, 2702, 11815, 3533, 14108, 5996, 13036, 38311, 2244, 32850,
            31635, 4858, 16715, 31344, 31738, 34496, 15927, 21931, 26682,
            5124, 50039, 44192, 21046, 48192, 32028, 15461),
        gap=(
            0.09375, 0.234375, 0.171875, 0.03125, 0.03125, 0.078125, 0.109375,
            0.03125, 0.09375, 0.515625, 0.03125, 0.1875, 0.15625, 0.328125,
            0.078125, 0.140625, 0.046875, 0.296875, 0.0625, 0.375, 0.046875,
            0.140625, 0.21875, 0.015625, 0.328125, 0.03125, 0.015625,
            0.578125, 0.5625, 0.0625, 0.0625, 0.015625, 0.15625, 0.265625,
            0.015625, 0.421875, 0.40625, 0.046875, 0.234375, 0.015625,
            0.234375, 0.15625, 0.109375, 0.25, 0.046875, 0.265625, 0.28125,
            0.1875, 0.328125, 0, 0.15625, 0.3125, 0.328125, 0.28125, 0.203125,
            0.140625, 0.203125, 0.0625, 0.046875, 0.34375, 0.453125, 0.296875,
            0.0625, 0.015625, 0.25, 0.15625, 0.171875, 0.671875, 0, 0.125,
            0.09375, 0.484375, 0.375, 0.109375, 0.09375, 0.03125, 0.03125,
            0.109375, 0.046875, 0.546875, 0.015625, 0.09375, 0.03125, 0.21875,
            0.046875, 0.0625, 0.03125, 0.03125, 0.015625, 0.03125, 0.203125,
            0, 0.140625, 0.109375, 0.078125, 0.078125, 0.0625, 0.3125,
            0.15625, 0.078125, 0.140625, 0.171875, 0.03125, 0, 0.09375,
            0.078125, 0, 0.15625, 0.171875, 0.140625, 0.046875, 0.828125,
            0.421875, 0.0625, 0, 0.015625, 0.25, 0.4375, 0.375, 0.171875,
            0.4375, 0.046875, 0.15625, 0.046875, 0.5, 0.046875, 0.171875,
            0.203125),
        logits=(
            3.21875, 3.34375, 3.453125, 3.265625, 3.1875, 3.125, 3.34375,
            3.125, 3.09375, 3.59375, 3.484375, 3.203125, 3.109375, 3.265625,
            3.484375, 3.1875, 3.390625, 3.390625, 3.046875, 3.453125,
            3.078125, 3.21875, 3.53125, 3.125, 3.34375, 3.140625, 3.40625,
            3.640625, 3.953125, 3.28125, 3.171875, 3.171875, 3.515625,
            3.359375, 3.28125, 3.75, 3.984375, 3.375, 3.640625, 3.5, 3.296875,
            3.5, 3.171875, 3.5625, 3.203125, 3.390625, 3.4375, 3.1875,
            3.265625, 3.140625, 3.203125, 3.453125, 3.5625, 3.578125, 3.21875,
            3.171875, 3.328125, 3.28125, 3.171875, 3.4375, 3.53125, 3.34375,
            3.140625, 3.09375, 3.46875, 3.265625, 3.390625, 3.984375, 3.28125,
            3.234375, 3.25, 3.53125, 3.796875, 3.125, 3.078125, 3.234375,
            3.328125, 3.21875, 3.234375, 3.5625, 3.078125, 3.6875, 3.109375,
            3.40625, 3.125, 3.078125, 3.171875, 3.375, 3.140625, 3.15625,
            3.265625, 2.984375, 3.234375, 3.1875, 3.328125, 3.0625, 3.234375,
            3.546875, 3.171875, 3.09375, 3.34375, 3.5625, 3.4375, 3.28125,
            3.03125, 3.046875, 3.046875, 3.140625, 3.265625, 3.171875,
            3.171875, 3.90625, 3.671875, 3.609375, 3.109375, 3.296875,
            3.53125, 3.625, 3.5, 3.40625, 3.40625, 3.078125, 3.234375, 3, 3.5,
            3.453125, 3.359375, 3.21875, 0.14355469, 1, 0.296875, -0.47070312,
            -0.36914062, 0.18945312, -1.6328125, -0.23339844, 1.1484375,
            -0.12109375, -0.21582031, 0.60546875, 0.31640625, 0.26953125,
            -0.0062561035, -0.83984375, -1.5234375, 0.33203125, 0.78125,
            0.15234375, 1.2734375, -0.7265625, -0.12597656, -0.088378906,
            1.921875, 0.5859375, -1.40625, -0.90234375, -0.0010681152,
            -0.09814453, -0.34960938, 1.1484375, 0.024902344, -0.6875,
            0.76953125, 0.11621094, -0.296875, 0.26757812, -0.61328125,
            -0.022094727)),
    "recurrentgemma-9b": dict(
        argmax=(
            13315, 53612, 2544, 32360, 10065, 110947, 229788, 203301, 182496,
            17636, 197598, 167945, 188300, 126223, 19714, 77182, 94883, 20450,
            125267, 159122, 55166, 222034, 146878, 5249, 255892, 80734,
            105556, 140224, 127746, 241275, 52147, 8637, 7626, 144441, 107508,
            241061, 233634, 229424, 143929, 201645, 251119, 165415, 53392,
            116414, 188136, 7926, 46759, 215017, 44131, 34295, 44688, 111028,
            148618, 162340, 101186, 96928, 249974, 7191, 41085, 28813, 40980,
            146821, 118909, 104569, 22380, 71370, 243952, 232596, 62799,
            83636, 183925, 73163, 50256, 73223, 180202, 107639, 231770, 87385,
            218107, 242757, 101009, 80911, 61884, 221955, 90485, 24338,
            206188, 122237, 196173, 206658, 58787, 20198, 243098, 244878,
            176367, 147875, 45613, 233507, 234218, 6847, 93940, 21090, 55587,
            23018, 69922, 68792, 149940, 47586, 158842, 52647, 19792, 85868,
            130807, 845, 138591, 216325, 202366, 199127, 209425, 254788,
            50394, 210746, 225739, 514, 91512, 75101, 131943, 115183),
        gap=(
            0.030181885, 0.7503123, 0.7509303, 0.53899145, 0.24168873,
            0.12093592, 0.2703476, 0.270895, 0.33135605, 0.24084377,
            0.3896885, 0.54188824, 0.27023554, 0.42096472, 0, 0.8126421,
            0.78144455, 0.24187183, 0.362669, 0.2400608, 1.3812656,
            0.56929684, 0.030170918, 0, 0.24122429, 0.030217648, 0.18147182,
            0.17989588, 0.24159765, 0.18167353, 0.09091997, 0.2106967,
            0.03007555, 0.090512276, 0.77752113, 0.5716467, 0.030170918,
            0.15097046, 0.21167755, 0, 0.06033039, 0.42147207, 0.33225822,
            1.2031064, 0.9939909, 0, 0.2098341, 0.661232, 0.030228138,
            0.18126726, 0.48148823, 0, 0.090581894, 0.48244143, 0.24141216,
            0.09068537, 0.21127701, 0.14962769, 0.7545223, 0.30187988,
            0.1507945, 0.779181, 0.66069174, 0.6558924, 0.06028223, 0.4507575,
            0.24196243, 0.12032604, 0.7527528, 0, 0.03011179, 0.09114647,
            0.57278156, 0.45184565, 0.09061766, 0.21035719, 0.03025055,
            0.09040594, 0.6593175, 0.12017965, 0, 0.09047747, 0.090441704,
            0.09047747, 0.39191008, 0.9500804, 0.21167755, 0.15097046,
            0.24015999, 0.6313062, 1.2520337, 0.060602188, 0.06046772,
            0.09061766, 0.27143002, 0.18098879, 0.8692584, 0.060602188,
            0.060352802, 0.1507945, 0.5093727, 0.2106967, 0.98224354,
            0.060602188, 0.45290184, 0.12107134, 0.6646223, 0.48244143, 0,
            0.09075308, 0.03011179, 0.030135155, 0.60443544, 0.8113303,
            0.30164766, 0.30117416, 0.8103318, 0.30187988, 0.54101515,
            0.060513496, 0.15097046, 0.48148823, 0.18153906, 0.03025055,
            0.12051773, 0.602334, 0.030194283, 0.18098879),
        logits=(
            5.5599957, 6.340479, 6.280744, 6.4001613, 5.5901666, 5.4694138,
            6.0412908, 5.891221, 5.86117, 5.86117, 6.2508583, 6.011302,
            6.071266, 6.0412908, 5.710732, 6.16112, 6.2508583, 5.529814,
            5.620326, 6.1012306, 6.6086273, 6.3703275, 5.5901666, 5.5901666,
            5.740844, 5.4694138, 5.4694138, 6.1311817, 5.620326, 5.3787284,
            5.257657, 5.86117, 5.831106, 5.620326, 6.6086273, 6.071266,
            5.5901666, 5.5901666, 5.4996195, 5.408968, 5.620326, 5.951286,
            5.650473, 6.4001613, 6.1910458, 5.287942, 6.16112, 6.1910458,
            5.439196, 5.5599957, 6.011302, 5.9212594, 5.5599957, 5.86117,
            5.6806083, 5.4694138, 5.650473, 6.2508583, 5.9212594, 5.6806083,
            5.6806083, 6.4597893, 6.2508583, 6.757123, 5.6806083, 6.1012306,
            5.4996195, 5.86117, 6.1012306, 5.710732, 5.740844, 5.0453587,
            5.9212594, 5.9212594, 5.529814, 5.9813004, 5.3787284, 5.710732,
            6.4001613, 5.951286, 5.4694138, 5.650473, 5.6806083, 5.650473,
            5.831106, 7.171039, 5.4996195, 5.5901666, 6.071266, 6.16112,
            7.0530643, 5.257657, 5.439196, 5.529814, 5.740844, 5.6806083,
            6.4895844, 5.257657, 5.5901666, 5.6806083, 6.340479, 5.86117,
            7.0235343, 5.257657, 5.740844, 5.3787284, 5.8010306, 5.86117,
            5.620326, 5.408968, 5.740844, 5.6806083, 5.740844, 6.280744,
            5.740844, 5.86117, 6.3703275, 5.6806083, 6.1311817, 5.3787284,
            5.5901666, 6.011302, 5.439196, 5.3787284, 5.740844, 6.011302,
            5.529814, 5.6806083, -0.9996298, 0.05712883, -0.86694604,
            3.2836664, -1.9114693, 0.60538656, -0.37107483, 0.16015473,
            1.0464504, -0.53509945, -0.05297846, -0.41208342, -0.70299625,
            1.6389916, -0.9996298, 0.24022925, 0.87865484, 1.2960678,
            -0.30077115, -1.0152371, 1.5766709, -0.45894855, 0.41403624,
            -0.30858287, 0.1621078, 1.8414321, -2.1059053, -0.6366231,
            0.6483365, 0.83962446, 1.1322744, 0.49800104, -0.32030034,
            1.0152371, 1.21808, -0.82401145, -0.20898099, -1.1868801,
            -0.16406086, 0.42770535)),
}


@contextlib.contextmanager
def launch_depth(arch, n_layers=None):
    """The registry's full config of ``arch`` cut to ``n_layers`` layers
    while the block runs (the serve launcher builds ``get_config(arch)``),
    or left whole with ``n_layers`` None; yields the config in force."""
    import dataclasses
    import importlib

    from repro_torch.configs import registry
    module = importlib.import_module(
        f"repro_torch.configs.{registry._MODULES[arch]}")
    full = module.CONFIG
    if n_layers is not None:
        module.CONFIG = dataclasses.replace(full, n_layers=n_layers)
    try:
        yield module.CONFIG
    finally:
        module.CONFIG = full


def state_bytes(cache):
    """(recurrent-state bytes, KV-cache bytes) of a decode cache: the SSM
    layers' (conv, ssm) state tuples and the attention layers' K and V."""
    rec = sum(t.numel() * t.element_size() for c in cache
              if isinstance(c, tuple) for t in c)
    kv = sum(c[k].numel() * c[k].element_size() for c in cache
             if isinstance(c, dict) for k in ("k", "v"))
    return rec, kv


def phase13(torch, np):
    """The recurrent block kinds at full width (slice 9)."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {}
    totals = dict(nn_search=0, candidate_sweep=0, fused_moment_sweep=0,
                  moment_sweep=0)

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    for arch in P13_ARCHS:
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=P13_LAYERS[arch])
        tag = f"phase13 {arch}"
        row = out[arch] = dict(layers=cfg.n_layers, full_layers=full.n_layers)

        # (a) weights
        t0 = time.perf_counter()
        tree = lm.init_params_numpy(cfg, 0)
        init_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = lm.params_from_reference(tree, cfg, dev)
        n_params, w_bytes = lm.param_count(model), lm.param_bytes(model)
        check(round(n_params / 1e6, 2) == P13_PARAMS_M[arch], f"{tag} a: "
              f"{n_params} parameters, expected {P13_PARAMS_M[arch]} M")
        row["a"] = dict(params=n_params, weight_bytes=w_bytes, init_s=init_s,
                        load_peak_bytes=torch.cuda.max_memory_allocated(dev))
        log(f"{tag} a: {cfg.n_layers} of {full.n_layers} layers "
            f"{cfg.layer_kinds[:3]}..., full width, {n_params / 1e6:.2f} M "
            f"parameters, {w_bytes / 1e9:.4f} GB on the card (bf16 kernels "
            f"and table; fp32 norms, SSM vectors and RG-LRU gates); numpy "
            f"init {init_s:.1f} s; max_memory_allocated "
            f"{row['a']['load_peak_bytes'] / 1e9:.4f} GB")

        # (b) teacher-forced logits against the JAX reference, card and CPU
        ref = dict(P13_REF[arch], tag=f"{tag} b", tol=P13_TOL[arch],
                   fixed_v=P13_FIXED_V[arch])
        tok = torch.from_numpy(np.random.default_rng(P13_SEED).integers(
            0, cfg.vocab_size, (P12_B, P12_S), dtype=np.int32))
        logits_card, _ = lm.forward(model, cfg, tokens=tok.to(dev))
        row["b_cuda"] = hold_logits(np, "cuda", logits_card, ref)
        cpu_model = lm.params_from_reference(tree, cfg, "cpu")
        del tree
        t0 = time.perf_counter()
        logits_cpu, _ = lm.forward(cpu_model, cfg, tokens=tok)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        del cpu_model
        row["b_cpu"] = hold_logits(np, "cpu", logits_cpu, ref)
        card_vs_cpu = float((logits_card.cpu() - logits_cpu).abs().max())
        row["b_cpu"].update(forward_ms=cpu_ms, card_vs_cpu=card_vs_cpu)
        log(f"{tag} b: card vs the port's CPU path, max |logit diff| over "
            f"all {logits_cpu.numel()} logits {card_vs_cpu:.6f}; the CPU "
            f"forward took {cpu_ms:.0f} ms (host clock)")
        del logits_card, logits_cpu

        # (c) serving: the launcher's defaults, then the long requests
        b_long, s_long, g_long = P13_LONG[arch]
        runs = (("b4_p32_g32", serve_launch.prompt_tokens(
            1, 4, 32, cfg.vocab_size), 32),
                (f"b{b_long}_p{s_long}_g{g_long}",
                 np.random.default_rng(P13_SEED + 1).integers(
                     0, cfg.vocab_size, (b_long, s_long), dtype=np.int32),
                 g_long))
        row["c"], served = {}, {}
        for name, prompts, gen in runs:
            prompts = torch.from_numpy(prompts).to(dev)
            b, s = prompts.shape
            engine = Engine(cfg, model, max_len=s + gen, device=dev)
            (toks, steps), wall, launches = counted(
                torch, lambda: serve_logits(torch, lm, engine, prompts, gen))
            add(launches)
            again = Engine(cfg, model, max_len=s + gen, device=dev).generate(
                prompts, gen)
            check(bool(torch.equal(toks, again)), f"{tag} c {name}: two "
                  f"engines gave different tokens")
            served[name] = toks
            c = teacher_forced(torch, lm, model, cfg, name, prompts, toks,
                               steps, tol=P13_DECODE_TOL[arch],
                               tag=f"{tag} c")
            prefill_ms, step_ms, issue_ms, cache = decode_timing(
                torch, lm, model, cfg, prompts, gen - 1)
            # positions 0 .. s + gen - 2 written; past the window the ring
            # holds the last ``window`` of them
            rings = [cache[li]["pos"] for li, kind in
                     enumerate(cfg.layer_kinds) if kind == "local_attn"]
            wrapped = bool(rings) and s + gen - 1 > cfg.window
            for ring in rings:
                oldest = s + gen - 1 - ring.numel() if wrapped else -1
                check(int(ring.max()) == s + gen - 2
                      and int(ring.min()) == oldest, f"{tag} c {name}: ring "
                      f"positions {int(ring.min())}..{int(ring.max())}")
            pos = s + gen - 1
            nxt = toks[:, -1]
            kernels, busy, host_launches = device_profile(
                torch, lambda: lm.decode_step(model, cfg, pos, cache,
                                              token=nxt))
            rec_bytes, kv_bytes = state_bytes(cache)
            # weights read once, recurrent states read and written, the KV
            # ring read, the fp32 logits written
            step_bytes = (w_bytes + 2 * rec_bytes + kv_bytes
                          + b * cfg.vocab_size * 4)
            bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
            idle = None if busy is None else 1 - busy / step_ms
            c.update(batch=b, prompt=s, gen=gen, wall_ms=wall,
                     tokens_per_s=b * gen / wall * 1e3, prefill_ms=prefill_ms,
                     decode_ms_per_token=step_ms, decode_issue_ms=issue_ms,
                     decode_tokens_per_s=b / step_ms * 1e3,
                     ring_wrapped=wrapped, step_kernels=kernels,
                     step_busy_ms=busy, step_host_launches=host_launches,
                     step_idle=idle, step_bytes=step_bytes,
                     state_bytes=rec_bytes, kv_bytes=kv_bytes,
                     step_bound_ms=bound_ms)
            row["c"][name] = c
            profiled = ("no device activity recorded" if busy is None else
                        f"{busy:.4f} ms busy, idle {idle:.1%}")
            ring = (f" (the {cfg.window}-slot ring wrapped)" if wrapped
                    else "")
            log(f"{tag} c {name}: B={b} prompt {s}{ring} gen {gen} | "
                f"generate {wall:.1f} ms wall, {c['tokens_per_s']:.1f} tok/s "
                f"| prefill {prefill_ms:.3f} ms | decode {step_ms:.3f} ms a "
                f"step ({c['decode_tokens_per_s']:.1f} tok/s; the host queues "
                f"a step in {issue_ms:.3f} ms) | one step: {kernels} device "
                f"kernels ({host_launches} host launches), {profiled} | byte "
                f"bound {bound_ms:.4f} ms ({step_bytes / 1e9:.4f} GB: weights "
                f"{w_bytes / 1e9:.4f} GB, recurrent states "
                f"{rec_bytes / 1e6:.2f} MB read and written, KV "
                f"{kv_bytes / 1e6:.2f} MB), {bound_ms / step_ms:.1%} of the "
                f"step")
            del cache, steps, engine
        row["c_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        log(f"{tag} c: max_memory_allocated over (a)-(c) "
            f"{row['c_peak_bytes'] / 1e9:.4f} GB")
        del model
        torch.cuda.empty_cache()

        # the launcher at its defaults: the full config, cut to
        # P13_LAUNCH_LAYERS; held to the engine's tokens at the phase's
        # depth
        text = io.StringIO()
        with launch_depth(arch, P13_LAUNCH_LAYERS.get(arch)) as launch_cfg, \
                contextlib.redirect_stdout(text):
            launched, wall, launches = counted(
                torch, lambda: serve_launch.main(["--arch", arch, "--device",
                                                  "cuda:0"]))
        add(launches)
        lines = [ln for ln in text.getvalue().splitlines() if "tok/s" in ln]
        check(len(lines) == 1, f"{tag} launcher: no tok/s line in "
              f"{text.getvalue()!r}")
        check(tuple(launched.shape) == (4, 32) and int(launched.min()) >= 0
              and int(launched.max()) < cfg.vocab_size, f"{tag} launcher: "
              f"bad tokens {tuple(launched.shape)}")
        if launch_cfg.n_layers == cfg.n_layers:
            check(bool(torch.equal(launched, served["b4_p32_g32"])),
                  f"{tag} launcher: its tokens differ from the engine's on "
                  f"the same weights and prompts")
        row["launcher"] = dict(line=lines[0], wall_ms=wall,
                               layers=launch_cfg.n_layers)
        log(f"{tag} launcher (repro_torch.launch.serve --arch {arch}, "
            f"{launch_cfg.n_layers} of {full.n_layers} layers): "
            f"{lines[0].strip()} | {wall:.0f} ms with its weight init")
        del launched
        torch.cuda.empty_cache()
        log(f"{tag}: {time.perf_counter() - t_arch:.1f} s")
    out["launch_totals"] = totals
    check(sum(totals.values()) == 0, f"phase13: the recurrent LM path "
          f"launched port kernels {totals}")
    log(f"phase13: {time.perf_counter() - t_phase:.1f} s")
    return out


# Slice 10: MLA and the single-device MoE FFN at full width, random weights
# from lm.init_params_numpy(cfg, 0): minicpm3-4b at full width and depth (62
# MLA layers, d_model 2560, 40 heads, q_lora 768, kv_lora 256, nope 64 /
# rope 32 / v 64, SwiGLU 6400, vocab 73,448 untied, q_block 512; 4,261.90 M
# parameters), deepseek-moe-16b at full width with its depth cut from 28
# to 4 layers (the dense first layer, SwiGLU 10,944, and 3 MoE layers of 64
# routed experts of 1,408, top-6 unnormalised, and 2 shared; 16 MHA heads
# of 128, vocab 102,400; 2,267.04 M) and qwen3-moe-235b-a22b at full width
# cut from 94 to 2 layers (128 experts of 1,536, top-8 renormalised, no
# shared; GQA 64 / 4 heads of 128 with QK-norm, vocab 151,936; 6,220.17 M).
# The cuts: the JAX CPU run below holds the weights on the host (the full
# deepseek-moe-16b is 16,375.73 M, qwen3-moe-235b-a22b 235,093.63 M, no
# single card holds it).
# (b) holds the teacher-forced logits of 2 x 64 tokens from
# np.random.default_rng(P14_SEED) and the summed MoE aux to a JAX CPU run of
# the reference on the same numpy weights, each leaf handed over at the
# dtype the reference computes with (bf16 where it casts at use: the same
# bits; the MoE router and MLA's wuk / wuv fp32), drawn leaf by leaf so the
# host never holds the fp32 tree (peak 15, 25 and 44 GB for deepseek,
# minicpm3 and qwen3, as XLA's CPU dots widen the bf16 weights to fp32;
# 1-3 min on an 8-core CPU host), for arch in P14_ARCHS:
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python -c "import dataclasses, jax
#   import numpy as np, jax.numpy as jnp; from chip_smoke import *
#   from repro.configs import get_config; from repro.models import lm
#   from repro_torch.models import lm as tlm
#   arch = 'minicpm3-4b'; cfg = dataclasses.replace(get_config(arch),
#       n_layers=P14_LAYERS[arch])
#   def leaf(path, spec):
#       n = [k.key for k in path]; dt = (jnp.bfloat16 if tlm.bf16_leaf(n)
#           else jnp.float32)
#       return jnp.asarray(tlm._draw('/'.join(n), *spec, 0)).astype(dt)
#   p = jax.tree_util.tree_map_with_path(leaf, tlm.param_shapes(cfg),
#       is_leaf=lambda v: isinstance(v, tuple) and len(v) == 2
#       and isinstance(v[1], str))
#   t = np.random.default_rng(P14_SEED).integers(0, cfg.vocab_size,
#       (2, 64), dtype=np.int32)
#   x, aux = jax.jit(lm.forward, static_argnums=1)(p, cfg, jnp.asarray(t))
#   x = np.asarray(x); s = np.sort(x, -1)
#   print(x.argmax(-1).ravel().tolist(), (s[..., -1] - s[..., -2]).ravel()
#         .tolist(), [float(x[c]) for c in p12_coords(x.argmax(-1),
#         P14_FIXED_V[arch])], float(aux))"
# The bars were fixed before the first card run, from the port's CPU path
# on the same weights and tokens against these constants (the forward of
# the port's model on the CPU): minicpm3-4b 0.17188 at the coordinates
# (0.41785 over all logits, whose largest is 5.47; the reference itself
# moves 0.09375 there between q_block 16 and its default), deepseek-moe-16b
# 0.0625 (0.17188; reference 0.03125), qwen3-moe-235b-a22b 0.125 (1.2979:
# a token routed or dropped otherwise moves its whole row; reference
# 0.09375); aux 3.5e-5 and 4.0e-5 relative (reference 9e-6, 3.9e-5). Each
# bar is about 2.4 times the reading. A near-tie route that the card takes
# otherwise than the CPU path moves the card's aux past its bar (run DA:
# qwen3-moe, one flip in the first MoE layer at a 3.7e-5 probability gap,
# 1.81e-4 relative), so the card's aux is held on every run to its fp64
# recomputation from the router logits and routes it recorded, within
# P14_AUX_FP64_RTOL (a 128-term fp32 sum's worst rounding, 128 x 2^-24 =
# 7.6e-6, rounded up; the port's CPU path reads 1.9e-8 and 7.6e-8), with
# every route that differs from the CPU path's a near-tie (P14_ROUTE_TIE)
# and the CPU path's aux within P14_AUX_RTOL of the reference's.
# Decode vs forward: the published capacity factor drops pairs in the
# forward (7-56%) and none in a decode step, and a dropped pair moves a
# token's later layers by a whole expert row, so every token is held there
# only to a loose bar (P14_DECODE_ALL_TOL). The tight bar holds the tokens
# of a copy of the config whose capacity (C = T) drops no pair, but for a
# token that decode and forward route otherwise, whose first differing
# layer must be a near-tie (the forward's k-th and (k+1)-th router
# probabilities within P14_ROUTE_TIE; the CPU's widest 5.5e-4). The port's
# CPU readings: minicpm3-4b 0.40039 at 2 x 256 + 16 (no MoE); on the
# no-drop copy deepseek-moe-16b 0.046875 at 4 x 32 + 32 (11 of 128 tokens
# routed otherwise) and 0.03125 at 2 x 256 + 16 (2 of 32),
# qwen3-moe-235b-a22b 0.0625 (6 of 128) and 0.046875 (2 of 32); at the
# published factor over every token deepseek 0.42578 and qwen3 3.125.
# deepseek-moe-16b runs last: its model stays on the card for phase 16, and
# no other arch's memory readings may include it.
P14_ARCHS = ("minicpm3-4b", "qwen3-moe-235b-a22b", "deepseek-moe-16b")
P14_SEED = 14
P14_LAYERS = {"minicpm3-4b": 62, "deepseek-moe-16b": 4,
              "qwen3-moe-235b-a22b": 2}
P14_PARAMS_M = {"minicpm3-4b": 4261.90, "deepseek-moe-16b": 2267.04,
                "qwen3-moe-235b-a22b": 6220.17}
P14_FIXED_V = {"minicpm3-4b": (0, 1, 4096, 65536, 73447),
               "deepseek-moe-16b": (0, 1, 4096, 65536, 102399),
               "qwen3-moe-235b-a22b": (0, 1, 4096, 65536, 151935)}
P14_TOL = {"minicpm3-4b": 0.4, "deepseek-moe-16b": 0.15,
           "qwen3-moe-235b-a22b": 0.3}
P14_AUX_RTOL = {"deepseek-moe-16b": 1e-4, "qwen3-moe-235b-a22b": 1e-4}
P14_AUX_FP64_RTOL = 1e-5
# tokens of the no-drop copy routed alike (minicpm3-4b: all); at the
# published capacity factor every token, dropped ones included
P14_DECODE_TOL = {"minicpm3-4b": 0.8, "deepseek-moe-16b": 0.2,
                  "qwen3-moe-235b-a22b": 0.3}
P14_DECODE_ALL_TOL = {"deepseek-moe-16b": 0.9, "qwen3-moe-235b-a22b": 6.5}
P14_ROUTE_TIE = 1e-3
P14_LAUNCH_SMOKE = ("qwen3-moe-235b-a22b",)
# the launcher's depth (the whole script's time limit: deepseek-moe-16b's
# 28 layers took 113-126 s and minicpm3-4b's 62 took 28-32 s, most of it
# numpy init): deepseek-moe-16b at the phase's 4 layers, so its tokens are
# held to the engine's; minicpm3-4b at 8 of 62
P14_LAUNCH_LAYERS = {"deepseek-moe-16b": 4, "minicpm3-4b": 8}
P14_LONG = (2, 1024, 16)   # minicpm3-4b: two q_blocks of 512
P14_REF = {
    "minicpm3-4b": dict(
        argmax=(
            21348, 46715, 6792, 60597, 3323, 30838, 65004, 39468, 20030, 28732,
            47245, 71959, 21363, 69932, 21548, 29802, 53076, 44525, 10236,
            16238, 55924, 8904, 27651, 40460, 3029, 58285, 32027, 44551, 377,
            1463, 26355, 33997, 43276, 12370, 2706, 38903, 31235, 55289, 28597,
            67344, 50369, 34519, 62696, 26822, 53447, 29578, 70868, 52977,
            40475, 53923, 64031, 42379, 42570, 3272, 58156, 21340, 3587, 1755,
            7008, 29626, 13844, 44163, 67082, 69937, 3023, 6982, 36125, 47438,
            63248, 22405, 9324, 42444, 3633, 14159, 37034, 47944, 9420, 31101,
            57768, 68091, 13389, 56027, 26334, 27609, 25351, 11138, 37723,
            15066, 29666, 72359, 21700, 38495, 65699, 31229, 60360, 25840,
            18917, 49668, 49067, 8815, 58377, 71424, 48780, 36051, 50008,
            36674, 48887, 6435, 46029, 32305, 70993, 56720, 25308, 600, 51016,
            53497, 16249, 55404, 2702, 5014, 14231, 27253, 50105, 66001, 6672,
            6657, 49878, 50338),
        gap=(
            0.015625, 0.28125, 0.09375, 0.375, 0.125, 0.140625, 0.09375, 0.375,
            0.0625, 0.03125, 0.0, 0.21875, 0.03125, 0.6875, 0.125, 0.21875,
            0.09375, 0.09375, 0.0, 0.0625, 0.0625, 0.53125, 0.03125, 1.296875,
            0.15625, 0.9375, 0.046875, 0.375, 0.296875, 0.21875, 0.46875,
            0.34375, 0.25, 0.0625, 0.4375, 0.0625, 0.125, 0.09375, 0.453125,
            0.609375, 0.0625, 0.75, 0.34375, 0.28125, 0.296875, 0.296875,
            0.0625, 0.03125, 0.390625, 0.03125, 0.9375, 0.25, 0.09375, 0.0625,
            0.15625, 0.71875, 0.453125, 0.6875, 0.3125, 0.65625, 0.03125,
            0.03125, 0.125, 0.09375, 0.59375, 0.109375, 0.125, 0.0, 0.34375,
            0.21875, 0.03125, 0.21875, 0.03125, 0.0625, 0.25, 0.4375, 0.0,
            0.59375, 0.375, 0.125, 0.125, 0.03125, 0.03125, 0.09375, 0.3125,
            0.21875, 0.03125, 0.03125, 0.15625, 0.0625, 0.09375, 0.03125,
            0.0625, 0.4375, 0.03125, 0.140625, 0.046875, 0.28125, 0.21875,
            0.09375, 0.03125, 0.15625, 0.46875, 0.15625, 0.0, 0.0625, 0.09375,
            0.03125, 0.4375, 0.28125, 0.09375, 0.15625, 0.3125, 0.21875,
            0.03125, 0.125, 0.15625, 0.6875, 0.0, 0.03125, 0.0, 0.125, 0.21875,
            0.09375, 0.0, 0.0, 0.1875, 0.0625),
        logits=(
            3.984375, 4.71875, 4.25, 4.5, 4.25, 4.09375, 4.4375, 4.53125,
            4.09375, 4.40625, 4.25, 4.625, 4.03125, 4.71875, 4.09375, 4.65625,
            4.21875, 4.40625, 4.375, 4.3125, 4.4375, 4.6875, 4.09375, 5.0625,
            4.1875, 5.28125, 3.8125, 4.375, 4.1875, 4.21875, 4.65625, 4.46875,
            4.40625, 4.0, 4.5625, 4.46875, 4.34375, 4.28125, 4.375, 4.4375,
            4.34375, 4.84375, 4.34375, 4.9375, 4.03125, 4.28125, 4.1875,
            4.09375, 4.28125, 4.0625, 5.1875, 4.65625, 4.46875, 4.34375, 4.5,
            4.78125, 4.375, 4.8125, 4.375, 4.71875, 4.4375, 4.25, 4.375, 4.25,
            4.65625, 4.0, 4.125, 4.15625, 4.40625, 4.4375, 4.3125, 4.53125,
            4.40625, 4.4375, 4.25, 4.75, 4.40625, 4.71875, 4.46875, 4.21875,
            4.40625, 4.15625, 4.28125, 4.25, 4.34375, 4.375, 4.125, 4.0625,
            4.3125, 4.4375, 4.21875, 4.15625, 4.15625, 4.53125, 4.03125,
            4.0625, 4.0, 4.53125, 4.25, 4.21875, 4.28125, 4.40625, 4.5625,
            4.53125, 4.21875, 3.84375, 4.375, 4.1875, 4.4375, 4.625, 4.40625,
            4.3125, 4.375, 4.625, 4.34375, 4.15625, 4.09375, 4.875, 4.3125,
            4.21875, 4.25, 4.1875, 4.4375, 4.46875, 4.28125, 4.28125, 3.953125,
            4.34375, -2.28125, 0.06591796875, -1.90625, -0.294921875,
            -0.93359375, 0.54296875, 0.88671875, -0.08740234375, 0.1923828125,
            -1.1640625, 0.8203125, -1.4453125, 0.81640625, 0.369140625, -0.5,
            -1.1171875, -0.6484375, 0.6640625, 0.83984375, 0.318359375,
            -1.109375, 0.26953125, -1.5625, -0.609375, 0.34765625, 0.474609375,
            -1.3359375, -0.2490234375, 0.51171875, 1.421875, -1.8515625,
            -0.35546875, -1.6640625, 0.625, 1.21875, 0.61328125, 1.71875,
            -1.734375, -1.203125, -1.0390625),
        aux=0.0),
    "deepseek-moe-16b": dict(
        argmax=(
            61019, 56591, 32279, 850, 59195, 35653, 21618, 88857, 76290, 62761,
            86947, 80822, 76680, 89385, 30945, 80883, 47420, 96314, 17885,
            7638, 88665, 35653, 2754, 48555, 64314, 89385, 82313, 64203, 21111,
            37332, 3185, 87998, 4931, 77794, 84907, 51725, 17967, 85496, 58025,
            43766, 101170, 66747, 12218, 15848, 33306, 26508, 52703, 96704,
            49788, 58660, 5293, 5438, 60796, 71751, 7836, 51721, 17975, 59430,
            73181, 31244, 94787, 37332, 14134, 88766, 61615, 87162, 70172,
            58937, 73993, 77737, 97257, 90788, 38501, 6060, 97757, 3318, 2094,
            14068, 47216, 4006, 102250, 25444, 94825, 62425, 96566, 78579,
            97757, 77053, 30610, 97257, 457, 77476, 9011, 72774, 68835, 18182,
            28524, 17351, 85672, 32206, 84718, 27716, 32206, 1930, 93614,
            60176, 4729, 78863, 56930, 54321, 50906, 31078, 30550, 44511, 2348,
            97454, 68835, 57568, 52713, 48091, 27268, 12012, 101381, 57881,
            4845, 48218, 7494, 58592),
        gap=(
            0.265625, 0.265625, 0.09375, 0.09375, 0.28125, 0.171875, 0.0625,
            0.015625, 0.09375, 0.34375, 0.34375, 0.109375, 0.328125, 0.265625,
            0.015625, 0.359375, 0.0625, 0.046875, 0.140625, 0.1875, 0.125,
            0.171875, 0.328125, 0.234375, 0.21875, 0.296875, 0.03125, 0.0,
            0.015625, 0.015625, 0.03125, 0.046875, 0.015625, 0.328125,
            0.203125, 0.0625, 0.390625, 0.03125, 0.0, 0.171875, 0.15625,
            0.28125, 0.453125, 0.109375, 0.078125, 0.140625, 0.03125, 0.40625,
            0.09375, 0.328125, 0.1875, 0.296875, 0.1875, 0.078125, 0.03125,
            0.03125, 0.15625, 0.40625, 0.078125, 0.046875, 0.0625, 0.015625,
            0.28125, 0.0625, 0.46875, 0.09375, 0.03125, 0.234375, 0.203125,
            0.640625, 0.484375, 0.40625, 0.03125, 0.15625, 0.25, 0.125,
            0.578125, 0.078125, 0.0625, 0.21875, 0.015625, 0.234375, 0.1875,
            0.015625, 0.1875, 0.046875, 0.1875, 0.078125, 0.171875, 0.015625,
            0.15625, 0.09375, 0.921875, 0.0625, 0.09375, 0.90625, 0.09375,
            0.484375, 0.09375, 0.015625, 0.5625, 0.53125, 0.03125, 0.171875,
            0.65625, 0.0625, 0.96875, 0.25, 0.15625, 0.25, 0.21875, 0.046875,
            0.109375, 0.296875, 0.015625, 0.171875, 0.015625, 0.125, 0.0625,
            0.015625, 0.1875, 0.125, 0.046875, 0.59375, 0.34375, 0.234375,
            0.265625, 0.171875),
        logits=(
            3.984375, 4.1875, 3.640625, 3.96875, 3.953125, 4.15625, 3.71875,
            3.78125, 4.15625, 4.1875, 4.40625, 3.984375, 4.3125, 4.25, 3.8125,
            3.890625, 3.65625, 3.84375, 3.953125, 3.734375, 4.03125, 3.828125,
            4.0625, 3.921875, 4.15625, 3.796875, 3.75, 3.640625, 3.546875,
            3.9375, 3.53125, 3.734375, 3.8125, 4.21875, 4.1875, 3.71875, 4.25,
            3.796875, 3.65625, 3.65625, 4.21875, 4.0, 4.125, 3.875, 3.703125,
            3.765625, 3.84375, 4.03125, 3.78125, 4.21875, 3.875, 4.03125,
            3.96875, 3.9375, 4.0, 3.765625, 3.984375, 4.1875, 3.84375,
            3.828125, 3.828125, 3.90625, 4.375, 3.921875, 4.0625, 3.625,
            3.90625, 3.859375, 4.0625, 4.46875, 4.4375, 4.15625, 3.71875,
            4.28125, 4.09375, 3.828125, 4.28125, 3.890625, 3.84375, 4.125,
            3.765625, 4.0625, 3.6875, 3.65625, 3.890625, 3.828125, 3.890625,
            3.8125, 3.890625, 3.84375, 3.921875, 4.25, 4.75, 3.6875, 3.9375,
            4.9375, 3.640625, 4.15625, 3.578125, 3.953125, 4.375, 4.15625,
            3.71875, 3.96875, 4.5, 3.796875, 4.8125, 3.921875, 3.6875,
            3.921875, 4.15625, 3.796875, 3.859375, 4.125, 3.8125, 4.0, 3.78125,
            3.6875, 3.828125, 3.796875, 3.65625, 4.125, 3.953125, 4.375, 4.125,
            3.75, 4.03125, 3.96875, 0.484375, -0.8203125, -0.921875,
            -0.30859375, 0.2099609375, -1.15625, 0.357421875, -0.6328125,
            -0.6484375, 0.255859375, -0.28125, -0.7265625, 0.6796875,
            -0.828125, 0.828125, -0.91796875, -0.6953125, 1.1171875,
            -0.1943359375, 2.1875, -0.396484375, 1.171875, 0.162109375,
            -0.76953125, 1.359375, -0.67578125, 0.77734375, -0.3125,
            -0.1083984375, 0.6640625, -0.5625, 1.0390625, -0.0322265625,
            0.021728515625, 2.09375, -0.169921875, -0.4296875, 1.140625,
            -0.1982421875, 0.5703125),
        aux=0.06647983193397522),
    "qwen3-moe-235b-a22b": dict(
        argmax=(
            49740, 11408, 22650, 126051, 53833, 122788, 40204, 68109, 122613,
            122613, 63203, 112219, 122613, 116469, 87718, 39427, 120643,
            133247, 35262, 139070, 35262, 127697, 136540, 136540, 30700, 35262,
            134648, 35262, 35262, 9239, 98992, 62862, 80787, 136540, 136540,
            80787, 80787, 134720, 134720, 136540, 80787, 136540, 134720,
            134720, 134720, 134720, 60710, 136540, 98992, 80787, 80787, 80787,
            80787, 134720, 94007, 5851, 134720, 38927, 80787, 80787, 80787,
            134720, 80787, 117420, 114643, 23286, 100157, 122128, 108493,
            108493, 88689, 134139, 124558, 88689, 8593, 41677, 25415, 8083,
            88689, 49385, 3379, 16525, 88689, 111302, 60506, 123942, 32074,
            5317, 135906, 71359, 8083, 124558, 69669, 11147, 113609, 69669,
            149806, 6, 69669, 60411, 32074, 81649, 133375, 69865, 61147, 69669,
            21193, 122104, 9229, 100070, 117761, 26745, 105749, 21933, 110118,
            57838, 105485, 53999, 26745, 110118, 36948, 70440, 113793, 70440,
            4939, 26745, 53999, 70440),
        gap=(
            0.03125, 0.03125, 0.4375, 0.75, 0.28125, 0.03125, 0.21875, 0.59375,
            0.09375, 0.375, 0.25, 0.3125, 0.40625, 0.125, 0.5, 0.21875,
            0.59375, 0.78125, 0.0, 0.28125, 0.09375, 0.21875, 0.0625, 0.0625,
            0.15625, 0.0625, 0.21875, 0.125, 0.15625, 0.0, 0.1875, 0.15625,
            0.6875, 0.71875, 1.0, 0.21875, 0.375, 0.78125, 0.4375, 0.0625,
            0.375, 0.40625, 0.53125, 0.6875, 0.21875, 0.4375, 0.28125, 0.625,
            0.25, 0.0625, 0.53125, 0.625, 0.375, 1.09375, 0.0625, 0.28125,
            0.40625, 0.0, 0.0625, 0.625, 0.4375, 0.96875, 0.71875, 0.15625,
            0.15625, 0.59375, 0.03125, 0.09375, 0.3125, 0.03125, 0.4375,
            0.0625, 0.21875, 0.09375, 0.0, 0.03125, 0.0625, 0.28125, 0.4375,
            0.125, 0.75, 0.0625, 0.40625, 0.09375, 0.78125, 0.15625, 0.0625,
            0.0625, 0.0625, 0.21875, 0.21875, 0.5625, 0.75, 0.09375, 0.125,
            0.09375, 0.09375, 0.09375, 0.15625, 0.03125, 0.09375, 0.4375,
            0.0625, 0.1875, 0.21875, 0.5625, 0.125, 0.03125, 0.25, 0.0625,
            0.28125, 0.0, 0.125, 0.0, 0.0, 0.34375, 0.03125, 0.59375, 0.1875,
            0.09375, 0.09375, 0.21875, 0.25, 0.625, 0.0, 0.03125, 0.15625,
            0.71875),
        logits=(
            5.4375, 5.65625, 6.125, 5.875, 5.78125, 5.5, 5.53125, 5.90625, 5.5,
            6.1875, 5.78125, 5.6875, 5.71875, 5.5, 6.21875, 5.9375, 5.84375,
            6.34375, 5.78125, 5.75, 5.40625, 5.5625, 5.6875, 5.6875, 5.90625,
            5.625, 6.03125, 5.59375, 5.78125, 5.125, 5.78125, 5.625, 6.15625,
            6.0625, 6.46875, 5.96875, 6.0, 6.46875, 5.90625, 5.84375, 6.125,
            6.375, 6.0625, 6.625, 6.375, 6.25, 5.71875, 6.0625, 5.8125, 5.625,
            6.3125, 6.25, 6.0, 6.46875, 5.625, 6.25, 6.28125, 5.21875, 5.59375,
            6.3125, 6.46875, 6.65625, 6.125, 5.6875, 5.5, 5.75, 5.625, 5.21875,
            5.375, 5.5625, 5.59375, 5.25, 5.625, 5.25, 4.9375, 5.53125,
            5.84375, 5.625, 5.875, 5.46875, 5.875, 5.625, 5.5625, 5.28125,
            6.375, 5.34375, 5.625, 5.65625, 5.3125, 5.53125, 5.6875, 6.03125,
            5.84375, 5.625, 5.40625, 5.34375, 5.46875, 5.65625, 5.65625,
            5.3125, 5.53125, 5.5625, 5.65625, 5.3125, 5.625, 5.65625, 5.40625,
            5.375, 5.53125, 5.09375, 5.21875, 5.1875, 5.25, 5.15625, 5.15625,
            5.53125, 5.46875, 5.78125, 5.28125, 5.4375, 5.375, 5.5625, 5.625,
            6.0, 5.25, 5.34375, 5.53125, 6.15625, -0.384765625, 0.78515625,
            0.34765625, -2.15625, 1.1015625, -1.5078125, -2.453125, 2.234375,
            -0.8203125, 2.8125, -1.5703125, -2.140625, 0.75, 0.78515625,
            2.421875, -2.078125, -1.71875, 1.109375, 1.28125, 3.046875,
            0.79296875, -0.55859375, -0.5234375, 0.455078125, -0.93359375,
            2.53125, -0.91015625, -0.89453125, 0.859375, -0.328125, 1.859375,
            -2.140625, 1.0390625, 0.06884765625, -0.010498046875, 0.7421875,
            -1.5859375, 0.77734375, 0.166015625, -0.828125),
        aux=0.06775811314582825),
}


class MoETrace:
    """Within the ``with`` block, every MoE layer call of the port's
    ``models.moe`` (``route`` and ``dispatch`` wrapped; a batched call of
    ``models.moe_ep``, one record a block) appends a record:
    its router logits (T, E), the chosen experts (T, k, ascending), each
    token's dropped flag (any of its pairs past the capacity) and the
    layer's ``dropped_frac`` (the share of pairs dropped). A forward or a
    prefill adds one record a MoE layer, in layer order; so does each
    decode step."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, (moe.route, moe.dispatch)
        torch = self.torch

        def route(logits, cfg):
            for block in (logits if logits.dim() == 3 else logits[None]):
                self.calls.append(dict(logits=block.float().clone()))
            return self.orig[0](logits, cfg)

        def dispatch(idx, c, e):
            out = self.orig[1](idx, c, e)
            _, st_tok, _, _, keep = out
            blocks = ((idx, st_tok, keep) if idx.dim() == 3 else
                      (idx[None], st_tok[None], keep[None]))
            for rec, ix, st, kp in zip(self.calls[-len(blocks[0]):],
                                       *blocks):
                dropped = torch.zeros(ix.shape[0], dtype=torch.int32,
                                      device=ix.device)
                dropped.index_add_(0, st, (~kp).int())
                rec.update(idx=ix.sort(-1).values, dropped=dropped > 0,
                           dropped_frac=(~kp).float().mean())
            return out

        moe.route, moe.dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.dispatch = self.orig


def route_diffs(torch, a, b, k):
    """(the (token, layer) routes two traces of the same tokens choose
    differently, the widest k-th vs (k+1)-th router probability gap of
    ``b`` among them)."""
    n, widest = 0, 0.0
    for x, y in zip(a.calls, b.calls):
        diff = (x["idx"].cpu() != y["idx"].cpu()).any(-1)
        n += int(diff.sum())
        if bool(diff.any()):
            top = torch.softmax(y["logits"].cpu(), -1).topk(k + 1).values
            widest = max(widest, float((top[:, k - 1] - top[:, k])[diff]
                                       .max()))
    return n, widest


def aux_fp64(torch, trace, mcfg):
    """The summed MoE aux of a trace's records (one forward), recomputed
    in fp64 on the CPU from each MoE layer's router logits and chosen
    experts as they were recorded: ``moe.route``'s load-balance and z
    losses weighted by ``mcfg``'s coefficients."""
    total = 0.0
    for c in trace.calls:
        z = c["logits"].cpu().double()
        e = z.shape[-1]
        assigned = torch.nn.functional.one_hot(c["idx"].cpu(), e).sum(1)
        fe = assigned.double().mean(0) / mcfg.top_k
        balance = e * float((fe * torch.softmax(z, -1).mean(0)).sum())
        z_loss = float((torch.logsumexp(z, -1) ** 2).mean())
        total += mcfg.aux_loss_coef * balance + mcfg.z_loss_coef * z_loss
    return total


def moe_held(torch, tf_trace, gen_trace, b, s, gen, k, tie, tag):
    """The (B, gen) tokens held to the decode-vs-forward bar on a config
    whose capacity drops no pair (checked): those that the forward over
    prompt + generated tokens and the call that decoded them (the prefill
    for the first, a decode step for the others) route to the same experts
    in every MoE layer. A token's first layer whose routes differ must be
    a near-tie there: the forward's k-th and (k+1)-th router probabilities
    within ``tie``. Its later layers then see inputs a whole expert row
    apart, and may route otherwise at any gap. -> (held, the number of
    tokens routed otherwise, the largest gap at a first difference)."""
    n_moe = len(tf_trace.calls)
    dev = tf_trace.calls[0]["idx"].device
    flipped = torch.zeros((b, gen), dtype=torch.bool)
    worst = 0.0
    fpos = (torch.arange(b)[:, None] * (s + gen)
            + (s - 1 + torch.arange(gen))[None]).to(dev)
    last = (torch.arange(b) * s + s - 1).to(dev)
    for layer in range(n_moe):
        f = tf_trace.calls[layer]
        calls = [gen_trace.calls[layer]] + [gen_trace.calls[n_moe * i + layer]
                                            for i in range(1, gen)]
        dropped = sum(int(c["dropped"].sum()) for c in calls + [f])
        check(dropped == 0, f"{tag}: MoE layer {layer} dropped pairs of "
              f"{dropped} tokens")
        d_idx = torch.stack([calls[0]["idx"][last]]
                            + [c["idx"] for c in calls[1:]], 1)
        diff = (f["idx"][fpos] != d_idx).any(-1).cpu()
        first = diff & ~flipped
        if bool(first.any()):
            top = torch.softmax(f["logits"][fpos], -1).topk(k + 1).values
            gap = (top[..., k - 1] - top[..., k]).cpu()
            worst = max(worst, float(gap[first].max()))
        flipped |= diff
    check(worst <= tie, f"{tag}: a token's first route that differs between "
          f"decode and forward lies where the forward's k-th and (k+1)-th "
          f"probabilities are {worst} apart (near-tie bar {tie})")
    return ~flipped, int(flipped.sum()), worst


def cache_bytes(cache):
    """Bytes of the attention caches (K/V, or MLA's latent and rope key;
    the positions left out)."""
    return sum(t.numel() * t.element_size() for c in cache
               for n, t in c.items() if n != "pos")


def phase14(torch, np):
    """MLA and the single-device MoE FFN at full width (slice 10); ->
    (report, the P16_ARCH model on the card, for phase 16)."""
    import contextlib
    import dataclasses
    import gc
    import io

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {}
    totals = dict(nn_search=0, candidate_sweep=0, fused_moment_sweep=0,
                  moment_sweep=0)

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    for arch in P14_ARCHS:
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=P14_LAYERS[arch])
        moe = cfg.ffn == "moe"
        k = cfg.top_k
        tag = f"phase14 {arch}"
        row = out[arch] = dict(layers=cfg.n_layers, full_layers=full.n_layers)

        # (a) weights
        t0 = time.perf_counter()
        tree = lm.init_params_numpy(cfg, 0)
        init_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = lm.params_from_reference(tree, cfg, dev)
        n_params, w_bytes = lm.param_count(model), lm.param_bytes(model)
        check(round(n_params / 1e6, 2) == P14_PARAMS_M[arch], f"{tag} a: "
              f"{n_params} parameters, expected {P14_PARAMS_M[arch]} M")
        wrong = []
        for key, buf in model.named_buffers():
            parts = key.split(".")
            if parts[-2] in ("router", "wuk", "wuv"):
                wrong += [key] if buf.dtype != torch.float32 else []
            elif parts[-2] == "ffn" and parts[-1] in ("wi", "wg", "wo"):
                wrong += [key] if buf.dtype != torch.bfloat16 else []
        check(not wrong, f"{tag} a: the router, wuk and wuv must be fp32 "
              f"and the experts bf16: {wrong[:4]}")
        row["a"] = dict(params=n_params, weight_bytes=w_bytes, init_s=init_s,
                        load_peak_bytes=torch.cuda.max_memory_allocated(dev))
        log(f"{tag} a: {cfg.n_layers} of {full.n_layers} layers, full "
            f"width, {n_params / 1e6:.2f} M parameters, {w_bytes / 1e9:.4f} "
            f"GB on the card (bf16 kernels, table and experts; fp32 norms"
            f"{', router' if moe else ', wuk and wuv'}); numpy init "
            f"{init_s:.1f} s; max_memory_allocated "
            f"{row['a']['load_peak_bytes'] / 1e9:.4f} GB")

        # (b) teacher-forced logits and aux against the JAX reference
        ref = dict(P14_REF[arch], tag=f"{tag} b", tol=P14_TOL[arch],
                   fixed_v=P14_FIXED_V[arch])
        tok = torch.from_numpy(np.random.default_rng(P14_SEED).integers(
            0, cfg.vocab_size, (P12_B, P12_S), dtype=np.int32))
        with MoETrace(torch) as card_trace:
            (logits_card, aux_card), _, launches = counted(
                torch, lambda: lm.forward(model, cfg, tokens=tok.to(dev)))
        add(launches)
        row["b_cuda"] = hold_logits(np, "cuda", logits_card, ref)
        cpu_model = lm.params_from_reference(tree, cfg, "cpu")
        del tree
        t0 = time.perf_counter()
        with MoETrace(torch) as cpu_trace:
            logits_cpu, aux_cpu = lm.forward(cpu_model, cfg, tokens=tok)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        del cpu_model
        gc.collect()
        row["b_cpu"] = hold_logits(np, "cpu", logits_cpu, ref)
        card_vs_cpu = float((logits_card.cpu() - logits_cpu).abs().max())
        row["b_cpu"].update(forward_ms=cpu_ms, card_vs_cpu=card_vs_cpu)
        log(f"{tag} b: card vs the port's CPU path, max |logit diff| over "
            f"all {logits_cpu.numel()} logits {card_vs_cpu:.6f}; the CPU "
            f"forward took {cpu_ms:.0f} ms (host clock)")
        if moe:
            # The card's aux is held on every run three ways: to its fp64
            # recomputation from the router logits and routes the card
            # recorded (its arithmetic); its routes to the CPU path's (a
            # route that differs must be a near-tie); and the CPU path's
            # aux to the reference's. A near-tie flip moves the token's
            # later layers by a whole expert row and the router losses of
            # every MoE layer after it (run DA), so the card's aux is held
            # to the reference's bar too where it routed every token as the
            # CPU path did.
            rtol = P14_AUX_RTOL[arch]
            routes = len(card_trace.calls) * P12_B * P12_S
            flips, widest = route_diffs(torch, card_trace, cpu_trace, k)
            check(widest <= P14_ROUTE_TIE, f"{tag} b: a route differs "
                  f"between the card and the CPU path where the CPU's k-th "
                  f"and (k+1)-th probabilities are {widest} apart (near-tie "
                  f"bar {P14_ROUTE_TIE})")
            mcfg = lm.moe_config(cfg)
            for name, aux, trace in (("cuda", aux_card, card_trace),
                                     ("cpu", aux_cpu, cpu_trace)):
                own = aux_fp64(torch, trace, mcfg)
                own_err = abs(float(aux) - own) / own
                check(own_err <= P14_AUX_FP64_RTOL, f"{tag} b {name}: aux "
                      f"{float(aux)} vs {own} recomputed in fp64 from its "
                      f"own router logits and routes ({own_err:.2e} relative "
                      f"> {P14_AUX_FP64_RTOL})")
                err = abs(float(aux) - ref["aux"]) / ref["aux"]
                row[f"b_{name}"].update(aux=float(aux), aux_rel_err=err,
                                        aux_fp64=own, aux_fp64_rel_err=own_err)
                if name == "cpu" or not flips:
                    check(err <= rtol, f"{tag} b {name}: aux {float(aux)} "
                          f"vs the reference's {ref['aux']} ({err:.2e} "
                          f"relative > {rtol})")
            drops = [int(c["dropped"].sum()) for c in card_trace.calls]
            row["b_routes"] = dict(routes=routes, card_vs_cpu=flips,
                                   widest_flip_gap=widest,
                                   dropped_tokens=drops)
            held = ("held" if not flips else
                    "recorded: the card routed otherwise on near-ties")
            log(f"{tag} b: aux card {float(aux_card):.8f} (its fp64 "
                f"recomputation {row['b_cuda']['aux_fp64_rel_err']:.2e} "
                f"relative, bar {P14_AUX_FP64_RTOL}; the reference's "
                f"{row['b_cuda']['aux_rel_err']:.2e}, {held}), CPU "
                f"{float(aux_cpu):.8f} (fp64 "
                f"{row['b_cpu']['aux_fp64_rel_err']:.2e}; the reference's "
                f"{row['b_cpu']['aux_rel_err']:.2e}), JAX {ref['aux']:.8f} "
                f"(relative bar {rtol}); {flips} of {routes} (token, layer) "
                f"routes differ between the card and the CPU path, each a "
                f"near-tie (widest k-th vs (k+1)-th probability gap "
                f"{widest:.2e}, bar {P14_ROUTE_TIE}); tokens with a dropped "
                f"pair a MoE layer (card) {drops}")
        del logits_card, logits_cpu, card_trace, cpu_trace

        # (c) serving: the launcher's defaults, then 2 x 1024-token prompts
        b_long, s_long, g_long = P14_LONG
        runs = (("b4_p32_g32", serve_launch.prompt_tokens(
            1, 4, 32, cfg.vocab_size), 32),
                (f"b{b_long}_p{s_long}_g{g_long}",
                 np.random.default_rng(P14_SEED + 1).integers(
                     0, cfg.vocab_size, (b_long, s_long), dtype=np.int32),
                 g_long))
        row["c"], served = {}, {}
        for name, prompts, gen in runs:
            prompts = torch.from_numpy(prompts).to(dev)
            b, s = prompts.shape
            engine = Engine(cfg, model, max_len=s + gen, device=dev)
            with MoETrace(torch) as gen_trace:
                (toks, steps), wall, launches = counted(
                    torch, lambda: serve_logits(torch, lm, engine, prompts,
                                                gen))
            add(launches)
            again = Engine(cfg, model, max_len=s + gen, device=dev).generate(
                prompts, gen)
            check(bool(torch.equal(toks, again)), f"{tag} c {name}: two "
                  f"engines gave different tokens")
            served[name] = toks
            # the prefill's records come first, one a MoE layer
            n_moe = len(gen_trace.calls) // gen
            pre_drop = [float(r["dropped_frac"])
                        for r in gen_trace.calls[:n_moe]]
            if moe:
                # every token at the published capacity factor (drops
                # move whole expert rows)...
                tf_logits, _ = lm.forward(model, cfg, tokens=torch.cat(
                    [prompts, toks], dim=1))
                every = float((steps - tf_logits[:, s - 1:-1]).abs().max())
                check(every <= P14_DECODE_ALL_TOL[arch], f"{tag} c {name}: "
                      f"max |decode - forward logit| over every token "
                      f"{every} > {P14_DECODE_ALL_TOL[arch]}")
                del tf_logits, steps
                # ... and each token held to the tight bar on a copy whose
                # capacity (C = T) cannot drop a pair, but for a route that
                # decode and forward choose otherwise on a near-tie
                held_cfg = dataclasses.replace(
                    cfg, capacity_factor=cfg.n_experts / cfg.top_k)
                held_engine = Engine(held_cfg, model, max_len=s + gen,
                                     device=dev)
                with MoETrace(torch) as gen_trace:
                    (toks_h, steps), _, launches = counted(
                        torch, lambda: serve_logits(torch, lm, held_engine,
                                                    prompts, gen))
                add(launches)
                with MoETrace(torch) as tf_trace:
                    tf_logits, _ = lm.forward(model, held_cfg,
                                              tokens=torch.cat(
                                                  [prompts, toks_h], dim=1))
                held, n_flip, worst = moe_held(
                    torch, tf_trace, gen_trace, b, s, gen, k, P14_ROUTE_TIE,
                    f"{tag} c {name}")
                c = teacher_forced(torch, lm, model, held_cfg, name, prompts,
                                   toks_h, steps, tol=P14_DECODE_TOL[arch],
                                   tag=f"{tag} c", logits=tf_logits,
                                   held=held.to(dev))
                c["decode_vs_forward_all"] = every
                log(f"{tag} c {name}: at capacity factor "
                    f"{held_cfg.capacity_factor:.4f} (no pair dropped) "
                    f"decode vs forward held at {int(held.sum())} of "
                    f"{held.numel()} tokens, {n_flip} left out for a route "
                    f"that differs (largest k-th vs (k+1)-th probability "
                    f"gap at a token's first difference {worst:.2e}, bar "
                    f"{P14_ROUTE_TIE}); at the "
                    f"published {cfg.capacity_factor} over every token "
                    f"{every:.6f} (bar {P14_DECODE_ALL_TOL[arch]})")
                del tf_logits, tf_trace, held_engine, toks_h
            else:
                held = torch.ones(toks.shape, dtype=torch.bool)
                n_flip = 0
                c = teacher_forced(torch, lm, model, cfg, name, prompts, toks,
                                   steps, tol=P14_DECODE_TOL[arch],
                                   tag=f"{tag} c")
            del gen_trace
            prefill_ms, step_ms, issue_ms, cache = decode_timing(
                torch, lm, model, cfg, prompts, gen - 1)
            pos = s + gen - 1
            nxt = toks[:, -1]
            kernels, busy, host_launches = device_profile(
                torch, lambda: lm.decode_step(model, cfg, pos, cache,
                                              token=nxt))
            kv_bytes = cache_bytes(cache)
            # every weight read once (the MoE buffer runs every expert), the
            # caches read, the fp32 logits written
            step_bytes = w_bytes + kv_bytes + b * cfg.vocab_size * 4
            bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
            idle = None if busy is None else 1 - busy / step_ms
            c.update(batch=b, prompt=s, gen=gen, wall_ms=wall,
                     tokens_per_s=b * gen / wall * 1e3, prefill_ms=prefill_ms,
                     decode_ms_per_token=step_ms, decode_issue_ms=issue_ms,
                     decode_tokens_per_s=b / step_ms * 1e3,
                     q_block=(bool(cfg.q_block) and s > cfg.q_block
                              and s % cfg.q_block == 0),
                     step_kernels=kernels, step_busy_ms=busy,
                     step_host_launches=host_launches, step_idle=idle,
                     step_bytes=step_bytes, kv_bytes=kv_bytes,
                     step_bound_ms=bound_ms, held=int(held.sum()),
                     left_out_flipped=n_flip,
                     prefill_dropped_frac=pre_drop)
            row["c"][name] = c
            blocks = (f" ({s // cfg.q_block} q_blocks of {cfg.q_block})"
                      if c["q_block"] else "")
            profiled = ("no device activity recorded" if busy is None else
                        f"{busy:.4f} ms busy, idle {idle:.1%}")
            drop = (f" | the prefill's dropped_frac a MoE layer "
                    f"{[round(x, 4) for x in pre_drop]}" if moe else "")
            log(f"{tag} c {name}: B={b} prompt {s}{blocks} gen {gen} | "
                f"generate {wall:.1f} ms wall, {c['tokens_per_s']:.1f} tok/s "
                f"| prefill {prefill_ms:.3f} ms | decode {step_ms:.3f} ms a "
                f"step ({c['decode_tokens_per_s']:.1f} tok/s; the host queues "
                f"a step in {issue_ms:.3f} ms) | one step: {kernels} device "
                f"kernels ({host_launches} host launches), {profiled} | byte "
                f"bound {bound_ms:.4f} ms ({step_bytes / 1e9:.4f} GB: weights "
                f"{w_bytes / 1e9:.4f} GB, caches {kv_bytes / 1e6:.2f} MB), "
                f"{bound_ms / step_ms:.1%} of the step{drop}")
            del cache, steps, engine
        row["c_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        log(f"{tag} c: max_memory_allocated over (a)-(c) "
            f"{row['c_peak_bytes'] / 1e9:.4f} GB")
        if arch == P16_ARCH:  # phase 16 runs its MoE layers again
            kept = model
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # the launcher at its defaults, the config cut to
        # P14_LAUNCH_LAYERS (deepseek-moe-16b at the phase's 4 layers, held
        # to the engine's tokens on the same weights; minicpm3-4b at 8);
        # qwen3-moe-235b-a22b with --smoke (its 94 layers are 470 GB in
        # bf16: no card holds them)
        smoke = arch in P14_LAUNCH_SMOKE
        text = io.StringIO()
        with launch_depth(arch, P14_LAUNCH_LAYERS.get(arch)) as launch_cfg, \
                contextlib.redirect_stdout(text):
            if smoke:
                launch_cfg = get_smoke(arch)
            launched, wall, launches = counted(
                torch, lambda: serve_launch.main(
                    ["--arch", arch, "--device", "cuda:0"]
                    + (["--smoke"] if smoke else [])))
        add(launches)
        lines = [ln for ln in text.getvalue().splitlines() if "tok/s" in ln]
        check(len(lines) == 1, f"{tag} launcher: no tok/s line in "
              f"{text.getvalue()!r}")
        check(tuple(launched.shape) == (4, 32) and int(launched.min()) >= 0
              and int(launched.max()) < launch_cfg.vocab_size, f"{tag} "
              f"launcher: bad tokens {tuple(launched.shape)}")
        if launch_cfg.n_layers == cfg.n_layers and not smoke:
            check(bool(torch.equal(launched, served["b4_p32_g32"])),
                  f"{tag} launcher: its tokens differ from the engine's on "
                  f"the same weights and prompts")
        row["launcher"] = dict(line=lines[0], wall_ms=wall,
                               layers=launch_cfg.n_layers, smoke=smoke)
        log(f"{tag} launcher (repro_torch.launch.serve --arch {arch}"
            f"{' --smoke' if smoke else ''}, {launch_cfg.n_layers} layers): "
            f"{lines[0].strip()} | {wall:.0f} ms with its weight init")
        del launched
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{tag}: {time.perf_counter() - t_arch:.1f} s")
    out["launch_totals"] = totals
    check(sum(totals.values()) == 0, f"phase14: the MLA / MoE LM path "
          f"launched port kernels {totals}")
    log(f"phase14: {time.perf_counter() - t_phase:.1f} s")
    return out, kept


# Slice 11: the LM training path at qwen2-0.5b's full width and depth
# (494.03 M parameters as fp32 nn.Parameters from lm.init_params_numpy(cfg,
# 0), the reference's masters), on 2 x 64 tokens from
# np.random.default_rng(P15_SEED) (p15_batch). (a) holds three AdamW steps
# of make_train_step (cosine_schedule(3e-4, 20, 21), remat "none", the same
# batch each step) and two Adafactor steps to a JAX CPU run of the
# reference on the same numpy weights (about 60 s and 14 GB on an 8-core
# CPU host): each step's loss, step 1's global gradient norm, and the
# parameters after the last step at 168 coordinates, the 12 largest
# |step-1 gradient| entries of each of P15_LEAVES (p15_coords):
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python -c "import jax, numpy as np
#   from chip_smoke import *; from repro.configs import get_config
#   from repro.models import lm; from repro.optim import (adamw,
#       adafactor, clip_by_global_norm, cosine_schedule)
#   from repro.train.train_step import TrainState, make_train_step
#   from repro_torch.models.lm import init_params_numpy
#   cfg = get_config(P15_ARCH); p = init_params_numpy(cfg, 0)
#   b = p15_batch(np, cfg.vocab_size)
#   g = jax.jit(jax.grad(lambda p, b: lm.loss_fn(p, cfg, b)[0]))(p, b)
#   c = p15_coords(np, g); print(float(clip_by_global_norm(g, 1.0)[1]), c)
#   for opt, n in ((adamw, 3), (adafactor, 2)):
#       o = opt(cosine_schedule(*P15_LR)); s = TrainState(p, o.init(p))
#       f = jax.jit(make_train_step(cfg, o, remat='none')); ls = []
#       for i in range(n): s, m = f(s, b); ls.append(float(m['loss']))
#       print(ls, [p15_value(np, s.params, k) for k in c])"
P15_ARCH = "qwen2-0.5b"
P15_SEED = 15
P15_B, P15_S = 2, 64
P15_LR = (3e-4, 20, 21)   # cosine_schedule(peak, warmup, total)
P15_PARAMS_M = 494.03
# the reference leaves whose coordinates are held: (path, repeat)
P15_LEAVES = ((("embed", "table"), None), (("final_norm", "scale"), None)) \
    + tuple((("groups", "0") + leaf, r) for r in (0, 12, 23)
            for leaf in (("mixer_norm", "scale"), ("mixer", "wq", "kernel"),
                         ("mixer", "wv", "bias"), ("ffn", "wg", "kernel")))
P15_PER_LEAF = 12


def p15_batch(np, vocab_size, b=P15_B, s=P15_S, seed=P15_SEED):
    """The (b, s) inputs and next-token labels of phase 15, as numpy."""
    toks = np.random.default_rng(seed).integers(0, vocab_size, (b, s + 1),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _p15_leaf(np, tree, key):
    path, r = key
    leaf = tree
    for k in path:
        leaf = leaf[k]
    leaf = np.asarray(leaf)
    return leaf if r is None else leaf[r]


def p15_coords(np, grads, leaves=P15_LEAVES, per_leaf=P15_PER_LEAF):
    """The held coordinates, ((path, repeat), flat index) each: the
    ``per_leaf`` largest |gradient| entries of each leaf of the reference
    tree ``grads`` (first index on ties)."""
    out = []
    for key in leaves:
        g = np.abs(_p15_leaf(np, grads, key).ravel())
        out += [(key, int(i)) for i in np.argsort(-g, kind="stable")[
            :per_leaf]]
    return out


def p15_value(np, params, coord):
    """A reference tree's value at a held coordinate, as a float."""
    key, i = coord
    return float(_p15_leaf(np, params, key).ravel()[i])


# from the JAX run above: step 1's global gradient norm, each leaf's 12
# coordinates (flat indices, largest |gradient| first), each step's loss
# and the parameters at the coordinates after the last step
P15_REF_GNORM = 18.880964279174805
P15_COORD_IDX = (
    (10257344, 126771931, 10256538, 126771588, 126772284, 126772204,
     10257012, 126772067, 10256572, 10257001, 126771596, 126771688),
    (550, 649, 492, 32, 418, 194, 27, 413, 408, 192, 376, 539),
    (818, 500, 147, 77, 828, 758, 523, 608, 160, 103, 622, 395),
    (368388, 479457, 480356, 431073, 383356, 798401, 607553, 431091,
     742546, 5491, 423905, 690931),
    (121, 51, 55, 52, 85, 50, 99, 48, 112, 103, 56, 123),
    (1319082, 2126506, 1322768, 2234435, 1319888, 1849258, 1852944,
     2132291, 2233514, 3022403, 2131370, 3727494),
    (373, 591, 183, 399, 396, 873, 504, 368, 790, 712, 262, 195),
    (208837, 778566, 208852, 209048, 490069, 209621, 329797, 335911,
     354904, 467800, 530374, 65350),
    (126, 93, 63, 87, 23, 119, 62, 44, 11, 122, 124, 98),
    (1470783, 2455944, 1136956, 2875487, 2455100, 3282824, 1469791,
     1137800, 2835336, 2660232, 2898592, 1794440),
    (183, 373, 431, 317, 564, 356, 766, 489, 579, 653, 839, 595),
    (650662, 699046, 337958, 187430, 354982, 422036, 493054, 650664,
     492968, 112166, 492990, 800133),
    (82, 97, 12, 119, 47, 112, 10, 18, 49, 21, 17, 42),
    (1020262, 3534950, 2676640, 2294630, 2951270, 3797606, 2678886,
     1295264, 1049446, 2304358, 1929830, 2703206),
)
P15_REF_ADAMW_LOSS = (
    12.116260528564453, 10.851802825927734, 9.648012161254883)
P15_REF_ADAMW = (
    0.029179884120821953, 0.01872286945581436, -0.030722619965672493,
    -0.004759158939123154, 0.01524401269853115, 0.014004879631102085,
    -0.015515485778450966, 0.013515650294721127, 0.030573323369026184,
    -0.02826586738228798, 0.03244776278734207, 0.021298594772815704,
    0.9999204874038696, 0.9999234676361084, 0.9999179840087891,
    0.999910831451416, 0.9999191164970398, 0.9999168515205383,
    0.9999207258224487, 1.0000793933868408, 0.9999556541442871,
    0.9999393820762634, 0.9999328851699829, 0.9999243021011353,
    0.9999732375144958, 1.000030279159546, 0.9999156594276428,
    1.0000169277191162, 1.000002384185791, 0.9999379515647888,
    0.9999553561210632, 0.9999482035636902, 1.000013828277588,
    1.0000391006469727, 1.0000362396240234, 1.0000269412994385,
    0.023787539452314377, -0.02744564414024353, 0.029193280264735222,
    -0.007286264095455408, -0.023612448945641518, 0.023240407928824425,
    0.00432141637429595, 0.014842319302260876, -0.041749875992536545,
    -0.003114615799859166, 0.026205509901046753, -0.010724596679210663,
    -4.4536780478665605e-05, 7.778999133734033e-05, -4.2143718019360676e-05,
    5.0571939937071875e-05, -4.04856946261134e-05, -1.4178022865962703e-05,
    -3.0455761589109898e-05, 2.7925865651923232e-05, -5.930688348598778e-05,
    6.828452023910359e-05, 1.4463988918578252e-05, -1.5212381185847335e-06,
    -0.01728910394012928, 0.02963349036872387, 0.01285848394036293,
    -0.005479223094880581, -0.015473423525691032, 0.028178302571177483,
    0.0018228853587061167, 0.016380675137043, -0.005137030966579914,
    -0.025674136355519295, 0.03064044564962387, -0.010140033438801765,
    1.0000183582305908, 1.0000633001327515, 1.000024676322937,
    1.0000635385513306, 0.9999265074729919, 1.000060796737671,
    1.0000585317611694, 1.000069499015808, 1.0000654458999634,
    1.0000420808792114, 1.0000426769256592, 1.0000594854354858,
    0.016410237178206444, -0.011607196182012558, -0.004009698983281851,
    0.0031344261951744556, -0.06189674139022827, -0.008571532554924488,
    -0.011071871966123581, 0.038189489394426346, -0.013880059123039246,
    -0.014760195277631283, 0.002871483564376831, -0.0021213674917817116,
    7.044543599477038e-05, -4.4429216359276325e-05, 3.56302443833556e-05,
    -5.5895285186124966e-05, 6.871418008813635e-05, -7.612175977556035e-05,
    8.177892595995218e-05, -3.953366558562266e-06, 5.8482535678194836e-05,
    5.783556844107807e-05, 7.082697993610054e-05, 5.200112354941666e-05,
    -0.005307108163833618, -0.004129640758037567, -0.004319444764405489,
    0.007876146584749222, -0.0010596831561997533, -0.0027575697749853134,
    0.00021122554608155042, -0.024772724136710167, 0.013796964660286903,
    -0.013756856322288513, -0.003911884967237711, -0.016020482406020164,
    0.9999147653579712, 1.0000706911087036, 1.0000780820846558,
    0.9999052286148071, 1.0000780820846558, 0.9999063014984131,
    1.000075101852417, 0.9999058246612549, 0.999903678894043,
    1.0000602006912231, 1.000074028968811, 1.0000736713409424,
    -0.011322728358209133, -0.01239236444234848, -0.04121202602982521,
    0.007391113787889481, -0.04514831304550171, 0.012361523695290089,
    -0.020265521481633186, 0.034566644579172134, -0.000360170379281044,
    -0.00804662611335516, -0.005162383429706097, 0.056461647152900696,
    -8.660133607918397e-05, 8.06402022135444e-05, -8.910362521419302e-05,
    8.510464977007359e-05, -7.762322638882324e-05, -7.609633757965639e-05,
    8.385646651731804e-05, 8.219457231462002e-05, 7.109862781362608e-05,
    -8.655458805151284e-05, -8.528398757334799e-05, 8.843657997203991e-05,
    0.044721029698848724, 0.02159261144697666, 0.015505507588386536,
    -0.011157973669469357, -0.0029533158522099257, 0.0007653613574802876,
    0.04745841771364212, -0.002992043038830161, 0.030611742287874222,
    0.0020761750638484955, -0.009479416534304619, 0.011097053997218609)
P15_REF_ADAFACTOR_LOSS = (
    12.116260528564453, 10.733209609985352)
P15_REF_ADAFACTOR = (
    0.02914145402610302, 0.018701286986470222, -0.030751410871744156,
    -0.004730070475488901, 0.015210096724331379, 0.014042963273823261,
    -0.015487810596823692, 0.013551332987844944, 0.030536675825715065,
    -0.028294401243329048, 0.03248322010040283, 0.021256914362311363,
    0.9999703168869019, 0.9999695420265198, 0.9999706745147705,
    0.9999677538871765, 0.9999693036079407, 0.9999681115150452,
    0.99997478723526, 1.0000427961349487, 0.9999964237213135,
    0.9999885559082031, 0.9999780654907227, 0.9999711513519287,
    1.0000123977661133, 1.000008463859558, 0.9999793171882629,
    0.9999843239784241, 0.9999844431877136, 0.9999842047691345,
    1.0000025033950806, 0.9999757409095764, 0.9999954700469971,
    1.000011920928955, 1.0000026226043701, 1.0000107288360596,
    0.02374986931681633, -0.02746659331023693, 0.02921593002974987,
    -0.007309694308787584, -0.023542286828160286, 0.023277344182133675,
    0.004274255596101284, 0.014884617179632187, -0.041783418506383896,
    -0.0030763749964535236, 0.026162119582295418, -0.010702521540224552,
    2.06580875783402e-06, 1.1328666914778296e-05, -8.800670343589445e-07,
    4.761354830407072e-06, 4.674654064729111e-06, 1.3541321095544845e-05,
    1.0788888175738975e-05, -1.1354150046827272e-05, -6.791398845962249e-06,
    6.243013558560051e-06, -4.903086392005207e-06, -1.196011362480931e-05,
    -0.01725086383521557, 0.029595371335744858, 0.012892919592559338,
    -0.005435403902083635, -0.015521317720413208, 0.028215259313583374,
    0.0018558010924607515, 0.016338419169187546, -0.0051030381582677364,
    -0.025712957605719566, 0.030607955530285835, -0.01018062699586153,
    0.9999865293502808, 1.0001362562179565, 0.9999849796295166,
    1.0000816583633423, 0.9999396204948425, 1.000052809715271,
    1.0000419616699219, 1.0001118183135986, 1.0000381469726562,
    1.0000367164611816, 1.0000147819519043, 1.0000766515731812,
    0.01638783887028694, -0.011626423336565495, -0.004038384649902582,
    0.003104447154328227, -0.0619342066347599, -0.008604039438068867,
    -0.011065622791647911, 0.03819209337234497, -0.013874482363462448,
    -0.014742781408131123, 0.0028998476918786764, -0.002147042891010642,
    8.164076280081645e-05, 4.534340860118391e-06, 2.747952748904936e-05,
    -2.8974813176319003e-05, 8.936050107877236e-06, -0.00014845245459582657,
    7.012527930783108e-05, 5.610317657556152e-06, 4.9440310249337927e-05,
    2.5316698156530038e-05, 5.736846651416272e-05, 1.7518272215966135e-05,
    -0.005308075342327356, -0.004116279538720846, -0.004350943956524134,
    0.007854224182665348, -0.0010827697115018964, -0.0027641223277896643,
    0.00018963859474752098, -0.024745438247919083, 0.013782952912151814,
    -0.013734702952206135, -0.0038923704996705055, -0.016034869477152824,
    0.9998160004615784, 1.0001120567321777, 1.0002323389053345,
    0.9998921751976013, 1.0002477169036865, 0.999845564365387,
    1.0001107454299927, 0.9998258948326111, 0.9998242855072021,
    1.0000916719436646, 1.0001095533370972, 1.0001306533813477,
    -0.011306576430797577, -0.012368608266115189, -0.0412350669503212,
    0.007369601167738438, -0.04517911747097969, 0.01239690463989973,
    -0.020239273086190224, 0.03457864373922348, -0.00033754276228137314,
    -0.008038333617150784, -0.0051452419720590115, 0.056490328162908554,
    -5.321912612998858e-05, 5.1756305765593424e-05, -9.009832137962803e-05,
    0.0001808690867619589, -3.938492955057882e-05, -3.0339302611537278e-05,
    9.126587974606082e-05, 8.940177212934941e-05, 4.7290202928707004e-05,
    -3.320068935863674e-05, -0.00013675786613021046, 8.46391121740453e-05,
    0.04469246789813042, 0.021626070141792297, 0.015481275506317616,
    -0.011195817962288857, -0.002988184103742242, 0.0008027192670851946,
    0.04749862104654312, -0.002992612775415182, 0.030578993260860443,
    0.002099280245602131, -0.009520160034298897, 0.011066213250160217)
P15_REF = {"adamw": (P15_REF_ADAMW_LOSS, P15_REF_ADAMW),
           "adafactor": (P15_REF_ADAFACTOR_LOSS, P15_REF_ADAFACTOR)}


# Bars, fixed before the first card run from the port's CPU path on the
# same weights and batch against these constants (2-11 s a step and ~12 GB
# on an 8-core CPU host):
#   PYTHONPATH=src:. python -c "import numpy as np, torch
#   from chip_smoke import *; from repro_torch.configs import get_config
#   from repro_torch.models import lm; from repro_torch.optim import (
#       adamw, adafactor, cosine_schedule)
#   from repro_torch.train import train_step as ts
#   cfg = get_config(P15_ARCH); tree = lm.init_params_numpy(cfg, 0)
#   cpu = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
#   for opt, n in ((adamw, 3), (adafactor, 2)):
#       st, ls, g = p15_train(torch, lm, ts, opt(cosine_schedule(*P15_LR)),
#           cfg, tree, 'cpu', cpu(p15_batch(np, cfg.vocab_size)), n)
#       print(ls, g, p15_port_values(lm, cfg, st.params, p15_coord_list()))
#   for accum in (1, 2):
#       st, ls, g = p15_train(torch, lm, ts, adamw(cosine_schedule(
#           *P15_LR)), cfg, tree, 'cpu', cpu(p15_batch(np, cfg.vocab_size,
#           4)), 1, accum=accum); print(ls, g)"
# (the worst leaf of the accumulation from the two runs' p.grad / accum).
# It read: AdamW losses 6.2e-4, 7.0e-4, 6.4e-3 from the JAX run,
# Adafactor's 6.2e-4, 6.1e-4; step 1's gradient norm 1.13e-3 relative;
# the coordinates 1.9e-6 (AdamW) and 1.3e-5 (Adafactor); accum_steps=2
# on 4 x 64 against accum_steps=1: loss 1.9e-6, gradient norm 2.5e-4
# relative, the worst leaf 1.9e-2 relative L2. Each bar is about twice
# its reading. The smoke-size block kinds (d) are held card against CPU
# within the CPU tests' bars against the reference
# (tests/_torch_train_ref.py): losses 2e-3, gradient norm 2e-3 relative.
P15_LOSS_TOL = {"adamw": 1.3e-2, "adafactor": 1.3e-3}
P15_GNORM_RTOL = 2.3e-3
P15_COORD_TOL = {"adamw": 4e-6, "adafactor": 2.6e-5}
P15_ACCUM_LOSS_TOL = 4e-6
P15_ACCUM_GNORM_RTOL = 5e-4
P15_ACCUM_LEAF_RTOL = 4e-2
P15_SMOKE = {"mamba2-780m": ("adamw",), "recurrentgemma-9b": ("adamw",),
             "minicpm3-4b": ("adamw",), "deepseek-moe-16b": ("adamw",),
             "qwen3-moe-235b-a22b": ("adamw", "adafactor")}
P15_SMOKE_LOSS_TOL = 2e-3
P15_SMOKE_GNORM_RTOL = 2e-3


def p15_coord_list():
    """The held coordinates, ((path, repeat), flat index) each, in the
    order of the pasted values."""
    return [(key, i) for key, idx in zip(P15_LEAVES, P15_COORD_IDX)
            for i in idx]


def p15_state_bits(torch, state):
    """The state's parameters, gradients and optimizer tensors, by name."""
    out = {f"p:{n}": p.detach() for n, p in state.params.named_parameters()}
    out.update({f"g:{n}": p.grad for n, p in
                state.params.named_parameters() if p.grad is not None})

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        else:
            out[f"s:{path}"] = node
    walk(state.opt_state.inner, "")
    return out


def p15_diff(torch, a, b):
    """Names whose tensors differ in a bit (or are missing) between two
    :func:`p15_state_bits` dicts."""
    return [k for k in a if k not in b or not bits_equal(torch, a[k], b[k])]


def p15_rel(torch, ref, got):
    return float((got.double() - ref.double()).norm()
                 / ref.double().norm().clamp_min(1e-30))


def p15_train(torch, lm, ts, opt, cfg, tree, dev, batch, steps, remat="none",
              accum=1, on_step=None):
    """``steps`` steps of ``make_train_step`` from fresh fp32 masters of
    ``tree`` on ``batch`` each step: -> (state, losses, step 1's global
    gradient norm). ``on_step(i, state)`` runs after step i."""
    from repro_torch.optim import clip_by_global_norm
    model = lm.params_from_reference(tree, cfg, dev, trainable=True)
    state = ts.TrainState(model, opt.init(model))
    step = ts.make_train_step(cfg, opt, remat=remat, accum_steps=accum)
    losses, gnorm = [], None
    for i in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            gnorm = float(clip_by_global_norm(
                {n: p.grad / accum for n, p in model.named_parameters()},
                1.0)[1])
        if on_step is not None:
            on_step(i, state)
    return state, losses, gnorm


def p15_port_values(lm, cfg, model, coords):
    """The model's parameters at the held coordinates (the reference's
    (path, repeat) mapped to the port's parameter by
    ``lm.reference_layout``), as floats."""
    names = {path: ns for path, ns, _ in lm.reference_layout(cfg)}
    return [model.get_parameter(names[path][r or 0]).detach().reshape(-1)[
        i].item() for (path, r), i in coords]


def p15_bound_ms(n_params, cfg, b, s):
    """(ms, FLOPs, bytes) of a train step's least time: the forward and
    backward products (6 x parameters x tokens, and attention's scores and
    values, 3 x 4 x S² x heads x d_head a sequence a layer) at the bf16
    dense peak, plus AdamW's bytes (read p, g, m, v; write p, m, v: 28
    bytes a parameter) at HBM peak."""
    tokens = b * s
    flops = (6 * n_params * tokens
             + 12 * b * s * s * cfg.n_heads * cfg.d_head * cfg.n_layers)
    nbytes = 28 * n_params
    return (flops / PEAK_BF16_FLOPS + nbytes / PEAK_BYTES_PER_S) * 1e3, \
        flops, nbytes


def p15_held(np, tag, name, losses, gnorm, values):
    """Losses, step 1's gradient norm and the held coordinates of optimizer
    ``name``'s run against the pasted JAX run, within the phase's bars;
    -> the readings."""
    ref_losses, ref_values = P15_REF[name]
    loss_tol, coord_tol = P15_LOSS_TOL[name], P15_COORD_TOL[name]
    loss = max(abs(a - r) for a, r in zip(losses, ref_losses))
    grel = abs(gnorm - P15_REF_GNORM) / P15_REF_GNORM
    coord = max(abs(a - r) for a, r in zip(values, ref_values))
    log(f"{tag}: losses {losses} (JAX {list(ref_losses)}), max |diff| "
        f"{loss:.3e} (bar {loss_tol}); step-1 gradient norm {gnorm:.6f} "
        f"(JAX {P15_REF_GNORM:.6f}), {grel:.3e} relative (bar "
        f"{P15_GNORM_RTOL}); {len(values)} coordinates, max |diff| "
        f"{coord:.3e} (bar {coord_tol})")
    check(loss <= loss_tol, f"{tag}: loss {loss} from the JAX run")
    check(grel <= P15_GNORM_RTOL, f"{tag}: gradient norm {grel} relative")
    check(coord <= coord_tol, f"{tag}: coordinates {coord}")
    return dict(losses=losses, gnorm=gnorm, loss_diff=loss, gnorm_rel=grel,
                coord_diff=coord)


def phase15(torch, np):
    """The LM training path at full width (slice 11)."""
    import contextlib
    import gc
    import io
    import os
    import shutil

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as train_launch
    from repro_torch.models import lm
    from repro_torch.optim import adafactor, adamw, cosine_schedule
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_step as ts

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {}
    totals = dict(nn_search=0, candidate_sweep=0, fused_moment_sweep=0,
                  moment_sweep=0)

    def run(fn):
        """``fn()`` with every kernel count set to 0 just before it and
        read just after, added to the phase's totals."""
        result, wall_ms, launches = counted(torch, fn)
        for k, v in launches.items():
            totals[k] += v
        return result, wall_ms

    scratch = ROOT / "build" / f"p15_{os.getpid()}"
    shutil.rmtree(scratch, ignore_errors=True)
    try:
        cfg = get_config(P15_ARCH)
        lr = cosine_schedule(*P15_LR)
        coords = p15_coord_list()
        tag = "phase15"

        # (a) the weights: the serving model's logits, then fp32 masters
        t0 = time.perf_counter()
        tree = lm.init_params_numpy(cfg, 0)
        init_s = time.perf_counter() - t0
        host = p15_batch(np, cfg.vocab_size)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        serve = lm.params_from_reference(tree, cfg, dev)
        (logits_serve, _), _ = run(lambda: lm.forward(
            serve, cfg, tokens=batch["tokens"]))
        del serve
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        model = lm.params_from_reference(tree, cfg, dev, trainable=True)
        n_params = lm.param_count(model)
        check(round(n_params / 1e6, 2) == P15_PARAMS_M,
              f"{tag} a: {n_params} parameters, expected {P15_PARAMS_M} M")
        check(all(isinstance(p, torch.nn.Parameter)
                  and p.dtype == torch.float32 for p in model.parameters())
              and not list(model.buffers()),
              f"{tag} a: every leaf must be an fp32 nn.Parameter")
        (logits_train, _), _ = run(lambda: lm.forward(
            model, cfg, tokens=batch["tokens"]))
        check(bits_equal(torch, logits_serve, logits_train.detach()),
              f"{tag} a: the trainable model's logits must be the serving "
              "model's bits")
        del model, logits_train, logits_serve
        gc.collect()
        p_bytes = 4 * n_params
        row = out["a"] = dict(params=n_params, param_bytes=p_bytes,
                              grad_bytes=p_bytes, adamw_bytes=2 * p_bytes,
                              init_s=init_s)

        # (a), (c): three AdamW steps, the state saved after step 2
        saved = {}

        def after(i, state):
            if i == 1:
                t1 = time.perf_counter()
                ckpt.save(scratch / "ckpt", state, step=2)
                saved["save_s"] = time.perf_counter() - t1
                saved["bytes"] = sum(
                    f.stat().st_size for f in (scratch / "ckpt").rglob("*")
                    if f.is_file())
        torch.cuda.reset_peak_memory_stats(dev)
        opt = adamw(lr)
        (state, losses, gnorm), wall_ms = run(lambda: p15_train(
            torch, lm, ts, opt, cfg, tree, dev, batch, 3, on_step=after))
        row["train_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        values = p15_port_values(lm, cfg, state.params, coords)
        row["adamw"] = p15_held(np, f"{tag} a adamw", "adamw", losses,
                                gnorm, values)
        log(f"{tag} a: {cfg.n_layers} layers, full width, {n_params / 1e6:.2f}"
            f" M fp32 parameters: {p_bytes / 1e9:.4f} GB, gradients "
            f"{p_bytes / 1e9:.4f} GB, AdamW m + v {2 * p_bytes / 1e9:.4f} GB; "
            f"numpy init {init_s:.1f} s; max_memory_allocated over three "
            f"steps {row['train_peak_bytes'] / 1e9:.4f} GB; the trainable "
            f"model's logits the serving model's bits; 3 steps "
            f"{wall_ms:.0f} ms wall (with the checkpoint)")
        bits_a = p15_state_bits(torch, state)

        # (c) determinism: the same three steps again, the same bits
        (again, _, _), _ = run(lambda: p15_train(
            torch, lm, ts, opt, cfg, tree, dev, batch, 3))
        differ = p15_diff(torch, bits_a, p15_state_bits(torch, again))
        check(not differ, f"{tag} c: a second run differs in {differ[:4]}")
        del again
        gc.collect()
        # (c) resume: step 3 from the checkpoint of step 2
        t1 = time.perf_counter()
        restored, step_at, _ = ckpt.restore(
            scratch / "ckpt", ts.abstract_state(cfg, opt), device=dev)
        restore_s = time.perf_counter() - t1
        check(step_at == 2 and restored.opt_state.step == 2,
              f"{tag} c: restored step {step_at}")
        step_fn = ts.make_train_step(cfg, opt, remat="none")
        (resumed, _), _ = run(lambda: step_fn(restored, batch))
        differ = p15_diff(torch, bits_a, p15_state_bits(torch, resumed))
        check(not differ, f"{tag} c: step 3 from the checkpoint differs in "
              f"{differ[:4]}")
        del restored, resumed, bits_a
        shutil.rmtree(scratch / "ckpt")
        gc.collect()
        out["c"] = dict(save_s=saved["save_s"], restore_s=restore_s,
                        ckpt_bytes=saved["bytes"])
        log(f"{tag} c: a second run of the three steps the same bits "
            f"(parameters, gradients, m, v); the TrainState saved after "
            f"step 2 ({saved['bytes'] / 1e9:.3f} GB, {saved['save_s']:.1f} s)"
            f" and restored onto ts.abstract_state ({restore_s:.1f} s): step "
            "3 from it the uninterrupted step 3's bits")

        # (a) timing: the step on the device, and its bound
        timing = out["timing"] = {}
        for b, s in ((P15_B, P15_S), (8, 128)):
            tb = {k: torch.from_numpy(v).to(dev) for k, v in
                  p15_batch(np, cfg.vocab_size, b, s).items()}
            times = []
            for i in range(6):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                start.record()
                state, _ = step_fn(state, tb)
                host_ms = (time.perf_counter() - t1) * 1e3
                end.record()
                end.synchronize()
                if i:  # the first at a new shape is a warm-up
                    times.append((start.elapsed_time(end), host_ms))
            step_ms = statistics.median(t for t, _ in times)
            issue_ms = statistics.median(h for _, h in times)
            kernels, busy, _ = device_profile(torch, lambda: step_fn(
                state, tb))
            bound_ms, flops, nbytes = p15_bound_ms(n_params, cfg, b, s)
            idle = None if busy is None else 1 - busy / step_ms
            timing[f"{b}x{s}"] = dict(
                step_ms=step_ms, host_issue_ms=issue_ms,
                tokens_per_s=b * s / step_ms * 1e3, kernels=kernels,
                busy_ms=busy, idle=idle, bound_ms=bound_ms, flops=flops,
                bytes=nbytes)
            log(f"{tag} a timing {b} x {s}: step {step_ms:.3f} ms (CUDA "
                f"events, median of 5), the host issues it in "
                f"{issue_ms:.3f} ms, {b * s / step_ms * 1e3:.0f} tokens/s; "
                f"{kernels} device kernels, busy {busy} ms, idle "
                f"{'n/a' if idle is None else f'{idle:.1%}'}; bound "
                f"{bound_ms:.4f} ms ({flops / 1e12:.3f} TFLOP at "
                f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s + {nbytes / 1e9:.2f} "
                f"GB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
        del state, step_fn
        gc.collect()

        # (a) Adafactor, on the stacked layout (24 repeats)
        (state, losses, gnorm), _ = run(lambda: p15_train(
            torch, lm, ts, adafactor(lr), cfg, tree, dev, batch, 2))
        check(state.opt_state.inner["groups/0/mixer_norm/scale"]["vr"].shape
              == (cfg.n_layers,), f"{tag} a: Adafactor must factor the "
              "stacked norm scale")
        values = p15_port_values(lm, cfg, state.params, coords)
        row["adafactor"] = p15_held(np, f"{tag} a adafactor", "adafactor",
                                    losses, gnorm, values)
        del state
        gc.collect()

        # (b) remat: full and dots give none's bits; each mode's peak
        remat = out["b"] = {}
        base = None
        for mode in ("none", "full", "dots"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)  # none's bits, kept
            (state, losses, _), _ = run(lambda: p15_train(
                torch, lm, ts, adamw(lr), cfg, tree, dev, batch, 1,
                remat=mode))
            remat[mode] = dict(peak_bytes=torch.cuda.max_memory_allocated(
                dev) - held, loss=losses[0])
            bits = p15_state_bits(torch, state)
            if base is None:
                base = bits
            else:
                differ = p15_diff(torch, base, bits)
                check(not differ, f"{tag} b: remat {mode!r} differs from "
                      f"'none' in {differ[:4]}")
            del state, bits
            gc.collect()
        del base
        log(f"{tag} b: remat 'full' and 'dots' give 'none''s loss, gradients "
            f"and parameters bit for bit; peak memory of a fresh state's "
            f"step (above what was allocated before it) none / full / dots "
            + " / ".join(f"{remat[m]['peak_bytes'] / 1e9:.4f}"
                         for m in remat) + " GB")
        # (b) accumulation: accum_steps=2 on 4 x 64 against one batch
        b4 = {k: torch.from_numpy(v).to(dev) for k, v in
              p15_batch(np, cfg.vocab_size, 4).items()}
        got = {}
        for accum in (1, 2):
            (state, losses, gnorm), _ = run(lambda: p15_train(
                torch, lm, ts, adamw(lr), cfg, tree, dev, b4, 1,
                accum=accum))
            got[accum] = (losses[0], gnorm, {
                n: p.grad / accum for n, p in
                state.params.named_parameters()})
            del state
            gc.collect()
        loss_d = abs(got[1][0] - got[2][0])
        grel = abs(got[1][1] - got[2][1]) / got[1][1]
        leaf = max(p15_rel(torch, got[1][2][n], got[2][2][n])
                   for n in got[1][2])
        del got
        gc.collect()
        remat["accum"] = dict(loss_diff=loss_d, gnorm_rel=grel,
                              leaf_rel=leaf)
        log(f"{tag} b: accum_steps=2 on 4 x 64 against accum_steps=1: loss "
            f"{loss_d:.3e} (bar {P15_ACCUM_LOSS_TOL}), gradient norm "
            f"{grel:.3e} (bar {P15_ACCUM_GNORM_RTOL}), worst leaf "
            f"{leaf:.3e} relative L2 (bar {P15_ACCUM_LEAF_RTOL})")
        check(loss_d <= P15_ACCUM_LOSS_TOL and grel <= P15_ACCUM_GNORM_RTOL
              and leaf <= P15_ACCUM_LEAF_RTOL, f"{tag} b: accumulation")
        del tree
        gc.collect()

        # (d) every other block kind at smoke size: card against CPU
        kinds = out["d"] = {}
        for arch, names in P15_SMOKE.items():
            scfg = get_smoke(arch)
            stree = lm.init_params_numpy(scfg, 0)
            sb = p15_batch(np, scfg.vocab_size, 2, 32, seed=P15_SEED)
            for name in names:
                make = {"adamw": adamw, "adafactor": adafactor}[name]
                res = {}
                for where in ("cpu", "cuda", "cuda again"):
                    d = torch.device("cpu") if where == "cpu" else dev
                    bd = {k: torch.from_numpy(v).to(d) for k, v in sb.items()}
                    (st, losses, gnorm), _ = run(lambda: p15_train(
                        torch, lm, ts, make(lr), scfg, stree, d, bd, 3))
                    res[where] = (losses, gnorm, {
                        k: v.cpu() for k, v in
                        p15_state_bits(torch, st).items()})
                loss_d = max(abs(a - b) for a, b in zip(res["cpu"][0],
                                                        res["cuda"][0]))
                grel = abs(res["cpu"][1] - res["cuda"][1]) / res["cpu"][1]
                differ = p15_diff(torch, res["cuda"][2], res["cuda again"][2])
                kinds[f"{arch} {name}"] = dict(loss_diff=loss_d,
                                               gnorm_rel=grel)
                log(f"{tag} d {arch} ({name}, 3 steps of 2 x 32): card vs "
                    f"CPU loss {loss_d:.3e} (bar {P15_SMOKE_LOSS_TOL}), "
                    f"step-1 gradient norm {grel:.3e} relative (bar "
                    f"{P15_SMOKE_GNORM_RTOL}); two card runs the same bits")
                check(loss_d <= P15_SMOKE_LOSS_TOL
                      and grel <= P15_SMOKE_GNORM_RTOL,
                      f"{tag} d {arch} {name}: card vs CPU")
                check(not differ, f"{tag} d {arch} {name}: two card runs "
                      f"differ in {differ[:4]}")

        # (e) the launcher at its defaults, the smoke resume, the example
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            losses, wall_ms = run(lambda: train_launch.main([]))
        lines = text.getvalue().splitlines()
        for line in lines:
            log(f"{tag} e launcher: {line}")
        check(len(losses) == 100 and losses[-1] < losses[0],
              f"{tag} e: the launcher's loss must fall ({losses[:1]} -> "
              f"{losses[-1:]})")
        check(any(line.startswith("step     0 loss") and "tok/s" in line
                  for line in lines)
              and lines[-1].startswith("done: 100 steps"),
              f"{tag} e: the launcher's lines")
        out["e"] = dict(launcher_wall_s=wall_ms / 1e3, first=losses[0],
                        last=losses[-1], lines=lines)
        smoke = ["--smoke", "--ckpt-every", "4"]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            run(lambda: train_launch.main(smoke + [
                "--steps", "6", "--ckpt-dir", str(scratch / "a")]))
            run(lambda: train_launch.main(smoke + [
                "--steps", "12", "--ckpt-dir", str(scratch / "a")]))
            run(lambda: train_launch.main(smoke + [
                "--steps", "12", "--ckpt-dir", str(scratch / "b")]))
        check("resumed from step 6" in text.getvalue(),
              f"{tag} e: the second smoke run must resume at step 6")

        def final(d):
            with np.load(d / "step_0000000012" / "arrays.npz") as f:
                return {k: f[k] for k in f.files}
        fa, fb = final(scratch / "a"), final(scratch / "b")
        check(sorted(fa) == sorted(fb)
              and all(np.array_equal(fa[k], fb[k]) for k in fa),
              f"{tag} e: the resumed smoke run must give the uninterrupted "
              "run's bits")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            (ex_losses, ex_ms) = run(lambda: train_lm.main(
                ["--ckpt-dir", str(scratch / "example")]))
        check(text.getvalue().rstrip().endswith("OK"),
              f"{tag} e: the example must print OK")
        out["e"].update(example_s=ex_ms / 1e3, example_first=ex_losses[0],
                        example_last=ex_losses[-1])
        log(f"{tag} e: the launcher at its defaults (qwen2-0.5b, full "
            f"width, 100 steps of 8 x 128) {wall_ms / 1e3:.1f} s with its "
            f"init, loss {losses[0]:.4f} -> {losses[-1]:.4f}; --smoke "
            f"stopped at 6 and resumed to 12: the uninterrupted run's bits; "
            f"the example OK in {ex_ms / 1e3:.1f} s (loss "
            f"{ex_losses[0]:.4f} -> {ex_losses[-1]:.4f})")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    check(not any(totals.values()), f"phase15: a port kernel ran: {totals}")
    out["launch_totals"] = totals
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase15: every port-kernel count 0; {out['seconds']:.1f} s")
    return out


# Slice 12: the expert-parallel MoE, the compressed data-parallel mean and
# the dry-run on the card. (a) models/moe_ep.py's moe_forward_ep at
# deepseek-moe-16b's full width (d_model 2,048, 64 routed experts of 1,408,
# top-6 unnormalised, 2 shared, capacity factor 1.25 as published) on a
# (2, 4) ("data", "model") mesh of cuda:0 repeated 8 times: 4 x 64 tokens
# of 0.5 N(0, 1) from np.random.default_rng(P16_SEED) in bf16, the batch
# over "data" and the sequence over "model", so each device routes 2 x 16
# tokens (capacity 8 a shard). The weights are phase 14's deepseek-moe-16b
# layer 1 (its first MoE layer: groups/0 repeat 0 of
# lm.init_params_numpy(cfg, 0)), so no second numpy init runs. Its output
# at 168 coordinates (P16_COORD_SEED), its aux losses and each shard's
# dropped pairs are held to a JAX CPU run of the reference's
# moe_forward_ep on an 8-device host mesh on the same weights and input
# (~30 s and ~8 GB on an 8-core CPU host; the weight leaves drawn as
# lm.init_params_numpy draws them, repeat 0 only):
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu XLA_FLAGS=\
#   --xla_force_host_platform_device_count=8 python -c "import dataclasses
#   import jax, numpy as np, jax.numpy as jnp; from chip_smoke import *
#   from repro.compat import make_mesh; from repro.models import moe as jm
#   from repro.launch.partition import partitioning
#   from repro.models.moe_ep import moe_forward_ep
#   from repro_torch.configs import get_config
#   from repro_torch.models import lm as tlm
#   cfg = dataclasses.replace(get_config(P16_ARCH), n_layers=4)
#   sp = tlm.param_shapes(cfg)['groups']['0']['ffn']
#   def leaf(path, s, bf16): return jnp.asarray(tlm._draw(
#       'groups/0/ffn/' + path, (1,) + s[0][1:], s[1], 0)[0]).astype(
#       jnp.bfloat16 if bf16 else jnp.float32)
#   p = {'router': {'kernel': leaf('router/kernel',
#       sp['router']['kernel'], False)}, **{k: leaf(k, sp[k], True)
#       for k in ('wi', 'wg', 'wo')}, 'shared': {k: {'kernel': leaf(
#       f'shared/{k}/kernel', sp['shared'][k]['kernel'], True)}
#       for k in ('wi', 'wg', 'wo')}}
#   x = jnp.asarray(np.random.default_rng(P16_SEED).standard_normal((4,
#       64, 2048), dtype=np.float32) * np.float32(0.5)).astype(jnp.bfloat16)
#   m = jm.MoEConfig(**dataclasses.asdict(tlm.moe_config(cfg)))
#   mesh = make_mesh(P16_MESH, ('data', 'model'))
#   with partitioning(mesh, P16_RULES) as r: y, aux = jax.jit(lambda pp,
#       xx: moe_forward_ep(pp, xx, m, mesh, r))(p, x)
#   y = np.asarray(y.astype(jnp.float32))
#   print([float(y[tuple(c)]) for c in p16_coords(np)], aux)"
# and each shard's dropped pairs from the reference's route and
# _local_dispatch under shard_map on the same mesh. The bars were fixed
# before the first card run, from the port's CPU path (the same mesh of
# repeated CPU devices) against these constants: every shard's routes the
# reference's, max |out diff| 3.05e-5 at the coordinates (0.00195 over
# all 524,288 values, one bf16 ulp at their largest magnitude, 0.54), the
# aux losses 0 and 1.05e-7 relative; P16_TOL is three bf16 ulps there,
# P16_AUX_RTOL 1e-5. The card's routes are held to the CPU path's (a route
# that differs must be a near-tie, P14_ROUTE_TIE); the card's coordinates
# are held where their shard routes as the CPU path does.
# Then a copy at capacity factor E / k (no pair dropped anywhere) against
# the port's single-program moe_forward on the card: the tokens both route
# alike within P16_NODROP_TOL (the CPU path reads 0.00195), a route that
# differs a near-tie; one backward pass through both all-to-alls (x and
# every weight a leaf) with a finite, non-zero gradient norm; and
# deepseek-moe-16b at phase 14's 4 layers and weights under
# partitioning(mesh, P16_RULES) at no-drop capacity, its 3 MoE layers on
# the EP path (24 shard calls), against the same forward without a
# context on phase 14's 2 x 64 tokens (2 x 16 tokens a device): the
# logits of tokens routed alike in every layer within P16_LM_ULPS bf16 ulp
# of their largest magnitude (2^-7 of it; the port's CPU path on a smoke
# deepseek reads 0, as did the card's runs FA-FC under a looser bar).
# (b) optim/compression.py's compressed_grad_reduce over qwen2-0.5b's 290
# gradient leaves (494.03 M values) on a 4-replica ("data",) mesh of
# cuda:0: Gaussian gradients (as the reference worker's) drawn on the card
# per (step, replica). One reduction: each replica the same mean, relative
# error against the exact mean under P16_REL_TOL, device ms, the wire bytes
# against an fp32 ring; 20 steps of N(0.3, 1) gradients with error
# feedback: the accumulated relative error under P16_REL_TOL (the worker's
# bars). The int8 codes, means and residuals of the leaves of P16_LEAVES
# are the bits of the port's CPU path on the same values.
# (c) the dry-run CLI (launch/dryrun.py, meta devices) on two cells.
P16_ARCH = "deepseek-moe-16b"
P16_SEED = 16
P16_X = (4, 64)
P16_MESH = (2, 4)
P16_RULES = {"tokens": ("data",), "expert": ("model",), "fsdp": None,
             "moe_impl": "shard_map_ep"}
P16_COORD_SEED = 160
P16_TOL = 6e-3
P16_AUX_RTOL = 1e-5
P16_NODROP_TOL = 1e-2
P16_LM_ULPS = 1
P16_REPLICAS = 4
P16_REL_TOL = 0.02
P16_EF_STEPS = 20
# the leaves of the first and last layer and the final norm (25 leaves):
# their codes, means and residuals held to the CPU path's bits
P16_LEAVES = ("layers.0.", "layers.23.", "final_norm.")
P16_DRYRUN = (("qwen2-0.5b", "decode_32k", "single"),
              ("fpps-icp", "fleet_130k", "multi"))
P16_REF_DROPS = (0, 1, 0, 0, 0, 0, 0, 0)
P16_REF_AUX = {"load_balance_loss": 1.0287522077560425,
               "router_z_loss": 18.1940860748291,
               "moe_aux_total": 0.019222838804125786}
P16_REF_OUT = (
    0.060791015625, -0.08642578125, -0.146484375, -0.16796875, 0.0947265625,
    0.05859375, -0.09521484375, 0.08984375, -0.1396484375, -0.0087890625,
    0.162109375, 0.0240478515625, -0.0267333984375, 0.0478515625,
    -0.09033203125, 0.142578125, -0.080078125, 0.087890625, 0.00341796875,
    -0.154296875, -0.0771484375, -0.005950927734375, -0.138671875,
    0.021484375, 0.07763671875, 0.01116943359375, -0.0042724609375,
    0.0595703125, -0.068359375, 0.0947265625, -0.044921875, -0.08251953125,
    -0.1865234375, -0.01055908203125, 0.0908203125, 0.064453125, 0.1953125,
    0.0947265625, -0.01416015625, -0.07568359375, -0.07177734375,
    -0.056396484375, 0.10498046875, -0.06005859375, -0.06787109375,
    -0.08349609375, 0.111328125, 0.02392578125, -0.107421875, 0.038818359375,
    0.154296875, 0.169921875, -0.09765625, -0.08203125, -0.1748046875,
    0.01416015625, 0.134765625, -0.037353515625, -0.1328125, -0.0233154296875,
    -0.10400390625, 0.0693359375, -0.03466796875, 0.1708984375, 0.048828125,
    0.00567626953125, -0.053466796875, -0.041259765625, -0.1142578125,
    -0.216796875, 0.050048828125, 0.06103515625, 0.0235595703125, 0.044921875,
    -0.1005859375, -0.040771484375, -0.043212890625, 0.1953125, 0.1337890625,
    0.037353515625, -0.039794921875, -0.0771484375, 0.2060546875,
    0.04638671875, 0.162109375, 0.259765625, -0.0267333984375, 0.025146484375,
    0.1826171875, -0.08642578125, -0.0693359375, -0.1748046875,
    -0.034912109375, -0.1552734375, 0.150390625, -0.2470703125, 0.08642578125,
    0.1484375, 0.053466796875, 0.0693359375, -0.09521484375, 0.0869140625,
    0.0654296875, -0.1328125, 0.1689453125, 0.06640625, 0.0615234375,
    0.0189208984375, -0.05029296875, 0.02197265625, -0.10986328125,
    -0.09521484375, 0.064453125, 0.1689453125, -0.11328125, 0.0419921875,
    0.062255859375, -0.050537109375, 0.08837890625, 0.11474609375,
    -0.1298828125, 0.08935546875, -0.0069580078125, 0.2060546875, 0.119140625,
    0.07373046875, 0.09375, -0.130859375, -0.166015625, 0.015869140625,
    0.04248046875, 0.09326171875, -0.061767578125, -0.1904296875, 0.310546875,
    -0.08349609375, -0.10986328125, 0.02294921875, 0.349609375,
    -0.050048828125, 0.02783203125, -0.236328125, -0.0849609375,
    0.026611328125, 0.232421875, -0.013427734375, -0.08251953125,
    -0.08642578125, 0.0033111572265625, 0.2001953125, 0.01806640625,
    -0.08544921875, 0.12255859375, 0.02587890625, 0.1064453125, -0.216796875,
    -0.01025390625, 0.061279296875, -0.138671875, 0.0274658203125, -0.171875,
    0.07421875, 0.1376953125, -0.1328125, 0.10107421875, -0.05419921875,
    0.0277099609375, 0.109375)


def p16_coords(np):
    """The 168 (b, s, d) coordinates of P16_REF_OUT."""
    return np.stack([np.random.default_rng(P16_COORD_SEED).integers(
        0, n, 168) for n in P16_X + (2048,)], 1)


def p16_token_routes(torch, calls, b, s, n_ep):
    """Each token's chosen experts (B, S, k) from a MoETrace's records of
    one EP layer (one record a shard, in block order: token block i over
    the batch, expert shard j over the sequence)."""
    n_tok = len(calls) // n_ep
    bl, sl = b // n_tok, s // n_ep
    out = torch.empty((b, s, calls[0]["idx"].shape[1]), dtype=torch.long)
    for n, c in enumerate(calls):
        i, j = divmod(n, n_ep)
        out[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl] = c["idx"].cpu(
        ).reshape(bl, sl, -1)
    return out


def p16_flips(torch, ep_calls, sp_calls, b, s, n_ep, k, tag):
    """(tokens routed alike in every MoE layer by the EP records and the
    single-program records of the same forward, the number of tokens
    routed otherwise): a token's first layer whose routes differ must be
    a near-tie in the single-program run's probabilities."""
    n_layers = len(sp_calls)
    flipped = torch.zeros((b, s), dtype=torch.bool)
    worst = 0.0
    per = len(ep_calls) // n_layers
    for layer in range(n_layers):
        ep = p16_token_routes(torch, ep_calls[layer * per:(layer + 1) * per],
                              b, s, n_ep)
        sp = sp_calls[layer]["idx"].cpu().reshape(b, s, -1)
        diff = (ep != sp).any(-1)
        first = diff & ~flipped
        if bool(first.any()):
            top = torch.softmax(sp_calls[layer]["logits"].cpu(), -1).topk(
                k + 1).values
            gap = (top[:, k - 1] - top[:, k]).reshape(b, s)
            worst = max(worst, float(gap[first].max()))
        flipped |= diff
    check(worst <= P14_ROUTE_TIE, f"{tag}: a token's first route that "
          f"differs between the EP and the single-program path lies where "
          f"the k-th and (k+1)-th probabilities are {worst} apart (near-tie "
          f"bar {P14_ROUTE_TIE})")
    return ~flipped, int(flipped.sum())


def phase16(torch, np, ds_model):
    """The expert-parallel MoE, the compressed data-parallel mean and the
    dry-run (slice 12)."""
    import contextlib
    import dataclasses
    import gc
    import io
    import math
    import os
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import partition as tpart
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models import moe as tmoe
    from repro_torch.models import moe_ep
    from repro_torch.optim import compression as comp
    from repro_torch.roofline.report import count_collectives

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {}
    totals = dict(nn_search=0, candidate_sweep=0, fused_moment_sweep=0,
                  moment_sweep=0)

    def run(fn):
        result, wall_ms, launches = counted(torch, fn)
        for key, v in launches.items():
            totals[key] += v
        return result, wall_ms

    # (a) the expert-parallel MoE at deepseek-moe-16b's full width
    tag = "phase16 a"
    cfg = ds_model.cfg
    mcfg = lm.moe_config(cfg)
    k, n_ep = mcfg.top_k, P16_MESH[1]
    check(cfg.name == P16_ARCH and cfg.n_layers == P14_LAYERS[P16_ARCH],
          f"{tag}: phase 14's {P16_ARCH} model is needed, got {cfg.name}")
    layer = ds_model["layers"]["1"]["ffn"]
    names = ("router/kernel", "wi", "wg", "wo", "shared/wi/kernel",
             "shared/wg/kernel", "shared/wo/kernel")

    def get(tree, name):
        for key in name.split("/"):
            tree = tree[key]
        return tree

    def params(device, grad=False):
        p = {}
        for name in names:
            node = p
            *parents, leaf = name.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            t = get(layer, name).detach().to(device)
            node[leaf] = t.clone().requires_grad_(True) if grad else t
        return p

    x_np = np.random.default_rng(P16_SEED).standard_normal(
        P16_X + (cfg.d_model,), dtype=np.float32) * np.float32(0.5)
    x = torch.from_numpy(x_np).to(dev).to(torch.bfloat16)
    mesh = make_debug_mesh(P16_MESH, device=dev)
    cpu_mesh = make_debug_mesh(P16_MESH, device="cpu")
    p_card, p_cpu = params(dev), params("cpu")

    def ep(p, xx, m, msh):
        with tpart.partitioning(msh, P16_RULES) as rules:
            return moe_ep.moe_forward_ep(p, xx, m, msh, rules)

    with MoETrace(torch) as card_tr, count_collectives() as coll:
        (y, aux), wall = run(lambda: ep(p_card, x, mcfg, mesh))
    with MoETrace(torch) as cpu_tr:
        y_cpu, aux_cpu = ep(p_cpu, x.cpu(), mcfg, cpu_mesh)
    check(tuple(y.shape) == P16_X + (cfg.d_model,) and y.dtype == torch.bfloat16
          and bool(torch.isfinite(y).all()), f"{tag}: bad output")
    check(len(card_tr.calls) == 8, f"{tag}: {len(card_tr.calls)} shard "
          f"calls, expected 8")
    flips, widest = route_diffs(torch, card_tr, cpu_tr, k)
    check(widest <= P14_ROUTE_TIE, f"{tag}: a route differs between the "
          f"card and the CPU path at a {widest} probability gap")
    shard_flip = [bool((a["idx"].cpu() != b["idx"].cpu()).any())
                  for a, b in zip(card_tr.calls, cpu_tr.calls)]
    t_loc = x.shape[0] * x.shape[1] // 8
    drops = {name: tuple(round(float(c["dropped_frac"]) * t_loc * k)
                         for c in tr.calls)
             for name, tr in (("cuda", card_tr), ("cpu", cpu_tr))}
    check(drops["cpu"] == P16_REF_DROPS, f"{tag} cpu: dropped pairs a shard "
          f"{drops['cpu']}, the reference's {P16_REF_DROPS}")
    coords = p16_coords(np)
    want = np.array(P16_REF_OUT)
    row = out["a"] = dict(params_layer=sum(get(layer, n).numel()
                                           for n in names),
                          routes_differ=flips, widest_flip_gap=widest,
                          shard_flip=shard_flip, drops=drops["cuda"])
    for name, yy, aa in (("cuda", y, aux), ("cpu", y_cpu, aux_cpu)):
        got = yy.float().cpu().numpy()
        held = [n for n, c in enumerate(coords)
                if name == "cpu" or not shard_flip[(c[0] // 2) * n_ep
                                                   + c[1] // 16]]
        err = float(np.abs(got[tuple(coords[held].T)] - want[held]).max())
        check(err <= P16_TOL, f"{tag} {name}: max |out - reference| {err} "
              f"> {P16_TOL} at {len(held)} coordinates")
        aux_err = {key: abs(float(aa[key]) - v) / abs(v)
                   for key, v in P16_REF_AUX.items()}
        if name == "cpu" or not any(shard_flip):
            check(max(aux_err.values()) <= P16_AUX_RTOL, f"{tag} {name}: "
                  f"aux {aux_err} relative > {P16_AUX_RTOL}")
            check(drops[name] == P16_REF_DROPS, f"{tag} {name}: dropped "
                  f"pairs {drops[name]}")
        check(float(aa["dropped_frac"]) == 0.0, f"{tag} {name}: "
              f"dropped_frac {float(aa['dropped_frac'])}, the reference "
              f"reports 0")
        row[name] = dict(max_abs_err=err, coords=len(held), aux_rel=aux_err)
    card_vs_cpu = float((y.float().cpu() - y_cpu.float()).abs().max())
    a2a = coll.get("all-to-all", {"count": 0, "bytes": 0})
    ms, ms_lo, ms_hi, ahead = device_ms(
        torch, lambda: ep(p_card, x, mcfg, mesh), reps=5, blocks=3)
    row.update(card_vs_cpu=card_vs_cpu, wall_ms=wall, ms=ms,
               ms_spread=(ms_lo, ms_hi), ahead=ahead,
               all_to_all_bytes=a2a["bytes"], all_to_alls=a2a["count"])
    log(f"{tag}: moe_forward_ep at {P16_ARCH}'s full width (layer 1 of "
        f"phase 14's weights, {row['params_layer'] / 1e6:.2f} M parameters) "
        f"on a {P16_MESH} mesh of cuda:0, x {tuple(x.shape)} bf16 | "
        f"card vs JAX reference max |diff| {row['cuda']['max_abs_err']:.6f} "
        f"at {row['cuda']['coords']} coordinates (CPU path "
        f"{row['cpu']['max_abs_err']:.6f}; bar {P16_TOL}), card vs CPU "
        f"{card_vs_cpu:.6f} over all; aux relative card "
        f"{max(row['cuda']['aux_rel'].values()):.2e} CPU "
        f"{max(row['cpu']['aux_rel'].values()):.2e} (bar {P16_AUX_RTOL}); "
        f"dropped pairs a shard {drops['cuda']} (reference {P16_REF_DROPS});"
        f" {flips} routes differ from the CPU path (widest gap "
        f"{widest:.2e}) | device {ms:.4f} ms a forward ({ms_lo:.4f}-"
        f"{ms_hi:.4f}, queued ahead {ahead}); {a2a['count']} all-to-alls "
        f"moving {a2a['bytes']} bytes between mesh coordinates")

    # no drop: EP against the single-program moe_forward on the card
    nd = dataclasses.replace(mcfg, capacity_factor=mcfg.n_experts / k)
    with MoETrace(torch) as ep_tr:
        (y_ep, _), _ = run(lambda: ep(p_card, x, nd, mesh))
    with MoETrace(torch) as sp_tr:
        (y_sp, _), _ = run(lambda: tmoe.moe_forward(p_card, x, nd))
    dropped = sum(int(c["dropped"].sum()) for c in ep_tr.calls + sp_tr.calls)
    check(dropped == 0, f"{tag} no-drop: {dropped} tokens dropped a pair")
    b, s = P16_X
    held, n_flip = p16_flips(torch, ep_tr.calls, sp_tr.calls, b, s, n_ep, k,
                             f"{tag} no-drop")
    diff = (y_ep.float() - y_sp.float()).abs().amax(-1).cpu()
    nodrop_err = float(diff[held].max())
    check(nodrop_err <= P16_NODROP_TOL, f"{tag} no-drop: EP vs moe_forward "
          f"{nodrop_err} > {P16_NODROP_TOL}")
    row["nodrop"] = dict(max_abs_err=nodrop_err, held=int(held.sum()),
                         routed_otherwise=n_flip)
    log(f"{tag} no-drop (capacity factor {nd.capacity_factor:.4f}): EP vs "
        f"the single-program moe_forward on the card, max |diff| "
        f"{nodrop_err:.6f} over {int(held.sum())} of {held.numel()} tokens "
        f"(bar {P16_NODROP_TOL}; {n_flip} routed otherwise on near-ties)")
    del y_ep, y_sp, ep_tr, sp_tr

    # one backward pass through both all-to-alls
    p_grad = params(dev, grad=True)
    xg = x.detach().clone().requires_grad_(True)

    def fwd_bwd():
        yy, aa = ep(p_grad, xg, mcfg, mesh)
        ((yy.float() ** 2).sum() + aa["moe_aux_total"]).backward()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    (_, bwd_wall) = run(fwd_bwd)  # warm-up and the launch count
    for t in [xg] + [get(p_grad, n) for n in names]:
        t.grad = None
    torch.cuda.synchronize()
    start.record()
    run(fwd_bwd)
    end.record()
    end.synchronize()
    fb_ms = start.elapsed_time(end)
    leaves = [xg] + [get(p_grad, n) for n in names]
    gnorm = math.sqrt(sum(float((t.grad.float() ** 2).sum()) for t in leaves))
    check(math.isfinite(gnorm) and gnorm > 0, f"{tag} backward: gradient "
          f"norm {gnorm}")
    check(all(t.grad is not None for t in leaves), f"{tag} backward: a leaf "
          f"got no gradient")
    row["backward"] = dict(grad_norm=gnorm, fwd_bwd_ms=fb_ms)
    log(f"{tag} backward: sum(out²) + aux through both all-to-alls, "
        f"gradient norm over x and the 7 weight leaves {gnorm:.6e} "
        f"(finite, non-zero); forward + backward {fb_ms:.3f} ms (CUDA "
        f"events, host gaps included)")
    del p_grad, xg, leaves, p_cpu, y_cpu
    gc.collect()

    # the 4-layer model under the EP rules at no-drop capacity
    lm_cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / k)
    tok = torch.from_numpy(np.random.default_rng(P14_SEED).integers(
        0, cfg.vocab_size, (P12_B, P12_S), dtype=np.int32)).to(dev)

    def forward_ep():
        with tpart.partitioning(mesh, P16_RULES):
            return lm.forward(ds_model, lm_cfg, tokens=tok)
    with MoETrace(torch) as ep_tr:
        (logits_ep, _), lm_wall = run(forward_ep)
    with MoETrace(torch) as sp_tr:
        (logits, _), _ = run(lambda: lm.forward(ds_model, lm_cfg, tokens=tok))
    n_moe = len(sp_tr.calls)
    check(len(ep_tr.calls) == 8 * n_moe and n_moe == cfg.n_layers - 1,
          f"{tag} lm: {len(ep_tr.calls)} EP shard calls for {n_moe} MoE "
          f"layers")
    held, n_flip = p16_flips(torch, ep_tr.calls, sp_tr.calls, P12_B, P12_S,
                             n_ep, k, f"{tag} lm")
    lm_err = float((logits_ep - logits).abs().amax(-1).cpu()[held].max())
    lm_bar = P16_LM_ULPS * 2.0 ** -7 * float(
        logits.float().abs().amax(-1).cpu()[held].max())
    check(lm_err <= lm_bar, f"{tag} lm: logits under the EP rules vs "
          f"without a context {lm_err} > {lm_bar} ({P16_LM_ULPS} bf16 ulp "
          f"of their largest magnitude)")
    lm_equal = bool(torch.equal(logits_ep.cpu()[held], logits.cpu()[held]))
    row["lm"] = dict(max_abs_err=lm_err, bar=lm_bar, bit_equal=lm_equal,
                     held=int(held.sum()), routed_otherwise=n_flip,
                     wall_ms=lm_wall)
    log(f"{tag} lm: {P16_ARCH} at phase 14's {cfg.n_layers} layers under "
        f"partitioning(mesh, {P16_RULES}) at capacity factor "
        f"{lm_cfg.capacity_factor:.4f}: {n_moe} MoE layers on the EP path "
        f"({len(ep_tr.calls)} shard calls), logits vs the same forward "
        f"without a context max |diff| {lm_err:.6f} over {int(held.sum())} "
        f"of {held.numel()} tokens, bit-equal {lm_equal} (bar {lm_bar:.6f}, "
        f"{P16_LM_ULPS} bf16 ulp of their largest; {n_flip} routed "
        f"otherwise on near-ties); {lm_wall:.1f} ms wall")
    del logits_ep, logits, ep_tr, sp_tr, card_tr, cpu_tr, y, p_card
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the compressed data-parallel mean over qwen2-0.5b's gradients
    tag = "phase16 b"
    q_cfg = get_config("qwen2-0.5b")
    shapes = {n: tuple(t.shape)
              for n, t in lm.init_abstract(q_cfg).named_parameters()}
    n_values = sum(math.prod(s) for s in shapes.values())
    check(len(shapes) == 290 and round(n_values / 1e6, 2) == 494.03,
          f"{tag}: {len(shapes)} leaves, {n_values} values")
    mesh4 = make_debug_mesh((P16_REPLICAS,), ("data",), device=dev)
    gen = torch.Generator(device=dev)

    def grads(step, shift=0.0):
        out_g = []
        for r in range(P16_REPLICAS):
            gen.manual_seed(P16_SEED * 1000 + step * 10 + r)
            out_g.append({n: torch.randn(s, generator=gen, device=dev) + shift
                          for n, s in shapes.items()})
        return out_g

    def zeros():
        return [{n: torch.zeros(s, device=dev) for n, s in shapes.items()}
                for _ in range(P16_REPLICAS)]

    def exact_mean(gs):
        return {n: sum(g[n] for g in gs) / P16_REPLICAS for n in gs[0]}

    def rel(a, b_):
        num = sum(float(((a[n] - b_[n]).double() ** 2).sum()) for n in a)
        den = sum(float((b_[n].double() ** 2).sum()) for n in a)
        return math.sqrt(num / den)

    gs = grads(0)
    efs = zeros()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    with count_collectives() as wire:
        (means, efs), red_wall = run(lambda: comp.compressed_grad_reduce(
            gs, mesh4, "data", efs))
    end.record()
    end.synchronize()
    red_ms = start.elapsed_time(end)
    same = all(torch.equal(m[n], means[0][n]) for m in means[1:]
               for n in shapes)
    check(same, f"{tag}: the replicas' means differ")
    single = rel(means[0], exact_mean(gs))
    check(single < P16_REL_TOL, f"{tag}: one reduction's relative error "
          f"{single} >= {P16_REL_TOL}")
    wire_bytes = sum(d["bytes"] for d in wire.values())
    ring = comp.fp32_ring_bytes(n_values, P16_REPLICAS)
    # bits against the port's CPU path on the subset
    cpu_mesh4 = make_debug_mesh((P16_REPLICAS,), ("data",), device="cpu")
    subset = {n: s for n, s in shapes.items() if n.startswith(P16_LEAVES)}
    split = 0
    for n in subset:
        zero = [torch.zeros(shapes[n], device=dev)] * P16_REPLICAS
        codes_c, codes_h = [], []
        m_c, e_c = comp.compressed_psum_mean([g[n] for g in gs], mesh4,
                                             "data", zero, codes=codes_c)
        m_h, e_h = comp.compressed_psum_mean(
            [g[n].cpu() for g in gs], cpu_mesh4, "data",
            [z.cpu() for z in zero], codes=codes_h)
        (q_c, q2_c), (q_h, q2_h) = codes_c[0], codes_h[0]
        for a_, b_ in zip(q_c + q2_c + m_c + e_c, q_h + q2_h + m_h + e_h):
            split += int((a_.cpu() != b_).sum())
        check(all(torch.equal(m_c[0], m[n]) for m in means), f"{tag}: "
              f"{n}'s mean differs from compressed_grad_reduce's")
    check(split == 0, f"{tag}: {split} values of the codes, means and "
          f"residuals differ between the card and the CPU path on "
          f"{len(subset)} leaves")
    del gs, means, efs
    gc.collect()
    # 20 steps of error feedback
    efs = zeros()
    acc_c = {n: torch.zeros(s, device=dev) for n, s in shapes.items()}
    acc_e = {n: torch.zeros(s, device=dev) for n, s in shapes.items()}
    t0 = time.perf_counter()
    for step in range(P16_EF_STEPS):
        gs = grads(step + 1, shift=0.3)
        (means, efs), _ = run(lambda: comp.compressed_grad_reduce(
            gs, mesh4, "data", efs))
        exact = exact_mean(gs)
        for n in shapes:
            acc_c[n] += means[0][n]
            acc_e[n] += exact[n]
        del gs, means, exact
    ef_s = time.perf_counter() - t0
    accumulated = rel(acc_c, acc_e)
    check(accumulated < P16_REL_TOL, f"{tag}: {P16_EF_STEPS}-step "
          f"accumulated relative error {accumulated} >= {P16_REL_TOL}")
    out["b"] = dict(leaves=len(shapes), values=n_values, rel_err=single,
                    ef_rel_err=accumulated, reduce_ms=red_ms,
                    reduce_wall_ms=red_wall, ef_steps_s=ef_s,
                    wire_bytes=wire_bytes, fp32_ring_bytes=ring,
                    subset_leaves=len(subset),
                    subset_values=sum(math.prod(v) for v in subset.values()),
                    cpu_split=split)
    log(f"{tag}: compressed_grad_reduce over qwen2-0.5b's {len(shapes)} "
        f"gradient leaves ({n_values / 1e6:.2f} M values) on "
        f"{P16_REPLICAS} replicas of cuda:0: relative error vs the exact "
        f"mean {single:.5f}, {P16_EF_STEPS} error-feedback steps "
        f"accumulated {accumulated:.5f} in {ef_s:.1f} s (bars "
        f"{P16_REL_TOL}); one reduction {red_ms:.2f} ms (CUDA events, host "
        f"gaps included; {red_wall:.1f} ms wall); wire {wire_bytes} bytes vs "
        f"an fp32 ring's {ring} ({ring / wire_bytes:.3f}x fewer); on the "
        f"{len(subset)} leaves of {P16_LEAVES} "
        f"({out['b']['subset_values'] / 1e6:.2f} M values) the codes, means "
        f"and residuals the CPU path's bits")
    del efs, acc_c, acc_e
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the dry-run CLI on meta devices
    tag = "phase16 c"
    out_dir = ROOT / "build" / f"p16_dryrun_{os.getpid()}"
    out["c"] = {}
    try:
        for arch, shape, mesh_name in P16_DRYRUN:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rec, wall = run(lambda: dryrun.main([
                    "--arch", arch, "--shape", shape, "--mesh", mesh_name,
                    "--out-dir", str(out_dir)]))
            check(rec.get("status") == "ok", f"{tag} {arch}/{shape}/"
                  f"{mesh_name}: {rec.get('error')}")
            mem, r = rec["memory"], rec["roofline"]
            out["c"][rec["label"]] = dict(memory=mem, roofline=r,
                                          flops=rec["analyzed"]["flops"],
                                          wall_ms=wall)
            log(f"{tag} {rec['label']}: {rec['n_devices']} meta devices, "
                f"{mem['argument_bytes'] / 1e9:.4f} GB of arguments and "
                f"{mem['temp_bytes'] / 1e9:.4f} GB of temp bytes a device "
                f"(fits 80 GB: {mem['fits_h100_80g']}), "
                f"{rec['analyzed']['flops']:.4e} FLOPs a device, roofline "
                f"compute {r['compute_s']:.6f} s memory {r['memory_s']:.6f} "
                f"s collective {r['collective_s']:.6f} s, dominant "
                f"{r['dominant']}, useful {r['useful_fraction']:.3f}; "
                f"{wall:.0f} ms")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out["launch_totals"] = totals
    check(sum(totals.values()) == 0, f"phase16: a port kernel ran: {totals}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase16: every port-kernel count 0; {out['seconds']:.1f} s")
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
    report["phase9"], fleet = phase9(torch, np)
    report["phase10"] = phase10(torch, np, scenes, fleet)
    report["phase11"] = phase11(torch, np, scenes, logs["fused_icp"])
    report["phase12"] = phase12(torch, np)
    report["phase13"] = phase13(torch, np)
    report["phase14"], ds_model = phase14(torch, np)
    # phase 16 runs on phase 14's deepseek-moe-16b, freed before phase 15
    report["phase16"] = phase16(torch, np, ds_model)
    del ds_model
    torch.cuda.empty_cache()
    report["phase15"] = phase15(torch, np)
    totals = {k: v + sum(report[f"phase{p}"]["launch_totals"][k]
                         for p in (7, 8, 9, 10, 11, 12, 13, 14, 15, 16))
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
    odom = (report["phase8"]["kernel_checks"]
            + report["phase9"]["kernel_checks"]
            + report["phase10"]["kernel_checks"])

    def odom_err(kernel):  # phases 8-10: the main path's calls vs plain
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
        plane_bound_ms=planes["seq0_b1"]["bound_ms"],
        setting_pass_ms={f"{r['warps_per_block']}w"
                         f"{'p' if r['prune'] else ''}": r["pass_ms"]
                         for r in report["phase11"]["autotune"]["configs"]}),
        dict(
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
