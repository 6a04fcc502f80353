"""Driver of the batched pair registration entry point:
``get_engine(<engine>).register_pairs`` of the program, in a closed loop.

Set-up draws the mix's pool of batches from the seed (scans on the device,
handed over as host arrays), builds the kernels and runs every batch once.
The window then registers the pool's batches in turn, each call followed by
the fetch of its transforms to the host, until the window's time is up; a
batch that ends after the window's end does not count. ``pairs_per_s`` is
the pairs of the counted batches over the time from the window's start to
the end of the last of them.

``correct``: once the window has closed and the program's state is freed,
the reference (:mod:`perfbench.reference.icp`) registers a sample of the
window's pairs, drawn from the seed, from the same inputs and warm starts,
and each sampled answer's transform is compared with the reference's.
"""
from __future__ import annotations

import time

import numpy as np
from perfbench import harness
from perfbench.reference import icp as ref_icp
from perfbench.traffic import generate, scenes

SPLIT = "pairs"


def _nn_work(batch) -> tuple[int, int, int]:
    """(query-target pairs, queries, targets) that one NN launch over
    ``batch`` is given, counting valid rows only."""
    q = [s.shape[0] for s, _ in batch.pairs]
    t = [d.shape[0] for _, d in batch.pairs]
    return int(np.dot(q, t)), int(sum(q)), int(sum(t))


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.core import ICPParams, get_engine
    from repro_torch.kernels.nn_search import nn_search_kernel

    cfg, mix = ctx.config, ctx.mix
    dev = ctx.device
    engine = get_engine(cfg["engine"], device=dev)
    engine.setup()
    params = ICPParams(**cfg["icp"])
    pool = generate.pair_batches(mix, scenes.scene_from_config(cfg["scene"]),
                                 cfg["source_points"], ctx.seed, dev)

    def register(batch):
        with ctx.tracer.span("register_pairs"):
            res, _ = engine.register_pairs(batch.pairs, params,
                                           initial_transforms=batch.init)
        with ctx.tracer.span("fetch"):
            out = (res.T.cpu().numpy(), res.iterations.cpu().numpy(),
                   res.converged.cpu().numpy())
        return out

    for batch in pool:                                  # warm-up
        register(batch)
    setup_s = ctx.end_setup()

    done, traced = [], []
    launches0 = nn_search_kernel.launches
    with ctx.tracer:
        t0 = time.perf_counter()
        t_close = t0 + ctx.seconds
        k = 0
        while True:
            T, its, conv = register(pool[k % len(pool)])
            t = time.perf_counter()
            traced.append((k % len(pool), its))
            if t > t_close:
                break
            done.append((k % len(pool), T, conv))
            t_last = t
            k += 1
    launches = nn_search_kernel.launches - launches0
    ctx.read_memory_peak()
    ctx.free()
    if not done:
        raise RuntimeError("no batch completed inside the window")
    n_pairs = sum(len(pool[b].pairs) for b, _, _ in done)
    metrics = {"pairs_per_s": n_pairs / (t_last - t0), "setup_s": setup_s}
    failed = sum(int((~np.isfinite(T).all((1, 2))).sum()) for _, T, _ in done)

    counters = {
        "split": SPLIT,
        "loop_steps": launches,           # one NN launch a loop step
        "lane_iterations": int(sum(its.sum() for _, its in traced)),
        "lane_steps": int(sum(its.size for _, its in traced)
                          * params.max_iterations),
        "nn_work": [_nn_work(pool[b]) for b, _ in traced
                    for _ in range(params.max_iterations)],
    }
    trace = ctx.finish_window(counters)
    checks, control, details = _check(ctx, pool, done)
    return dict(metrics=metrics, attempted=n_pairs, failed=failed,
                checks=checks, control=control, trace=trace,
                details=details)


def _check(ctx, pool, done):
    """A sample of the window's answers against the reference; with
    ``ctx.control`` also the control's numbers (the reference in TF32 put
    in the program's place). The reference registers every sampled pair
    in full from the same inputs and warm start, and takes one step from
    each answer whose pair it converged on itself, and from its own
    answer: the program's own flags choose nothing, and the stop rule's
    leftover step, which the reference's answer shares, is taken off."""
    torch = ctx.torch
    chk, icp = ctx.config["check"], ctx.config["icp"]
    gate = icp["max_correspondence_distance"]
    answers = [(w, lane) for w, (_, T, _) in enumerate(done)
               for lane in range(T.shape[0])]
    rng = np.random.default_rng(scenes.mix(ctx.seed, "check"))
    picked = [answers[i] for i in rng.choice(
        len(answers), min(chk["sample_pairs"], len(answers)), replace=False)]

    def run_icp(batch, T0, tf32):
        return ref_icp.icp(*batch, max_iterations=icp["max_iterations"],
                           gate=gate, epsilon=icp["transformation_epsilon"],
                           T0=T0, allow_tf32=tf32)

    got, want, low, said, ref_conv, step, low_step, own = ([] for _ in
                                                           range(8))
    group = int(chk["lanes_per_call"])
    for g in range(0, len(picked), group):
        part = picked[g:g + group]
        batch = _stack(torch, [pool[done[w][0]].pairs[lane]
                               for w, lane in part], ctx.device)
        T0 = torch.as_tensor(np.stack([pool[done[w][0]].init[lane]
                                       for w, lane in part]),
                             device=ctx.device)
        r = run_icp(batch, T0, False)
        want.append(r.T.cpu().numpy())
        ref_conv += r.converged.tolist()
        own += ref_icp.restep(*batch, r.T, gate).tolist()
        T = np.stack([done[w][1][lane] for w, lane in part])
        got.append(T)
        said += [bool(done[w][2][lane]) for w, lane in part]
        step += ref_icp.restep(*batch, torch.as_tensor(T, device=ctx.device),
                               gate).tolist()
        if ctx.control:
            r = run_icp(batch, T0, True)
            low.append(r.T.cpu().numpy())
            low_step += ref_icp.restep(*batch, r.T, gate).tolist()
    want, got = np.concatenate(want), np.concatenate(got)
    details = {"t_err": ref_icp.pose_errors(got, want)[0],
               "converged": said, "ref_converged": ref_conv, "restep": step,
               "ref_restep": own}
    own = np.array(own)
    control = None
    if low:
        details["control_t_err"] = ref_icp.pose_errors(np.concatenate(low),
                                                       want)[0]
        details["control_restep"] = low_step
        control = _numbers(ctx, details["control_t_err"],
                           np.where(ref_conv, np.array(low_step) - own, 0.0))
    return (_numbers(ctx, details["t_err"],
                     np.where(ref_conv, np.array(step) - own, 0.0)),
            control, details)


def _numbers(ctx, t_err, step) -> list:
    """The upper quartile of the answers' translation errors (m); the
    largest excess of the step the reference takes from an answer to a
    pair it converged on over the step it takes from its own answer, in
    the stop rule's measure (``||R - I||_F² + ||t||²``); and the answers
    farther than ``gross_t_m`` from the reference's."""
    chk = ctx.config["check"]
    lim = chk["limits"]
    return [harness.Check("pair_t_err_p75_m",
                          float(np.percentile(t_err, 75)),
                          lim["pair_t_err_p75_m"]),
            harness.Check("pair_restep_excess_max", float(np.max(step)),
                          lim["pair_restep_excess_max"]),
            harness.Check("pair_gross_count",
                          int(np.sum(t_err > chk["gross_t_m"])),
                          lim["pair_gross_count"])]


def _stack(torch, pairs, dev):
    """Padded (B, N, 3) / (B, M, 3) device tensors and their masks."""
    n = max(s.shape[0] for s, _ in pairs)
    m = max(d.shape[0] for _, d in pairs)
    out = []
    for k, width in ((0, n), (1, m)):
        x = np.zeros((len(pairs), width, 3), np.float32)
        v = np.zeros((len(pairs), width), bool)
        for i, p in enumerate(pairs):
            x[i, :p[k].shape[0]] = p[k]
            v[i, :p[k].shape[0]] = True
        out.append((torch.as_tensor(x, device=dev),
                    torch.as_tensor(v, device=dev)))
    (src, sv), (dst, dv) = out
    return src, dst, sv, dv
