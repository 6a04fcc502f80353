"""Dry-run of every cell on a production mesh, without a card (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
        --shape decode_32k --mesh single [--rule seq=data] [--remat full] \
        [--accum N] [--kv-quant] [--out-dir build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]

It answers "does this cell fit, and what bounds it, on the production
mesh" as the reference does, on ``meta`` tensors: the mesh is 256 (single
pod) or 512 (two pods) ``meta`` devices, the state, cache and inputs are
``meta`` tensors laid out by the partition rules (``launch.partition``),
and the step (the train step, the prefill or one decode step) runs once on
them under ``roofline.report.FlopCounter`` (``torch.utils.flop_counter``'s
rules): nothing is allocated and nothing is compiled. Each cell writes a
JSON record with the reference's keys where they have a counterpart:

  * ``memory``: per-device argument bytes (the shard shapes of the state,
    cache and inputs), output bytes, aliased (donated) bytes, temp bytes
    (the peak of the bytes the eager step creates and holds at once,
    ``FlopCounter.peak_bytes``, split evenly over the devices: no
    activation layout is modelled, so it is the least a device could
    hold), and ``fits_h100_80g`` (arguments plus temp bytes under 80 GB,
    as the reference's ``fits_v5e_16g``);
  * ``analyzed``: the counted FLOPs over the devices, HBM bytes (arguments
    plus outputs) and collective bytes (``roofline.report.StepCost``);
  * ``roofline``: the three terms on an H100 (``roofline.report``);
  * ``status``: "ok", or "error" with the traceback, as the reference
    records its failures.

Left out, with no counterpart: the compiled module's peak bytes and XLA's
``naive_cost_analysis`` (no compiler runs). The two fpps-icp cells count
one device's brute-force NN search (the four-term augmented product the
NN kernel computes, in fp32) times the iterations, against the
reference's useful FLOPs formula, the per-device bytes of the frame- and
target-sharded inputs, and as temp bytes one device's augmented operands
and the plain search's 1024-column score tiles.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import (cells, get_shape, list_archs,
                                          runnable_cell)
from repro_torch.device import round_up
from repro_torch.kernels import ref
from repro_torch.kernels.nn_search import BLOCK_N, TILE_M
from repro_torch.launch.mesh import batch_axes_for, make_production_mesh
from repro_torch.launch.partition import (DEFAULT_RULES, ShardSpec,
                                          param_sharding, partitioning,
                                          shard_bytes)
from repro_torch.launch.specs import batch_specs, sharding_for_axes
from repro_torch.models import lm
from repro_torch.optim import cosine_schedule, pick_optimizer
from repro_torch.roofline.report import (H100, FlopCounter, StepCost,
                                         count_collectives, roofline_terms)
from repro_torch.train import train_step as ts

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# The paper's own workload, as first-class dry-run cells.
ICP_SHAPES = {
    # fleet: one KITTI-like frame-pair per vehicle, paper-sized clouds
    "fleet_130k": dict(frames=256, n_src=4096, m_dst=131072, iters=50),
    # giant-frame: scan-to-city-map registration, target over every chip
    "giant_134m": dict(frames=1, n_src=65536, m_dst=2 ** 27, iters=50),
}


def _mesh_for(name: str):
    return make_production_mesh(multi_pod=(name == "multi"), device="meta")


def _trim_batch_axes(mesh, axes, global_batch: int):
    """Longest prefix of ``axes`` (present in mesh) dividing global_batch."""
    chosen, size = [], 1
    for ax in axes or ():
        if ax not in mesh.axis_names:
            continue
        if global_batch % (size * mesh.shape[ax]) == 0:
            chosen.append(ax)
            size *= mesh.shape[ax]
        else:
            break
    return tuple(chosen)


def _rules_for(mesh, global_batch: int, overrides: dict | None = None,
               cfg=None):
    rules = dict(DEFAULT_RULES)
    rules["batch"] = batch_axes_for(mesh, global_batch)
    if cfg is not None:
        for k, v in cfg.sharding_override_rules.items():
            if k == "batch":
                rules[k] = _trim_batch_axes(mesh, v, global_batch)
            else:
                rules[k] = v
    rules["tokens"] = rules["batch"]  # flattened (B*S) dim follows batch
    if overrides:
        rules.update(overrides)
    return rules


def _auto_accum(cfg, shape, mesh, rules) -> int:
    """Gradient-accumulation depth: keep per-device microbatch tokens small
    enough that checkpointed activations fit HBM (width-dependent)."""
    axes = rules.get("batch") or ()
    shards = 1
    for a in axes:
        shards *= mesh.shape[a]
    b_loc = max(1, shape.global_batch // max(shards, 1))
    tokens_loc = b_loc * shape.seq_len
    if cfg.d_model >= 12288:
        target = 4096
    elif cfg.d_model >= 4096:
        target = 8192
    else:
        target = 16384
    accum = max(1, tokens_loc // target)
    while b_loc % accum:  # accum must divide the local batch
        accum -= 1
    return accum


def _replicated_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _collect(label: str, n_devices: int, arg_bytes: int, out_bytes: int,
             alias_bytes: int, temp_bytes: int, flops: float,
             collectives: dict, cfg=None, shape=None,
             model_flops_override=None) -> dict:
    coll = sum(d["bytes"] for d in collectives.values()) / n_devices
    cost = StepCost(flops=flops / n_devices,
                    hbm_bytes=float(arg_bytes + out_bytes),
                    collective_bytes=coll, collective_detail=collectives)
    terms = roofline_terms(cost, cfg, shape, n_devices,
                           model_flops_override=model_flops_override)
    return {
        "label": label,
        "n_devices": n_devices,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp_bytes,
            "alias_bytes": alias_bytes,
            "fits_h100_80g": arg_bytes + temp_bytes < H100["hbm_bytes"],
        },
        "analyzed": cost.to_json(),
        "roofline": terms.to_json(),
    }


def _run_lm_cell(arch: str, shape, mesh_name: str,
                 rules_overrides: dict | None = None, remat: str = "full",
                 accum: int | None = None, kv_quant: bool = False) -> dict:
    """One LM cell; ``shape`` a registry name or a ``ShapeConfig``."""
    cfg = get_config(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if isinstance(shape, str):
        shape = get_shape(shape)
    mesh = _mesh_for(mesh_name)
    n_dev = mesh.size
    rules = _rules_for(mesh, shape.global_batch, rules_overrides, cfg)
    specs, axes = batch_specs(cfg, shape)
    in_sh = sharding_for_axes(mesh, axes, rules)
    in_bytes = shard_bytes(in_sh, specs)
    b = shape.global_batch
    logit_sh = ShardSpec(mesh, (rules["batch"] or None,))

    t0 = time.time()
    with partitioning(mesh, rules), count_collectives() as coll:
        if shape.kind == "train":
            if accum is None:
                accum = _auto_accum(cfg, shape, mesh, rules)
            opt = pick_optimizer(cfg.total_params(), cosine_schedule(3e-4))
            state = ts.abstract_state(cfg, opt)
            ref_state = ts.state_to_reference(state)
            state_sh = param_sharding(ts.state_logical_axes(cfg, opt), mesh,
                                      rules, ref_state)
            state_bytes = shard_bytes(state_sh, ref_state)
            step = ts.make_train_step(cfg, opt, remat=remat,
                                      accum_steps=accum,
                                      grad_shardings=state_sh.params)
            with FlopCounter() as counter:
                _, metrics = step(state, specs)
            arg_bytes = state_bytes + in_bytes
            out_bytes = state_bytes + _replicated_bytes(metrics.values())
            alias_bytes = state_bytes
        else:
            model = lm.init_abstract(cfg)
            ref_params = lm.abstract_reference(cfg)
            p_sh = param_sharding(lm.param_logical_axes(cfg), mesh, rules,
                                  ref_params)
            p_bytes = shard_bytes(p_sh, ref_params)
            if shape.kind == "prefill":
                with FlopCounter() as counter:
                    logits, cache = lm.prefill(model, cfg,
                                               max_len=shape.seq_len, **specs)
                alias_bytes = 0
            else:
                cache = lm.init_cache(cfg, b, shape.seq_len, device="meta")
                ref_cache = lm.reference_cache(cfg, cache)
                c_sh = param_sharding(lm.cache_logical_axes(ref_cache), mesh,
                                      rules, ref_cache)
                alias_bytes = shard_bytes(c_sh, ref_cache)
                kw = ({"token": specs["token"]} if cfg.embed_inputs
                      else {"embed": specs["embed"]})
                with FlopCounter() as counter:
                    logits, cache = lm.decode_step(
                        model, cfg, shape.seq_len - 1, cache, **kw)
            ref_out = lm.reference_cache(cfg, cache)
            out_sh = param_sharding(lm.cache_logical_axes(ref_out), mesh,
                                    rules, ref_out)
            arg_bytes = p_bytes + alias_bytes + in_bytes
            out_bytes = (shard_bytes(out_sh, ref_out)
                         + shard_bytes(logit_sh, logits))
    run_s = time.time() - t0
    # the step's peak working memory, split evenly over the devices
    temp_bytes = -(-counter.peak_bytes // n_dev)
    out = _collect(f"{arch}/{shape.name}/{mesh_name}", n_dev, arg_bytes,
                   out_bytes, alias_bytes, temp_bytes, counter.flops, coll,
                   cfg=cfg, shape=shape)
    out["timing"] = {"run_s": run_s}
    out["remat"] = remat
    if shape.kind == "train":
        out["accum"] = accum
    out["rules"] = {k: list(v) if isinstance(v, tuple) else v
                    for k, v in rules.items()}
    return out


def _run_icp_cell(shape_name: str, mesh_name: str) -> dict:
    spec = ICP_SHAPES[shape_name]
    mesh = _mesh_for(mesh_name)
    n_dev = mesh.size
    f, n, m = spec["frames"], spec["n_src"], spec["m_dst"]
    frame_axes = batch_axes_for(mesh, f)
    # giant frame: spread the target over every remaining axis too
    target_axes = tuple(ax for ax in ("data", "model")
                        if ax not in frame_axes or f == 1)
    if f == 1:
        frame_axes = ()
        target_axes = tuple(mesh.axis_names)
    src_abs = torch.empty((f, n, 3), device="meta")
    dst_abs = torch.empty((f, m, 3), device="meta")
    src_sh = ShardSpec(mesh, (frame_axes or None,))
    dst_sh = ShardSpec(mesh, (frame_axes or None, target_axes))
    f_loc = src_sh.shard_shape(src_abs.shape)[0]
    m_loc = dst_sh.shard_shape(dst_abs.shape)[1]
    n_target = m // m_loc
    t0 = time.time()
    # one device's search a iteration: its frames' moved sources against
    # its target shard, the augmented four-term product of the NN kernel
    with FlopCounter() as counter:
        src_aug = torch.empty((f_loc, ref.AUG_ROWS, round_up(n, BLOCK_N)),
                              device="meta")
        dst_aug = torch.empty((f_loc, ref.AUG_ROWS, round_up(m_loc, TILE_M)),
                              device="meta")
        ref.blocked_argmin(src_aug, dst_aug)
    run_s = time.time() - t0
    iters = spec["iters"]
    flops = counter.flops * iters * n_dev
    # per iteration each frame's moved source goes to its other target
    # shards and their winners (score, x, y, z) come back to its home
    # device (core.distributed's combine)
    per_frame = (n_target - 1) * n * (3 + 4) * 4
    coll = {"combine": {"count": iters,
                        "bytes": iters * f * per_frame}}
    # useful flops: the xyz distance cross-term (2*3*N*M per iteration)
    useful = iters * f * (2.0 * 3 * n * m) / n_dev
    arg_bytes = (shard_bytes(src_sh, src_abs) + shard_bytes(dst_sh, dst_abs))
    out_bytes = f_loc * (16 + 5) * 4  # T (4x4) and the scalar diagnostics
    out = _collect(f"fpps-icp/{shape_name}/{mesh_name}", n_dev, arg_bytes,
                   out_bytes, 0, counter.peak_bytes, flops, coll,
                   model_flops_override=useful)
    out["timing"] = {"run_s": run_s}
    out["icp_spec"] = spec
    out["score_dtype"] = "fp32"  # the NN kernel's scores
    out["sharding"] = {"frame_axes": list(frame_axes),
                       "target_axes": list(target_axes)}
    return out


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: pathlib.Path, remat: str = "full",
             rules_overrides: dict | None = None,
             accum: int | None = None,
             kv_quant: bool = False) -> dict:
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    try:
        if arch == "fpps-icp":
            rec = _run_icp_cell(shape_name, mesh_name)
        else:
            ok, reason = runnable_cell(arch, shape_name)
            if not ok:
                rec = {"label": f"{arch}/{shape_name}/{mesh_name}",
                       "skipped": True, "reason": reason}
                path.write_text(json.dumps(rec, indent=2))
                print(f"SKIP {rec['label']}: {reason}")
                return rec
            rec = _run_lm_cell(arch, shape_name, mesh_name, rules_overrides,
                               remat, accum=accum, kv_quant=kv_quant)
        rec["status"] = "ok"
    except Exception as e:  # record failures as artifacts, don't hide them
        rec = {"label": f"{arch}/{shape_name}/{mesh_name}", "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    path.write_text(json.dumps(rec, indent=2, default=str))
    status = rec.get("status")
    print(f"[{status}] {rec['label']} -> {path}")
    if status == "ok":
        r, mem = rec["roofline"], rec["memory"]
        print(f"  args={mem['argument_bytes'] / 1e9:.3f} GB/device "
              f"temp={mem['temp_bytes'] / 1e9:.3f} GB/device "
              f"fits_h100_80g={mem['fits_h100_80g']} "
              f"flops={rec['analyzed']['flops']:.4e}/device "
              f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
              f"collective={r['collective_s']:.4f}s dominant={r['dominant']} "
              f"useful_frac={r['useful_fraction']:.3f}")
    return rec


def run_all(out_dir: pathlib.Path, meshes=("single", "multi"),
            only_missing: bool = True) -> list:
    """Every cell (the registry's 40 and the two fpps-icp cells) on both
    meshes, in this process (nothing is allocated: a cell's failure is its
    record's)."""
    out_dir = pathlib.Path(out_dir)
    all_cells = [(a, s) for (a, s) in cells()]
    all_cells += [("fpps-icp", s) for s in ICP_SHAPES]
    results = []
    for mesh_name in meshes:
        for arch, shape in all_cells:
            path = out_dir / f"{arch}__{shape}__{mesh_name}.json"
            if only_missing and path.exists():
                rec = json.loads(path.read_text())
                if rec.get("status") == "ok" or rec.get("skipped"):
                    continue
            run_cell(arch, shape, mesh_name, out_dir)
            results.append(path)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="FPPS dry-run on meta devices")
    ap.add_argument("--arch", choices=list_archs() + ["fpps-icp"])
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="with --all: re-run cells that already have results")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--accum", type=int, default=None,
                    help="gradient-accumulation depth (default: auto)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for decode cells")
    ap.add_argument("--rule", action="append", default=[],
                    help="logical-axis rule override, e.g. seq=data or "
                         "expert=; repeatable")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out_dir)
    if args.all:
        return run_all(out_dir, only_missing=not args.force)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    overrides = {}
    for r in args.rule:
        k, _, v = r.partition("=")
        overrides[k] = tuple(x for x in v.split(",") if x) or None
    return run_cell(args.arch, args.shape, args.mesh, out_dir,
                    remat=args.remat, rules_overrides=overrides or None,
                    accum=args.accum, kv_quant=args.kv_quant)


if __name__ == "__main__":
    main()
