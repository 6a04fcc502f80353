"""Explicit expert-parallel MoE: local sort + all-to-all (port of
``repro.models.moe_ep``).

The reference runs this under ``shard_map``. The port has no
``shard_map``; as in ``core.distributed``, one process drives every mesh
device, and a device's work is a plain block of code on that device's
tensors:

  per device (tokens local over the token axes, experts local over the one
  expert axis):
    1. route its own tokens in fp32 and sort them into an (E, C, d) send
       buffer, with the capacity C counted per source shard
       (``capacity(t_loc)``), so the drops differ from ``moe.moe_forward``'s;
    2. all-to-all over the expert axis: slab ``e // E_loc`` of the buffer
       goes to the device that owns those experts, which receives its
       experts' slabs from every token shard of its row;
    3. FSDP all-gather of its experts' weights where ``fsdp`` names a mesh
       axis (recorded only: one process holds the whole weights), then one
       bf16 SwiGLU over (E_loc, n_ep * C, d) (``moe.expert_mlp``'s op
       order);
    4. the reverse all-to-all and the weighted combine back to its tokens
       (``moe.combine``: the reference's bf16 add order).

The batch is split over the token axes and the sequence over the expert
axis (the reference's in_specs ``P(tok, expert, None)``); devices on the
mesh's other axes hold replicas in the reference, and the port computes
each block once, on the replica at coordinate 0. The blocks that share a
device run as one batch (``moe.route``, ``dispatch``, ``expert_mlp`` and
``combine`` take a leading block dim), so a (2, 4) mesh of ``cuda:0``
repeated, or a production mesh of 256 ``meta`` devices, costs one
block's launches, not 8 or 256 times them; with one group the
all-to-alls are a transpose, and the blocks of an expert shard read a
view of its weights (no copy of them). Slabs move between devices with
``.to(device)``, so autograd carries the gradient back through both
all-to-alls: the layer trains. The router's aux metrics
are averaged over the token axes, then the expert axis (the reference's
``pmean``s); ``dropped_frac`` is 0, as the reference reports it (its drops
are tracked per shard and not returned). The bytes each collective moves
between distinct mesh coordinates are recorded with
``roofline.report.record_collective``. ``moe``'s functions are called
through the module, so a tracer that wraps ``moe.route`` / ``moe.dispatch``
sees each shard's call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import check_fp32_matmul
from repro_torch.launch.partition import (all_to_all, device_groups,
                                          in_block_order)
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.roofline.report import record_collective


def _axes_of(v) -> tuple:
    if not v:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def moe_forward_ep(p, x: torch.Tensor, cfg: moe_lib.MoEConfig, mesh,
                   rules):
    """Expert-parallel forward over ``mesh`` (a ``core.distributed.Mesh``)
    under ``rules`` (a partitioning context's merged rules: "expert" one
    mesh axis, "tokens" and "fsdp" axes or None). x: (B,S,D) -> (out,
    metrics). Raises where the reference's ``shard_map`` would reject the
    shapes: more or less than one expert axis, E, S or B not split evenly,
    d not split by the FSDP axes."""
    expert_axes = _axes_of(rules.get("expert"))
    if len(expert_axes) != 1:
        raise ValueError(f"EP wants exactly one expert axis, got "
                         f"{expert_axes}")
    ax = expert_axes[0]
    names = mesh.axis_names
    n_ep = mesh.shape[ax]
    fsdp = tuple(a for a in _axes_of(rules.get("fsdp"))
                 if a in names and a != ax)
    tok = tuple(a for a in _axes_of(rules.get("tokens"))
                if a in names and a != ax)
    e = cfg.n_experts
    b, s, d = x.shape
    n_tok = int(np.prod([mesh.shape[a] for a in tok]))
    n_fsdp = int(np.prod([mesh.shape[a] for a in fsdp]))
    if e % n_ep:
        raise ValueError(f"{e} experts do not split over {n_ep} devices")
    if b % n_tok or s % n_ep:
        raise ValueError(f"x {tuple(x.shape)}: batch over {tok} ({n_tok}) "
                         f"or sequence over {ax} ({n_ep}) does not divide")
    if d % n_fsdp:
        raise ValueError(f"d_model {d} does not split over {fsdp}")
    e_loc, b_loc, s_loc = e // n_ep, b // n_tok, s // n_ep
    t = b_loc * s_loc
    c = moe_lib.capacity(t, cfg)

    def device(i: int, j: int):
        """Token block i (row-major over ``tok``), expert shard j; the
        replica at coordinate 0 of every other axis."""
        coord = [0] * len(names)
        for a in reversed(tok):
            i, coord[names.index(a)] = divmod(i, mesh.shape[a])
        coord[names.index(ax)] = j
        return mesh.devices[tuple(coord)]

    nb = n_tok * n_ep
    groups = device_groups([device(*divmod(blk, n_ep)) for blk in range(nb)])
    # block (i, j) = batch rows i*b_loc.. and sequence j*s_loc.., flat
    xs = x.reshape(n_tok, b_loc, n_ep, s_loc, d).transpose(1, 2).reshape(
        nb, t, d)
    sends, infos, metric_parts = [], [], []
    for dev, ids in groups:
        flat = _blocks(xs, ids).to(dev)                         # (n, t, d)
        check_fp32_matmul(flat)
        logits = flat.float() @ p["router"]["kernel"].to(dev).float()
        weights, idx, metrics = moe_lib.route(logits, cfg)
        order, st_tok, se, slot, keep = moe_lib.dispatch(idx, c, e)
        sw = moe_lib.rows_of(weights.reshape(len(ids), t * cfg.top_k), order)
        buf = torch.zeros((len(ids), e * c + 1, d), dtype=flat.dtype,
                          device=dev)
        bidx = torch.arange(len(ids), device=dev)[:, None]
        buf[bidx, torch.where(keep, slot, e * c)] = moe_lib.rows_of(
            flat, st_tok)                                 # overflow: trash
        sends.append(buf[:, :e * c].reshape(len(ids), n_ep, e_loc, c, d))
        infos.append((st_tok, se, slot, keep, sw))
        metric_parts.append(metrics)
    # each device sends n_ep - 1 of its n_ep slabs to other devices
    slab_bytes = e_loc * c * d
    record_collective("all-to-all", nb * (n_ep - 1) * slab_bytes
                      * x.element_size())
    recvs = all_to_all(sends, groups, n_ep)    # my experts' slab from each
    if fsdp:  # FSDP all-gather of each block's experts' shards
        for name in ("wi", "wg", "wo"):
            record_collective("all-gather", nb * (n_fsdp - 1)
                              * _nbytes(p[name]) // (n_ep * n_fsdp))
    if len(groups) == 1:
        # every block on one device: expert shard j's weights are a view
        # of rows j of (n_ep, E_loc, ...), shared by the token rows' blocks
        # of that shard, one product a token row
        dev = groups[0][0]
        local = {name: p[name].to(dev).reshape(n_ep, e_loc,
                                               *p[name].shape[1:])
                 for name in ("wi", "wg", "wo")}
        recv = recvs[0].reshape(n_tok, n_ep, n_ep, e_loc, c, d)
        ys = [moe_lib.expert_mlp(local, row.transpose(1, 2).reshape(
            n_ep, e_loc, n_ep * c, d)) for row in recv]  # (n_ep, E_loc, ..)
        backs = [torch.stack(ys).reshape(n_tok, n_ep, e_loc, n_ep, c, d)
                 .transpose(2, 3).reshape(nb, n_ep, e_loc, c, d)]
    else:
        backs = []
        for (dev, ids), recv in zip(groups, recvs):
            mine = recv.transpose(1, 2).reshape(len(ids), e_loc, n_ep * c, d)
            local = {name: torch.stack([
                p[name][(blk % n_ep) * e_loc:(blk % n_ep + 1) * e_loc].to(dev)
                for blk in ids]) for name in ("wi", "wg", "wo")}
            y = moe_lib.expert_mlp(local, mine)     # (n, E_loc, n_ep*C, d)
            backs.append(y.reshape(len(ids), e_loc, n_ep, c, d)
                         .transpose(1, 2))
    record_collective("all-to-all", nb * (n_ep - 1) * slab_bytes
                      * backs[0].element_size())
    outs = []
    for (dev, ids), back, (st_tok, se, slot, keep, sw) in zip(
            groups, all_to_all(backs, groups, n_ep), infos):
        rows = moe_lib.rows_of(back.reshape(len(ids), e * c, d),
                               torch.where(keep, slot, 0))
        rows = rows * (sw * keep).to(rows.dtype)[..., None]
        outs.append(moe_lib.combine(rows, st_tok, se, t, e).to(x.device))
    out = in_block_order(outs, groups).reshape(
        n_tok, n_ep, b_loc, s_loc, d).transpose(1, 2).reshape(b, s, d)

    # aux metrics: average over every token-holding axis, then the expert
    # axis (the reference's pmeans, each a sum over the axis / its size)
    grid_shape = tuple(mesh.shape[a] for a in tok) + (n_ep,)
    metrics = {k: _reduce_axes(in_block_order(
        [m[k].to(x.device) for m in metric_parts], groups), grid_shape)
        for k in metric_parts[0]}
    metrics["dropped_frac"] = torch.zeros((), dtype=torch.float32,
                                          device=x.device)
    metrics["moe_aux_total"] = (cfg.aux_loss_coef
                                * metrics["load_balance_loss"]
                                + cfg.z_loss_coef * metrics["router_z_loss"])
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], x.reshape(-1, d)).reshape(x.shape)
    return out, metrics


def _blocks(xs: torch.Tensor, ids: list) -> torch.Tensor:
    """Rows ``ids`` of a (blocks, ...) tensor (a view when they are all of
    them, in order)."""
    if ids == list(range(xs.shape[0])):
        return xs
    return torch.stack([xs[blk] for blk in ids])


def _reduce_axes(vals: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The mean of per-block scalars (block order, row-major over
    ``shape``), taken over the axes in order, each a sequential sum over
    the axis divided by its size."""
    vals = vals.reshape(shape)
    while vals.dim():
        tot = vals[0]
        for r in range(1, vals.shape[0]):
            tot = tot + vals[r]
        vals = tot / vals.shape[0]
    return vals
