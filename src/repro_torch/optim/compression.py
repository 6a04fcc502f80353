"""Int8 error-feedback gradient compression for the data-parallel mean
(port of ``repro.optim.compression``).

In place of the fp32 ring all-reduce of the gradients, each replica

    1. adds its error-feedback residual from the previous step,
    2. quantizes to int8 with its own per-tensor scale,
    3. REDUCE via all-to-all: replica j receives every replica's chunk j
       (the tensor padded to n chunks) and takes its mean
       (wire: ~1 byte a value instead of ~8),
    4. re-quantizes the mean chunk and all-gathers the int8 chunks back
       (wire: ~1 byte a value),
    5. dequantizes; keeps (its input - dequant(its quantized input)) as
       the new residual, so the quantization error goes into the next
       step instead of being lost.

The reference runs this inside ``shard_map`` with one tensor a device.
The port has no ``shard_map``: ``compressed_psum_mean`` takes the list of
the replicas' tensors, one a device along the mesh axis (each on its
device; devices may repeat, and the replicas on one device run as one
batch), and moves the chunks with ``.to(device)``.
The arithmetic is the reference's, op for op: the scale
``max(max|g|, 1e-12) / 127`` (as XLA computes it: times fp32(1/127)),
round half to even, the clip to [-127, 127], each received chunk's codes
times its sender's scale summed in replica order and divided by n. XLA
contracts a product and the add that takes it into one fused multiply-add
(the residual ``flat - q * scale`` and each step of the sum), so the port
rounds those once too (:func:`_fma`: the exact product and sum in fp64,
rounded to fp32), which gives the reference's bits. Wire bytes are recorded with
``roofline.report.record_collective`` as the reference's docstring counts
them: the int8 chunks each device sends and receives (and the fp32
scales), against 8 bytes a value for an fp32 ring
(:func:`fp32_ring_bytes`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.partition import (all_to_all, device_groups,
                                          in_block_order)
from repro_torch.roofline.report import record_collective

_EPS = 1e-12
_INV_127 = float(np.float32(1.0 / 127.0))


def _quantize(g: torch.Tensor):
    """Each row of ``g`` (..., N): its int8 codes and its fp32 scale."""
    # XLA turns the division by the constant 127 into a product with its
    # fp32 reciprocal (1 ulp apart on some inputs); the port does the same
    scale = torch.clamp_min(g.abs().amax(-1), _EPS) * _INV_127
    q = torch.clamp(torch.round(g / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.float()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
         ) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once: ``a`` holds int8 codes, so the
    product of ``a`` and the fp32 ``b`` is exact in fp64."""
    return (a.double() * b.double() + c.double()).float()


def _axis_devices(mesh, axis: str) -> list:
    """The devices along ``axis`` (at coordinate 0 of every other axis)."""
    k = mesh.axis_names.index(axis)
    index = [0] * len(mesh.axis_names)
    index[k] = slice(None)
    return list(mesh.devices[tuple(index)])


def compressed_psum_mean(gs, mesh, axis: str, efs, codes: list | None = None):
    """Mean-reduce the replicas' ``gs`` (one fp32 tensor a device along
    ``axis``, each on that device) with int8 compression.

    ``efs``: each replica's error-feedback residual, same shape. Returns
    (each replica's mean, each replica's new residual), on the replicas'
    devices; the replicas on one device share their mean's tensor.
    ``codes``, if a list, receives each replica's int8 codes of step 2
    and of step 4 (for tests and the smoke run). The replicas that share a
    device run as one batch."""
    devices = _axis_devices(mesh, axis)
    n = len(devices)
    if len(gs) != n or len(efs) != n:
        raise ValueError(f"{len(gs)} gradients / {len(efs)} residuals for "
                         f"{n} devices along {axis!r}")
    shape = gs[0].shape
    orig = gs[0].numel()
    pad = (-orig) % n
    chunk = (orig + pad) // n
    groups = device_groups(devices)
    sends, scales, new_efs = [], [], [None] * n
    for dev, ids in groups:
        flat = torch.stack([(gs[r].to(dev) + efs[r].to(dev)).reshape(-1)
                            for r in ids])
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        q, scale = _quantize(flat)
        residual = _fma(q, -scale[:, None], flat)[:, :orig]
        for a, r in enumerate(ids):
            new_efs[r] = residual[a].reshape(shape)
        sends.append(q.reshape(len(ids), n, chunk))
        scales.append(scale)
    # all-to-all of the chunks and all-gather of the scales: replica j
    # receives every replica's chunk j and takes their mean
    record_collective("all-to-all", n * (n - 1) * chunk)
    record_collective("all-gather", n * (n - 1) * 4)
    q2s, s2s = [], []
    for (dev, ids), recv in zip(groups, all_to_all(sends, groups, n)):
        scale = in_block_order([s.to(dev) for s in scales], groups)
        summed = torch.zeros((len(ids), chunk), dtype=torch.float32,
                             device=dev)
        for i in range(n):
            summed = _fma(recv[:, i], scale[i], summed)
        q2, s2 = _quantize(summed / n)
        q2s.append(q2)
        s2s.append(s2)
    # all-gather of the re-quantized chunks and their scales
    record_collective("all-gather", n * (n - 1) * (chunk + 4))
    outs = [None] * n
    for dev, ids in groups:
        q2 = in_block_order([q.to(dev) for q in q2s], groups)
        s2 = in_block_order([s.to(dev) for s in s2s], groups)
        full = (q2.float() * s2[:, None]).reshape(-1)[:orig].reshape(shape)
        for r in ids:
            outs[r] = full
    if codes is not None:
        codes.append((list(in_block_order(sends, groups)),
                       list(in_block_order(q2s, groups))))
    return outs, new_efs


def fp32_ring_bytes(n_values: int, n: int) -> int:
    """Bytes an fp32 ring all-reduce of ``n_values`` over ``n`` replicas
    moves in all: each replica sends 2 (n - 1) / n of its 4-byte values."""
    return 2 * (n - 1) * n_values * 4


def init_error_feedback(params) -> dict:
    """Zero residuals: a dict of the parameters' names (a module's
    ``named_parameters``, or a dict of tensors) to fp32 zeros."""
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else params)
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items()}


def compressed_grad_reduce(grads, mesh, axis: str, ef_state):
    """Compressed mean over the replicas' gradient dicts (``grads`` and
    ``ef_state``: one dict of name -> tensor a device along ``axis``),
    leaf by leaf in the dicts' order. Returns (each replica's dict of
    means, each replica's dict of new residuals)."""
    n = len(grads)
    outs = [{} for _ in range(n)]
    efs = [{} for _ in range(n)]
    for name in grads[0]:
        gm, ne = compressed_psum_mean([g[name].float() for g in grads], mesh,
                                      axis, [e[name] for e in ef_state])
        for r in range(n):
            outs[r][name] = gm[r]
            efs[r][name] = ne[r]
    return outs, efs
