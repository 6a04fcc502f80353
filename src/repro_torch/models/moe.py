"""Mixture-of-Experts FFN: fine-grained routed experts + shared experts (port
of ``repro.models.moe``).

Covers both MoE archs of the registry:
  * deepseek-moe-16b: 64 routed (top-6) + 2 shared experts, softmax -> top-k
    router without weight renormalisation (DeepSeekMoE, arXiv:2401.06066).
  * qwen3-moe-235b-a22b: 128 routed (top-8), no shared, renormalised top-k.

Dispatch is sort-based with a static per-expert capacity (GShard-style
drops): the (token, expert) pairs are sorted by expert, packed into an
(E, C, d) buffer, run through a batched expert SwiGLU (one bf16 batched
product a matrix) and combined back with the router weights. A pair past
its expert's capacity is dropped: it adds nothing, and the residual stream
passes through.

As in the reference, and where the card could compute otherwise:
  * the router product is fp32 with the fp32 router (IEEE fp32 on the card,
    ``device.check_fp32_matmul``: TF32 ranks experts differently);
  * top-k takes the lower expert index first on equal probabilities
    (``jax.lax.top_k``'s order): a stable descending sort cut to k;
  * which pairs fit is decided by a stable sort of the pair experts (the
    earliest tokens of an expert are kept), with no host sync;
  * each token's k weighted rows are summed in bf16 in ascending expert
    order, one add at a time from zero: the reference's scatter-add over
    the sorted pairs. ``index_add_`` on the card adds through atomics in no
    fixed order.
This is the single-program path the reference runs without a mesh;
``models.moe_ep`` is the expert-parallel one, which ``lm._moe_dispatch``
picks under partition rules that select it.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.device import check_fp32_matmul
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    normalize_topk: bool = False      # True for qwen3
    aux_loss_coef: float = 0.001
    z_loss_coef: float = 0.001


def moe_init_numpy(cfg: MoEConfig, seed: int = 0, path: str = "") -> dict:
    """One MoE FFN's weights in the reference's ``moe_init`` layout as fp32
    numpy: the fp32 router (d, E), the raw experts ``wi`` / ``wg`` (E, d,
    f) and ``wo`` (E, f, d), and the shared SwiGLU if any, each leaf
    normal(0.02) from its own generator seeded by (seed, crc32 of
    ``path``/its name), as ``lm.init_params_numpy`` draws a layer's."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
    shapes = {"router/kernel": (d, e), "wi": (e, d, f), "wg": (e, d, f),
              "wo": (e, f, d)}
    if cfg.n_shared_experts:
        w = cfg.n_shared_experts * f
        shapes.update({"shared/wi/kernel": (d, w), "shared/wg/kernel": (d, w),
                       "shared/wo/kernel": (w, d)})
    out: dict = {}
    for name, shape in shapes.items():
        key = f"{path}/{name}" if path else name
        rng = np.random.default_rng([seed, zlib.crc32(key.encode())])
        arr = rng.standard_normal(shape, dtype=np.float32)
        arr *= np.float32(0.02)
        node = out
        *parents, leaf = name.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return out


def route(logits: torch.Tensor, cfg: MoEConfig):
    """logits (T,E) fp32 -> (weights (T,k), idx (T,k), aux_metrics); a
    leading batch dim (a batch of token blocks, ``models.moe_ep``) routes
    each block alone, with per-block metrics."""
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[..., :cfg.top_k], idx[..., :cfg.top_k]
    if cfg.normalize_topk:
        weights = weights / torch.clamp_min(
            weights.sum(dim=-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss + router z-loss.
    e = cfg.n_experts
    me = probs.mean(dim=-2)                                       # (E,)
    # one_hot's values without its range check (a host sync on the card)
    experts = torch.arange(e, device=idx.device)
    assigned = (idx[..., None] == experts).float().sum(-2)       # (T,E)
    fe = assigned.mean(dim=-2) / cfg.top_k
    aux = e * torch.sum(fe * me, dim=-1)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2, dim=-1)
    return weights, idx, {"load_balance_loss": aux, "router_z_loss": z}


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference does


def expert_mlp(p, buf: torch.Tensor, compute_dtype=L.COMPUTE_DTYPE
               ) -> torch.Tensor:
    """buf: (..., E, C, d) -> (..., E, C, d), batched SwiGLU over the
    expert dim (and any leading dims the weights share)."""
    xb = buf.to(compute_dtype)
    wi, wg, wo = (p[n].to(compute_dtype) for n in ("wi", "wg", "wo"))
    h = L.silu(torch.matmul(xb, wg)) * torch.matmul(xb, wi)
    return torch.matmul(h, wo)


def _router_logits(p, flat: torch.Tensor) -> torch.Tensor:
    check_fp32_matmul(flat)
    return flat.float() @ p["router"]["kernel"].float()


def rows_of(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 1-D ``idx``; for a (B, M) ``idx`` (a batch of
    blocks) each block's rows of its own ``x[b]``: ``x[b, idx[b]]``."""
    if idx.dim() == 1:
        return x[idx]
    return x[torch.arange(idx.shape[0], device=idx.device)[:, None], idx]


def dispatch(idx: torch.Tensor, c: int, n_experts: int):
    """The pairs' sort by expert and which of them fit. idx (T,k) -> (order,
    st_tok, se, slot, keep), each (T*k,) in the sorted order: the pair's
    index (token * k + its rank in the token's top-k), its token and
    expert, its row of the (E*C, d) expert buffer, and whether it is within
    its expert's capacity ``c`` (the earliest tokens of an expert are
    kept). A (B, T, k) ``idx`` sorts each block alone: (B, T*k) each."""
    *lead, t, k = idx.shape
    pair_e = idx.reshape(*lead, t * k)                # expert of each pair
    order = torch.argsort(pair_e, dim=-1, stable=True)
    se = torch.gather(pair_e, -1, order)
    st_tok = torch.div(order, k, rounding_mode="floor")
    # first sorted pair of each expert: the reference's cumsum - bincount
    experts = torch.arange(n_experts, device=idx.device)
    starts = torch.searchsorted(se, experts.expand(*lead, n_experts)
                                .contiguous())
    pos = (torch.arange(t * k, device=idx.device)
           - torch.gather(starts, -1, se))
    keep = pos < c
    return order, st_tok, se, se * c + pos, keep


def combine(rows: torch.Tensor, st_tok: torch.Tensor, se: torch.Tensor,
            t: int, n_experts: int) -> torch.Tensor:
    """The reference's ``zeros((t, d)).at[st_tok].add(rows)`` over rows in
    the sorted pair order, with its bits: each token's k rows in ascending
    expert order, added one at a time from zero in the rows' dtype. Rows
    (B, T*k, d) of a batch of blocks combine each block alone."""
    *lead, tk, d = rows.shape
    by_token = rows_of(rows, torch.argsort(st_tok * n_experts + se, dim=-1))
    by_token = by_token.reshape(*lead, t, tk // t, d)
    out = torch.zeros((*lead, t, d), dtype=rows.dtype, device=rows.device)
    for j in range(tk // t):
        out = out + by_token[..., j, :]
    return out


def moe_forward(p, x: torch.Tensor, cfg: MoEConfig):
    """x: (B,S,D) -> (out (B,S,D), metrics)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    c = capacity(t, cfg)
    flat = x.reshape(t, d)
    weights, idx, metrics = route(_router_logits(p, flat), cfg)
    order, st_tok, se, slot, keep = dispatch(idx, c, e)
    sw = weights.reshape(-1)[order]
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, slot, e * c)] = flat[st_tok]  # overflow -> trash
    h = expert_mlp(p, buf[:e * c].reshape(e, c, d))   # (E,C,d)
    rows = h.reshape(e * c, d)[torch.where(keep, slot, 0)]
    rows = rows * (sw * keep).to(rows.dtype)[:, None]
    out = combine(rows, st_tok, se, t, e)
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], flat)
    # the mean as XLA computes it: the sum times fp32(1 / n)
    metrics["dropped_frac"] = 1.0 - keep.float().sum() * (1.0 / keep.numel())
    metrics["moe_aux_total"] = (
        cfg.aux_loss_coef * metrics["load_balance_loss"]
        + cfg.z_loss_coef * metrics["router_z_loss"])
    return out.reshape(b, s, d), metrics


def moe_forward_dense(p, x: torch.Tensor, cfg: MoEConfig):
    """Exact dense oracle (every expert computes every token): O(E·T·d·f),
    for parity tests on small configs only."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    logits = _router_logits(p, flat)
    weights, idx, metrics = route(logits, cfg)
    # combine weights (T, E): the top-k weights landing on each expert
    comb = torch.zeros_like(logits).scatter_add_(1, idx, weights)
    xb = flat.to(torch.bfloat16)
    wi, wg, wo = (p[n].to(torch.bfloat16) for n in ("wi", "wg", "wo"))
    h = L.silu(torch.einsum("td,edf->tef", xb, wg))
    h = h * torch.einsum("td,edf->tef", xb, wi)
    y = torch.einsum("tef,efd->ted", h, wo)
    out = torch.einsum("ted,te->td", y.float(), comb)
    if cfg.n_shared_experts:
        out = out + L.swiglu(p["shared"], flat).float()
    return out.to(x.dtype).reshape(b, s, d), metrics
