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
expert parallelism (``repro.models.moe_ep``) waits for the partition
rules that select it (ROADMAP queue 1 item 8.4).
"""
from __future__ import annotations

import dataclasses

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


def route(logits: torch.Tensor, cfg: MoEConfig):
    """logits (T,E) fp32 -> (weights (T,k), idx (T,k), aux_metrics)."""
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :cfg.top_k], idx[:, :cfg.top_k]
    if cfg.normalize_topk:
        weights = weights / torch.clamp_min(
            weights.sum(dim=-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss + router z-loss.
    e = cfg.n_experts
    me = probs.mean(dim=0)                                        # (E,)
    assigned = torch.nn.functional.one_hot(idx, e).float().sum(1)  # (T,E)
    fe = assigned.mean(dim=0) / cfg.top_k
    aux = e * torch.sum(fe * me)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return weights, idx, {"load_balance_loss": aux, "router_z_loss": z}


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference does


def expert_mlp(p, buf: torch.Tensor, compute_dtype=L.COMPUTE_DTYPE
               ) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d), batched SwiGLU over the expert dim."""
    xb = buf.to(compute_dtype)
    wi, wg, wo = (p[n].to(compute_dtype) for n in ("wi", "wg", "wo"))
    h = L.silu(torch.bmm(xb, wg)) * torch.bmm(xb, wi)
    return torch.bmm(h, wo)


def _router_logits(p, flat: torch.Tensor) -> torch.Tensor:
    check_fp32_matmul(flat)
    return flat.float() @ p["router"]["kernel"].float()


def dispatch(idx: torch.Tensor, c: int, n_experts: int):
    """The pairs' sort by expert and which of them fit. idx (T,k) -> (order,
    st_tok, se, slot, keep), each (T*k,) in the sorted order: the pair's
    index (token * k + its rank in the token's top-k), its token and
    expert, its row of the (E*C, d) expert buffer, and whether it is within
    its expert's capacity ``c`` (the earliest tokens of an expert are
    kept)."""
    t, k = idx.shape
    pair_e = idx.reshape(t * k)                       # expert of each pair
    order = torch.argsort(pair_e, stable=True)
    se = pair_e[order]
    st_tok = torch.div(order, k, rounding_mode="floor")
    # first sorted pair of each expert: the reference's cumsum - bincount
    starts = torch.searchsorted(se, torch.arange(n_experts,
                                                 device=idx.device))
    pos = torch.arange(t * k, device=idx.device) - starts[se]
    keep = pos < c
    return order, st_tok, se, se * c + pos, keep


def combine(rows: torch.Tensor, st_tok: torch.Tensor, se: torch.Tensor,
            t: int, n_experts: int) -> torch.Tensor:
    """The reference's ``zeros((t, d)).at[st_tok].add(rows)`` over rows in
    the sorted pair order, with its bits: each token's k rows in ascending
    expert order, added one at a time from zero in the rows' dtype."""
    k = rows.shape[0] // t
    by_token = rows[torch.argsort(st_tok * n_experts + se)]
    by_token = by_token.reshape(t, k, rows.shape[1])
    out = torch.zeros((t, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for j in range(k):
        out = out + by_token[:, j]
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
