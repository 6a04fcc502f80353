"""Shared primitive layers: norms, RoPE, dense MLPs, embeddings (port of
``repro.models.layers``).

Conventions, as in the reference:
  * params are dict-like (a ``ParamTree`` or a plain dict of tensors).
    Matmul weights are stored (d_in, d_out).
  * activations are bf16; precision-sensitive math (norm reductions,
    softmax, rope) runs in fp32. The reference keeps fp32 master weights
    and casts them at every use; the port casts the matmul weights and
    tables to bf16 once when they are loaded (``models.lm``), which gives
    the same bits, and the ``.to`` calls below are then no-ops.
  * a bias is added after the product has been rounded to bf16, as the
    reference does, not fused into the GEMM's epilogue (``F.linear``
    rounds once).
  * the activations are ``jax.nn``'s formulas, one op at a time in the
    input's dtype with the constants rounded to it: each bf16 op then
    rounds where the reference's does (``F.silu``/``F.gelu`` round once).
"""
from __future__ import annotations

import math

import torch

COMPUTE_DTYPE = torch.bfloat16


def dense(p, x: torch.Tensor, compute_dtype=COMPUTE_DTYPE) -> torch.Tensor:
    y = x.to(compute_dtype) @ p["kernel"].to(compute_dtype)
    if "bias" in p:
        y = y + p["bias"].to(compute_dtype)
    return y


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head QK-norm (scale shaped (d_head,)), fp32 math."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               has_head_dim: bool = True) -> torch.Tensor:
    """Split-half RoPE. x: (..., S, H, d_head) if has_head_dim else
    (..., S, d_head); positions: (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)       # (d/2,)
    angles = positions[:, None].float() * freqs         # (S, d/2)
    if has_head_dim:
        angles = angles[:, None, :]                     # (S, 1, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), sigmoid as 1 / (1 + exp(-x))."""
    return x * (1 / (1 + torch.exp(-x)))


def _const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (a Python float, so no device copy)."""
    return torch.tensor(value, dtype=dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default)."""
    c = _const(math.sqrt(2 / math.pi), x.dtype)
    k = _const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def swiglu(p, x: torch.Tensor, compute_dtype=COMPUTE_DTYPE) -> torch.Tensor:
    h = silu(dense(p["wg"], x, compute_dtype)) * dense(p["wi"], x,
                                                       compute_dtype)
    return dense(p["wo"], h, compute_dtype)


def geglu(p, x: torch.Tensor, compute_dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """Gated-GELU MLP over swiglu-layout params (Gemma family)."""
    h = gelu(dense(p["wg"], x, compute_dtype)) * dense(p["wi"], x,
                                                       compute_dtype)
    return dense(p["wo"], h, compute_dtype)


def gelu_mlp(p, x: torch.Tensor, compute_dtype=COMPUTE_DTYPE) -> torch.Tensor:
    return dense(p["wo"], gelu(dense(p["wi"], x, compute_dtype)),
                 compute_dtype)


# ----------------------------------------------------------------------------
# Embedding / LM head
# ----------------------------------------------------------------------------
def embed(p, tokens: torch.Tensor, compute_dtype=COMPUTE_DTYPE
          ) -> torch.Tensor:
    return p["table"].to(compute_dtype)[tokens.long()]


def unembed(p, x: torch.Tensor, compute_dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """Tied head: logits = x @ tableᵀ (fp32 logits of a bf16 product)."""
    return (x.to(compute_dtype) @ p["table"].to(compute_dtype).T).float()
