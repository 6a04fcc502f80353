"""State-space mixers: Mamba-2 (SSD, chunked) and Griffin's RG-LRU (port of
``repro.models.ssm``).

Mamba-2 / SSD (arXiv:2405.21060): the chunked "state-space duality"
algorithm, an intra-chunk quadratic part (attention-like matmuls) plus an
inter-chunk linear recurrence over chunk states. ``ssd_naive``, the
sequential recurrence, is the oracle the tests hold it to.

RG-LRU (Griffin, arXiv:2402.19427): the gated linear recurrence
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t),
    a_t = exp(-c · softplus(Λ) · r_t),
computed over the sequence by :func:`linear_scan`, the odd/even recursion
of ``jax.lax.associative_scan`` (log depth: ~2 log2(S) rounds of
elementwise ops, not S). :func:`linear_scan_naive` is its sequential
oracle for the tests.

As in the reference, activations are bf16 and the recurrences, gates and
states fp32, each op in the reference's dtype and order:
  * ``_causal_conv`` returns its state in the activations' dtype (bf16),
    while ``mamba2_init_state`` and ``rglru_init_state`` make it fp32;
  * the SSD state and the RG-LRU ``h`` stay fp32; ``_rglru_core`` returns
    the sequence cast to the activations' dtype and ``h_last`` unrounded;
  * the RG-LRU gates ``w_a`` and ``w_i`` are fp32 matmuls on fp32 weights
    (``models.lm`` keeps those two leaves fp32 at load);
  * ``softplus`` and ``sigmoid`` follow ``jax.nn``'s formulas.
The fp32 reductions (cumsum, einsum, the scan tree) run in another order
than XLA's, so they agree with the reference to a tolerance, not to bits.

The reference's ``mamba2_init`` and ``rglru_block_init`` have no function
here: their layouts and initialisers are ``models.lm._layer_shapes``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

RGLRU_C = 8.0   # Griffin's c in a_t = exp(-c · softplus(Λ) · r_t)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    chunk: int = 256
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim


def _split_proj(p, u: torch.Tensor, cfg: SSMConfig):
    d_in, ds, nh = cfg.d_inner, cfg.d_state, cfg.n_heads
    zxbcdt = L.dense(p["in_proj"], u)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + d_in + 2 * ds]
    dt = zxbcdt[..., -nh:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv1d, width W. xBC: (B,S,C); conv_w: (W,C).

    If ``state`` ((B, W-1, C), previous inputs) is given, runs in streaming
    mode. Returns (out, new_state), the state in xBC's dtype."""
    w = conv_w.shape[0]
    if state is not None:
        ctx = torch.cat([state.to(xBC.dtype), xBC], dim=1)
    else:
        ctx = F.pad(xBC, (0, 0, w - 1, 0))
    new_state = ctx[:, -(w - 1):]
    s = xBC.shape[1]
    # the reference's sum() from 0: the same bits, as 0 + term_0 is exact
    out = ctx[:, :s] * conv_w[0].to(xBC.dtype)
    for i in range(1, w):
        out = out + ctx[:, i:i + s] * conv_w[i].to(xBC.dtype)
    out = L.silu(out + conv_b.to(xBC.dtype))
    return out, new_state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) log-decays -> (..., Q, Q) lower-triangular cumulative
    sums: out[i,j] = sum_{k=j+1..i} x[k] for i >= j, -inf otherwise (masked
    after the subtraction, so no inf - inf)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """SSD forward. Shapes: x (b,s,h,p); dt (b,s,h) [post-softplus];
    A (h,) [negative]; Bm, Cm (b,s,n). Returns (y (b,s,h,p) in x's dtype,
    final_state (b,h,p,n) fp32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    # dt-scaled input & per-step log decay
    xd = x * dt[..., None]                                 # (b,s,h,p)
    dA = dt * A[None, None, :]                             # (b,s,h)
    xc = xd.reshape(b, nc, chunk, h, p).float()
    dAc = dA.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n).float()
    Cc = Cm.reshape(b, nc, chunk, n).float()
    dA_cs = torch.cumsum(dAc, dim=2)                       # (b,nc,Q,h)

    # 1) intra-chunk: Y_diag[l] = Σ_{s<=l} C_l·B_s decay x_s
    Lmat = torch.exp(_segsum(dAc.permute(0, 1, 3, 2)))     # (b,nc,h,Q,Q)
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)           # (b,nc,Q,Q)
    W = Lmat * CB[:, :, None]                              # (b,nc,h,Q,Q)
    Y_diag = torch.einsum("bchls,bcshp->bclhp", W, xc)

    # 2) each chunk's contribution to the carried state
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b,nc,Q,h)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, decay_states, xc)

    # 3) inter-chunk recurrence, one step a chunk; keep the state before it
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # (b,nc,h)
    carry = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (b,nc,h,p,n)

    # 4) state -> output within the chunk
    state_decay = torch.exp(dA_cs)                         # (b,nc,Q,h)
    Y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states,
                         state_decay)

    y = (Y_diag + Y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_naive(x, dt, A, Bm, Cm, initial_state=None):
    """Sequential reference recurrence for tests: a step a token."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    hstate = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
              if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A[None, :])              # (b,h)
        hstate = hstate * dA[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t].float() * dt[:, t, :, None],
            Bm[:, t].float())
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), hstate


def mamba2_forward(p, u: torch.Tensor, cfg: SSMConfig, initial_state=None,
                   conv_state=None, return_state: bool = False):
    """u: (B,S,D) -> (B,S,D). Optionally returns (out, (conv_state,
    ssm_state))."""
    b, s, _ = u.shape
    d_in, ds, nh, hp = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim
    z, xBC, dt = _split_proj(p, u, cfg)
    xBC, new_conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                       conv_state)
    x = xBC[..., :d_in].reshape(b, s, nh, hp)
    Bm = xBC[..., d_in:d_in + ds]
    Cm = xBC[..., d_in + ds:]
    A = -torch.exp(p["A_log"].float())
    dt = _softplus(dt.float() + p["dt_bias"].float())
    # Pad S up to a chunk multiple with dt=0 no-op steps: dA=exp(0)=1 keeps
    # the carried state untouched and x̄=x·dt=0 injects nothing, so outputs
    # and final_state are the unpadded sequence's.
    pad = (-s) % cfg.chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, final_state = ssd_chunked(x, dt, A, Bm, Cm, cfg.chunk, initial_state)
    if pad:
        y = y[:, :s]
        x = x[:, :s]
    y = y + p["D"].to(y.dtype)[None, None, :, None] * x
    y = y.reshape(b, s, d_in)
    # gated RMSNorm (Mamba-2): norm(y * silu(z)), at rmsnorm's default eps
    y = L.rmsnorm(p["norm"], y * L.silu(z))
    out = L.dense(p["out_proj"], y)
    if return_state:
        return out, (new_conv_state, final_state)
    return out


def mamba2_init_state(batch: int, cfg: SSMConfig, dtype=torch.float32,
                      device=None):
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    return (torch.zeros(batch, cfg.conv_width - 1, conv_dim, dtype=dtype,
                        device=device),
            torch.zeros(batch, cfg.n_heads, cfg.headdim, cfg.d_state,
                        dtype=dtype, device=device))


def mamba2_decode_step(p, u: torch.Tensor, state, cfg: SSMConfig):
    """u: (B,1,D); state from mamba2_init_state. O(1) per token."""
    conv_state, h = state
    b = u.shape[0]
    d_in, ds, nh, hp = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim
    z, xBC, dt = _split_proj(p, u, cfg)
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    x = xBC[:, 0, :d_in].reshape(b, nh, hp)
    Bm = xBC[:, 0, d_in:d_in + ds]
    Cm = xBC[:, 0, d_in + ds:]
    A = -torch.exp(p["A_log"].float())
    dt1 = _softplus(dt[:, 0].float() + p["dt_bias"].float())     # (B,h)
    dA = torch.exp(dt1 * A[None, :])                             # (B,h)
    # h' = h * dA + dt·x ⊗ B
    xd = x.float() * dt1[..., None]
    h = h.float() * dA[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xd, Bm.float())
    y = torch.einsum("bhpn,bn->bhp", h, Cm.float())
    y = y + p["D"].float()[None, :, None] * x.float()
    y = y.reshape(b, 1, d_in).to(u.dtype)
    y = L.rmsnorm(p["norm"], y * L.silu(z))
    return L.dense(p["out_proj"], y), (conv_state, h)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / recurrentgemma)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    lru_width: int
    conv_width: int = 4
    c: float = RGLRU_C


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (even has as many entries
    as odd, or one more)."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """The scan of (a, b) pairs under (a_l, b_l) ∘ (a_r, b_r) = (a_l a_r,
    b_l a_r + b_r) along dim 1: -> (a_scan, b_scan), where b_scan[:, t] is
    h_t of h_t = a_t h_{t-1} + b_t from h_{-1} = 0 and a_scan[:, t] the
    product a_0 ... a_t. ``jax.lax.associative_scan``'s odd/even recursion,
    pair for pair: combine adjacent pairs, scan the half-length sequence
    (the odd outputs), then combine each with the next even input."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a_r, b_r = a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = linear_scan(a[:, 0:-1:2] * a_r, b[:, 0:-1:2] * a_r + b_r)
    if n % 2 == 0:
        odd_a_in, odd_b_in = odd_a[:, :-1], odd_b[:, :-1]
    else:
        odd_a_in, odd_b_in = odd_a, odd_b
    a_e = a[:, 2::2]
    even_a = torch.cat([a[:, :1], odd_a_in * a_e], dim=1)
    even_b = torch.cat([b[:, :1], odd_b_in * a_e + b[:, 2::2]], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def linear_scan_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sequential oracle for tests: h_t = a_t h_{t-1} + b_t along dim 1
    from h_{-1} = 0; -> h (B,S,W)."""
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def _rglru_core(p, x: torch.Tensor, cfg: RGLRUConfig, h0=None):
    """x: (B,S,W) post-conv activations. Returns (h_seq in x's dtype,
    h_last fp32)."""
    r = _sigmoid(L.dense(p["w_a"], x, torch.float32))
    i = _sigmoid(L.dense(p["w_i"], x, torch.float32))
    log_a = -cfg.c * _softplus(p["lambda"].float()) * r
    a = torch.exp(log_a)
    gated_x = x.float() * i
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * gated_x
    a_scan, b_scan = linear_scan(a, b)
    h = b_scan if h0 is None else b_scan + a_scan * h0[:, None, :]
    return h.to(x.dtype), h[:, -1]


def rglru_block_forward(p, u: torch.Tensor, cfg: RGLRUConfig, state=None,
                        return_state: bool = False):
    """Griffin recurrent block: gate ⊙ RG-LRU(conv(W_in u)), then W_out.

    state: (conv_state (B,W-1,w), h (B,w)) or None."""
    conv_state, h0 = state if state is not None else (None, None)
    gate = L.gelu(L.dense(p["w_gate"], u))
    rec = L.dense(p["w_rec_in"], u)
    rec, new_conv_state = _causal_conv(rec, p["conv_w"], p["conv_b"],
                                       conv_state)
    h, h_last = _rglru_core(p, rec, cfg, h0)
    out = L.dense(p["w_out"], gate * h)
    if return_state:
        return out, (new_conv_state, h_last.float())
    return out


def rglru_init_state(batch: int, cfg: RGLRUConfig, dtype=torch.float32,
                     device=None):
    return (torch.zeros(batch, cfg.conv_width - 1, cfg.lru_width,
                        dtype=dtype, device=device),
            torch.zeros(batch, cfg.lru_width, dtype=torch.float32,
                        device=device))
