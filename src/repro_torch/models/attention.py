"""Attention variants with caches for decode (port of
``repro.models.attention``): grouped-query attention (GQA/MQA/MHA: full,
query-blocked and local-window) and DeepSeek-style multi-head latent
attention (MLA, MiniCPM3's mixer).

As in the reference:
  * scores and softmax in fp32 (q scaled before the product), the
    probabilities cast to bf16 before the PV product. No
    ``scaled_dot_product_attention``: its fused paths compute other
    numbers.
  * query-blocked attention (``q_block``) runs only when S > q_block and S
    divides into blocks; each block takes an exact softmax against the full
    K, so memory is O(q_block x S_kv).
  * local attention keeps a ring KV cache of ``window`` slots: position p
    lives in slot p % window, and a slot whose position is -1 was never
    written.
  * ``kv_quant`` stores K and V as int8 with one bf16 absmax scale per
    (token, head) vector.

Prefill repeats the KV heads up to the query heads (the reference's
repeat-KV); decode uses the grouped reshape. Both compute the same thing.
The port updates a decode cache in place, which stands in for the
reference's donated buffer.

MLA, as in the reference:
  * prefill decompresses K and V from the latent (``wuk``, ``wuv`` through
    ``L.dense``, bf16 at use) and honours ``q_block``; the scale is
    ``(qk_nope + qk_rope) ** -0.5``, applied to the summed fp32 scores.
  * ``wdkv`` fuses the latent and the rope key: its first
    ``kv_lora_rank`` columns are the latent ``c``, the rest the one rope
    key shared by every head.
  * decode absorbs ``wuk`` into the query and ``wuv`` into the output
    (fp32 products with the fp32 masters), so the cache holds
    ``kv_lora_rank + qk_rope_head_dim`` values a token. On the card these
    products must be IEEE fp32 (``device.check_fp32_matmul``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import check_fp32_matmul
from repro_torch.models import layers as L

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int = 0             # 0 => global causal
    q_block: int = 0            # 0 => unblocked (full scores)
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rms_eps: float = 1e-5
    kv_quant: bool = False      # int8 KV cache (per-vector scales)


def _project_qkv(p, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    q = L.dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = L.dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = L.dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = L.rms_head_norm(p["q_norm"], q, cfg.rms_eps)
        k = L.rms_head_norm(p["k_norm"], k, cfg.rms_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, q_pos, kv_pos, *, window: int, scale: float):
    """q: (B,Sq,H,dh); k,v: (B,Skv,Hkv,dh); positions (Sq,)/(Skv,).

    Causal (+ optional local-window) grouped attention. kv_pos < 0 marks
    invalid (unwritten ring) slots.
    """
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * scale, k.float())
    mask = kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    mask &= kv_pos[None, :] >= 0
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, dh)


def _attend(p, q, k, v, positions, cfg: AttnConfig):
    """The prefill/forward attention of projected q, k, v: repeat-KV, the
    ``q_block`` loop, and the output projection."""
    b, s = q.shape[:2]
    g = cfg.n_heads // cfg.n_kv_heads
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scale = cfg.d_head ** -0.5
    qb = cfg.q_block
    if qb and s > qb and s % qb == 0:
        out = torch.cat([
            _sdpa(q[:, i:i + qb], k, v, positions[i:i + qb], positions,
                  window=cfg.window, scale=scale)
            for i in range(0, s, qb)], dim=1)
    else:
        out = _sdpa(q, k, v, positions, positions, window=cfg.window,
                    scale=scale)
    return L.dense(p["wo"], out.reshape(b, s, -1))


def gqa_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: AttnConfig) -> torch.Tensor:
    """Training/prefill forward (no cache). positions: (S,) int32."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    return _attend(p, q, k, v, positions, cfg)


def _kv_quantize(x: torch.Tensor):
    """(..., d_head) -> (int8 values, bf16 scales (...,)). Per-vector absmax
    scaling (KIVI/KVQuant-style per-token-per-head granularity)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127
                    ).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def _cache_size(cfg: AttnConfig, max_len: int) -> int:
    return min(cfg.window, max_len) if cfg.window else max_len


def gqa_init_cache(batch: int, max_len: int, cfg: AttnConfig,
                   dtype=torch.bfloat16, device=None) -> dict:
    size = _cache_size(cfg, max_len)
    shape = (batch, size, cfg.n_kv_heads, cfg.d_head)
    # per-slot absolute position; -1 == never written (ring validity)
    cache = {"pos": torch.full((size,), -1, dtype=torch.int32,
                               device=device)}
    if cfg.kv_quant:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{name}_scale"] = torch.zeros(
                shape[:-1], dtype=torch.bfloat16, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _write(cache: dict, k, v, slots, positions, quant: bool) -> None:
    """Write K/V rows (B, n, Hkv, dh) at cache ``slots`` (a slice or an
    index tensor) in place, quantising them for an int8 cache."""
    if quant:
        (k, k_sc), (v, v_sc) = _kv_quantize(k), _kv_quantize(v)
        cache["k_scale"][:, slots] = k_sc
        cache["v_scale"][:, slots] = v_sc
    cache["k"][:, slots] = k.to(cache["k"].dtype)
    cache["v"][:, slots] = v.to(cache["v"].dtype)
    cache["pos"][slots] = positions.to(torch.int32)


def gqa_prefill_cache(p, x: torch.Tensor, positions: torch.Tensor,
                      cfg: AttnConfig, max_len: int):
    """Run prefill and return (output, cache populated with S entries).

    Q, K and V are projected once (the reference projects them twice and
    leaves XLA to merge the two; the numbers are the same)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _attend(p, q, k, v, positions, cfg)
    size = _cache_size(cfg, max_len)
    cache = gqa_init_cache(x.shape[0], max_len, cfg, k.dtype, x.device)
    if cfg.window:
        # Ring invariant: position p lives at slot p % size; decode writes
        # with the same rule, so prefill scatters accordingly.
        if x.shape[1] > size:
            k, v, positions = k[:, -size:], v[:, -size:], positions[-size:]
        slots = torch.remainder(positions.long(), size)
    else:
        slots = slice(0, x.shape[1])
    _write(cache, k, v, slots, positions, cfg.kv_quant)
    return out, cache


def gqa_decode_step(p, x: torch.Tensor, pos: int, cache: dict,
                    cfg: AttnConfig, positions: torch.Tensor | None = None):
    """x: (B,1,D); pos: absolute position (an int); ``positions``: the same
    as a (1,) int32 tensor on x's device, made here if not given (filled
    on the device: a host copy would sync the stream). Writes the new K/V
    into ``cache`` in place; returns (out, cache)."""
    if positions is None:
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    slot = pos % cache["k"].shape[1] if cfg.window else pos
    _write(cache, k, v, slice(slot, slot + 1), positions, cfg.kv_quant)
    if cfg.kv_quant:
        k_full = _kv_dequantize(cache["k"], cache["k_scale"], k.dtype)
        v_full = _kv_dequantize(cache["v"], cache["v_scale"], v.dtype)
    else:
        k_full, v_full = cache["k"], cache["v"]
    out = _sdpa(q, k_full, v_full, positions, cache["pos"],
                window=cfg.window, scale=cfg.d_head ** -0.5)
    return L.dense(p["wo"], out.reshape(x.shape[0], 1, -1)), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 / MiniCPM3 style)
# ---------------------------------------------------------------------------
def _mla_q(p, x: torch.Tensor, positions: torch.Tensor, cfg: AttnConfig):
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = L.rmsnorm(p["q_norm"], L.dense(p["wdq"], x), cfg.rms_eps)
    q = L.dense(p["wuq"], cq).reshape(b, s, cfg.n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: AttnConfig):
    ckv = L.dense(p["wdkv"], x)
    c, k_rope = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    c = L.rmsnorm(p["kv_norm"], c, cfg.rms_eps)
    k_rope = L.apply_rope(k_rope, positions, cfg.rope_theta,
                          has_head_dim=False)           # (B,S,dr) shared
    return c, k_rope


def _mla_sdpa(q_nope, q_rope, k_nope, k_rope, v, q_pos, kv_pos, scale):
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                             k_rope.float())) * scale
    mask = kv_pos[None, :] <= q_pos[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _mla_attend(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: AttnConfig):
    """mla_forward's output and the latent it made: (out, c, k_rope)."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c, k_rope = _mla_latent(p, x, positions, cfg)
    k_nope = L.dense(p["wuk"], c).reshape(b, s, cfg.n_heads, dn)
    v = L.dense(p["wuv"], c).reshape(b, s, cfg.n_heads, dv)
    scale = (dn + dr) ** -0.5
    qb = cfg.q_block
    if qb and s > qb and s % qb == 0:
        out = torch.cat([
            _mla_sdpa(q_nope[:, i:i + qb], q_rope[:, i:i + qb], k_nope,
                      k_rope, v, positions[i:i + qb], positions, scale)
            for i in range(0, s, qb)], dim=1)
    else:
        out = _mla_sdpa(q_nope, q_rope, k_nope, k_rope, v, positions,
                        positions, scale)
    return L.dense(p["wo"], out.reshape(b, s, -1)), c, k_rope


def mla_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: AttnConfig) -> torch.Tensor:
    """Training/prefill: decompress K/V (the standard path). Honours
    cfg.q_block (query-blocked exact attention, bounded score memory)."""
    return _mla_attend(p, x, positions, cfg)[0]


def mla_init_cache(batch: int, max_len: int, cfg: AttnConfig,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {
        "c": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                              dtype=dtype, device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
    }


def mla_prefill_cache(p, x: torch.Tensor, positions: torch.Tensor,
                      cfg: AttnConfig, max_len: int):
    """Run prefill and return (output, cache populated with S entries).
    The latent is computed once (the reference computes it twice)."""
    out, c, k_rope = _mla_attend(p, x, positions, cfg)
    cache = mla_init_cache(x.shape[0], max_len, cfg, c.dtype, x.device)
    s = x.shape[1]
    cache["c"][:, :s] = c
    cache["k_rope"][:, :s] = k_rope.to(cache["k_rope"].dtype)
    cache["pos"][:s] = positions.to(torch.int32)
    return out, cache


def mla_decode_step(p, x: torch.Tensor, pos: int, cache: dict,
                    cfg: AttnConfig, positions: torch.Tensor | None = None):
    """Weight-absorbed MLA decode: scores and outputs in the latent space,
    in fp32; the cache holds kv_lora_rank + qk_rope_head_dim values a
    token. x: (B,1,D); pos: absolute position (an int); ``positions`` as
    in :func:`gqa_decode_step`. Writes the cache in place; returns (out,
    cache)."""
    check_fp32_matmul(x)
    b = x.shape[0]
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    if positions is None:
        positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)           # (B,1,H,*)
    c_new, k_rope_new = _mla_latent(p, x, positions, cfg)   # (B,1,r),(B,1,dr)
    cache["c"][:, pos:pos + 1] = c_new.to(cache["c"].dtype)
    cache["k_rope"][:, pos:pos + 1] = k_rope_new.to(cache["k_rope"].dtype)
    cache["pos"][pos:pos + 1] = positions
    # absorb W_uk into q: q_lat[b,h,r] = sum_d q_nope[b,h,d] wuk[r, h*dn+d]
    wuk = p["wuk"]["kernel"].reshape(r, cfg.n_heads, dn)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wuk.float())
    c_all = cache["c"].float()
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat, c_all)
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                             cache["k_rope"].float())) * (dn + dr) ** -0.5
    kv_pos = cache["pos"]
    mask = (kv_pos[None, :] <= positions[:, None]) & (kv_pos[None, :] >= 0)
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out_lat = torch.einsum("bhqk,bkr->bqhr", probs, c_all)  # (B,1,H,r)
    wuv = p["wuv"]["kernel"].reshape(r, cfg.n_heads, dv)
    out = torch.einsum("bqhr,rhd->bqhd", out_lat, wuv.float())
    out = out.to(x.dtype).reshape(b, 1, -1)
    return L.dense(p["wo"], out), cache
