"""Modality frontend stubs for the [vlm]/[audio] archs (port of
``repro.serve.modality``): the one place the paper's technique transfers to
the LM zoo.

Chameleon's image tokenizer (VQ-VAE) and MusicGen's EnCodec (residual VQ)
both look up the nearest codebook vector of each patch or frame latent:
the FPPS nearest-neighbour problem. A 3-D codebook with ``use_kernel``
set (the reference's ``use_pallas``) goes through
:func:`repro_torch.kernels.ops.nn_search_cuda`, the brute-force NN kernel
on a CUDA tensor and its plain version on a CPU tensor; every other D
takes the plain matmul expansion :func:`_nn_anyd`.

These are STUBS: the conv encoders that would produce latents are out of
scope, and latents arrive precomputed (here: seeded normal draws). What is
real is the quantisation math and the NN search.
"""
from __future__ import annotations

import torch

from repro_torch.device import check_fp32_matmul, resolve_device
from repro_torch.kernels.ops import nn_search_cuda


def vq_encode(latents: torch.Tensor, codebook: torch.Tensor, *,
              use_kernel: bool = False):
    """latents (..., D), codebook (K, D) -> (codes (...) int32, quantised
    (..., D)) on the tensors' device."""
    flat = latents.reshape(-1, latents.shape[-1])
    if use_kernel and latents.shape[-1] == 3:
        _, idx = nn_search_cuda(flat, codebook)
    else:
        _, idx = _nn_anyd(flat, codebook)
    quant = codebook[idx.long()].reshape(latents.shape)
    return idx.reshape(latents.shape[:-1]), quant


def _nn_anyd(src: torch.Tensor, dst: torch.Tensor):
    """FPPS brute-force NN generalised to D dims (the same matmul
    expansion). -> (d2, idx).
    Raises on a CUDA tensor while TF32 matmuls are on."""
    check_fp32_matmul(src)
    sn = torch.sum(src * src, dim=-1, keepdim=True)
    dn = torch.sum(dst * dst, dim=-1, keepdim=True).T
    d2 = torch.clamp_min(sn + dn - 2.0 * (src @ dst.T), 0.0)
    idx = torch.argmin(d2, dim=1)
    return d2.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def rvq_encode(latents: torch.Tensor, codebooks: torch.Tensor):
    """Residual VQ (EnCodec-style): codebooks (L, K, D). Returns
    (codes (L, ...), reconstruction)."""
    residual = latents
    codes, recon = [], torch.zeros_like(latents)
    for li in range(codebooks.shape[0]):
        idx, quant = vq_encode(residual, codebooks[li])
        codes.append(idx)
        recon = recon + quant
        residual = residual - quant
    return torch.stack(codes, dim=0), recon


def stub_normals(seed: int, *shapes, device="cuda"):
    """fp32 standard normals of each shape in turn, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (so the same on every device)
    and moved to ``device`` (default ``"cuda"``; raises without a card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dev) for s in shapes]


def chameleon_image_stub(seed: int, batch: int, n_patches: int,
                         d_latent: int = 256, codebook_size: int = 8192,
                         device="cuda"):
    """Precomputed-patch-latent stand-in for the Chameleon VQ-VAE encoder;
    returns (image token ids, codebook) via FPPS NN search."""
    codebook, latents = stub_normals(
        seed, (codebook_size, d_latent), (batch, n_patches, d_latent),
        device=device)
    codes, _ = vq_encode(latents, codebook)
    return codes, codebook


def musicgen_frame_stub(seed: int, batch: int, n_frames: int,
                        d_latent: int = 128, n_books: int = 4,
                        codebook_size: int = 2048, device="cuda"):
    """EnCodec-style RVQ stand-in: returns (codes (L,B,T), recon)."""
    books, latents = stub_normals(
        seed, (n_books, codebook_size, d_latent), (batch, n_frames, d_latent),
        device=device)
    return rvq_encode(latents, books)
