"""Signal-processing helpers on tensors.

Port of pyfasst_tpu/utils/signal.py: median filtering, the Itakura-Saito
divergence, decibels, harmonic weighting and spectral smoothing, as plain
PyTorch functions that run on the tensors' own device.
"""
from __future__ import annotations

import torch


def median_filter(x: torch.Tensor, size: int, axis: int = -1
                  ) -> torch.Tensor:
    """Running median along `axis` (edge-replicated), odd `size`: a stack of
    shifted slices and a median over the stack."""
    if size % 2 != 1:
        raise ValueError("size must be odd")
    half = size // 2
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], half), x,
                    x[..., -1:].expand(*x.shape[:-1], half)], dim=-1)
    windows = torch.stack([xp[..., i:i + n] for i in range(size)], dim=-1)
    med = torch.median(windows, dim=-1).values
    return torch.movedim(med, -1, axis)


def is_distortion(P: torch.Tensor, V: torch.Tensor,
                  eps: float = 1e-30) -> torch.Tensor:
    """Itakura-Saito divergence D_IS(P || V) = sum(P/V - log(P/V) - 1): the
    quantity the IS-NMF multiplicative updates do not increase."""
    r = torch.clamp(P, min=eps) / torch.clamp(V, min=eps)
    return torch.sum(r - torch.log(r) - 1.0)


def db(x: torch.Tensor, floor: float = 1e-30) -> torch.Tensor:
    """Power in decibels: 10 log10(max(|x|, floor))."""
    return 10.0 * torch.log10(torch.clamp(x.abs(), min=floor))


def hwps_weight(freqs: torch.Tensor, f0: float, width: float = 0.5
                ) -> torch.Tensor:
    """Harmonic weighting helper: Gaussian bumps at multiples of f0."""
    h = torch.round(freqs / f0)
    return torch.exp(-0.5 * ((freqs - h * f0) / (width * f0)) ** 2) \
        * (h > 0)


def smooth_spectrum(P: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Median-smoothed power spectrum along frequency (axis 0)."""
    return median_filter(P, size, axis=0)
