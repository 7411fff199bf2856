"""Model parameters: spatial and spectral components as tensor dataclasses.

Port of pyfasst_tpu/models/components.py. Tensors carry a leading clip axis
B (the JAX package vmaps over clips instead); the host API uses B = 1:

    SpatialComp.A    'inst': real (B, I, R); 'conv': complex (B, F, I, R)
    SpectralComp.FB  (B, F, L)    FW (B, L, K)    TW (B, K, M)    TB (B, M, N)
                 trans (B, Q, Q) or (B, Q)    FB2 (B, F, G)   TW2 (B, G, N)

Structure (mixing type, freedom flags, constraint, spatial index) is plain
Python. The dataclasses are frozen; updates build new ones with ``replace``.

Model recap: mixture x(f,n) in C^I, each spatial component j contributes
y_j = A_j(f) s_j with A_j in C^{I x R_j}; sub-sources share the PSD
v_j(f,n) = sum over attached spectral components k of
[FB_k @ FW_k @ TW_k @ TB_k]_{f,n}.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

INST = "inst"
CONV = "conv"

NMF = "NMF"
GMM = "GMM"
HMM = "HMM"


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The complex dtype of the same precision as a real or complex dtype."""
    return (torch.complex128 if dtype in (torch.float64, torch.complex128)
            else torch.complex64)


@dataclasses.dataclass(frozen=True)
class SpatialComp:
    """One spatial component (source image).

    A: mixing matrix. 'inst' -> real (B, I, R), frequency-independent;
       'conv' (and full-rank, which is conv with R == I) -> complex
       (B, F, I, R).
    """

    A: torch.Tensor
    mix_type: str = INST
    free: bool = True

    @property
    def rank(self) -> int:
        return int(self.A.shape[-1])

    def replace(self, **kw) -> "SpatialComp":
        return dataclasses.replace(self, **kw)

    def conv_mixing(self, F: int) -> torch.Tensor:
        """A as complex (B, F, I, R) regardless of mixing type."""
        A = self.A
        if self.mix_type == INST:
            A = A.to(complex_dtype(A.dtype))[:, None].expand(
                -1, F, -1, -1)
        return A

    def spatial_cov(self, F: int) -> torch.Tensor:
        """Packed Hermitian R_j(f) = A_j A_j^H, shape (B, F, 4)."""
        from pyfasst_tpu_torch.ops import herm
        if self.mix_type == INST:
            R = herm.herm_from_mixing(self.A.to(complex_dtype(self.A.dtype)))
            return R[:, None].expand(-1, F, -1)
        return herm.herm_from_mixing(self.A)      # (B, F, 4)


@dataclasses.dataclass(frozen=True)
class SpectralComp:
    """One spectral component: v_k = FB @ FW @ TW @ TB (all nonnegative).

    FW and TB may be None, meaning identity. `free` flags which factors the
    M-step updates. `constraint` selects the TW update: NMF (multiplicative)
    or GMM/HMM (discrete states, ops/hmm.py: TW holds the per-state gains;
    `trans` is the (B, Q, Q) transition matrix for HMM or the (B, Q) prior
    for GMM, never re-estimated; `decode` is "soft" (forward-backward
    posteriors) or "viterbi" (the MAP path, HMM only)). FB2/TW2 hold the
    optional multiplicative second chain of source-filter (SIMM) models,
    v = (FB @ FW @ TW @ TB) * (FB2 @ TW2); `free2` flags which of FB2, TW2
    the M-step updates.
    """

    FB: torch.Tensor
    TW: torch.Tensor
    FW: Optional[torch.Tensor] = None
    TB: Optional[torch.Tensor] = None
    trans: Optional[torch.Tensor] = None
    FB2: Optional[torch.Tensor] = None
    TW2: Optional[torch.Tensor] = None
    spat_ind: int = 0
    free: Tuple[bool, bool, bool, bool] = (True, False, True, False)
    free2: Tuple[bool, bool] = (False, True)
    constraint: str = NMF
    decode: str = "soft"

    def replace(self, **kw) -> "SpectralComp":
        return dataclasses.replace(self, **kw)

    def freq_pattern(self) -> torch.Tensor:
        """W_k = FB @ FW, shape (B, F, K)."""
        return self.FB if self.FW is None else self.FB @ self.FW

    def time_activation(self) -> torch.Tensor:
        """H_k = TW @ TB, shape (B, K, N)."""
        return self.TW if self.TB is None else self.TW @ self.TB

    def power(self) -> torch.Tensor:
        """v_k(f, n): FB @ FW @ TW @ TB, optionally * (FB2 @ TW2)."""
        p = self.freq_pattern() @ self.time_activation()
        if self.FB2 is not None:
            p = p * (self.FB2 @ self.TW2)
        return p


@dataclasses.dataclass(frozen=True)
class FasstParams:
    """All parameters of one GEM run, for B clips."""

    spat: Tuple[SpatialComp, ...]
    spec: Tuple[SpectralComp, ...]

    @property
    def n_spat(self) -> int:
        return len(self.spat)

    @property
    def batch(self) -> int:
        return int(self.spat[0].A.shape[0])

    def replace(self, **kw) -> "FasstParams":
        return dataclasses.replace(self, **kw)

    def source_power(self, j: int) -> torch.Tensor:
        """v_j = sum of attached spectral component powers, (B, F, N)."""
        vs = [k.power() for k in self.spec if k.spat_ind == j]
        if not vs:
            raise ValueError(f"spatial component {j} has no spectral comps")
        out = vs[0]
        for v in vs[1:]:
            out = out + v
        return out

    def all_source_powers(self) -> torch.Tensor:
        """(B, J, F, N) stacked source PSDs."""
        return torch.stack([self.source_power(j) for j in range(self.n_spat)],
                           dim=1)


# -- initializers --------------------------------------------------------------

def uniform_init(generator: torch.Generator, shape, dtype=torch.float32,
                 device="cpu", batch: int = 1) -> torch.Tensor:
    """0.5 + U[0, 1) of shape (batch,) + shape, drawn in float64 from the
    CPU `generator` (the same numbers on every device), then cast."""
    u = torch.rand((batch,) + tuple(shape), generator=generator,
                   dtype=torch.float64)
    return (0.5 + u).to(dtype=dtype, device=device)


def init_nmf_comp(generator: torch.Generator, F: int, N: int, n_nmf: int,
                  spat_ind: int, dtype=torch.float32, device="cpu",
                  batch: int = 1,
                  fixed_FB: Optional[np.ndarray] = None) -> SpectralComp:
    """Random-init NMF spectral component with a leading clip axis:
    FB free random (B, F, K), FW/TB identity, TW free random (B, K, N).
    With fixed_FB (an (F, L) ERB/Mel tf.filterbank.spectral_basis), FB is
    that fixed basis and FW (B, L, K) becomes the free pattern weights on
    the band grid: free = (False, True, True, False).

    The draws come from `generator`, a CPU torch.Generator, so CPU and CUDA
    runs start from the same numbers. They are NOT the numbers of the JAX
    package's jax.random draws from the same seed: to compare the two
    packages, hand both the same parameters (convert.params_from_numpy).
    """
    def uniform(*shape):
        return uniform_init(generator, shape, dtype, device, batch)

    if fixed_FB is None:
        return SpectralComp(FB=uniform(F, n_nmf), TW=uniform(n_nmf, N),
                            spat_ind=spat_ind)
    FB = torch.as_tensor(np.asarray(fixed_FB), dtype=dtype, device=device)
    FW = uniform(FB.shape[1], n_nmf)
    return SpectralComp(FB=FB[None].repeat(batch, 1, 1), FW=FW,
                        TW=uniform(n_nmf, N), spat_ind=spat_ind,
                        free=(False, True, True, False))


def init_inst_mixing(key, I: int, R: int, J: int, dtype=torch.float32,
                     device="cpu"):
    """Near-uniform instantaneous mixing directions, as a list of J real
    (I, R) tensors: source j at angle theta_j in (0, pi/2) for stereo;
    evenly spread positive-orthant directions for I > 2; plus a small
    random perturbation.

    Drawn with numpy exactly as the JAX package draws them, so the same key
    gives the same numbers in both packages. key: None keeps the
    deterministic per-source draw; an int seed (or a torch.Generator, by its
    initial seed) varies the perturbation.
    """
    thetas = (np.arange(J) + 1.0) / (J + 1.0) * (np.pi / 2)
    if key is None:
        noise = np.stack([np.random.default_rng(j).standard_normal((I, R))
                          for j in range(J)])
    else:
        if isinstance(key, torch.Generator):
            key = key.initial_seed()
        noise = np.random.default_rng(int(key)).standard_normal((J, I, R))
    mats = []
    for j in range(J):
        if I == 1:
            base = np.ones((1, 1))
        elif I == 2:
            base = np.array([[np.cos(thetas[j])], [np.sin(thetas[j])]])
        else:
            # exponential gain taper across the array, slope spread over
            # sources (keeps init directions separable for I > 2)
            slope = 2.0 * (j + 1.0) / (J + 1.0) - 1.0      # in (-1, 1)
            t = 16.0 ** slope
            c = t ** (np.arange(I) / (I - 1.0) - 0.5)
            base = (c / np.linalg.norm(c))[:, None]
        A = np.tile(base, (1, R)) + 0.05 * noise[j]
        mats.append(torch.as_tensor(np.abs(A), dtype=dtype, device=device))
    return mats
