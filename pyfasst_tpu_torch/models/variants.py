"""Pre-wired FASST model variants.

Port of pyfasst_tpu/models/variants.py. Ported so far:

    MultiChanNMFInst_FASST  -- instantaneous mixing, NMF spectra
    MultiChanNMFConv        -- convolutive (per-frequency complex) mixing;
                               spatial_rank == nchannels is the full-rank
                               spatial covariance model

Constructor kwarg names (`nbComps`, `nbNMFComps`, `spatial_rank`) follow
the reference. `freq_basis` ("erb" or "mel") fixes each NMF component's FB
to a tf.filterbank.spectral_basis of `n_bands` bands, with free weights FW
on the band grid.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyfasst_tpu_torch.models.components import (
    CONV, INST, FasstParams, SpatialComp, complex_dtype, init_inst_mixing,
    init_nmf_comp,
)
from pyfasst_tpu_torch.models.fasst import FASST
from pyfasst_tpu_torch.tf.filterbank import spectral_basis


def _fixed_basis(model: FASST, freq_basis: Optional[str], n_bands: int):
    if freq_basis in ("erb", "mel"):
        return spectral_basis(freq_basis, n_bands, model.F, model.fs,
                              model.tft.wlen)
    return None


def _nmf_comps(model: FASST, nbComps: int, nbNMFComps: int, fixed_FB):
    return tuple(
        init_nmf_comp(model.generator, model.F, model.N, nbNMFComps,
                      spat_ind=j, dtype=model.dtype, device=model.device,
                      fixed_FB=fixed_FB)
        for j in range(nbComps))


class MultiChanNMFInst_FASST(FASST):
    """Instantaneous multichannel NMF.

    The mixing starts from the JAX package's numpy draw (the same numbers
    for the same seed); the NMF factors from `self.generator`, which does
    not reproduce jax.random's bits.
    """

    def __init__(self, audio, nbComps: int = 2, nbNMFComps: int = 4,
                 spatial_rank: int = 1, freq_basis: Optional[str] = None,
                 n_bands: int = 40, **kw):
        super().__init__(audio, **kw)
        fixed_FB = _fixed_basis(self, freq_basis, n_bands)
        A_list = init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                  nbComps, dtype=self.dtype,
                                  device=self.device)
        spat = tuple(SpatialComp(A=A[None], mix_type=INST, free=True)
                     for A in A_list)
        spec = _nmf_comps(self, nbComps, nbNMFComps, fixed_FB)
        self.params = FasstParams(spat=spat, spec=spec)


def expand_rank(init_mixing: np.ndarray, spatial_rank: int) -> np.ndarray:
    """(J, F, I, R0) mixing -> (J, F, I, spatial_rank) when R0 is smaller:
    appends 0.2-scaled columns orthogonal to the first one, so the extra
    spatial degrees of freedom start near-anechoic and grow only if the
    data asks for them (DEMIX directions seeding a full-rank model)."""
    init_mixing = np.asarray(init_mixing)
    if init_mixing.shape[-1] >= spatial_rank:
        return init_mixing
    a = init_mixing[..., 0]                                  # (J, F, 2)
    orth = np.stack([-np.conj(a[..., 1]), np.conj(a[..., 0])], axis=-1)
    norm = np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12
    cols = [init_mixing] + [
        (0.2 * orth / norm)[..., None]
        for _ in range(spatial_rank - init_mixing.shape[-1])]
    return np.concatenate(cols, axis=-1)


class MultiChanNMFConv(FASST):
    """Convolutive multichannel NMF (anechoic/reverberant; configs[1]/[2]).

    spatial_rank == nchannels gives the full-rank spatial covariance model.
    Initial mixing defaults to broadside-ish complex directions (the JAX
    package's numpy draw, the same numbers for the same seed); pass
    `init_mixing` (J, F, I, R) to seed from DEMIX (models/demix.py).
    """

    def __init__(self, audio, nbComps: int = 3, nbNMFComps: int = 4,
                 spatial_rank: int = 1,
                 init_mixing: Optional[np.ndarray] = None,
                 freq_basis: Optional[str] = None, n_bands: int = 40, **kw):
        super().__init__(audio, **kw)
        fixed_FB = _fixed_basis(self, freq_basis, n_bands)
        cdt = (np.complex128 if self.dtype == torch.float64
               else np.complex64)
        if init_mixing is not None:
            A0 = expand_rank(init_mixing, spatial_rank).astype(cdt)
        else:
            base = np.stack(
                [np.tile(a.numpy()[None], (self.F, 1, 1)) for a in
                 init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                  nbComps)]
            ).astype(cdt)
            rng = np.random.default_rng(self.seed)
            A0 = base * np.exp(
                1j * 0.05 * rng.standard_normal(base.shape)).astype(cdt)
        A0 = torch.as_tensor(A0, dtype=complex_dtype(self.dtype),
                             device=self.device)
        spat = tuple(SpatialComp(A=A0[j][None], mix_type=CONV, free=True)
                     for j in range(nbComps))
        spec = _nmf_comps(self, nbComps, nbNMFComps, fixed_FB)
        self.params = FasstParams(spat=spat, spec=spec)
