"""Pre-wired FASST model variants.

Port of pyfasst_tpu/models/variants.py. Ported so far:

    MultiChanNMFInst_FASST  -- instantaneous mixing, NMF spectra

Constructor kwarg names (`nbComps`, `nbNMFComps`, `spatial_rank`) follow
the reference.
"""
from __future__ import annotations

from typing import Optional

from pyfasst_tpu_torch.models.components import (
    INST, FasstParams, SpatialComp, init_inst_mixing, init_nmf_comp,
)
from pyfasst_tpu_torch.models.fasst import FASST


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
        if freq_basis in ("erb", "mel"):
            raise NotImplementedError(
                "freq_basis needs tf/filterbank, which is not ported yet "
                "(ROADMAP item 11)")
        A_list = init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                  nbComps, dtype=self.dtype,
                                  device=self.device)
        spat = tuple(SpatialComp(A=A[None], mix_type=INST, free=True)
                     for A in A_list)
        spec = tuple(
            init_nmf_comp(self.generator, self.F, self.N, nbNMFComps,
                          spat_ind=j, dtype=self.dtype, device=self.device)
            for j in range(nbComps))
        self.params = FasstParams(spat=spat, spec=spec)
