"""Model families: the FASST base class and its pre-wired variants.

Port of pyfasst_tpu/models. Lazy attribute loading keeps `ops` <->
`models.components` import order acyclic.
"""

import importlib

from pyfasst_tpu_torch.models.components import (  # noqa: F401
    FasstParams, SpatialComp, SpectralComp,
    INST, CONV, NMF, GMM, HMM,
)

_LAZY = {
    "FASST": "pyfasst_tpu_torch.models.fasst",
    "MultiChanNMFInst_FASST": "pyfasst_tpu_torch.models.variants",
    "MultiChanNMFConv": "pyfasst_tpu_torch.models.variants",
    "MultiChanHMM": "pyfasst_tpu_torch.models.variants",
    "multiChanSourceF0Filter": "pyfasst_tpu_torch.models.variants",
    "DEMIX": "pyfasst_tpu_torch.models.demix",
    "separate_streaming": "pyfasst_tpu_torch.models.streaming",
}

__all__ = [
    "FasstParams", "SpatialComp", "SpectralComp",
    "INST", "CONV", "NMF", "GMM", "HMM",
] + list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'pyfasst_tpu_torch.models' has no attribute {name!r}")
