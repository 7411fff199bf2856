"""Configuration, checkpoints, metrics, logging and signal helpers (port of
pyfasst_tpu/utils). Only the configuration is imported eagerly; the rest
load on first use."""

import importlib

from pyfasst_tpu_torch.utils.config import (  # noqa: F401
    AnnealingMode, GEMConfig, load_config,
)

_LAZY = {
    "save_params": "pyfasst_tpu_torch.utils.checkpoint",
    "load_params": "pyfasst_tpu_torch.utils.checkpoint",
    "bss_eval_sources": "pyfasst_tpu_torch.utils.metrics",
    "bss_eval_images": "pyfasst_tpu_torch.utils.metrics",
    "si_sdr": "pyfasst_tpu_torch.utils.metrics",
    "xrt": "pyfasst_tpu_torch.utils.metrics",
}

__all__ = ["AnnealingMode", "GEMConfig", "load_config"] + list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'pyfasst_tpu_torch.utils' has no attribute {name!r}")
