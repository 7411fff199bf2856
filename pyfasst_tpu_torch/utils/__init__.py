"""Configuration (port of pyfasst_tpu/utils)."""

from pyfasst_tpu_torch.utils.config import (  # noqa: F401
    AnnealingMode, GEMConfig, load_config,
)
