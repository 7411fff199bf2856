"""Batch separation over many clips on one device (port of
pyfasst_tpu/parallel: the bucketed batch path and the single-device half
of sharding.py; the multi-device mesh is ROADMAP item 15)."""

from pyfasst_tpu_torch.parallel.batch import (  # noqa: F401
    batch_params, batch_separate, batch_separate_files, frame_buckets,
)

__all__ = ["batch_params", "batch_separate", "batch_separate_files",
           "frame_buckets"]
