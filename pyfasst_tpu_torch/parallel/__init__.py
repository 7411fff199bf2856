"""Batch separation over many clips, on one device or a mesh of ranks
(port of pyfasst_tpu/parallel: the bucketed batch path and sharding.py on
torch.distributed)."""

from pyfasst_tpu_torch.parallel.batch import (  # noqa: F401
    batch_separate, batch_separate_files, frame_buckets,
)
from pyfasst_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh, batch_params, batched_run_gem, make_mesh, sharded_batch_separate,
)

__all__ = ["batch_params", "batch_separate", "batch_separate_files",
           "frame_buckets", "Mesh", "make_mesh", "batched_run_gem",
           "sharded_batch_separate"]
