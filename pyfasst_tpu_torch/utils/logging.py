"""Structured run logging and profiling hooks.

Port of pyfasst_tpu/utils/logging.py: per-run metrics as JSON lines, a
wall-clock phase timer, and a profiler window around a phase
(``device_trace``: torch.profiler here, jax.profiler in the JAX package).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("pyfasst_tpu_torch")


class JSONLWriter:
    """Append-only JSONL metrics sink (one dict per line)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, record: Dict[str, Any]) -> None:
        with open(self.path, "a") as fh:
            fh.write(json.dumps(record) + "\n")


@contextlib.contextmanager
def phase_timer(name: str, sink: Optional[JSONLWriter] = None, **fields):
    """Wall-clock a pipeline phase; logs and optionally emits JSONL.

    CUDA work is asynchronous: end the block with a host read of a result
    (or torch.cuda.synchronize()) for the device's time to be counted.
    """
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    logger.info("%s: %.3f s", name, dt)
    if sink is not None:
        sink.write({"phase": name, "seconds": dt, "ts": time.time(),
                    **fields})


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """torch.profiler window around a phase, host and CUDA activity, written
    as a Chrome trace under `logdir` (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def gem_metrics_record(logliks, seconds: float, audio_seconds: float,
                       niter: int, **extra) -> Dict[str, Any]:
    """The per-run record of a GEM run: loglik trend, time, throughput."""
    import numpy as np
    ll = np.asarray(logliks, np.float64)
    return {
        "niter": int(niter),
        "loglik_first": float(ll[0]),
        "loglik_last": float(ll[-1]),
        "loglik_monotone_frac": float(np.mean(np.diff(ll) >= 0)),
        "seconds": float(seconds),
        "iters_per_sec": float(niter / max(seconds, 1e-12)),
        "xrt": float(audio_seconds / max(seconds, 1e-12)),
        **extra,
    }
