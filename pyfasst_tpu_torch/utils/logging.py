"""Spans of the program's stages, and a profiler window around a phase.

``span(name)`` marks a stage. A span is recorded only while a torch
profiler records in this process (``recording()``); there is no other
switch, so the spans and the device trace always cover the same window.
A recorded span goes two ways:

- into a bounded in-memory buffer (``spans()``, the newest SPAN_BUFFER
  records), as a ``Span``: its name, the span open around it, and its
  start and end on ``time.perf_counter_ns``;
- into the profiler's trace as a host-only range
  (``torch._C._profiler._RecordFunctionFast``): a CPU event on the clock
  of the profiler's kernel records. ``torch.profiler.record_function``
  would also add a CUDA-type ``gpu_user_annotation`` event under CUDA
  activity, which a reader of the device's events would count as a
  kernel.

A hot loop reads ``recording()`` once and calls ``begin`` and ``end`` only
when it is true (ops/gem.py::run_gem), so with no profiler an iteration
does no more than a branch per stage. ``device_trace(logdir)`` runs a
phase under the profiler and writes a Chrome trace, spans and kernels
together.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch

SPAN_BUFFER = 65536


class Span(NamedTuple):
    id: int
    name: str
    parent: Optional[int]          # the id of the span open around it
    start_ns: int
    end_ns: int


class _Open(threading.local):
    def __init__(self):
        self.stack = []            # this thread's open spans, innermost last


_spans = collections.deque(maxlen=SPAN_BUFFER)
_ids = itertools.count()
_open = _Open()


def recording() -> bool:
    """True while a torch profiler records in this process."""
    return torch._C._autograd._profiler_enabled()


def spans() -> collections.deque:
    """The buffer of recorded spans, each appended when it ends."""
    return _spans


def begin(name: str) -> tuple:
    """Open a span; the caller has read recording() as true. Returns the
    token that end() takes."""
    stack = _open.stack
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    token = (next(_ids), name, stack[-1][0] if stack else None, rf,
             time.perf_counter_ns())
    stack.append(token)
    return token


def end(token: tuple) -> None:
    """Close the span begin() opened, and every span opened inside it
    that is still open."""
    t1 = time.perf_counter_ns()
    stack = _open.stack
    while stack:
        top = stack.pop()
        sid, name, parent, rf, t0 = top
        rf.__exit__(None, None, None)
        _spans.append(Span(sid, name, parent, t0, t1))
        if top is token:
            return


@contextlib.contextmanager
def span(name: str):
    """A stage while a profiler records, nothing otherwise; a context
    manager or a function's decorator."""
    if not recording():
        yield
        return
    token = begin(name)
    try:
        yield
    finally:
        end(token)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """torch.profiler window around a phase, host and CUDA activity, written
    as a Chrome trace under `logdir` (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
