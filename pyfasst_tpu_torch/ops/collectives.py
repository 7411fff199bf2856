"""Reductions over a sharded axis of the GEM loop.

Inside ``sharded(axis, group, total)`` each rank of `group` holds a
contiguous slice of one axis of every clip's plane: the frequencies
("F", the mesh's fp axis) or the frames ("N", frame sharding). A sum over
that axis is then a partial on each rank; the helpers here finish it with
an ``all_reduce`` over the group, a fixed-order collective (no float
atomics, so a chunked or resumed run repeats itself bit for bit). A mean
divides the finished sum by the axis' global length.

The frame recursions of the state models (ops/hmm.py) need the whole
sequence: ``gather_frames`` all-gathers a frame-sharded tensor in rank
order, so every rank runs the same recursion on the same bits and keeps
its own span of the result.

With no shard active every helper is the plain ``torch.sum`` /
``torch.mean`` it replaces (``gather_frames`` the identity), so the
single-device path computes what it computed before, bit for bit. The
E-step's own frame sums are finished once per step by ``reduce_stats``
(ops/gem.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class _Shard:
    axis: str          # "F" or "N"
    group: object      # the process group that shares the clips
    total: int         # the axis' global length


_ACTIVE: Optional[_Shard] = None


@contextlib.contextmanager
def sharded(axis: str, group, total: int) -> Iterator[None]:
    """Within the block, sums over `axis` ("F" or "N") are partials to be
    all-reduced over `group`, whose ranks hold slices of an axis of global
    length `total`."""
    global _ACTIVE
    if axis not in ("F", "N"):
        raise ValueError(f"axis must be 'F' or 'N', got {axis!r}")
    prev, _ACTIVE = _ACTIVE, _Shard(axis, group, int(total))
    try:
        yield
    finally:
        _ACTIVE = prev


def active_axis() -> Optional[str]:
    """"F", "N" or None: the axis sharded in the current block."""
    return None if _ACTIVE is None else _ACTIVE.axis


def axis_length(axis: str, local: int) -> int:
    """The global length of `axis` ("F" or "N") whose slice on this rank
    has `local` entries: the shard's total when `axis` is sharded."""
    if _ACTIVE is not None and _ACTIVE.axis == axis:
        return _ACTIVE.total
    return local


def span(total: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of slice `index` of `parts` contiguous slices of an axis:
    equal slices of ceil(total / parts), the last one shorter."""
    size = -(-total // parts)
    if size * (parts - 1) >= total:
        raise ValueError(f"an axis of {total} cannot be cut into {parts} "
                         "non-empty contiguous slices")
    return index * size, min(total, (index + 1) * size)


def all_gather(t: torch.Tensor, dim: int, group, size: int,
               total: int) -> torch.Tensor:
    """Concatenate the ranks' slices of `t` along `dim`, in rank order,
    into the axis' `total` length (span's slices, the last one padded for
    the collective and cropped after)."""
    if size == 1:
        return t
    if t.is_complex():
        return torch.view_as_complex(all_gather(
            torch.view_as_real(t), dim, group, size, total).contiguous())
    width = -(-total // size)
    if t.shape[dim] < width:
        pad = list(t.shape)
        pad[dim] = width - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim=dim)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim).narrow(dim, 0, total)


def gather_frames(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(the whole frame axis, lo): `t`, whose last dim holds this rank's
    frames, all-gathered over the active group in rank order into the
    axis' global length, and the first frame of this rank's span in it.
    (t, 0) when the frames are not sharded."""
    if _ACTIVE is None or _ACTIVE.axis != "N":
        return t, 0
    g = _ACTIVE.group
    parts = dist.get_world_size(g)
    lo = span(_ACTIVE.total, parts, dist.get_rank(g))[0]
    return all_gather(t, t.ndim - 1, g, parts, _ACTIVE.total), lo


def all_reduce_many(tensors: Sequence[torch.Tensor], group
                    ) -> List[torch.Tensor]:
    """Sum each tensor over `group`, in one all_reduce per real dtype:
    the tensors are flattened (complex as real pairs) into one buffer."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        r = torch.view_as_real(t) if t.is_complex() else t
        by_dtype.setdefault(r.dtype, []).append((i, r))
    for items in by_dtype.values():
        # complex tensors first: each takes an even number of words, so
        # every complex view of the buffer starts at an even offset
        items.sort(key=lambda item: not tensors[item[0]].is_complex())
        buf = torch.cat([r.reshape(-1) for _, r in items])
        dist.all_reduce(buf, group=group)
        pos = 0
        for i, r in items:
            part = buf[pos:pos + r.numel()].view(r.shape)
            pos += r.numel()
            out[i] = (torch.view_as_complex(part) if tensors[i].is_complex()
                      else part)
    return out


def contract(t: torch.Tensor, axes: str) -> torch.Tensor:
    """Finish `t`, a sum over the axes named in `axes` ("F", "N" or "FN")
    of this rank's slice: the global sum when the sharded axis is among
    them, else `t` itself."""
    if _ACTIVE is None or _ACTIVE.axis not in axes:
        return t
    return all_reduce_many([t], _ACTIVE.group)[0]


def sum_over(t: torch.Tensor, dim: Union[int, Tuple[int, ...]], axes: str,
             keepdim: bool = False) -> torch.Tensor:
    """torch.sum(t, dim) where `axes` names each summed dim in order."""
    return contract(torch.sum(t, dim=dim, keepdim=keepdim), axes)


def mean_over(t: torch.Tensor, dim: Union[int, Tuple[int, ...]], axes: str,
              keepdim: bool = False) -> torch.Tensor:
    """torch.mean(t, dim) where `axes` names each averaged dim in order
    ("F" frequencies, "N" frames, "-" any other); over a sharded axis the
    mean is the all-reduced sum over its global length."""
    if _ACTIVE is None or _ACTIVE.axis not in axes:
        return torch.mean(t, dim=dim, keepdim=keepdim)
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    if len(dims) != len(axes):
        raise ValueError(f"axes {axes!r} must name each of dims {dims}")
    count = math.prod(_ACTIVE.total if a == _ACTIVE.axis else t.shape[d]
                      for d, a in zip(dims, axes))
    return sum_over(t, dims, axes, keepdim) / count


def reduce_stats(stats):
    """Finish one E-step's statistics (ops/estep.SuffStats) over the
    sharded axis: the log-likelihood (a sum over F and N) always; under
    frame sharding also the frame sums Txs, Tss, T4 and T7. xi is
    per-(f, n) and stays local. One all_reduce per dtype."""
    if _ACTIVE is None:
        return stats
    parts = [stats.loglik]
    if _ACTIVE.axis == "N":
        parts += list(stats.Txs) + list(stats.T4)
        parts += [t for row in stats.Tss for t in row]
        parts += [t for row in stats.T7 for t in row if t is not None]
    red = iter(all_reduce_many(parts, _ACTIVE.group))
    loglik = next(red)
    if _ACTIVE.axis == "F":
        return dataclasses.replace(stats, loglik=loglik)
    Txs = tuple(next(red) for _ in stats.Txs)
    T4 = tuple(next(red) for _ in stats.T4)
    Tss = tuple(tuple(next(red) for _ in row) for row in stats.Tss)
    T7 = tuple(tuple(None if t is None else next(red) for t in row)
               for row in stats.T7)
    return dataclasses.replace(stats, loglik=loglik, Txs=Txs, Tss=Tss,
                               T4=T4, T7=T7)
