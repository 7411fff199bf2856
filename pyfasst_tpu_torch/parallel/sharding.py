"""Mesh construction and the sharded batch-separation path, on
torch.distributed.

Port of pyfasst_tpu/parallel/sharding.py. The JAX package lays a (dp, fp)
mesh over its devices and lets GSPMD insert the collectives; here each
rank of an initialized process group is one device of the mesh and runs
the GEM loop on its own slice, and the cross-shard reductions are
explicit all-reduces (ops/collectives.py):

  - dp: clips. Each rank takes a contiguous slice of the clip axis B (B
    must divide by dp); no collective inside the loop.
  - fp: frequencies. Each rank takes a contiguous slice of F (F need not
    divide by fp: the last slice is shorter). The sums over F -- the
    pooled instantaneous spatial solve and its 1/sigma weights, the conv
    ridge and norm floor, the spectral updates' F-contractions (TW's
    statistics, tw_stats on the card), the renormalization, v_floor, the
    state models' gains and log-likelihoods, the source-filter chains'
    F-contractions and the log-likelihood -- are all-reduced over the
    rank's fp group.
  - sp: frames, through batched_run_gem(shard_frames=True): the mesh's
    second axis slices N instead, and the E-step's frame sums, the FB
    (and FB2) statistics (fb_stats on the card) and v_floor are
    all-reduced; the HMM recursions run on the frames gathered from every
    rank.
  - The source axis J is not sharded, as in the JAX package.

Every rank passes the full batch and gets the full result back: the
slices are all-gathered in rank order at the end, as a JAX global array
reads. The kernels are not changed; each rank launches them on its own
slice. A mesh of one device (no process group, or a group of one) runs
the single-device path, bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from pyfasst_tpu_torch.convert import _SPEC_ARRAYS
from pyfasst_tpu_torch.models.components import (
    CONV, FasstParams,
)
# through the module, so that a wrapper of gem.run_gem sees every run
from pyfasst_tpu_torch.ops import collectives, gem
from pyfasst_tpu_torch.ops.collectives import all_gather, span as _span
from pyfasst_tpu_torch.ops.wiener import separate_sources
from pyfasst_tpu_torch.utils.config import GEMConfig
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

LAUNCH_HINT = (
    "n_devices={n} needs one process per device in an initialized "
    "torch.distributed process group of {n} ranks{why}: launch with "
    "`torchrun --nproc-per-node {n} -m pyfasst_tpu_torch ... --n-devices "
    "{n}` (or your script under torchrun), or call "
    "torch.distributed.init_process_group first")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, fp) mesh over the ranks of the default process group; rank
    r sits at (r // fp, r % fp). `device` is this rank's device.
    dp_group links the ranks of one fp coordinate (they hold other clips),
    fp_group the ranks of one dp coordinate (they hold the same clips)."""

    dp: int
    fp: int
    device: torch.device
    axes: Tuple[str, str] = ("dp", "fp")
    dp_rank: int = 0
    fp_rank: int = 0
    dp_group: object = None
    fp_group: object = None

    @property
    def shape(self) -> dict:
        return {self.axes[0]: self.dp, self.axes[1]: self.fp}

    @property
    def size(self) -> int:
        return self.dp * self.fp


_MESHES: dict = {}


def _default_dp(n: int) -> int:
    """The largest power of two <= sqrt(n) that divides n (JAX
    sharding.py make_mesh), so data and frequencies both get lanes."""
    dp = 1
    while (dp * 2) * (dp * 2) <= n and n % (dp * 2) == 0:
        dp *= 2
    while n % dp != 0:
        dp //= 2
    return dp


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, str] = ("dp", "fp"),
              dp: Optional[int] = None, device=None) -> Mesh:
    """Mesh over the n ranks of the initialized default process group,
    factored into (dp, fp); dp defaults to the largest power-of-two
    divisor <= sqrt(n) (n = 2 -> (1, 2), 4 -> (2, 2), 8 -> (2, 4)).

    n_devices 1 (or None with no process group) is the single-device
    mesh, whatever the group. n_devices > 1 without a group, or with a
    group of another size, raises RuntimeError saying how to launch.
    device: this rank's device; default cuda:{LOCAL_RANK} under a group,
    else the card (pass "cpu" for the CPU, as the tests do, or "cuda:0" to
    put several ranks on one card). Every rank must make its meshes in the
    same order (the subgroups are created collectively); a mesh is made
    once per group, size, dp and device and then reused.
    """
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    n = world if n_devices is None else int(n_devices)
    if device is None:
        device = (f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
                  if grouped and torch.cuda.is_available()
                  else DEFAULT_DEVICE)
    device = resolve_device(device)
    if n == 1:
        return Mesh(1, 1, device, tuple(axes))
    if n != world:
        raise RuntimeError(LAUNCH_HINT.format(
            n=n, why=(f" (the initialized group has {world})" if grouped
                      else " (none is initialized)")))
    dp = _default_dp(n) if dp is None else int(dp)
    if dp < 1 or n % dp:
        raise ValueError(f"dp={dp} does not divide n_devices={n}")
    fp = n // dp
    key = (dist.group.WORLD, n, dp, str(device), tuple(axes))
    if key not in _MESHES:
        rank = dist.get_rank()
        fp_groups = [dist.new_group([d * fp + f for f in range(fp)])
                     for d in range(dp)]
        dp_groups = [dist.new_group([d * fp + f for d in range(dp)])
                     for f in range(fp)]
        _MESHES[key] = Mesh(dp, fp, device, tuple(axes), rank // fp,
                            rank % fp, dp_groups[rank % fp],
                            fp_groups[rank // fp])
    return _MESHES[key]


def is_writer() -> bool:
    """True on the rank that writes files: rank 0, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the default group (a file written by rank 0
    is then there for all); nothing without a group of several ranks."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.barrier()


def batch_params(params_list: Sequence[FasstParams], device=None
                 ) -> FasstParams:
    """Concatenate parameter trees along the clip axis (each usually B = 1),
    on `device` when given. The structure comes from the first tree."""
    def cat(tensors):
        if tensors[0] is None:
            if any(t is not None for t in tensors):
                raise ValueError("clips disagree on which factors are "
                                 "present")
            return None
        out = torch.cat(tensors)
        return out if device is None else out.to(device)

    first = params_list[0]
    spat = tuple(c.replace(A=cat([p.spat[j].A for p in params_list]))
                 for j, c in enumerate(first.spat))
    spec = tuple(c.replace(**{n: cat([getattr(p.spec[k], n)
                                      for p in params_list])
                              for n in _SPEC_ARRAYS})
                 for k, c in enumerate(first.spec))
    return FasstParams(spat=spat, spec=spec)


# -- slicing and gathering ----------------------------------------------------

def _map_fields(params: FasstParams, spat_fn, spec_fn) -> FasstParams:
    spat = tuple(c.replace(A=spat_fn(c, c.A)) for c in params.spat)
    spec = tuple(c.replace(**{n: spec_fn(c, n, getattr(c, n))
                              for n in _SPEC_ARRAYS
                              if getattr(c, n) is not None})
                 for c in params.spec)
    return FasstParams(spat=spat, spec=spec)


def _sharded_dim(axis: str, comp, name: str) -> Optional[int]:
    """The dim of a parameter that a mesh axis slices: under "F" a conv
    mixing's frequencies and the rows of FB and of a source-filter
    component's FB2; under "N" the frames of the last factor of the
    temporal chain (TB, else TW) and of TW2. None: replicated (FW, the
    state models' trans, an instantaneous mixing)."""
    if axis == "F":
        if name == "A":
            return 1 if comp.mix_type == CONV else None
        return 1 if name in ("FB", "FB2") else None
    if name == "A":
        return None
    last = "TB" if comp.TB is not None else "TW"
    return 2 if name in (last, "TW2") else None


def _slice_params(params: FasstParams, b: Tuple[int, int], axis: str,
                  span: Tuple[int, int], device) -> FasstParams:
    def cut(comp, name, t):
        t = t[b[0]:b[1]]
        d = _sharded_dim(axis, comp, name)
        if d is not None:
            t = t.narrow(d, span[0], span[1] - span[0])
        return t.to(device).contiguous()
    return _map_fields(params, lambda c, t: cut(c, "A", t), cut)


def _gather_params(params: FasstParams, mesh: Mesh, axis: str, total: int,
                   B: int) -> FasstParams:
    def join(comp, name, t):
        d = _sharded_dim(axis, comp, name)
        if d is not None:
            t = all_gather(t, d, mesh.fp_group, mesh.fp, total)
        return all_gather(t, 0, mesh.dp_group, mesh.dp, B)
    return _map_fields(params, lambda c, t: join(c, "A", t), join)


def _local(mesh: Mesh, B: int, L: int):
    if B % mesh.dp:
        raise ValueError(f"the batch of {B} clips does not divide the "
                         f"mesh's dp axis of {mesh.dp}: pad it")
    per = B // mesh.dp
    return ((mesh.dp_rank * per, (mesh.dp_rank + 1) * per),
            _span(L, mesh.fp, mesh.fp_rank))


# -- the sharded entry points -------------------------------------------------

def batched_run_gem(params_b: FasstParams, X_b: torch.Tensor,
                    cfg: GEMConfig, mesh: Mesh, sigma_endpoints_b=None,
                    bounds=None, shard_frames: bool = False):
    """Run the GEM loop for a batch of equal-shape clips on a mesh.

    params_b: parameters with clip axis B; X_b: (B, F, N, I) complex. Every
    rank passes the full batch. B must be divisible by the 'dp' axis size;
    F need not divide 'fp'. sigma_endpoints_b, if given, is a (sigma0
    (B, F), sigma1 (B, F)) pair of per-clip annealing endpoints (compute
    them on the UNPADDED frames -- see batch.batch_separate); otherwise
    they come from the full X_b before it is sliced. bounds, if given, is a
    (start_iter, end_iter) pair: iterations outside the range leave their
    loglik entries zero (chunked checkpoint/resume; the annealing schedule
    stays a function of the index against the FULL cfg.niter). Returns
    (params_b, logliks (B, niter)), the full batch on every rank, on the
    mesh's device.

    shard_frames=True shards the frames N over the mesh's second axis
    instead of F (the SP row: tests/test_sharding.py
    test_frame_axis_sharding_sp). Every spectral model shards: NMF,
    GMM/HMM (their state sums over F are all-reduced, and under sp each
    rank runs the frame recursion on the gathered sequence) and
    source-filter (FB2 sliced with F, TW2 with N).
    """
    it0, it1 = (0, cfg.niter) if bounds is None else bounds
    X_b = torch.as_tensor(X_b)
    if sigma_endpoints_b is None:
        sigma_endpoints_b = gem.annealing_endpoints(X_b, cfg)
    if mesh.size == 1:
        X_b = X_b.to(mesh.device)
        sig = tuple(s.to(mesh.device) for s in sigma_endpoints_b)
        return gem.run_gem(params_b, X_b, cfg, start_iter=it0,
                           end_iter=it1, sigma_endpoints=sig)
    axis = "N" if shard_frames else "F"
    B, F, N = X_b.shape[:3]
    L = N if shard_frames else F
    b, span = _local(mesh, B, L)
    params = _slice_params(params_b, b, axis, span, mesh.device)
    X = X_b[b[0]:b[1]]
    X = (X[:, :, span[0]:span[1]] if shard_frames
         else X[:, span[0]:span[1]])
    X = X.to(mesh.device).contiguous()
    sig = tuple((s[b[0]:b[1]] if shard_frames
                 else s[b[0]:b[1], span[0]:span[1]]).to(mesh.device)
                .contiguous() for s in sigma_endpoints_b)
    if mesh.fp > 1:
        with collectives.sharded(axis, mesh.fp_group, L):
            params, lls = gem.run_gem(params, X, cfg, start_iter=it0,
                                      end_iter=it1, sigma_endpoints=sig)
    else:
        params, lls = gem.run_gem(params, X, cfg, start_iter=it0,
                                  end_iter=it1, sigma_endpoints=sig)
    return (_gather_params(params, mesh, axis, L, B),
            all_gather(lls, 0, mesh.dp_group, mesh.dp, B))


def sharded_batch_separate(params_b: FasstParams, X_b: torch.Tensor,
                           sigma_b: torch.Tensor, mesh: Mesh
                           ) -> torch.Tensor:
    """Wiener-separate a batch of clips on the mesh: (B, J, F, N, I) on
    every rank, on the mesh's device. The separation is per (f, n), so
    each rank separates its clips' frequency slice and nothing is
    reduced."""
    X_b = torch.as_tensor(X_b)
    if mesh.size == 1:
        return separate_sources(params_b, X_b.to(mesh.device),
                                sigma_b.to(mesh.device))
    B, F = X_b.shape[:2]
    b, span = _local(mesh, B, F)
    params = _slice_params(params_b, b, "F", span, mesh.device)
    X = X_b[b[0]:b[1], span[0]:span[1]].to(mesh.device).contiguous()
    sig = sigma_b[b[0]:b[1], span[0]:span[1]].to(mesh.device).contiguous()
    Y = separate_sources(params, X, sig)
    Y = all_gather(Y, 2, mesh.fp_group, mesh.fp, F)
    return all_gather(Y, 0, mesh.dp_group, mesh.dp, B)
