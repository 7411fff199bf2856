"""Fused spectral M-step statistics, bound with ctypes.

Port of pyfasst_tpu/ops/pallas_spectral.py (fb_stats, tw_stats, eligible,
fused_spectral_update). For the plain two-factor IS-NMF chains (one
component per source, FB and TW free, no FW/TB/FB2, NMF constraint) the
spectral M-step is the FB update and then the TW update against V
refreshed after it, as mstep.update_spectral computes them. Two CUDA C++
kernels for sm_90a (csrc/spectral.cu, built by ops/_build.py) form their
statistics without writing an (F, N) plane:

    fb_stats   (xi / Vc^2) TW^T and (1 / Vc) TW^T, (B, J, F, K)
    tw_stats   FB^T (xi / Vc^2) and FB^T (1 / Vc), (B, J, K, N)

with V = FB TW formed inside the kernel and Vc = max(V, vfloor). Each
launches its kernel on a CUDA tensor and runs its plain PyTorch version
(``fb_stats_ref``, ``tw_stats_ref``) on a CPU tensor; there is no fallback
on CUDA. ``LAUNCHES`` counts the kernels' launches by name. The kernels
take any NMF rank K. Up to 32 each thread keeps its K values and 2K sums
in registers. Above it one tiled kernel body serves both statistics, as the
TPU kernels do (pallas_spectral.py:55-113): per tile of 16 output rows and
64 positions of the contracted axis it forms V once over all K in register
tiles, then q = xi / Vc^2 and d = 1 / Vc, then contracts them with the
staged factor, again in register tiles. It is compute-bound: 6K + 5
float32 operations per (b, j, f, n), held to the card's rate without FMA
(--fmad=false). Past K = 64 the components go through it in chunks of 64
within the block, V still formed once. Where a launch has too few blocks
to fill the card (B = 1) the kernel splits the contracted axis and a second
pass adds the segments' sums in order from a scratch buffer allocated
here; one call either way, counted once. ``eligible`` puts no bound on K,
as the JAX package's does not (pallas_spectral.py:192-212).
"""
from __future__ import annotations

import ctypes

import torch

from pyfasst_tpu_torch.models.components import NMF, FasstParams
from pyfasst_tpu_torch.ops.cuda_estep import _check
from pyfasst_tpu_torch.ops.mstep import _mul_upd
from pyfasst_tpu_torch.ops.collectives import contract, mean_over

LAUNCHES = {"fb_stats": 0, "tw_stats": 0}
"""Launches of each CUDA kernel in this process (comparison launches
included; callers reset the counts before the run they want to count).
Calls under CUDA-graph capture, and the graph's replays, do not count."""

def _vc(FB, TW, vfloor):
    """Vc = max(FB @ TW, vfloor), (B, J, F, N)."""
    return torch.maximum(FB @ TW, vfloor[..., None, None])


def fb_stats_ref(xi, FB, TW, vfloor):
    """Plain PyTorch version of the fb_stats kernel.

    xi (B, J, F, N), FB (B, J, F, K), TW (B, J, K, N), vfloor (B, J).
    Returns (num, den), each (B, J, F, K): (xi / Vc^2) @ TW^T and
    (1 / Vc) @ TW^T.
    """
    Vc = _vc(FB, TW, vfloor)
    return (xi / (Vc * Vc)) @ TW.mT, (1.0 / Vc) @ TW.mT


def tw_stats_ref(xi, FB, TW, vfloor):
    """Plain PyTorch version of the tw_stats kernel: inputs as
    fb_stats_ref; returns (num, den), each (B, J, K, N): FB^T @ (xi / Vc^2)
    and FB^T @ (1 / Vc)."""
    Vc = _vc(FB, TW, vfloor)
    return FB.mT @ (xi / (Vc * Vc)), FB.mT @ (1.0 / Vc)


def _launch(name, xi, FB, TW, vfloor, out_shape):
    B, J, F, N = xi.shape
    K = FB.shape[-1]
    dev = xi.device
    _check("xi", xi, (B, J, F, N), dev)
    _check("FB", FB, (B, J, F, K), dev)
    _check("TW", TW, (B, J, K, N), dev)
    _check("vfloor", vfloor, (B, J), dev)
    from pyfasst_tpu_torch.ops import _build

    lib = _build.load()
    fn = getattr(lib, f"pyfasst_{name}")
    # the split contracted axis' partial sums, when the launch splits it
    # (-1: a shape the kernel refuses, as its launch then reports)
    words = getattr(lib, f"pyfasst_{name}_workspace")(B, J, F, N, K)
    num = torch.empty(out_shape, dtype=torch.float32, device=dev)
    den = torch.empty(out_shape, dtype=torch.float32, device=dev)
    ws = (torch.empty(words, dtype=torch.float32, device=dev) if words > 0
          else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(xi.data_ptr(), FB.data_ptr(), TW.data_ptr(),
                 vfloor.data_ptr(), num.data_ptr(), den.data_ptr(),
                 None if ws is None else ws.data_ptr(), B, J, F, N, K,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1  # a call under graph capture launches nothing
    return num, den


def _dispatch(name, ref, xi, FB, TW, vfloor, out_shape):
    if xi.device.type == "cpu":
        return ref(xi, FB, TW, vfloor)
    if xi.device.type != "cuda":
        raise NotImplementedError(f"no {name} kernel for device {xi.device}")
    return _launch(name, xi, FB, TW, vfloor, out_shape)


def fb_stats(xi, FB, TW, vfloor):
    """The fb_stats kernel on a CUDA tensor, fb_stats_ref on a CPU one.

    On CUDA every input must be float32, contiguous and on one device; the
    outputs are allocated here and the kernel runs on the current stream.
    """
    B, J, F, _ = xi.shape
    return _dispatch("fb_stats", fb_stats_ref, xi, FB, TW, vfloor,
                     (B, J, F, FB.shape[-1]))


def tw_stats(xi, FB, TW, vfloor):
    """The tw_stats kernel on a CUDA tensor, tw_stats_ref on a CPU one
    (FB is the updated basis). Requirements as fb_stats."""
    B, J, _, N = xi.shape
    return _dispatch("tw_stats", tw_stats_ref, xi, FB, TW, vfloor,
                     (B, J, FB.shape[-1], N))


def eligible(params: FasstParams) -> bool:
    """Every spectral component is a plain two-factor free IS-NMF chain (FB
    and TW free, no FW/TB/FB2, NMF constraint), one per spatial source in
    source order, float32, all of one rank K: the shapes the kernels stack
    (pallas_spectral.py:192-212)."""
    if len(params.spec) != params.n_spat:
        return False
    K = None
    for i, c in enumerate(params.spec):
        if (c.spat_ind != i or c.FW is not None or c.TB is not None
                or c.FB2 is not None or c.constraint != NMF
                or tuple(c.free) != (True, False, True, False)):
            return False
        if c.FB.dtype != torch.float32:
            return False
        if K is None:
            K = c.FB.shape[-1]
        elif c.FB.shape[-1] != K:
            return False
    return True


def fused_spectral_update(params: FasstParams, stats,
                          eps: float = 1e-30) -> FasstParams:
    """mstep.update_spectral on `eligible` params through the two kernels
    (pallas_spectral.py:215-235, with the clip axis): the FB update with
    its clamps, then the TW update against V rebuilt from the updated FB.
    vfloor = 1e-12 mean(xi over F, N) + eps per clip and source, the floor
    update_spectral takes."""
    FB = torch.stack([c.FB for c in params.spec], dim=1)     # (B, J, F, K)
    TW = torch.stack([c.TW for c in params.spec], dim=1)     # (B, J, K, N)
    xi = stats.xi.contiguous()                               # (B, J, F, N)
    vfloor = (1e-12 * mean_over(xi, (2, 3), "FN") + eps).contiguous()
    # on a mesh (parallel/sharding.py) fb_stats contracts this rank's
    # frames and tw_stats its frequencies: partials, finished between the
    # kernel and the update
    fn, fd = fb_stats(xi, FB, TW, vfloor)
    FB2 = _mul_upd(FB, contract(fn, "N"), contract(fd, "N"), eps)
    tn, td = tw_stats(xi, FB2, TW, vfloor)
    TW2 = _mul_upd(TW, contract(tn, "F"), contract(td, "F"), eps)
    spec = tuple(c.replace(FB=FB2[:, j], TW=TW2[:, j])
                 for j, c in enumerate(params.spec))
    return params.replace(spec=spec)
