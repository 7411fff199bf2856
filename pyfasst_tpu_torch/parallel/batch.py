"""Batch separation over many clips, on one device or a mesh of ranks.

Port of pyfasst_tpu/parallel/batch.py. Clips of different lengths are
padded into frame BUCKETS; each bucket is one GEM run over a stacked clip
axis B (every tensor of the port carries it, so a bucket is one run_gem
call and one separate_sources call, with per-clip (B, F) annealing
endpoints), and the per-clip results are cropped back. On a mesh
(parallel/sharding.py) each bucket runs through batched_run_gem and
sharded_batch_separate, padded to a multiple of the dp axis.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pyfasst_tpu_torch.models.components import FasstParams, complex_dtype
from pyfasst_tpu_torch.ops.gem import endpoints_from_power
from pyfasst_tpu_torch.parallel.sharding import (
    barrier, batch_params, batched_run_gem, is_writer, make_mesh,
    sharded_batch_separate,
)
from pyfasst_tpu_torch.utils.checkpoint import load_params, save_params
from pyfasst_tpu_torch.utils.config import GEMConfig
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE


def frame_buckets(n_frames: Sequence[int], granularity: int = 128
                  ) -> Dict[int, List[int]]:
    """Group clip indices by padded frame count (multiples of granularity).
    Padding waste is bounded by granularity / bucket size."""
    buckets: Dict[int, List[int]] = {}
    for i, n in enumerate(n_frames):
        b = max(granularity, int(math.ceil(n / granularity)) * granularity)
        buckets.setdefault(b, []).append(i)
    return buckets


def _pad_frames(X: torch.Tensor, n_target: int) -> torch.Tensor:
    """(F, N, I) -> (F, n_target, I), zero frames appended."""
    F, N, I = X.shape
    return torch.cat([X, X.new_zeros((F, n_target - N, I))], dim=1)


def _bucket_ckpt_path(checkpoint_dir: str, Npad: int) -> str:
    return os.path.join(checkpoint_dir, f"bucket_{Npad}.npz")


def batch_separate(
    Xs: Sequence,
    make_params: Callable[[int, int, int], FasstParams],
    cfg: GEMConfig,
    device=DEFAULT_DEVICE,
    granularity: int = 128,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    on_checkpoint: Optional[Callable[[int, int], None]] = None,
    mesh=None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Estimate and separate a set of clips on `device`, or on `mesh`.

    Xs: complex STFTs (F, N_i, I) (arrays or tensors), one F and I, varying
    N_i. make_params(F, N_padded, clip_index) builds one clip's initial
    parameters (B = 1). Returns (images, logliks) per clip as numpy arrays,
    cropped to the true lengths; images are (J, F, N_i, I).

    The annealing endpoints are computed from each clip's UNPADDED frames
    (padding would dilute the per-frequency mean power and shrink the noise
    floor of heavily padded clips).

    checkpoint_dir + checkpoint_every=K save each bucket's stacked params
    every K iterations (one .npz per frame bucket). A killed run called
    again with the same arguments resumes each unfinished bucket from its
    last chunk boundary, exactly on the uninterrupted trajectory. A
    checkpoint whose clip membership or total iteration count disagrees
    with this call is ignored (fresh start), not trusted. A finished bucket
    deletes its checkpoint file. on_checkpoint(Npad, iteration), if given,
    is called after each save.

    mesh: a parallel.sharding.Mesh; None is make_mesh over the current
    process group (the single `device` when there is none), whose device
    then replaces `device`. Each bucket is padded to a multiple of the dp
    axis with copies of its last clip, as the JAX package pads it. Every
    rank computes the whole result; only rank 0 writes checkpoints.
    """
    mesh = mesh or make_mesh(device=device)
    device, dp = mesh.device, mesh.dp
    writer = is_writer()
    F = Xs[0].shape[0]
    n_frames = [int(x.shape[1]) for x in Xs]
    out_imgs: List[Optional[np.ndarray]] = [None] * len(Xs)
    out_lls: List[Optional[np.ndarray]] = [None] * len(Xs)
    every = int(checkpoint_every or 0)
    if every and not checkpoint_dir:
        raise ValueError("checkpoint_every requires checkpoint_dir")
    if checkpoint_dir and writer:
        os.makedirs(checkpoint_dir, exist_ok=True)

    for Npad, idxs in sorted(frame_buckets(n_frames, granularity).items()):
        # round the batch up to a multiple of the dp axis with repeats
        batch_idx = list(idxs)
        while len(batch_idx) % dp != 0:
            batch_idx.append(idxs[-1])
        params_b = batch_params([make_params(F, Npad, i) for i in batch_idx],
                                device=device)
        real = params_b.spec[0].FB.dtype
        Xt = [torch.as_tensor(Xs[i]).to(device=device,
                                        dtype=complex_dtype(real))
              for i in batch_idx]
        X_b = torch.stack([_pad_frames(x, Npad) for x in Xt])
        # per-clip endpoints from the true (unpadded) frames
        sig0_b, sig1_b = endpoints_from_power(
            torch.stack([torch.mean(x.abs() ** 2, dim=(1, 2)) for x in Xt]),
            cfg)

        start = 0
        logliks = torch.zeros((len(batch_idx), cfg.niter),
                              dtype=torch.float32, device=device)
        ckpt = (_bucket_ckpt_path(checkpoint_dir, Npad)
                if checkpoint_dir else None)
        bucket_id = {"clips": list(map(int, batch_idx)),
                     "niter": int(cfg.niter)}
        if ckpt and os.path.exists(ckpt):
            saved, it, extra = load_params(ckpt, device=device, dtype=real)
            if extra.get("clips") == bucket_id["clips"] \
                    and extra.get("niter") == bucket_id["niter"]:
                params_b, start = saved, int(it)
                logliks = torch.as_tensor(extra["logliks"],
                                          dtype=torch.float32, device=device)

        while start < cfg.niter:
            end = min(start + every, cfg.niter) if every else cfg.niter
            params_b, lls = batched_run_gem(
                params_b, X_b, cfg, mesh, sigma_endpoints_b=(sig0_b, sig1_b),
                bounds=(start, end))
            logliks[:, start:end] = lls[:, start:end]
            start = end
            if ckpt and every and start < cfg.niter:
                if writer:
                    save_params(ckpt, params_b, iteration=start,
                                extra=bucket_id,
                                extra_arrays={
                                    "logliks": logliks.cpu().numpy()},
                                stacked=True)
                barrier()
                if on_checkpoint is not None:
                    on_checkpoint(Npad, start)
        if ckpt:
            if writer and os.path.exists(ckpt):
                os.remove(ckpt)
            barrier()

        Y_b = sharded_batch_separate(params_b, X_b, sig1_b,
                                     mesh).cpu().numpy()
        lls = logliks.cpu().numpy()
        for slot, i in enumerate(idxs):
            out_imgs[i] = Y_b[slot][:, :, :n_frames[i], :]
            out_lls[i] = lls[slot]
    return out_imgs, out_lls


def batch_separate_files(
    paths: Sequence[str],
    out_dir: str,
    nbComps: int = 2,
    nbNMFComps: int = 4,
    wlen: int = 1024,
    iters: int = 200,
    freq_basis: Optional[str] = None,
    n_bands: int = 40,
    seed: int = 0,
    granularity: int = 128,
    device=DEFAULT_DEVICE,
    mesh=None,
) -> Dict[str, Dict]:
    """Batch-separate a directory's worth of WAV files.

    Variable-length clips ride the bucketed batch_separate path (the
    instantaneous multichannel NMF model per clip, clip i's NMF factors
    from split(PRNGKey(seed + i), nbComps), the JAX package's draws);
    each clip's stems are written as <out_dir>/<stem>_est_<j>.wav.
    Returns a per-clip report {stem: {"files": [...], "final_loglik": x}}.
    mesh: as batch_separate; on a mesh only rank 0 writes the WAVs, and
    every rank returns the report.
    """
    from pyfasst_tpu_torch.audio import AudioObject
    from pyfasst_tpu_torch.models.components import (
        SpatialComp, init_inst_mixing, init_nmf_comp,
    )
    from pyfasst_tpu_torch.tf.filterbank import spectral_basis
    from pyfasst_tpu_torch.tf.stft import STFT
    from pyfasst_tpu_torch.utils import prng

    mesh = mesh or make_mesh(device=device)
    device = mesh.device
    objs = [AudioObject(p) for p in paths]
    n_ch = {o.channels for o in objs}
    if len(n_ch) != 1:
        raise ValueError("one batch must share a channel count; got "
                         f"{sorted(n_ch)} -- split the directory by channel "
                         "count")
    I = n_ch.pop()
    tfts = [STFT(wlen=wlen, fs=o.samplerate, device=device) for o in objs]
    Xs, scales = [], []
    for o, tft in zip(objs, tfts):
        X = tft.computeTransform(o.data.astype(np.float32))
        scales.append(float(np.sqrt(max(float(torch.mean(X.abs() ** 2)),
                                        1e-30))))
        Xs.append(X / scales[-1])
    F = wlen // 2 + 1
    fixed_FBs = [
        spectral_basis(freq_basis, n_bands, F, o.samplerate, wlen)
        if freq_basis in ("erb", "mel") else None for o in objs]

    def make_params(F_, Npad, i):
        keys = prng.split(prng.PRNGKey(seed + i), nbComps)
        spat = tuple(SpatialComp(A=a[None]) for a in
                     init_inst_mixing(None, I, 1, nbComps, device=device))
        spec = tuple(
            init_nmf_comp(keys[j], F_, Npad, nbNMFComps, spat_ind=j,
                          device=device, fixed_FB=fixed_FBs[i])
            for j in range(nbComps))
        return FasstParams(spat=spat, spec=spec)

    images, lls = batch_separate(Xs, make_params, GEMConfig(niter=int(iters)),
                                 granularity=granularity, mesh=mesh)

    writer = is_writer()
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    report: Dict[str, Dict] = {}
    for p, o, tft, Y, ll, sc in zip(paths, objs, tfts, images, lls, scales):
        stem = os.path.splitext(os.path.basename(p))[0]
        ys = tft.invertTransform(torch.as_tensor(Y, device=device),
                                 nsamples=o.nsamples).cpu().numpy() * sc
        files = []
        for j in range(ys.shape[0]):
            y = ys[j]
            peak = np.max(np.abs(y))
            out = os.path.join(out_dir, f"{stem}_est_{j}.wav")
            if writer:
                AudioObject(data=y / peak if peak > 1.0 else y,
                            samplerate=o.samplerate)._write(out)
            files.append(out)
        report[stem] = {"files": files, "final_loglik": float(ll[-1])}
    return report
