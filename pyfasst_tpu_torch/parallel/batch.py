"""Batch separation over many clips on one device.

Port of pyfasst_tpu/parallel/batch.py and of the single-device half of
pyfasst_tpu/parallel/sharding.py. Clips of different lengths are padded
into frame BUCKETS; each bucket is one GEM run over a stacked clip axis B
(every tensor of the port carries it, so a bucket is one run_gem call and
one separate_sources call, with per-clip (B, F) annealing endpoints), and
the per-clip results are cropped back. There is no mesh: the multi-device
legs (clips and frequencies across devices) are ROADMAP item 15.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pyfasst_tpu_torch.convert import _SPEC_ARRAYS
from pyfasst_tpu_torch.models.components import FasstParams, complex_dtype
from pyfasst_tpu_torch.ops.gem import endpoints_from_power, run_gem
from pyfasst_tpu_torch.ops.wiener import separate_sources
from pyfasst_tpu_torch.utils.checkpoint import load_params, save_params
from pyfasst_tpu_torch.utils.config import GEMConfig
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


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
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Estimate and separate a set of clips on `device`.

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
    """
    device = resolve_device(device)
    F = Xs[0].shape[0]
    n_frames = [int(x.shape[1]) for x in Xs]
    out_imgs: List[Optional[np.ndarray]] = [None] * len(Xs)
    out_lls: List[Optional[np.ndarray]] = [None] * len(Xs)
    every = int(checkpoint_every or 0)
    if every and not checkpoint_dir:
        raise ValueError("checkpoint_every requires checkpoint_dir")
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)

    for Npad, idxs in sorted(frame_buckets(n_frames, granularity).items()):
        params_b = batch_params([make_params(F, Npad, i) for i in idxs],
                                device=device)
        real = params_b.spec[0].FB.dtype
        Xt = [torch.as_tensor(Xs[i]).to(device=device,
                                        dtype=complex_dtype(real))
              for i in idxs]
        X_b = torch.stack([_pad_frames(x, Npad) for x in Xt])
        # per-clip endpoints from the true (unpadded) frames
        sig0_b, sig1_b = endpoints_from_power(
            torch.stack([torch.mean(x.abs() ** 2, dim=(1, 2)) for x in Xt]),
            cfg)

        start = 0
        logliks = torch.zeros((len(idxs), cfg.niter), dtype=torch.float32,
                              device=device)
        ckpt = (_bucket_ckpt_path(checkpoint_dir, Npad)
                if checkpoint_dir else None)
        bucket_id = {"clips": list(map(int, idxs)), "niter": int(cfg.niter)}
        if ckpt and os.path.exists(ckpt):
            saved, it, extra = load_params(ckpt, device=device, dtype=real)
            if extra.get("clips") == bucket_id["clips"] \
                    and extra.get("niter") == bucket_id["niter"]:
                params_b, start = saved, int(it)
                logliks = torch.as_tensor(extra["logliks"],
                                          dtype=torch.float32, device=device)

        while start < cfg.niter:
            end = min(start + every, cfg.niter) if every else cfg.niter
            params_b, logliks = run_gem(params_b, X_b, cfg, start_iter=start,
                                        end_iter=end, logliks=logliks,
                                        sigma_endpoints=(sig0_b, sig1_b))
            start = end
            if ckpt and every and start < cfg.niter:
                save_params(ckpt, params_b, iteration=start, extra=bucket_id,
                            extra_arrays={"logliks": logliks.cpu().numpy()},
                            stacked=True)
                if on_checkpoint is not None:
                    on_checkpoint(Npad, start)
        if ckpt and os.path.exists(ckpt):
            os.remove(ckpt)

        Y_b = separate_sources(params_b, X_b, sig1_b).cpu().numpy()
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
) -> Dict[str, Dict]:
    """Batch-separate a directory's worth of WAV files.

    Variable-length clips ride the bucketed batch_separate path (the
    instantaneous multichannel NMF model per clip, clip i seeded with
    seed + i); each clip's stems are written as <out_dir>/<stem>_est_<j>.wav.
    Returns a per-clip report {stem: {"files": [...], "final_loglik": x}}.
    The NMF draws come from a torch.Generator, not jax.random: the two
    packages start from other numbers for the same seed.
    """
    from pyfasst_tpu_torch.audio import AudioObject
    from pyfasst_tpu_torch.models.components import (
        SpatialComp, init_inst_mixing, init_nmf_comp,
    )
    from pyfasst_tpu_torch.tf.filterbank import spectral_basis
    from pyfasst_tpu_torch.tf.stft import STFT

    device = resolve_device(device)
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
        gen = torch.Generator().manual_seed(seed + i)
        spat = tuple(SpatialComp(A=a[None]) for a in
                     init_inst_mixing(None, I, 1, nbComps, device=device))
        spec = tuple(
            init_nmf_comp(gen, F_, Npad, nbNMFComps, spat_ind=j,
                          device=device, fixed_FB=fixed_FBs[i])
            for j in range(nbComps))
        return FasstParams(spat=spat, spec=spec)

    images, lls = batch_separate(Xs, make_params, GEMConfig(niter=int(iters)),
                                 device=device, granularity=granularity)

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
            AudioObject(data=y / peak if peak > 1.0 else y,
                        samplerate=o.samplerate)._write(out)
            files.append(out)
        report[stem] = {"files": files, "final_loglik": float(ll[-1])}
    return report
