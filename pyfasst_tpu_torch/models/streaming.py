"""Bounded-memory streaming separation of long recordings.

Port of pyfasst_tpu/models/streaming.py. Estimation, separation and
synthesis run block by block, so device memory stays O(F x block frames)
whatever the recording's length:

  pass 1   STFT.stream_blocks (a seek and a read per block) ->
           ops.online.online_block: exponential-forgetting GEM learns the
           frequency-side parameters (rank-1 mixing columns A_j(f) or, with
           spatial_rank = I, a full-rank spatial covariance per source,
           and the spectral patterns FB_j).
  pass 2   re-stream; per block re-estimate the time weights TW under the
           frozen final parameters, Wiener-separate through
           ops.wiener.separate_sources, and emit time samples through
           tf.stft.StreamingSynthesis (exact WOLA with an overlap carry).

Host memory is O(output samples) only because the separated stems are
returned and written as whole arrays. The work runs on `device` (the card
unless the caller asks for "cpu"): on CUDA each rank-1 stereo block
E-step is the general E-step kernel (variant b), seven launches per block
and pass at the default inner_iters = 6; full-rank, mono and I >= 3 blocks
run plain PyTorch. Nothing waits for the device per block but the
synthesis, which hands each block's samples to the host: the block
log-likelihoods are fetched once per pass, and the noise floor reads the
first block's power once.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["separate_streaming"]


def _save_stream_state(path: str, state, sigma, next_block: int, lls,
                       config: dict) -> None:
    """Atomic .npz checkpoint of the online state mid-stream, in the JAX
    package's layout (no clip axis; complex leaves stay complex, real stay
    real). `config` stamps the run's configuration (J/K/wlen/
    frames_per_block/spatial_rank/init/seed/forgetting and the file's
    geometry), so a resume with other settings is refused instead of
    silently corrupting the state."""
    arrays = {"next_block": np.asarray(next_block),
              "lls": np.asarray(lls, np.float64),
              "sigma": sigma[0].cpu().numpy(),
              "config_json": np.asarray(json.dumps(config, sort_keys=True))}
    for name, val in state._asdict().items():
        arrays[name] = val[0].cpu().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def _load_stream_state(path: str, expect_config: dict, device):
    """-> (OnlineState with B = 1, sigma (1, F), next_block, lls list), from
    a checkpoint of either package.

    Refuses to resume if the checkpoint's configuration differs from
    `expect_config`, listing the mismatched keys; a checkpoint without a
    configuration cannot be validated and is refused too."""
    from pyfasst_tpu_torch.ops.online import OnlineState

    with np.load(path) as z:
        if "config_json" not in z:
            raise ValueError(
                f"streaming checkpoint {path!r} predates configuration "
                "stamping and cannot be validated for resume; delete it "
                "to restart estimation from scratch")
        saved = json.loads(str(z["config_json"]))
        diffs = [f"{k}: checkpoint={saved.get(k)!r} run={v!r}"
                 for k, v in expect_config.items() if saved.get(k) != v]
        if diffs:
            raise ValueError(
                f"streaming checkpoint {path!r} was written by a run with "
                "different configuration -- resuming would silently corrupt "
                "the online state. Mismatches: " + "; ".join(diffs)
                + ". Delete the checkpoint to restart, or rerun with the "
                "original settings.")

        def up(a):
            dt = torch.complex64 if np.iscomplexobj(a) else torch.float32
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)[None].contiguous()

        state = OnlineState(**{n: up(z[n]) for n in OnlineState._fields})
        return (state, up(z["sigma"]), int(z["next_block"]),
                [float(v) for v in z["lls"]])


def _blind_prefix_init(tft, filename, Nb: int, J: int, K: int, R: int,
                       channels: int, init_seconds: float, fs: int,
                       seed: int, verbose: int):
    """Blind init from a bounded prefix of the recording.

    Reads ceil(init_seconds * fs / hop) frames of blocks (memory stays
    O(prefix)) and seeds the online state: stereo -> DEMIX anechoic
    direction estimates (a global clustering in direction space); mono ->
    mixture IS-NMF + envelope clustering (models/mono.nmf_cluster_init).
    Returns (A0 (J, F, 2[, R]) complex numpy or None, FB0 (J, F, K) numpy
    or None, valid (J, F) bool or None); None keeps the caller's default
    init for that part. Every decision runs on the host in float64."""
    hop = tft.hop
    need_frames = max(int(np.ceil(init_seconds * fs / hop)), Nb)
    blocks = []
    got = 0
    for Xb in tft.stream_blocks(filename, Nb):
        blocks.append(Xb.cpu().numpy())
        got += blocks[-1].shape[1]
        if got >= need_frames:
            break
    X = np.concatenate(blocks, axis=1)                    # (F, Np, I)
    if verbose:
        print(f"blind prefix init: {X.shape[1]} frames "
              f"({X.shape[1] * hop / fs:.1f} s)")
    from pyfasst_tpu_torch.models.mono import nmf_cluster_init

    if channels == 1:
        groups = nmf_cluster_init(X[..., 0], J, K, seed=seed)
        FB0 = np.stack([g[0] * np.maximum(g[1].mean(1), 1e-12)
                        for g in groups])                  # scale into FB
        return None, FB0, None
    if channels != 2:
        # no DEMIX for I != 2: keep the caller's default init entirely
        return None, None, None

    # DEMIX clusters local directions over all bins at once, so there is
    # no per-frequency permutation alignment to fail on stationary
    # material (the JAX package measured its consensus-vote init collapse
    # onto the mixture's principal direction there).
    from pyfasst_tpu_torch.models.demix import DEMIX

    dmx = DEMIX(X=X)
    dmx.comp_pcafeatures()
    dmx.comp_parameters(J)
    Acols = dmx.mixing(X.shape[0])[..., 0]            # (J, F, 2) complex
    Acols = Acols / np.maximum(
        np.linalg.norm(Acols, axis=-1, keepdims=True), 1e-12)
    if R > 1:
        # rank expansion: orthogonal complement column at 0.2 scale
        orth = np.stack([-np.conj(Acols[..., 1]),
                         np.conj(Acols[..., 0])], -1)
        A = np.stack([Acols, 0.2 * orth], -1)         # (J, F, 2, 2)
    else:
        A = Acols
    # The spectral side keeps the random FB: the JAX package measured
    # direction-masked NMF dictionaries trap the online spectral update
    # (A-only 37.4 dB, A+FB 15.1 on its dense-band fixture).
    valid = np.ones((J, X.shape[0]), bool)
    return A, None, valid


def _default_mixing(dirs, channels: int, R: int, F: int, seed: int):
    """The random init's mixing (J, F, I[, R]) float64 numpy, and the
    per-source seeds it broadcasts ((I,) or (I, R)): rank 1 the default
    directions; full rank each direction plus Gram-Schmidt random columns
    orthogonal to it, scaled 0.2 (the batch variants' rank expansion)."""
    if R == 1:
        seeds = dirs
    else:
        rngA = np.random.default_rng(seed + 1)
        seeds = []
        for d in dirs:
            basis = [d / np.linalg.norm(d)]
            cols = [d]
            for _ in range(R - 1):
                q = rngA.standard_normal(channels)
                for b in basis:
                    q = q - (b @ q) * b
                q = q / max(np.linalg.norm(q), 1e-12)
                basis.append(q)
                cols.append(0.2 * np.linalg.norm(d) * q)
            seeds.append(np.stack(cols, axis=-1))         # (I, R)
    A0 = np.stack([np.broadcast_to(s.astype(np.float32),
                                   (F,) + s.shape) for s in seeds])
    return A0, seeds


def separate_streaming(filename, J: int = 2, K: int = 8, wlen: int = 1024,
                       frames_per_block: int = 64, forgetting: float = 0.95,
                       inner_iters: int = 6, noise_rel: float = 1e-3,
                       seed: int = 0, out_dir: Optional[str] = None,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 0,
                       estimate_blocks: Optional[int] = None,
                       spatial_rank: int = 1,
                       init: str = "random", init_seconds: float = 12.0,
                       verbose: int = 1, device=DEFAULT_DEVICE):
    """Two-pass blind streaming separation of a WAV on disk (any I).

    spatial_rank=1 (default) learns rank-1 mixing columns A_j(f), the
    point-source model. spatial_rank=I (or -1 for "the channel count,
    whatever the header says") learns a full-rank spatial covariance per
    source (the Duong model, re-estimated every block from the forgotten
    statistics): the reverberant / diffuse mode. Its extra columns start
    as small orthogonal perturbations of the rank-1 direction.

    Returns (ys (J, nsamples, I) float32 source images, info dict with the
    block log-likelihoods, the geometry and the host seconds of the blind
    init and of each pass). With out_dir, also writes stream_src_<j>.wav
    per source and lists the paths in info["files"].

    noise_rel sets the fixed noise-PSD floor relative to the first
    block's mean bin power (streaming has no annealing schedule).

    checkpoint_path + checkpoint_every=K save the online state every K
    estimation blocks (atomic .npz, the JAX package's layout: either
    package resumes the other's); if the file exists, estimation resumes
    from it without reading the skipped blocks, and the resumed run is the
    uninterrupted one. The checkpoint stamps the run's configuration; a
    resume whose settings differ raises ValueError listing them.
    estimate_blocks caps pass 1 (learn from the first N blocks, then
    separate the whole recording with the frozen parameters).

    init="blind" seeds the online state from the first `init_seconds` of
    the recording before any online EM runs (stereo: DEMIX anechoic
    directions; mono: the mixture-NMF + envelope-clustering spectral seed
    of models/mono.py; I >= 3 keeps the default init). Only the prefix is
    materialized. init="random" (default) starts from the default
    directions and random patterns.

    device: where the blocks are transformed and the GEM runs, the card
    unless it says "cpu". On CUDA an E-step no kernel computes raises
    NotImplementedError (float64, ranks past 2 at I = 2); there is no
    CPU fallback. A non-finite block log-likelihood in pass 1 raises
    RuntimeError naming the block (checked once, at the pass's end).
    """
    from pyfasst_tpu_torch.audio import wav_info, wavwrite
    from pyfasst_tpu_torch.models.components import (
        CONV, FasstParams, SpatialComp, SpectralComp, init_inst_mixing,
    )
    from pyfasst_tpu_torch.ops.online import online_block, online_init
    from pyfasst_tpu_torch.ops.wiener import separate_sources
    from pyfasst_tpu_torch.tf.stft import STFT

    dev = resolve_device(device)
    wi = wav_info(filename)                 # the header only
    fs, nsamples, channels = wi["samplerate"], wi["frames"], wi["channels"]
    tft = STFT(wlen=wlen, fs=fs, device=dev)
    F, Nb = tft.F, int(frames_per_block)

    R = int(spatial_rank)
    if R == -1:                          # "full": resolve after the probe
        R = channels
    if R not in (1, channels):
        raise ValueError(f"spatial_rank must be 1 (point sources), "
                         f"{channels} (= channels, full-rank Duong "
                         f"model), or -1 (full, any I), got {R}")
    dirs = [a.numpy()[:, 0].astype(np.float64)
            for a in init_inst_mixing(None, channels, 1, J)]
    A0_h, seeds = _default_mixing(dirs, channels, R, F, seed)
    rng = np.random.default_rng(seed)
    FB0_h = (0.5 + rng.random((J, F, K))).astype(np.float32)
    TW0 = torch.as_tensor((0.5 + rng.random((J, K, Nb))).astype(np.float32),
                          device=dev)[None]

    if init not in ("random", "blind"):
        raise ValueError(f"init must be 'random' or 'blind', got {init!r}")
    t_init = time.perf_counter()
    if init == "blind":
        A_h, FB_h, valid = _blind_prefix_init(tft, filename, Nb, J, K, R,
                                              channels, init_seconds, fs,
                                              seed, verbose)
        if A_h is not None:
            # frequencies without evidence keep the default direction
            A_default = np.stack([np.broadcast_to(
                np.asarray(s, np.complex64), A_h.shape[1:]) for s in seeds])
            vmask = valid[:, :, None] if R == 1 \
                else valid[:, :, None, None]
            A0_h = np.where(vmask, A_h, A_default)
        if FB_h is not None:
            FB0_h = np.maximum(FB_h, 1e-8).astype(np.float32)
    init_s = time.perf_counter() - t_init
    A0 = torch.as_tensor(np.ascontiguousarray(A0_h, np.complex64),
                         device=dev)[None]
    FB0 = torch.as_tensor(FB0_h, dtype=torch.float32, device=dev)[None]

    # configuration fingerprint stamped into checkpoints; resume refuses a
    # mismatch (file identity = geometry: frames/channels/samplerate)
    ckpt_cfg = {"J": int(J), "K": int(K), "wlen": int(wlen),
                "frames_per_block": int(Nb), "spatial_rank": int(R),
                "init": str(init),
                "seed": int(seed), "forgetting": float(forgetting),
                "file_frames": int(nsamples), "file_channels": int(channels),
                "file_samplerate": int(fs)}

    t1 = time.perf_counter()
    state = online_init(A0, FB0)
    sigma = None
    lls_done = []
    start_block = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        state, sigma, start_block, lls_done = \
            _load_stream_state(checkpoint_path, ckpt_cfg, dev)
        if verbose:
            print(f"resumed streaming estimation at block {start_block}")
    lls = []
    n_full = start_block
    for Xb in tft.stream_blocks(filename, Nb,       # pass 1: learn A, FB
                                start_block=start_block):
        Xb = Xb[None]
        if sigma is None:                           # one fetch per run
            sigma = torch.full((1, F), noise_rel * float(
                torch.mean(Xb.abs() ** 2)), dtype=torch.float32, device=dev)
        if Xb.shape[2] < Nb:                         # ragged tail: skip in
            break                                    # estimation only
        state, (_, ll) = online_block(state, Xb, TW0, sigma,
                                      forgetting=forgetting,
                                      inner_iters=inner_iters)
        lls.append(ll)
        n_full += 1
        if checkpoint_path is not None and checkpoint_every \
                and (n_full - start_block) % checkpoint_every == 0:
            _save_stream_state(
                checkpoint_path, state, sigma, n_full,
                lls_done + torch.cat(lls).cpu().tolist(), ckpt_cfg)
        if estimate_blocks is not None and n_full >= estimate_blocks:
            break
    if not (lls or lls_done):
        raise ValueError("recording shorter than one block; use the "
                         "batch path")
    new = torch.cat(lls).cpu().tolist() if lls else []   # one fetch
    bad = [start_block + i for i, v in enumerate(new) if not np.isfinite(v)]
    if bad:
        raise RuntimeError(f"streaming estimation diverged (non-finite "
                           f"log-likelihood) at block {bad[0]}")
    lls = lls_done + new
    pass1_s = time.perf_counter() - t1

    spat = tuple(SpatialComp(
        A=state.A[:, j][..., None] if state.A.ndim == 4 else state.A[:, j],
        mix_type=CONV) for j in range(J))

    def sep_block(TWb, Xb):
        spec = tuple(SpectralComp(FB=state.FB[:, j], TW=TWb[:, j],
                                  spat_ind=j) for j in range(J))
        return separate_sources(FasstParams(spat=spat, spec=spec), Xb,
                                sigma)[0]               # (J, F, Nb, I)

    t2 = time.perf_counter()
    syns = [tft.synthesis_stream(nsamples) for _ in range(J)]
    ys = np.zeros((J, nsamples, channels), np.float32)
    pos = [0] * J
    for Xb in tft.stream_blocks(filename, Nb):       # pass 2: frozen params
        nb = Xb.shape[1]
        Xb = Xb[None]
        if nb < Nb:                                  # pad the ragged tail
            Xb = torch.nn.functional.pad(Xb, (0, 0, 0, Nb - nb))
        _, (TWb, _) = online_block(state, Xb, TW0, sigma,
                                   forgetting=forgetting,
                                   inner_iters=inner_iters)
        Y = sep_block(TWb, Xb)[:, :, :nb]
        for j in range(J):
            chunk = syns[j].push(Y[j])
            ys[j, pos[j]:pos[j] + chunk.shape[0]] = chunk
            pos[j] += chunk.shape[0]
    for j in range(J):
        chunk = syns[j].flush()
        ys[j, pos[j]:pos[j] + chunk.shape[0]] = chunk
        pos[j] += chunk.shape[0]
    pass2_s = time.perf_counter() - t2

    out = {"fs": fs, "nsamples": nsamples, "blocks": n_full,
           "block_frames": Nb, "logliks": lls, "resumed_at": start_block,
           "spatial_rank": R,
           "seconds": {"init": init_s, "pass1": pass1_s, "pass2": pass2_s}}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for j in range(J):
            p = os.path.join(out_dir, f"stream_src_{j}.wav")
            wavwrite(ys[j], fs, p)
            paths.append(p)
        out["files"] = paths
    if verbose:
        print(f"streamed {n_full} blocks of {Nb} frames; "
              f"loglik {lls[0]:.1f} -> {lls[-1]:.1f}")
    return ys, out
