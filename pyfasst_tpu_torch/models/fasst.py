"""The FASST host API class.

Port of pyfasst_tpu/models/fasst.py. Same user-facing flow:

    model = MultiChanNMFInst_FASST("mix.wav", nbComps=2, nbNMFComps=8)
    model.estim_param_a_posteriori()          # run the GEM loop
    model.separate_spat_comps("out_dir/")     # per-source WAVs on disk

Audio I/O and WAV writing stay on the host; the transform, the GEM loop and
the separation run on `device`, the card ("cuda") unless the caller asks
for "cpu". A model on "cuda" runs there or raises: it never moves to the
CPU. Parameters carry a clip axis of size 1 and are replaced wholesale
after each estimation call. Any channel count runs: I = 2 through the
packed 2x2 engine and the CUDA kernels, I != 2 through the general-I
engine (ops/engine_general.py). Checkpoints (save_checkpoint,
load_checkpoint, estim_param_a_posteriori's checkpoint_path) use the JAX
package's .npz layout (utils/checkpoint.py).

The front-end is pluggable, as in the JAX package: the STFT by default,
`tf_method="erblet"` for the perfect-reconstruction ERBlet transform, or
any object with computeTransform / invertTransform passed as `transform`
(tf.erblet.ERBLetTransform, tf.minqt.MinQTransfo, tf.filterbank.
ERBTransform).

Not ported yet: the blind estimators (estim_param_blind_*).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Union

import numpy as np
import torch

from pyfasst_tpu_torch.audio import AudioObject
from pyfasst_tpu_torch.models.components import FasstParams
from pyfasst_tpu_torch.ops import wiener
from pyfasst_tpu_torch.ops.gem import (
    annealing_endpoints, observed_covariance, run_gem,
)
from pyfasst_tpu_torch.tf.erblet import ERBLetTransform
from pyfasst_tpu_torch.tf.stft import STFT
from pyfasst_tpu_torch.utils.checkpoint import load_params, save_params
from pyfasst_tpu_torch.utils.config import GEMConfig
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class FASST:
    """Base class: holds the mixture transform and the parameters.

    Subclasses (variants.py) construct `self.params`. kwargs mirror the
    reference's constructor knobs: `wlen`, `hop`, `iter_num`, annealing
    mode, `verbose`; `device` says where the tensors live (the card unless
    it says "cpu").
    """

    def __init__(self,
                 audio: Union[str, AudioObject, np.ndarray],
                 fs: int = 44100,
                 wlen: int = 1024,
                 hop: Optional[int] = None,
                 iter_num: int = 200,
                 annealing: str = "ann",
                 sigma_start_frac: float = 1e-2,
                 sigma_end_frac: float = 3e-6,
                 verbose: int = 0,
                 tf_method: str = "fft",
                 dtype: str = "float32",
                 seed: int = 0,
                 spatial_hold_frac: Optional[float] = None,
                 transform: Optional[object] = None,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if isinstance(audio, AudioObject):
            self.audio = audio
        elif isinstance(audio, (str, os.PathLike)):
            self.audio = AudioObject(audio)
        else:
            self.audio = AudioObject(data=np.asarray(audio), samplerate=fs)
        self.fs = self.audio.samplerate
        self.verbose = verbose
        self.seed = int(seed)
        # CPU generator: the same draws whatever the device (they are not
        # the JAX package's jax.random draws)
        self.generator = torch.Generator().manual_seed(self.seed)
        if dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be float32/float64, got {dtype!r}")
        self.dtype = torch.float64 if dtype == "float64" else torch.float32
        self.np_dtype = np.float64 if dtype == "float64" else np.float32

        # Any object with computeTransform((T, I)) -> complex (F, N, I) and
        # invertTransform(Y, nsamples) works; the GEM engine sees only the
        # (F, N, I) plane. Features that map linear STFT bins (freq_basis,
        # the F0 dictionaries) guard through `stft_wlen`.
        if transform is not None:
            self.tft = transform
        elif tf_method == "erblet":
            self.tft = ERBLetTransform(fs=self.fs, device=self.device)
        else:
            self.tft = STFT(wlen=wlen, hop=hop, fs=self.fs, method=tf_method,
                            device=self.device)
        self.Xs = None       # (1, F, N, I) complex tensor on self.device
        self.comp_transf_Cx()

        hold = {} if spatial_hold_frac is None else \
            {"spatial_hold_frac": float(spatial_hold_frac)}
        self.cfg = GEMConfig(niter=iter_num, annealing=annealing,
                             sigma_start_frac=sigma_start_frac,
                             sigma_end_frac=sigma_end_frac, **hold)
        self.params: Optional[FasstParams] = None
        self.logliks: Optional[np.ndarray] = None

    # -- transform ----------------------------------------------------------
    @property
    def F(self) -> int:
        return int(self.Xs.shape[1])

    @property
    def N(self) -> int:
        return int(self.Xs.shape[2])

    @property
    def nchannels(self) -> int:
        return self.audio.channels

    @property
    def stft_wlen(self) -> int:
        """Window length of the STFT front-end.

        Features that map LINEAR rfft bins -- ERB/Mel `freq_basis` factors
        (tf/filterbank.spectral_basis) and the WF0 comb dictionaries
        (variants.generate_WF0*) -- are meaningless on an already
        frequency-warped front-end (erblet/minqt); they guard through this
        property so the failure is a clear error at construction.
        """
        wlen = getattr(self.tft, "wlen", None)
        if wlen is None or getattr(self.tft, "name", "stft") != "stft":
            name = getattr(self.tft, "name", type(self.tft).__name__)
            raise ValueError(
                "freq_basis / F0-dictionary features map linear STFT bins "
                f"and require the STFT front-end; the '{name}' transform "
                "is already frequency-warped")
        return int(wlen)

    def comp_transf_Cx(self) -> None:
        """Analysis transform of the mixture.

        The spectra are normalized to unit mean power (scale restored at
        separation time): O(1)-centered statistics keep every float32
        intermediate in range regardless of the recording level.
        """
        data = self.audio.data.astype(self.np_dtype)
        if data.shape[1] < 1:
            raise ValueError("mixture has no channels")
        X = torch.as_tensor(self.tft.computeTransform(data)).to(
            self.device)                               # (F, N, I) complex
        mean_pow = float(torch.mean(X.abs() ** 2))
        self._scale = np.sqrt(max(mean_pow, 1e-30))
        self.Xs = (X / self._scale)[None]

    @property
    def Cx(self) -> torch.Tensor:
        """Packed (1, F, N, 4) empirical mixture covariance, computed on
        demand (an inspection and parity convenience; the GEM engine reads
        Xs). Stereo only; for other channel counts form
        Xs[..., :, None] * Xs[..., None, :].conj() directly."""
        if self.Xs.shape[-1] != 2:
            raise ValueError("packed Cx is defined for stereo input only")
        return observed_covariance(self.Xs)

    # -- estimation ----------------------------------------------------------
    def estim_param_a_posteriori(self, niter: Optional[int] = None,
                                 start_iter: int = 0,
                                 checkpoint_path: Optional[str] = None,
                                 checkpoint_every: Optional[int] = None
                                 ) -> np.ndarray:
        """Run the GEM loop; returns the per-iteration log-likelihoods.

        start_iter > 0 resumes an interrupted run (see load_checkpoint):
        the annealing schedule is a pure function of the iteration index
        against the FULL niter, so the resumed trajectory is exactly the
        uninterrupted one (run it with the same niter as the original);
        entries before start_iter are left zero.

        checkpoint_path + checkpoint_every=K run the loop in chunks of K
        iterations, check the log-likelihood after each chunk (one host
        wait per chunk) and save the parameters after each chunk; with
        checkpoint_path alone the loop is one chunk, saved at its end. The
        chunked trajectory is exactly the uninterrupted one. A non-finite
        log-likelihood in a chunk rolls the parameters back to the last
        checkpoint (the chunk's start) and raises RuntimeError naming the
        iteration and the checkpoint.
        """
        if self.params is None:
            raise RuntimeError("model parameters not initialized "
                               "(use a concrete FASST variant)")
        cfg = self.cfg if niter is None else \
            GEMConfig(**{**self.cfg.__dict__, "niter": int(niter)})
        every = int(checkpoint_every or 0)
        if every and not checkpoint_path:
            raise ValueError("checkpoint_every requires checkpoint_path")
        t0 = time.perf_counter()
        logliks = torch.zeros((1, cfg.niter), dtype=torch.float32,
                              device=self.device)
        s = int(start_iter)
        params = self.params
        while s < cfg.niter:
            e = min(s + every, cfg.niter) if every else cfg.niter
            new_params, logliks = run_gem(params, self.Xs, cfg,
                                          start_iter=s, end_iter=e,
                                          logliks=logliks)
            finite = torch.isfinite(logliks[0, s:e])
            if not bool(finite.all()):
                bad = s + int(torch.argmin(finite.to(torch.int8)))
                self.params = params        # last good (checkpointed) state
                raise RuntimeError(
                    f"GEM diverged (non-finite log-likelihood) at iteration "
                    f"{bad}; parameters rolled back to iteration {s}"
                    + (f" (checkpoint: {checkpoint_path})"
                       if checkpoint_path else ""))
            params = new_params
            if checkpoint_path:
                self.params = params
                self.save_checkpoint(checkpoint_path, iteration=e)
            s = e
        self._gem_seconds = time.perf_counter() - t0
        self.params = params
        self.logliks = logliks[0].cpu().numpy().astype(np.float64)
        if self.verbose:
            print(f"GEM {cfg.niter} iters in {self._gem_seconds:.3f}s, "
                  f"final loglik {self.logliks[-1]:.6g}")
        return self.logliks

    # -- separation ----------------------------------------------------------
    def _final_sigma(self) -> torch.Tensor:
        _, sigma1 = annealing_endpoints(self.Xs, self.cfg)
        return sigma1

    def _to_time(self, Y) -> np.ndarray:
        """(J, F, N, I) spectra -> (J, nsamples, I) host signals, rescaled."""
        ys = self.tft.invertTransform(Y, nsamples=self.audio.nsamples)
        return ys.cpu().numpy() * self._scale

    def separated_images(self) -> np.ndarray:
        """Posterior-mean source images, time domain: (J, nsamples, I)."""
        Y = wiener.separate_sources(self.params, self.Xs, self._final_sigma())
        return self._to_time(Y[0])

    def separate_spat_comps(self, dir_results: Optional[str] = None,
                            suffix: str = "est") -> List[str]:
        """Wiener-separate every spatial component and write WAVs.

        Returns the written file paths (or in-memory arrays via
        `separated_images`).
        """
        return self._write_sources(self.separated_images(), dir_results,
                                   suffix)

    def separate_spatial_filter_comp(self, dir_results: Optional[str] = None,
                                     suffix: str = "sf") -> List[str]:
        """Spatial-filter (PSD-independent) separation variant."""
        Y = wiener.separate_spatial_filter(self.params, self.Xs,
                                           self._final_sigma())
        return self._write_sources(self._to_time(Y[0]), dir_results, suffix)

    # -- checkpoint / resume ---------------------------------------------------
    def save_checkpoint(self, path: str, iteration: Optional[int] = None
                        ) -> str:
        """Persist the current parameters (utils/checkpoint.py's .npz
        layout, without the clip axis, as the JAX package writes it)."""
        it = self.cfg.niter if iteration is None else int(iteration)
        return save_params(path, self.params, iteration=it)

    def load_checkpoint(self, path: str) -> int:
        """Restore parameters onto this model's device and dtype (from a
        checkpoint of either package); returns the saved iteration index,
        to pass as estim_param_a_posteriori(start_iter=...) for an exact
        resume."""
        params, it, _ = load_params(path, device=self.device,
                                    dtype=self.dtype)
        self.params = params
        return it

    def retrieveSubsrcSignals(self) -> np.ndarray:
        """Alias kept for reference API parity: the separated source images."""
        return self.separated_images()

    def _write_sources(self, ys: np.ndarray, dir_results: Optional[str],
                       suffix: str) -> List[str]:
        if dir_results is None:
            return []
        os.makedirs(dir_results, exist_ok=True)
        stem = os.path.splitext(os.path.basename(
            self.audio.filename or "mixture"))[0]
        paths = []
        for j in range(ys.shape[0]):
            path = os.path.join(dir_results, f"{stem}_{suffix}_{j}.wav")
            peak = np.max(np.abs(ys[j]))
            data = ys[j] / peak if peak > 1.0 else ys[j]
            AudioObject(data=data, samplerate=self.fs)._write(path)
            paths.append(path)
        return paths
