"""Pre-wired FASST model variants.

Port of pyfasst_tpu/models/variants.py:

    MultiChanNMFInst_FASST  -- instantaneous mixing, NMF spectra
    MultiChanNMFConv        -- convolutive (per-frequency complex) mixing;
                               spatial_rank == nchannels is the full-rank
                               spatial covariance model
    MultiChanHMM            -- GSMM/HMM spectral states
    multiChanSourceF0Filter -- source/filter (SIMM) spectral model with a
                               glottal-source F0 dictionary (WF0) and a
                               smooth filter dictionary (WGAMMA)

Constructor kwarg names (`nbComps`, `nbNMFComps`, `spatial_rank`) follow
the reference. `freq_basis` ("erb" or "mel") fixes each NMF component's FB
to a tf.filterbank.spectral_basis of `n_bands` bands, with free weights FW
on the band grid.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyfasst_tpu_torch.models.components import (
    CONV, GMM, HMM, INST, FasstParams, SpatialComp, SpectralComp,
    complex_dtype, init_inst_mixing, init_nmf_comp, uniform_init,
)
from pyfasst_tpu_torch.models.fasst import FASST
from pyfasst_tpu_torch.tf.filterbank import spectral_basis


def _fixed_basis(model: FASST, freq_basis: Optional[str], n_bands: int):
    if freq_basis in ("erb", "mel"):
        return spectral_basis(freq_basis, n_bands, model.F, model.fs,
                              model.stft_wlen)
    return None


def _nmf_comps(model: FASST, nbComps: int, nbNMFComps: int, fixed_FB):
    return tuple(
        init_nmf_comp(model.generator, model.F, model.N, nbNMFComps,
                      spat_ind=j, dtype=model.dtype, device=model.device,
                      fixed_FB=fixed_FB)
        for j in range(nbComps))


def _uniform(model: FASST, *shape) -> torch.Tensor:
    """0.5 + U[0, 1) of `shape` with a clip axis of 1, from the model's
    generator, in its dtype on its device."""
    return uniform_init(model.generator, shape, model.dtype, model.device)


def _inst_spat(model: FASST, nbComps: int, spatial_rank: int):
    """Instantaneous mixing from the JAX package's numpy draw."""
    A_list = init_inst_mixing(model.seed, model.nchannels, spatial_rank,
                              nbComps, dtype=model.dtype, device=model.device)
    return tuple(SpatialComp(A=A[None], mix_type=INST, free=True)
                 for A in A_list)


class MultiChanNMFInst_FASST(FASST):
    """Instantaneous multichannel NMF.

    The mixing starts from the JAX package's numpy draw (the same numbers
    for the same seed); the NMF factors from `self.generator`, which does
    not reproduce jax.random's bits.
    """

    def __init__(self, audio, nbComps: int = 2, nbNMFComps: int = 4,
                 spatial_rank: int = 1, freq_basis: Optional[str] = None,
                 n_bands: int = 40, **kw):
        super().__init__(audio, **kw)
        fixed_FB = _fixed_basis(self, freq_basis, n_bands)
        spat = _inst_spat(self, nbComps, spatial_rank)
        spec = _nmf_comps(self, nbComps, nbNMFComps, fixed_FB)
        self.params = FasstParams(spat=spat, spec=spec)


def expand_rank(init_mixing: np.ndarray, spatial_rank: int) -> np.ndarray:
    """(J, F, I, R0) mixing -> (J, F, I, spatial_rank) when R0 is smaller:
    appends 0.2-scaled columns orthogonal to the first one, so the extra
    spatial degrees of freedom start near-anechoic and grow only if the
    data asks for them (DEMIX directions seeding a full-rank model)."""
    init_mixing = np.asarray(init_mixing)
    if init_mixing.shape[-1] >= spatial_rank:
        return init_mixing
    a = init_mixing[..., 0]                                  # (J, F, 2)
    orth = np.stack([-np.conj(a[..., 1]), np.conj(a[..., 0])], axis=-1)
    norm = np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12
    cols = [init_mixing] + [
        (0.2 * orth / norm)[..., None]
        for _ in range(spatial_rank - init_mixing.shape[-1])]
    return np.concatenate(cols, axis=-1)


class MultiChanNMFConv(FASST):
    """Convolutive multichannel NMF (anechoic/reverberant; configs[1]/[2]).

    spatial_rank == nchannels gives the full-rank spatial covariance model.
    Initial mixing defaults to broadside-ish complex directions (the JAX
    package's numpy draw, the same numbers for the same seed); pass
    `init_mixing` (J, F, I, R) to seed from DEMIX (models/demix.py).
    """

    def __init__(self, audio, nbComps: int = 3, nbNMFComps: int = 4,
                 spatial_rank: int = 1,
                 init_mixing: Optional[np.ndarray] = None,
                 freq_basis: Optional[str] = None, n_bands: int = 40, **kw):
        super().__init__(audio, **kw)
        fixed_FB = _fixed_basis(self, freq_basis, n_bands)
        cdt = (np.complex128 if self.dtype == torch.float64
               else np.complex64)
        if init_mixing is not None:
            A0 = expand_rank(init_mixing, spatial_rank).astype(cdt)
        else:
            base = np.stack(
                [np.tile(a.numpy()[None], (self.F, 1, 1)) for a in
                 init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                  nbComps)]
            ).astype(cdt)
            rng = np.random.default_rng(self.seed)
            A0 = base * np.exp(
                1j * 0.05 * rng.standard_normal(base.shape)).astype(cdt)
        A0 = torch.as_tensor(A0, dtype=complex_dtype(self.dtype),
                             device=self.device)
        spat = tuple(SpatialComp(A=A0[j][None], mix_type=CONV, free=True)
                     for j in range(nbComps))
        spec = _nmf_comps(self, nbComps, nbNMFComps, fixed_FB)
        self.params = FasstParams(spat=spat, spec=spec)


class MultiChanHMM(FASST):
    """GSMM/HMM spectral-state model (BASELINE.json configs[3]).

    Each source has nbStates spectral templates (columns of FB); per frame
    one state is active with a free gain. sparsity='GMM' uses i.i.d. state
    priors, 'HMM' a transition matrix with `self_trans` on its diagonal;
    decode 'viterbi' takes the MAP state path instead of the posteriors.
    mix_type INST or CONV (the INST directions, frequency-independent, as
    complex per-frequency mixing). FB and TW start from `self.generator`.
    """

    def __init__(self, audio, nbComps: int = 2, nbStates: int = 8,
                 spatial_rank: int = 1, sparsity: str = "HMM",
                 self_trans: float = 0.9, mix_type: str = INST,
                 decode: str = "soft", **kw):
        super().__init__(audio, **kw)
        if mix_type == INST:
            spat = _inst_spat(self, nbComps, spatial_rank)
        else:
            cdt = (np.complex128 if self.dtype == torch.float64
                   else np.complex64)
            base = np.stack(
                [np.tile(a.numpy()[None], (self.F, 1, 1)) for a in
                 init_inst_mixing(self.seed, self.nchannels, spatial_rank,
                                  nbComps)]
            ).astype(cdt)
            A0 = torch.as_tensor(base, dtype=complex_dtype(self.dtype),
                                 device=self.device)
            spat = tuple(SpatialComp(A=A0[j][None], mix_type=CONV, free=True)
                         for j in range(nbComps))
        Q = nbStates
        if sparsity == "HMM":
            trans = (self_trans * np.eye(Q)
                     + (1.0 - self_trans) / max(Q - 1, 1) * (1 - np.eye(Q)))
        else:                      # GMM/GSMM: i.i.d. state prior
            trans = np.full(Q, 1.0 / Q)
        trans = torch.as_tensor(trans, dtype=self.dtype,
                                device=self.device)[None]
        spec = []
        for j in range(nbComps):
            FB = _uniform(self, self.F, Q)
            TW = _uniform(self, Q, self.N)
            spec.append(SpectralComp(
                FB=FB, TW=TW, trans=trans, spat_ind=j,
                free=(True, False, True, False),
                constraint=(HMM if sparsity == "HMM" else GMM),
                decode=decode))
        self.params = FasstParams(spat=spat, spec=tuple(spec))


def generate_WF0(F: int, fs: int, wlen: int, n_f0: int = 60,
                 f0_min: float = 80.0, f0_max: float = 500.0,
                 rolloff: float = 1.0) -> np.ndarray:
    """Harmonic-comb source dictionary (F, n_f0) on a log-F0 grid.

    Each column is a Gaussian-blurred harmonic comb with 1/h^rolloff
    amplitude decay -- a simple pitched-source atom family. The glottal-
    pulse atoms (and chirped variants) are generate_WF0_chirped below.
    """
    freqs = np.arange(F) * fs / wlen
    f0s = np.geomspace(f0_min, f0_max, n_f0)
    W = np.zeros((F, n_f0))
    bw = fs / wlen  # one-bin Gaussian width
    for i, f0 in enumerate(f0s):
        n_harm = int(np.floor((fs / 2) / f0))
        for h in range(1, n_harm + 1):
            W[:, i] += (h ** -rolloff) * np.exp(
                -0.5 * ((freqs - h * f0) / bw) ** 2)
    W /= np.maximum(W.sum(axis=0, keepdims=True), 1e-12)
    return W


def odgd_harmonic_amplitudes(n_harm: int, Oq: float = 0.6,
                             oversample: int = 4096) -> np.ndarray:
    """Complex Fourier coefficients c_1..c_n_harm of the KLGLOTT88
    derivative-glottal-flow waveform (open quotient Oq).

    The waveform over one normalized period t in [0, 1):

        g(t) = 27/(4 Oq^2) t^2 - 27/(4 Oq^3) t^3   for t < Oq, else 0

    Coefficients are computed numerically (FFT of a densely sampled
    period): identical to ~1e-10 at this oversampling and immune to the
    small-m cancellation in the analytic expression.
    """
    t = np.arange(oversample) / oversample
    g = np.where(t < Oq,
                 27.0 / (4 * Oq ** 2) * t ** 2
                 - 27.0 / (4 * Oq ** 3) * t ** 3, 0.0)
    C = np.fft.rfft(g) / oversample
    return C[1:n_harm + 1]


def generate_WF0_chirped(F: int, fs: int, wlen: int, n_f0: int = 60,
                         f0_min: float = 80.0, f0_max: float = 500.0,
                         chirp_per_f0: int = 1,
                         chirp_semitones: float = 0.5,
                         Oq: float = 0.6,
                         window: Optional[np.ndarray] = None) -> np.ndarray:
    """Glottal-source dictionary (F, n_f0 * chirp_per_f0), chirped atoms.

    Each atom is the power spectrum of a windowed KLGLOTT88 glottal pulse
    train at fundamental f0, including chirped variants whose F0 glides by
    up to +-chirp_semitones across the analysis window. Atoms are ordered
    f0-major: columns [i*chirp_per_f0 : (i+1)*chirp_per_f0] all belong to
    f0s[i] (melody tracking pools them). Host-side init-time NumPy.
    """
    if window is None:
        n = np.arange(wlen)
        window = np.sin(np.pi * (n + 0.5) / wlen)   # STFT sine window
    f0s = np.geomspace(f0_min, f0_max, n_f0)
    tt = np.arange(wlen) / fs
    Tw = wlen / fs
    n_fft = 2 * (F - 1)
    W = np.zeros((F, n_f0 * chirp_per_f0))
    if chirp_per_f0 == 1:
        rates = np.array([0.0])
    else:
        rates = np.linspace(-1.0, 1.0, chirp_per_f0)
    for i, f0 in enumerate(f0s):
        n_harm = max(int(np.floor((fs / 2) / (f0 * 2 ** (
            chirp_semitones / 12.0)))), 1)
        C = odgd_harmonic_amplitudes(n_harm, Oq=Oq)
        m = np.arange(1, n_harm + 1)
        for c_idx, r in enumerate(rates):
            # F0 glides from f0 to f0 * 2^(r * semitones / 12) over the
            # window: linear-in-time frequency, quadratic phase.
            f1 = f0 * 2.0 ** (r * chirp_semitones / 12.0)
            slope = (f1 - f0) / Tw
            phase = np.outer(m, f0 * tt + 0.5 * slope * tt * tt)
            x = (C[:, None] * np.exp(2j * np.pi * phase)).sum(axis=0).real
            spec = np.fft.rfft(window * x, n_fft)[:F]
            W[:, i * chirp_per_f0 + c_idx] = np.abs(spec) ** 2
    W /= np.maximum(W.sum(axis=0, keepdims=True), 1e-12)
    return W


class multiChanSourceF0Filter(FASST):
    """Source/filter (SIMM) lead + NMF accompaniment model.

    Source 0 (lead) has the MULTIPLICATIVE source-filter PSD
        v_0 = (WF0 @ HF0) * (WGAMMA @ HGAMMA)
    (WF0 glottal-source dictionary fixed -- chirped KLGLOTT88 atoms by
    default, generate_WF0_chirped; HF0 free F0 activations; WGAMMA smooth
    Mel filter dictionary fixed, HGAMMA free envelope activations); sources
    1.. are plain NMF components. init_from_lead seeds HF0 and HGAMMA from
    a SeparateLeadStereoTF run on the same grids.
    """

    def __init__(self, audio, nbComps: int = 2, nbNMFComps: int = 4,
                 n_f0: int = 60, n_filter_bands: int = 20,
                 spatial_rank: int = 1, f0_min: float = 80.0,
                 f0_max: float = 500.0, init_from_lead: bool = False,
                 lead_iters: int = 30, glottal: bool = True,
                 chirp_per_f0: int = 1, **kw):
        super().__init__(audio, **kw)
        spat = _inst_spat(self, nbComps, spatial_rank)
        if glottal:
            WF0 = generate_WF0_chirped(self.F, self.fs, self.stft_wlen,
                                       n_f0=n_f0, f0_min=f0_min,
                                       f0_max=f0_max,
                                       chirp_per_f0=chirp_per_f0)
        else:
            WF0 = generate_WF0(self.F, self.fs, self.stft_wlen, n_f0=n_f0,
                               f0_min=f0_min, f0_max=f0_max)
        U = WF0.shape[1]
        WGAMMA = spectral_basis("mel", n_filter_bands, self.F, self.fs,
                                self.stft_wlen)
        TW0 = _uniform(self, U, self.N)
        TW20 = _uniform(self, n_filter_bands, self.N)
        if init_from_lead:
            # run the SeparateLeadStereo pipeline first and seed the lead
            # source's F0/envelope activations from its melody-constrained
            # SIMM estimate (same WF0/WGAMMA grids)
            from pyfasst_tpu_torch.models.lead import SeparateLeadStereoTF
            sep = SeparateLeadStereoTF(
                audio=self.audio.data, fs=self.fs, wlen=self.stft_wlen,
                hop=self.tft.hop, n_f0=n_f0, f0_min=f0_min, f0_max=f0_max,
                n_filter=n_filter_bands, niter=lead_iters,
                glottal=glottal, chirp_per_f0=chirp_per_f0,
                device=self.device)
            sep.runDecomposition()
            # seed with a RELATIVE floor: the melody constraint leaves hard
            # zeros off the Viterbi corridor, and multiplicative updates
            # cannot regrow from exact zero
            HF0 = sep.HF0.to(self.dtype)
            HG = sep.HG.to(self.dtype)
            TW0 = HF0 + 1e-2 * torch.mean(HF0)
            TW20 = HG + 1e-2 * torch.mean(HG)
            self.lead_melody = sep.melody

        def fixed(a):
            return torch.as_tensor(a, dtype=self.dtype,
                                   device=self.device)[None]

        lead = SpectralComp(
            FB=fixed(WF0), TW=TW0, FB2=fixed(WGAMMA), TW2=TW20,
            spat_ind=0, free=(False, False, True, False),
            free2=(False, True))
        spec = [lead] + [
            init_nmf_comp(self.generator, self.F, self.N, nbNMFComps,
                          spat_ind=j, dtype=self.dtype, device=self.device)
            for j in range(1, nbComps)]
        self.params = FasstParams(spat=spat, spec=tuple(spec))
