"""SeparateLeadStereo: source/filter (SIMM) lead / accompaniment separation.

Port of pyfasst_tpu/models/lead.py: Durrieu's smoothed instantaneous
mixture model, STEREO form. Each channel's power spectrogram is modelled
with per-source panning gains,

    |X_L|^2 ~ V_L = gL * (WF0 @ HF0) * (WGAMMA @ HGAMMA) + WM @ diag(bL) @ HM
    |X_R|^2 ~ V_R = gR * (WF0 @ HF0) * (WGAMMA @ HGAMMA) + WM @ diag(bR) @ HM

all estimated by IS-divergence multiplicative updates. WF0 holds chirped
KLGLOTT88 glottal-source atoms (variants.generate_WF0_chirped); the melody
is Viterbi-tracked over the chirp-pooled F0 activations, a
melody-constrained second pass re-estimates, and per-channel Wiener masks
synthesize the stems.

The JAX package runs each update loop as one compiled fori_loop; here they
are plain PyTorch loops on the pipeline's device, with no kernel of their
own. Tensors carry a leading clip axis B (1 for the pipeline).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from pyfasst_tpu_torch.audio import AudioObject
from pyfasst_tpu_torch.models.variants import (
    generate_WF0, generate_WF0_chirped,
)
from pyfasst_tpu_torch.ops.hmm import viterbi_decode
from pyfasst_tpu_torch.ops.mstep import _mul_upd
from pyfasst_tpu_torch.tf.filterbank import spectral_basis
from pyfasst_tpu_torch.tf.stft import STFT
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pyfasst_tpu_torch.utils.precision import highest_precision


def _mean(P: torch.Tensor) -> torch.Tensor:
    """Per-clip mean of a (B, F, N) plane, shaped to broadcast: (B, 1, 1)."""
    return torch.mean(P, dim=(-2, -1), keepdim=True)


@highest_precision
def simm_updates(P, WF0, WG, HF0, HG, WM, HM, niter: int, eps=1e-12):
    """IS-NMF multiplicative updates of the SIMM factors against P = |X|^2.

    Shapes: P (B, F, N); WF0 (F, U); HF0 (B, U, N); WG (F, G); HG (B, G, N);
    WM (B, F, M); HM (B, M, N) (the dictionaries WF0, WG may carry B too).
    Returns updated (HF0, HG, WM, HM). The GEM engine's float32 guards:
    model PSD floored relative to the observed scale, ratios clamped.
    """
    v_floor = 1e-12 * _mean(P) + eps

    def nd(V):
        Vc = torch.maximum(V, v_floor)
        return P / (Vc * Vc), 1.0 / Vc

    for _ in range(niter):
        SF0 = WF0 @ HF0
        SPHI = WG @ HG
        num, den = nd(SF0 * SPHI + WM @ HM)
        HF0 = _mul_upd(HF0, WF0.mT @ (SPHI * num), WF0.mT @ (SPHI * den),
                       eps)
        SF0 = WF0 @ HF0
        num, den = nd(SF0 * SPHI + WM @ HM)
        HG = _mul_upd(HG, WG.mT @ (SF0 * num), WG.mT @ (SF0 * den), eps)
        SPHI = WG @ HG
        num, den = nd(SF0 * SPHI + WM @ HM)
        HM = _mul_upd(HM, WM.mT @ num, WM.mT @ den, eps)
        num, den = nd(SF0 * SPHI + WM @ HM)
        WM = _mul_upd(WM, num @ HM.mT, den @ HM.mT, eps)
    return HF0, HG, WM, HM


@highest_precision
def simm_updates_stereo(PL, PR, WF0, WG, HF0, HG, WM, HM,
                        gL, gR, bL, bR, niter: int, eps=1e-12):
    """Stereo IS-NMF multiplicative updates of the SIMM factors AND the
    per-source panning gains against (PL, PR) = (|X_L|^2, |X_R|^2).

    Shapes as simm_updates, plus gL/gR (B,) lead power gains and bL/bR
    (B, M) accompaniment power gains. Every update is the exact IS rule for
    the summed two-channel divergence D(PL|V_L) + D(PR|V_R). Scale
    indeterminacies are pinned each iteration: gL + gR = 1 (scale into
    HF0) and bL + bR = 1 per component (scale into HM rows). Returns
    (HF0, HG, WM, HM, gL, gR, bL, bR).
    """
    v_floor = 1e-12 * 0.5 * (_mean(PL) + _mean(PR)) + eps

    def nd(V, P):
        Vc = torch.maximum(V, v_floor)
        return P / (Vc * Vc), 1.0 / Vc

    def g3(g):
        return g[:, None, None]

    # the closures read the loop's current factors and gains
    def acc(b):
        return WM @ (b[..., None] * HM)

    def lead_nd(S):
        nL, dL = nd(g3(gL) * S + acc(bL), PL)
        nR, dR = nd(g3(gR) * S + acc(bR), PR)
        return nL, dL, nR, dR

    for _ in range(niter):
        # -- lead chain ---------------------------------------------------
        SF0 = WF0 @ HF0
        SPHI = WG @ HG
        nL, dL, nR, dR = lead_nd(SF0 * SPHI)
        num = WF0.mT @ (SPHI * (g3(gL) * nL + g3(gR) * nR))
        den = WF0.mT @ (SPHI * (g3(gL) * dL + g3(gR) * dR))
        HF0 = _mul_upd(HF0, num, den, eps)

        SF0 = WF0 @ HF0
        nL, dL, nR, dR = lead_nd(SF0 * SPHI)
        num = WG.mT @ (SF0 * (g3(gL) * nL + g3(gR) * nR))
        den = WG.mT @ (SF0 * (g3(gL) * dL + g3(gR) * dR))
        HG = _mul_upd(HG, num, den, eps)
        SPHI = WG @ HG
        S = SF0 * SPHI

        # -- accompaniment ------------------------------------------------
        nL, dL, nR, dR = lead_nd(S)
        num = bL[..., None] * (WM.mT @ nL) + bR[..., None] * (WM.mT @ nR)
        den = bL[..., None] * (WM.mT @ dL) + bR[..., None] * (WM.mT @ dR)
        HM = _mul_upd(HM, num, den, eps)

        nL, dL, nR, dR = lead_nd(S)
        num = nL @ (bL[..., None] * HM).mT + nR @ (bR[..., None] * HM).mT
        den = dL @ (bL[..., None] * HM).mT + dR @ (bR[..., None] * HM).mT
        WM = _mul_upd(WM, num, den, eps)

        # -- panning gains ------------------------------------------------
        nL, dL, nR, dR = lead_nd(S)
        gL = _mul_upd(gL, torch.sum(S * nL, dim=(-2, -1)),
                      torch.sum(S * dL, dim=(-2, -1)), eps)
        gR = _mul_upd(gR, torch.sum(S * nR, dim=(-2, -1)),
                      torch.sum(S * dR, dim=(-2, -1)), eps)
        bL = _mul_upd(bL, torch.sum((WM.mT @ nL) * HM, dim=-1),
                      torch.sum((WM.mT @ dL) * HM, dim=-1), eps)
        bR = _mul_upd(bR, torch.sum((WM.mT @ nR) * HM, dim=-1),
                      torch.sum((WM.mT @ dR) * HM, dim=-1), eps)

        # -- pin the scale indeterminacies --------------------------------
        s = torch.clamp(gL + gR, min=eps)
        HF0 = HF0 * g3(s)
        gL, gR = gL / s, gR / s
        sm = torch.clamp(bL + bR, min=eps)
        HM = HM * sm[..., None]
        bL, bR = bL / sm, bR / sm
    return HF0, HG, WM, HM, gL, gR, bL, bR


def viterbi_melody(salience: torch.Tensor, jump_penalty: float = 0.8
                   ) -> torch.Tensor:
    """Viterbi path over F0 salience (B, U, N) with a quadratic jump
    penalty. Returns the melody index path (B, N) int64."""
    U = salience.shape[-2]
    logS = torch.log(torch.clamp(salience, min=1e-12)).mT     # (B, N, U)
    idx = torch.arange(U, device=salience.device)
    d2 = ((idx[:, None] - idx[None, :]) ** 2).to(salience.dtype)
    pen = -jump_penalty * d2 / U                              # (from, to)
    return viterbi_decode(logS[:, 0], logS, pen)


class SeparateLeadStereoTF:
    """Lead / accompaniment separation pipeline (Durrieu SIMM).

    Usage mirrors the reference:
        sep = SeparateLeadStereoTF("song.wav", device="cuda")
        sep.runDecomposition()
        sep.writeSeparatedSignals("out_dir")   # lead + accompaniment WAVs

    The factors start from the JAX class's numpy draws (the same numbers
    for the same seed) and live on `device` (the card unless the caller
    asks for "cpu"), with a clip axis of 1.
    """

    def __init__(self, inputAudioFilename=None, audio=None, fs: int = 44100,
                 wlen: int = 2048, hop: Optional[int] = None,
                 n_f0: int = 120, f0_min: float = 80.0, f0_max: float = 800.0,
                 n_filter: int = 30, n_acc: int = 16,
                 niter: int = 50, melody_halfwidth: int = 2, seed: int = 0,
                 glottal: bool = True, chirp_per_f0: int = 1,
                 chirp_semitones: float = 0.5, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if audio is not None:
            self.audio = AudioObject(data=np.asarray(audio), samplerate=fs)
        else:
            self.audio = AudioObject(inputAudioFilename)
        self.fs = self.audio.samplerate
        self.tft = STFT(wlen=wlen, hop=hop, fs=self.fs, device=self.device)
        self.niter = niter
        self.melody_halfwidth = melody_halfwidth
        self.n_f0 = n_f0
        self.chirp_per_f0 = chirp_per_f0 if glottal else 1
        data = self.audio.data.astype(np.float32)
        if data.shape[1] == 1:
            data = np.repeat(data, 2, axis=1)
        self.X = self.tft.computeTransform(data)[None]       # (1, F, N, 2)
        F, N = self.X.shape[1:3]
        self.F, self.N = F, N
        if glottal:
            WF0 = generate_WF0_chirped(
                F, self.fs, wlen, n_f0=n_f0, f0_min=f0_min, f0_max=f0_max,
                chirp_per_f0=chirp_per_f0, chirp_semitones=chirp_semitones)
        else:
            WF0 = generate_WF0(F, self.fs, wlen, n_f0=n_f0, f0_min=f0_min,
                               f0_max=f0_max)
        U = WF0.shape[1]
        rng = np.random.default_rng(seed)
        self.WF0 = self._f32(WF0)
        self.WG = self._f32(spectral_basis("mel", n_filter, F, self.fs,
                                           wlen))
        self.HF0 = self._f32(0.5 + rng.random((U, N)))
        self.HG = self._f32(0.5 + rng.random((n_filter, N)))
        self.WM = self._f32(0.5 + rng.random((F, n_acc)))
        self.HM = self._f32(0.5 + rng.random((n_acc, N)))
        # panning power gains: lead (gL, gR), accompaniment per component
        # (bL, bR); pinned gL + gR = 1, bL + bR = 1
        self.gL = torch.full((1,), 0.5, device=self.device)
        self.gR = torch.full((1,), 0.5, device=self.device)
        self.bL = torch.full((1, n_acc), 0.5, device=self.device)
        self.bR = torch.full((1, n_acc), 0.5, device=self.device)
        self.melody: Optional[np.ndarray] = None

    def _f32(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a float32 tensor on the device with a clip axis."""
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)[None]

    # -- pipeline -------------------------------------------------------------
    def runDecomposition(self) -> np.ndarray:
        """Two-pass stereo SIMM estimation with a Viterbi melody constraint.

        Pass 1 estimates all factors and panning gains on (|X_L|^2,
        |X_R|^2); the melody is Viterbi-tracked over the chirp-pooled F0
        activations; pass 2 re-estimates with activations constrained to a
        corridor around the melody. Returns the melody path (F0-grid
        indices per frame, length N).
        """
        PL = self.X[..., 0].abs() ** 2
        PR = self.X[..., 1].abs() ** 2
        scale = torch.clamp(0.5 * (_mean(PL) + _mean(PR)), min=1e-30)
        PL, PR = PL / scale, PR / scale
        HF0, HG, WM, HM, gL, gR, bL, bR = simm_updates_stereo(
            PL, PR, self.WF0, self.WG, self.HF0, self.HG, self.WM, self.HM,
            self.gL, self.gR, self.bL, self.bR, self.niter)
        path = viterbi_melody(self._pool_chirps(HF0))         # (1, N)
        # melody-constrained second pass: zero F0 activations away from the
        # path (corridor in f0-grid units; all chirp variants of an allowed
        # f0 stay allowed)
        grid = torch.arange(self.n_f0, device=self.device)
        dist = (grid[:, None] - path[:, None, :]).abs()      # (1, n_f0, N)
        mask = (dist <= self.melody_halfwidth).to(HF0.dtype)
        mask = torch.repeat_interleave(mask, self.chirp_per_f0, dim=1)
        HF0 = HF0 * mask + 1e-12
        (self.HF0, self.HG, self.WM, self.HM,
         self.gL, self.gR, self.bL, self.bR) = simm_updates_stereo(
            PL, PR, self.WF0, self.WG, HF0, HG, WM, HM,
            gL, gR, bL, bR, self.niter)
        self.melody = path[0].cpu().numpy()
        return self.melody

    def _pool_chirps(self, HF0: torch.Tensor) -> torch.Tensor:
        """Pool atom activations (B, U, N) over chirp variants ->
        (B, n_f0, N)."""
        if self.chirp_per_f0 == 1:
            return HF0
        return HF0.reshape(HF0.shape[0], self.n_f0, self.chirp_per_f0,
                           -1).sum(dim=2)

    @property
    def f0_activations(self) -> torch.Tensor:
        """Chirp-pooled F0 activations (1, n_f0, N): the melody salience."""
        return self._pool_chirps(self.HF0)

    @property
    def alpha(self) -> Tuple[float, float]:
        """Lead amplitude panning (alpha_L, alpha_R), alpha^2 = power gain."""
        return (float(torch.sqrt(self.gL[0])), float(torch.sqrt(self.gR[0])))

    @highest_precision
    def lead_mask(self) -> torch.Tensor:
        """Per-channel Wiener mask of the lead source, (1, F, N, 2) in
        [0, 1]."""
        S = (self.WF0 @ self.HF0) * (self.WG @ self.HG)
        VaL = self.WM @ (self.bL[..., None] * self.HM)
        VaR = self.WM @ (self.bR[..., None] * self.HM)
        gL, gR = self.gL[:, None, None], self.gR[:, None, None]
        mL = gL * S / torch.clamp(gL * S + VaL, min=1e-30)
        mR = gR * S / torch.clamp(gR * S + VaR, min=1e-30)
        return torch.stack([mL, mR], dim=-1)

    def separated_signals(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lead, accompaniment) time-domain stereo signals, (T, 2) each."""
        mask = self.lead_mask()
        n = self.audio.nsamples
        lead = self.tft.invertTransform(self.X * mask, nsamples=n)
        acc = self.tft.invertTransform(self.X * (1.0 - mask), nsamples=n)
        return lead[0].cpu().numpy(), acc[0].cpu().numpy()

    def writeSeparatedSignals(self, dir_results: str,
                              suffix: str = "") -> Tuple[str, str]:
        os.makedirs(dir_results, exist_ok=True)
        lead, acc = self.separated_signals()
        stem = os.path.splitext(os.path.basename(
            self.audio.filename or "input"))[0] + suffix
        p1 = os.path.join(dir_results, f"{stem}_lead.wav")
        p2 = os.path.join(dir_results, f"{stem}_accompaniment.wav")
        for p, sig in ((p1, lead), (p2, acc)):
            peak = np.max(np.abs(sig))
            AudioObject(data=sig / peak if peak > 1 else sig,
                        samplerate=self.fs)._write(p)
        return p1, p2
