"""Plain reference of the `nmf_inst` model: multichannel NMF with
instantaneous real rank-1 mixing (Ozerov, Vincent & Bimbot, IEEE TASLP
20(4), 2012), stereo, one free FB/TW NMF chain a source.

Written from the model's equations, in plain PyTorch, and sharing no code
with the program: the STFT by gathered frames and rfft, the E-step as the
textbook posterior of the sources (Sigma_x^-1 through the adjugate of a
sum of rank-1 terms, and determinants by Cauchy-Binet, so that no step
subtracts large terms and the reference holds in float32 too), the
Gauss-Seidel pooled spatial solve, the IS-NMF multiplicative
updates, the renormalisation, the Wiener images and the weighted
overlap-add. Every step takes the dtype of its inputs: float64 for the
reference, float32 for the control (with `tf32` the matrix products run
in TF32 on a card, with `low` the fit's state is held in bfloat16 and the
Wiener filter runs in it). A GEM configuration is the dict of the
configuration's "gem" entry.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 matrix products on (tf32) or off for the block, as a card
    takes them; the CPU has no TF32 and ignores it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


# -- front end -------------------------------------------------------------------

def frame_geometry(nsamples: int, wlen: int, hop: int):
    """(pad_front, n_frames, padded_len): wlen - hop zeros in front, and
    frames until every sample lies wlen - hop inside the last one."""
    pad_front = wlen - hop
    cover = nsamples + 2 * (wlen - hop)
    n_frames = max(1, math.ceil(max(cover - wlen, 0) / hop) + 1)
    return pad_front, n_frames, (n_frames - 1) * hop + wlen


def sine_window(wlen: int, dtype, device):
    n = torch.arange(wlen, dtype=torch.float64, device=device)
    return torch.sin(math.pi * (n + 0.5) / wlen).to(dtype)


def stft(x, wlen: int, hop: int):
    """(B, T, I) real -> (B, F, N, I) complex, sine window."""
    B, T, I = x.shape
    pad_front, N, L = frame_geometry(T, wlen, hop)
    xp = torch.zeros((B, L, I), dtype=x.dtype, device=x.device)
    xp[:, pad_front:pad_front + T] = x
    idx = (torch.arange(N, device=x.device)[:, None] * hop
           + torch.arange(wlen, device=x.device)[None, :])
    frames = xp[:, idx]                                   # (B, N, wlen, I)
    frames = frames * sine_window(wlen, x.dtype, x.device)[:, None]
    return torch.fft.rfft(frames, dim=2).permute(0, 2, 1, 3)


def istft(Y, wlen: int, hop: int, nsamples: int):
    """(..., F, N, I) complex -> (..., nsamples, I): windowed inverse
    frames, overlap-added and divided by the window's summed energy."""
    lead = Y.shape[:-3]
    F, N, I = Y.shape[-3:]
    pad_front, n_frames, L = frame_geometry(nsamples, wlen, hop)
    if N != n_frames:
        raise ValueError(f"expected {n_frames} frames, got {N}")
    win = sine_window(wlen, Y.real.dtype, Y.device)
    frames = torch.fft.irfft(Y.movedim(-1, -3).transpose(-1, -2), n=wlen,
                             dim=-1) * win                # (..., I, N, wlen)
    frames = frames.reshape(-1, I, N * wlen)
    idx = (torch.arange(N, device=Y.device)[:, None] * hop
           + torch.arange(wlen, device=Y.device)[None, :]).reshape(-1)
    y = torch.zeros((frames.shape[0], I, L), dtype=frames.dtype,
                    device=Y.device).index_add_(-1, idx, frames)
    norm = torch.zeros(L, dtype=frames.dtype, device=Y.device).index_add_(
        0, idx, (win * win).repeat(N))
    y = (y / norm)[..., pad_front:pad_front + nsamples]
    return y.transpose(-1, -2).reshape(lead + (nsamples, I))


# -- the GEM fit -----------------------------------------------------------------

def endpoints(X, gem):
    """sigma0, sigma1 (B, F): fractions of each bin's mean mixture power,
    silent bins floored at a fraction of the clip's mean."""
    Pm = torch.mean(X.abs() ** 2, dim=(-2, -1))
    floor = torch.clamp(gem["power_floor_frac"] * Pm.mean(-1, keepdim=True),
                        min=gem["eps"])
    Pm = torch.maximum(Pm, floor)
    return gem["sigma_start_frac"] * Pm, gem["sigma_end_frac"] * Pm


def noise_psd(it: int, gem, sigma0, sigma1):
    if gem["annealing"] == "no_ann":
        return sigma1
    if gem["annealing"] != "ann":
        raise ValueError(f"the reference anneals 'ann' or 'no_ann', not "
                         f"{gem['annealing']!r}")
    w = 1.0 - it / max(gem["niter"] - 1, 1)
    return w * sigma0 + (1.0 - w) * sigma1


def _det(v, a0, a1, sig, keep):
    """det(sigma I + sum over `keep` of v_k a_k a_k^T) as a sum of
    nonnegative terms (Cauchy-Binet): sigma^2 + sigma sum_k v_k |a_k|^2 +
    sum_{k < l} v_k v_l c_kl^2, with c_kl = a0_k a1_l - a1_k a0_l."""
    lin = quad = 0.0
    for i, k in enumerate(keep):
        lin = lin + v[:, k] * (a0[k] ** 2 + a1[k] ** 2)
        for l in keep[i + 1:]:
            quad = quad + v[:, k] * v[:, l] * (a0[k] * a1[l]
                                               - a1[k] * a0[l]) ** 2
    return sig * sig + sig * lin + quad


def _posterior_means(X, v, a0, a1, sig, det):
    """s^_j = v_j a_j^T Sigma_x^-1 x for every j, and x^H Sigma_x^-1 x, by
    the adjugate of a sum of rank-1 terms: adj(a a^T) = b b^T with b =
    (a1, -a0), so a_j^T adj(Sigma_x) x = sigma a_j.x + sum_k v_k c_jk
    b_k.x, and x^H adj(Sigma_x) x = sigma |x|^2 + sum_k v_k |b_k.x|^2:
    no difference of large terms."""
    J = v.shape[1]
    x0, x1 = X[..., 0], X[..., 1]
    u = [a1[k] * x0 - a0[k] * x1 for k in range(J)]       # b_k . x
    quad = sig * (x0.abs() ** 2 + x1.abs() ** 2)
    for k in range(J):
        quad = quad + v[:, k] * u[k].abs() ** 2
    s_hat = []
    for j in range(J):
        num = sig * (a0[j] * x0 + a1[j] * x1)
        for k in range(J):
            if k != j:
                num = num + v[:, k] * (a0[j] * a1[k] - a1[j] * a0[k]) * u[k]
        s_hat.append(v[:, j] * num / det)
    return s_hat, quad / det


def estep(X, v, A, sigma, eps):
    """Posterior statistics of the sources given x = A s + b, s_j ~
    N(0, v_j), b ~ N(0, sigma I), for X (B, F, N, 2), v (B, J, F, N), A
    (B, J, 2) real, sigma (B, F). Returns (loglik (B,), xi (B, J, F, N),
    Rxs (B, F, 2, J), Rss (B, F, J, J)). The posterior covariance of the
    sources is C_jj = v_j det(Sigma_x - v_j a_j a_j^T) / det(Sigma_x) and
    C_jk = -v_j v_k a_j^T Sigma_x^-1 a_k."""
    J = v.shape[1]
    a0 = [A[:, j, 0, None, None] for j in range(J)]
    a1 = [A[:, j, 1, None, None] for j in range(J)]
    sig = sigma[:, :, None]
    x0, x1 = X[..., 0], X[..., 1]
    det = _det(v, a0, a1, sig, list(range(J)))
    s_hat, quad = _posterior_means(X, v, a0, a1, sig, det)
    loglik = -torch.sum(torch.log(det) + quad, dim=(1, 2))

    def c(j, k):
        return a0[j] * a1[k] - a1[j] * a0[k]
    C = [[None] * J for _ in range(J)]
    for j in range(J):
        C[j][j] = v[:, j] * _det(v, a0, a1, sig,
                                 [k for k in range(J) if k != j]) / det
        for k in range(J):
            if k != j:
                g = sig * (a0[j] * a0[k] + a1[j] * a1[k])
                for m in range(J):
                    g = g + v[:, m] * c(j, m) * c(k, m)
                C[j][k] = -v[:, j] * v[:, k] * g / det
    xi = torch.stack([torch.clamp(s_hat[j].abs() ** 2 + C[j][j], min=eps)
                      for j in range(J)], dim=1)
    Rxs = torch.stack([torch.stack([torch.sum(xc * s.conj(), dim=-1)
                                    for s in s_hat], dim=-1)
                       for xc in (x0, x1)], dim=2)          # (B, F, 2, J)
    Rss = torch.stack([torch.stack(
        [torch.sum(s_hat[j] * s_hat[k].conj() + C[j][k], dim=-1)
         for k in range(J)], dim=-1) for j in range(J)], dim=-2)
    return loglik, xi, Rxs, Rss


def update_mixing(A, Rxs, Rss, sigma, eps: float = 1e-12):
    """One Gauss-Seidel sweep: A_j <- (R_xs,j - sum_{k != j} A_k R_ss[k, j])
    / R_ss[j, j], each pooled over frequency with 1/sigma weights of unit
    mean, the others' newest A."""
    w = 1.0 / torch.clamp(sigma, min=1e-30)
    w = (w / w.mean(-1, keepdim=True))[..., None]            # (B, F, 1)
    A = A.clone()
    for j in range(A.shape[1]):
        target = Rxs[..., j]                                 # (B, F, 2)
        for k in range(A.shape[1]):
            if k != j:
                target = target - A[:, k, None, :] * Rss[..., k, j, None]
        tp = torch.sum(w * target, dim=1).real               # (B, 2)
        rp = torch.sum(w[..., 0] * Rss[..., j, j], dim=1).real
        A[:, j] = tp / (rp + eps * rp)[:, None]
    return A


def _mult(factor, num, den, eps):
    return torch.clamp(
        factor * torch.clamp(num / torch.clamp(den, min=eps), 1e-5, 1e5),
        min=eps)


def update_nmf(FB, TW, xi, eps):
    """IS-NMF multiplicative updates of FB (B, J, F, K), then of TW (B, J,
    K, N), against the posterior powers xi, the model power refreshed in
    between and floored at 1e-12 of xi's mean."""
    floor = 1e-12 * xi.mean(dim=(-2, -1), keepdim=True) + eps
    V = torch.maximum(FB @ TW, floor)
    FB = _mult(FB, (xi / V ** 2) @ TW.mT, (1.0 / V) @ TW.mT, eps)
    V = torch.maximum(FB @ TW, floor)
    TW = _mult(TW, FB.mT @ (xi / V ** 2), FB.mT @ (1.0 / V), eps)
    return FB, TW


def renormalize(A, FB, TW):
    """Each source's mixing to unit mean power, its power into FB; FB's
    columns to unit sum, their scale into TW."""
    norm = torch.clamp(torch.sum(A ** 2, dim=-1) / A.shape[-1], min=1e-30)
    A = A / torch.sqrt(norm)[..., None]
    FB = FB * norm[..., None, None]
    s = torch.clamp(FB.sum(dim=-2), min=1e-30)               # (B, J, K)
    return A, FB / s[..., None, :], TW * s[..., None]


def _held(low, *state):
    """The state rounded to `low` and back (unchanged for low None)."""
    return state if low is None else tuple(t.to(low).to(t.dtype)
                                           for t in state)


def gem(X, A, FB, TW, gem_cfg, start: int = 0, stop: int = None,
        low=None):
    """The GEM fit from (A, FB, TW) over iterations [start, stop) of the
    schedule over the configuration's niter (all of them by default):
    returns (logliks (B, stop - start), A, FB, TW). With `low` (a real
    dtype) the state is held in it: rounded to it on entry and after
    every iteration."""
    niter, eps = gem_cfg["niter"], gem_cfg["eps"]
    stop = niter if stop is None else stop
    sigma0, sigma1 = endpoints(X, gem_cfg)
    hold = int(gem_cfg["spatial_hold_frac"] * niter)
    logliks = torch.zeros((X.shape[0], stop - start), dtype=A.dtype,
                          device=X.device)
    A, FB, TW = _held(low, A, FB, TW)
    for it in range(start, stop):
        sigma = noise_psd(it, gem_cfg, sigma0, sigma1)
        loglik, xi, Rxs, Rss = estep(X, FB @ TW, A, sigma, eps)
        if it >= hold:
            A = update_mixing(A, Rxs, Rss, sigma)
        FB, TW = update_nmf(FB, TW, xi, eps)
        A, FB, TW = _held(low, *renormalize(A, FB, TW))
        logliks[:, it - start] = loglik
    return logliks, A, FB, TW


def wiener(X, A, FB, TW, sigma, low=None):
    """Posterior-mean source images a_j s^_j: (B, J, F, N, 2). With `low`
    (a real dtype) the filter runs in that dtype, on the real and the
    imaginary plane apart (its coefficients are real), and the images come
    back in float32."""
    v = FB @ TW
    if low is None:
        return _wiener(X, A, v, sigma)
    A, v, sigma = A.to(low), v.to(low), sigma.to(low)
    return torch.complex(_wiener(X.real.to(low), A, v, sigma).float(),
                         _wiener(X.imag.to(low), A, v, sigma).float())


def _wiener(X, A, v, sigma):
    J = v.shape[1]
    a0 = [A[:, j, 0, None, None] for j in range(J)]
    a1 = [A[:, j, 1, None, None] for j in range(J)]
    sig = sigma[:, :, None]
    s_hat, _ = _posterior_means(X, v, a0, a1, sig,
                                _det(v, a0, a1, sig, list(range(J))))
    return torch.stack([torch.stack([a0[j] * s_hat[j], a1[j] * s_hat[j]],
                                    dim=-1) for j in range(J)], dim=1)


# -- whole paths -------------------------------------------------------------------
#
# The check follows the program's fit from its inputs (fit, host_fit) and
# judges its images from its own final state (separate, host_separate).

def _fit(X, A, FB, TW, gem_cfg, steps, low):
    ll, A1, FB1, TW1 = gem(X, A, FB, TW, gem_cfg, low=low)
    out = {"logliks": ll, "A": A1, "FB": FB1, "TW": TW1, "steps": []}
    for st in steps:
        ll, A1, FB1, TW1 = gem(X, *(st[n].to(A.dtype) for n in
                                    ("A", "FB", "TW")),
                               gem_cfg, st["it"], st["it"] + 1, low)
        out["steps"].append({"it": st["it"], "loglik": ll[:, 0], "A": A1,
                             "FB": FB1, "TW": TW1})
    return out


def fit(mix, A, FB, TW, model, steps=(), tf32: bool = False, low=None):
    """The batch path's STFT and GEM on mix (B, T, 2) from (A (B, J, 2),
    FB, TW), in mix's dtype: {"logliks" (B, niter), "A", "FB", "TW"}, and
    under "steps", for each {"it", "A", "FB", "TW"} of `steps` (a state
    before iteration it), that iteration from that state: {"it", "loglik"
    (B,), "A", "FB", "TW"}. tf32 and low: the matrix products in TF32,
    the state held in `low` (gem)."""
    with matmul_precision(tf32):
        X = stft(mix, model["wlen"], model["hop"])
        return _fit(X, A, FB, TW, model["gem"], steps, low)


def separate(mix, A, FB, TW, model, low=None):
    """The batch path's images (B, J, T, 2) from a state (A, FB, TW): the
    STFT of mix, the Wiener images at the last noise floor and the inverse
    STFT, in mix's dtype (the filter in `low`, if given)."""
    wlen, hop = model["wlen"], model["hop"]
    X = stft(mix, wlen, hop)
    Y = wiener(X, A, FB, TW, endpoints(X, model["gem"])[1], low)
    return istft(Y.to(X.dtype), wlen, hop, mix.shape[1])


def _host_plane(data, model):
    X = stft(data[None], model["wlen"], model["hop"])
    scale = torch.sqrt(torch.clamp(torch.mean(X.abs() ** 2), min=1e-30))
    return X / scale, scale


def host_fit(data, A, FB, TW, model, steps=(), tf32: bool = False,
             low=None):
    """The host API's fit of one clip, data (T, 2) as read from its WAV:
    the transform normalised to unit mean power, then GEM from (A (J, 2),
    FB, TW); returns as fit(), its states (1, J, ...)."""
    with matmul_precision(tf32):
        Xs, _ = _host_plane(data, model)
        return _fit(Xs, A[None], FB[None], TW[None], model["gem"], steps,
                    low)


def host_separate(data, A, FB, TW, model, low=None):
    """The PCM16 words (J, T, 2) the host API writes for a state (A (1, J,
    2), FB, TW): the Wiener images, the inverse transform, the scale
    restored."""
    Xs, scale = _host_plane(data, model)
    Y = wiener(Xs, A, FB, TW, endpoints(Xs, model["gem"])[1], low)
    ys = istft(Y.to(Xs.dtype), model["wlen"], model["hop"],
               data.shape[0])[0] * scale
    return pcm16(ys)


def pcm16(ys):
    """The PCM16 words the host API writes for images (J, T, I): each
    image divided by its peak where that passes 1, clipped, times 32767,
    rounded half to even."""
    peak = ys.abs().amax(dim=(-2, -1), keepdim=True)
    ys = torch.where(peak > 1.0, ys / peak, ys)
    return torch.round(torch.clamp(ys, -1.0, 1.0) * 32767.0)


def as_tensors(arrays, dtype, device):
    return [torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)
            for a in arrays]
