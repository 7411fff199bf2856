"""Learned per-bin TF embeddings for blind source assignment.

Port of pyfasst_tpu/models/binfeat.py. A small fully-convolutional network
maps the local feature PLANE around each bin (I*I normalized covariance
channels and one standardized log-power channel) to a unit-norm embedding,
trained by the JAX package with the permutation-free deep-clustering
objective (Hershey et al. 2016, arXiv:1508.04306). Inference is one
weighted spherical k-means over every bin: the embeddings are globally
aligned by training, so the per-frequency permutation step of the
hand-crafted vote families never arises. The blind reverberant pipeline
(models/reverb.py) uses the votes as a pool candidate and as the
selection judge.

The network runs in PyTorch (F.conv2d, NCHW) on an explicit device, with
TF32 off (utils/precision.highest_precision: cuDNN would otherwise take
TF32 for float32 convolutions, and the embeddings feed argmax decisions).
Parameters are a dict of numpy arrays with the weights in torch's OIHW
layout; the weights file keeps the JAX package's HWIO layout, so one file
loads in either package: load_params transposes HWIO -> OIHW, save_params
back. The trained weights ship as pyfasst_tpu_torch/data/binfeat.npz, a
byte-identical copy of the JAX package's. The training driver stays on
the JAX side; dc_loss is differentiable, so the port can train too.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pyfasst_tpu_torch.utils.precision import highest_precision

__all__ = [
    "bin_inputs", "init_params", "embed", "embed_host", "dc_loss",
    "learned_votes", "save_params", "load_params", "default_params_path",
    "has_default_params",
]

# architecture constants (one published geometry -- the weights file
# carries its own copy so other geometries stay loadable)
_WIDTH = 40
_EMB_DIM = 16
# (kernel_f, kernel_n, dilation_f, dilation_n) per conv layer
_LAYERS = (
    (5, 5, 1, 1),
    (5, 5, 2, 1),
    (5, 5, 4, 2),
    (5, 5, 8, 4),
    (3, 3, 16, 8),
)


def _is_conv_weight(name: str) -> bool:
    return name.endswith("/w")


# -- inputs ---------------------------------------------------------------

def bin_inputs(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(F, N, I) complex STFT plane -> (inputs (F, N, C), pw (F, N)).

    Channels are scale-invariant so one network transfers across
    families and levels: the I*I normalized covariance entries of
    `spatial_init.tf_covariance_features` plus one standardized log-power
    channel (spectral structure: harmonicity, onsets).
    """
    from pyfasst_tpu_torch.models.spatial_init import tf_covariance_features

    feat, _w, pw, _xx = tf_covariance_features(X)
    lp = np.log(pw + 1e-12)
    lp = (lp - np.median(lp)) / (lp.std() + 1e-6)
    inp = np.concatenate([feat, lp[..., None]], -1).astype(np.float32)
    return inp, pw.astype(np.float32)


# -- network (pure functions over a param dict) ---------------------------

def init_params(seed: int = 0, c_in: int = 5, width: int = _WIDTH,
                emb_dim: int = _EMB_DIM, layers=_LAYERS) -> Dict:
    """He-initialized parameters. Keys: conv{i}/{w,b,g}; head/{w,b}; g is
    the per-channel LayerNorm gain applied after each conv. Drawn with
    numpy exactly as the JAX package draws them (its HWIO arrays, here in
    OIHW)."""
    rng = np.random.default_rng(seed)
    params = {"_meta": {"c_in": c_in, "width": width, "emb_dim": emb_dim,
                        "layers": [list(l) for l in layers]}}
    cin = c_in
    for i, (kf, kn, _df, _dn) in enumerate(layers):
        fan_in = kf * kn * cin
        w = (rng.standard_normal((kf, kn, cin, width))
             * np.sqrt(2.0 / fan_in)).astype(np.float32)
        params[f"conv{i}/w"] = _hwio_to_oihw(w)
        params[f"conv{i}/b"] = np.zeros((width,), np.float32)
        params[f"conv{i}/g"] = np.ones((width,), np.float32)
        cin = width
    w = (rng.standard_normal((1, 1, width, emb_dim))
         * np.sqrt(1.0 / width)).astype(np.float32)
    params["head/w"] = _hwio_to_oihw(w)
    params["head/b"] = np.zeros((emb_dim,), np.float32)
    return params


def _hwio_to_oihw(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _as_tensors(params: Dict, device) -> Dict:
    """The weights as float32 tensors on `device` (the _meta entry kept)."""
    dev = resolve_device(device)
    return {k: (v if k == "_meta" else
                torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                device=dev))
            for k, v in params.items()}


def embed(params: Dict, inp: torch.Tensor) -> torch.Tensor:
    """(B, F, N, C) float32 tensor -> (B, F, N, D) unit-norm embeddings.

    params: tensors on inp's device (OIHW conv weights) and "_meta".
    SAME-padded dilated conv stack (odd kernels: d (k - 1) / 2 on each
    side), channel LayerNorm (population variance, eps 1e-6 inside the
    sqrt) + GELU (tanh approximation, jax.nn.gelu's default) per layer,
    1x1 head, L2 normalization. Differentiable; callers that feed a
    decision run it under highest_precision (embed_host does).
    """
    meta = params["_meta"]
    h = inp.permute(0, 3, 1, 2)                       # NCHW: C, F, N
    for i, (kf, kn, df, dn) in enumerate(meta["layers"]):
        h = TF.conv2d(h, params[f"conv{i}/w"], params[f"conv{i}/b"],
                      padding=(df * (kf - 1) // 2, dn * (kn - 1) // 2),
                      dilation=(df, dn))
        mu = h.mean(1, keepdim=True)
        sd = torch.sqrt(h.var(1, unbiased=False, keepdim=True) + 1e-6)
        h = (h - mu) / sd * params[f"conv{i}/g"][None, :, None, None]
        h = TF.gelu(h, approximate="tanh")
    v = TF.conv2d(h, params["head/w"], params["head/b"])
    v = v.permute(0, 2, 3, 1)                          # (B, F, N, D)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-8)


@highest_precision
def embed_host(params: Dict, inp: np.ndarray,
               device=DEFAULT_DEVICE) -> np.ndarray:
    """(F, N, C) numpy -> (F, N, D) numpy: one embed call on `device`,
    with TF32 off."""
    dev = resolve_device(device)
    w = _as_tensors(params, dev)
    x = torch.as_tensor(np.asarray(inp, np.float32))[None].to(dev)
    with torch.no_grad():
        return embed(w, x)[0].cpu().numpy()


# -- training objective ----------------------------------------------------

def dc_loss(V, Y, wb):
    """Power-weighted deep-clustering loss, normalized per plane.

    V (B, F, N, D) unit embeddings; Y (B, F, N, J) one-hot dominance;
    wb (B, F, N) bin weights (sum 1 per plane). The affinity distance
    ||VV' - YY'||_F^2 collapses to Gram matrices,
        ||V'V||^2 - 2 ||V'Y||^2 + ||Y'Y||^2,   rows scaled by sqrt(wb),
    divided by ||Y'Y||^2 (0 = perfect, 1 = uninformative). Tensors in,
    a differentiable scalar out.
    """
    B = V.shape[0]
    s = torch.sqrt(torch.clamp(wb, min=0.0))[..., None]
    Vw = (V * s).reshape(B, -1, V.shape[-1])
    Yw = (Y * s).reshape(B, -1, Y.shape[-1])
    vtv = Vw.transpose(1, 2) @ Vw
    vty = Vw.transpose(1, 2) @ Yw
    yty = Yw.transpose(1, 2) @ Yw
    ref = torch.clamp((yty ** 2).sum((-2, -1)), min=1e-12)
    num = ((vtv ** 2).sum((-2, -1)) - 2.0 * (vty ** 2).sum((-2, -1))
           + (yty ** 2).sum((-2, -1)))
    return (num / ref).mean()


# -- inference: embeddings -> votes ---------------------------------------

def _weighted_spherical_kmeans(V2, wb, J, seed, iters=30):
    """Host k-means on unit rows V2 (M, D) with weights wb (M,).
    Returns (labels (M,), mean within-cluster cosine score)."""
    rng = np.random.default_rng(seed)
    # power-biased init: sample proportional to weight
    p = wb / wb.sum()
    C = V2[rng.choice(len(V2), J, replace=False, p=p)]
    lab = np.zeros(len(V2), np.int64)
    for _ in range(iters):
        sim = V2 @ C.T                                   # (M, J)
        lab = sim.argmax(1)
        for j in range(J):
            m = lab == j
            if m.any():
                c = (V2[m] * wb[m, None]).sum(0)
                C[j] = c / max(np.linalg.norm(c), 1e-12)
            else:                                         # dead centroid:
                C[j] = V2[rng.choice(len(V2), p=p)]       # re-seed by power
    score = float((wb * (V2 @ C.T).max(1)).sum() / wb.sum())
    return lab, score


def learned_votes(X: np.ndarray, J: int, params: Optional[Dict] = None,
                  n_seeds: int = 4, device=DEFAULT_DEVICE,
                  return_emb: bool = False):
    """(F, N, I) complex STFT -> learned vote plane (F, N, J) one-hot.

    Embeds every bin (one embed call on `device`), then runs `n_seeds`
    weighted spherical k-means over ALL bins jointly on the host (float64)
    and keeps the best within-cluster-cosine run.
    """
    if params is None:
        params = load_params()
    inp, pw = bin_inputs(X)
    V = embed_host(params, inp, device=device)            # (F, N, D)
    F, N, D = V.shape
    V2 = V.reshape(-1, D).astype(np.float64)
    wb = pw.reshape(-1).astype(np.float64)
    wb = wb / max(wb.sum(), 1e-20)
    best = None
    for s in range(n_seeds):
        lab, score = _weighted_spherical_kmeans(V2, wb, J, seed=s)
        if best is None or score > best[1]:
            best = (lab, score)
    votes = np.eye(J, dtype=np.float64)[best[0].reshape(F, N)]
    if return_emb:
        return votes, V
    return votes


# -- weight persistence ----------------------------------------------------

def default_params_path() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "binfeat.npz")


def has_default_params() -> bool:
    return os.path.exists(default_params_path())


def save_params(params: Dict, path: Optional[str] = None) -> str:
    """Write the JAX package's layout (HWIO conv weights, _meta_json)."""
    path = path or default_params_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {k: (_oihw_to_hwio(np.asarray(v)) if _is_conv_weight(k)
                  else np.asarray(v))
              for k, v in params.items() if k != "_meta"}
    arrays["_meta_json"] = np.frombuffer(
        json.dumps(params["_meta"]).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_params(path: Optional[str] = None) -> Dict:
    """Read a weights file of either package; conv weights come back in
    OIHW."""
    path = path or default_params_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no trained binfeat weights at {path}; pass params "
            "explicitly or train them (the JAX package's "
            "tools/train_binfeat.py)")
    z = np.load(path)
    params = {k: (_hwio_to_oihw(z[k]) if _is_conv_weight(k) else z[k])
              for k in z.files if k != "_meta_json"}
    params["_meta"] = json.loads(bytes(z["_meta_json"]).decode())
    return params
