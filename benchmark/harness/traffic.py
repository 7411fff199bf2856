"""The one generator of clips and initial parameters, driven by a traffic
file (benchmark/traffic/<name>.json) and a seed.

The clip recipe is bench.py's make_mixture (frozen from chip_smoke.py at
commit 34b280c4): a vibrato tone with two harmonics panned one way and
gated noise panned the other, scaled to a peak of 1. Its tone pitch and
gate rate take one of a few steps from each clip's own seed. The initial
parameters follow bench_tree: each source's mixing a direction in the
first quadrant plus a small jitter, FB and TW 0.5 plus a uniform draw. Both
are drawn on the device, from a torch.Generator seeded from --seed, in a
few large calls: the same seed gives the same pool on the same device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from harness.reference import frame_geometry


def seed_words(seed: int, n: int, stream: int) -> np.ndarray:
    """n uint32 words from --seed (any whole number) for `stream`."""
    return np.random.SeedSequence([int(seed) % 2 ** 64, stream]) \
        .generate_state(n, np.uint32)


def generator(seed: int, stream: int, device) -> torch.Generator:
    word = seed_words(seed, 2, stream).astype(np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(word[0] << np.uint64(32) | word[1]))
    return g


def clip_shape(clips: dict, model: dict):
    """(nsamples, F, N) of the traffic's clips under the model's STFT."""
    T = int(round(clips["fs"] * clips["seconds"]))
    N = frame_geometry(T, model["wlen"], model["hop"])[1]
    return T, model["wlen"] // 2 + 1, N


def make_clips(seed: int, clips: dict, count: int, device,
               chunk: int = 8) -> torch.Tensor:
    """(count, T, 2) float32 stereo mixtures, made `chunk` clips at a time
    in float64 on `device`."""
    T = int(round(clips["fs"] * clips["seconds"]))
    tone, noise = clips["tone"], clips["noise"]
    words = seed_words(seed, count, 1).astype(np.int64)
    g = generator(seed, 2, device)
    t = torch.arange(T, dtype=torch.float64, device=device) / clips["fs"]
    out = torch.empty((count, T, 2), dtype=torch.float32, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    for lo in range(0, count, chunk):
        w = words[lo:lo + chunk]
        f0 = torch.as_tensor(tone["f0_hz"] + tone["f0_step_hz"]
                             * (w % tone["f0_steps"]), **f64)[:, None]
        gate = torch.as_tensor(noise["gate_hz"] + noise["gate_step_hz"]
                               * (w % noise["gate_steps"]), **f64)[:, None]
        vib = tone["vibrato_depth"] * torch.sin(
            2 * math.pi * tone["vibrato_hz"] * t)
        s1 = sum(a * torch.sin(2 * math.pi * ((h + 1) * f0 * t
                                               + (vib if h == 0 else 0.0)))
                 for h, a in enumerate(tone["harmonics"]))
        env = (torch.sin(2 * math.pi * gate * t) > 0).to(torch.float64)
        s2 = noise["level"] * torch.randn((len(w), T), generator=g,
                                          **f64) * env
        mix = (s1[..., None] * torch.as_tensor(tone["pan"], **f64)
               + s2[..., None] * torch.as_tensor(noise["pan"], **f64))
        out[lo:lo + chunk] = (mix / mix.abs().amax(dim=(1, 2), keepdim=True)
                              ).to(torch.float32)
    return out


def make_params(seed: int, init: dict, count: int, J: int, F: int, N: int,
                K: int, device):
    """Initial (A (count, J, 2), FB (count, J, F, K), TW (count, J, K, N)),
    float32 on `device`."""
    g = generator(seed, 3, device)
    f32 = dict(dtype=torch.float32, device=device)
    theta = (torch.arange(J, dtype=torch.float64) + 1.0) / (J + 1.0) \
        * (math.pi / 2)
    base = torch.stack([torch.cos(theta), torch.sin(theta)], -1).to(**f32)
    A = (base + init["mixing_jitter"]
         * torch.randn((count, J, 2), generator=g, **f32)).abs()
    lo, span = init["nmf_low"], init["nmf_span"]
    FB = lo + span * torch.rand((count, J, F, K), generator=g, **f32)
    TW = lo + span * torch.rand((count, J, K, N), generator=g, **f32)
    return A, FB, TW


def host_seeds(seed: int, count: int) -> list:
    """The host API's own seed for each clip of the pool, in [0, 2**31)
    (the range in which its draw is defined)."""
    return [int(w) & 0x7FFFFFFF for w in seed_words(seed, count, 4)]
