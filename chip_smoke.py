#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (each prints one line with its numbers and seconds):
  0. the machine: nvidia-smi name and power limit, torch, CUDA and nvcc;
  1. build the CUDA kernels from csrc/ (nvcc, sm_90a);
  2. the E-step kernel against its plain PyTorch version on the card, at
     the bench shapes (B=8, F=513, N=863) and two small ones;
  3. the host API: MultiChanNMFInst_FASST on a 10 s stereo WAV, 500 GEM
     iterations, WAVs written; the kernel must carry every E-step and the
     separation must reach 60 dB SDR;
  4. the bench pipeline (STFT, 500 GEM iterations, Wiener, ISTFT) over 8
     clips at once, with the same SDR gate, and CUDA-event timings of one
     E-step (kernel and plain) and of the whole pipeline at B=1 and B=8.

Any failure raises and exits non-zero before the last line, which is
{"ok": true, "device": {...}} only when every phase passed. Without a CUDA
device the script exits non-zero at once. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

FS = 44100
DUR = 10.0
WLEN = 1024
HOP = 512
NITER = 500
J, K = 2, 8
BATCH = 8
SDR_GATE = 60.0
REPLACES = "pyfasst_tpu/ops/pallas_estep.py:108"
KERNEL_SOURCE = "pyfasst_tpu_torch/csrc/estep.cu"
# Bars of tests/test_pallas_estep.py: xi 2e-4, frame-reduced statistics
# 5e-4 (its multi-tile case), loglik 1e-4.
TOL = {"xi": 2e-4, "txs": 5e-4, "tss": 5e-4, "t4": 5e-4, "t7": 5e-4,
       "loglik": 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def make_mixture(fs=FS, dur=DUR, seed=0):
    """The bench mixture (bench.py::make_mixture): a vibrato tone and gated
    noise, panned apart. Returns (mix, image1, image2), float32."""
    rng = np.random.default_rng(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    f0 = 180.0 + 20.0 * (seed % 5)
    s1 = (0.4 * np.sin(2 * np.pi * (f0 * t
                                    + 3 * np.sin(2 * np.pi * 0.5 * t)))
          + 0.2 * np.sin(2 * np.pi * 2 * f0 * t)
          + 0.1 * np.sin(2 * np.pi * 3 * f0 * t))
    env = (np.sin(2 * np.pi * (1.0 + 0.1 * (seed % 7)) * t) > 0)
    s2 = 0.3 * rng.standard_normal(n) * env.astype(np.float64)
    y1 = s1[:, None] * np.array([0.95, 0.31])
    y2 = s2[:, None] * np.array([0.31, 0.95])
    mix = y1 + y2
    scale = np.max(np.abs(mix))
    return ((mix / scale).astype(np.float32), (y1 / scale).astype(np.float32),
            (y2 / scale).astype(np.float32))


def bench_tree(F, N, seed=0):
    """bench.py::build_params as a parameter tree for convert."""
    from pyfasst_tpu_torch.models.components import init_inst_mixing
    rng = np.random.default_rng(seed)
    spat = [{"A": a.numpy(), "mix_type": "inst", "free": True}
            for a in init_inst_mixing(None, 2, 1, J)]
    spec = [{"FB": (0.5 + rng.random((F, K))).astype(np.float32),
             "TW": (0.5 + rng.random((K, N))).astype(np.float32),
             "spat_ind": j} for j in range(J)]
    return {"spat": spat, "spec": spec}


def min_sdr(ys, y_true):
    """Permutation-best min source SDR per clip: ys, y_true (B, 2, T, I)."""
    import torch
    ys = ys.to(torch.float64)
    y_true = y_true.to(torch.float64)

    def sdr(e, r):
        num = torch.sum(r ** 2, dim=(-2, -1))
        den = torch.clamp(torch.sum((e - r) ** 2, dim=(-2, -1)), min=1e-12)
        return 10.0 * torch.log10(num / den)

    p0 = torch.minimum(sdr(ys[:, 0], y_true[:, 0]), sdr(ys[:, 1], y_true[:, 1]))
    p1 = torch.minimum(sdr(ys[:, 1], y_true[:, 0]), sdr(ys[:, 0], y_true[:, 1]))
    return torch.maximum(p0, p1).cpu().numpy()


def pipeline(mix, params, cfg, window, nsamples):
    """Bench pipeline on B clips: STFT -> GEM -> Wiener -> ISTFT."""
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints, run_gem
    from pyfasst_tpu_torch.ops.wiener import separate_sources
    from pyfasst_tpu_torch.tf.stft import _istft_core, _stft_core
    X = _stft_core(mix, window, WLEN, HOP, "fft")          # (B, F, N, 2)
    params, logliks = run_gem(params, X, cfg)
    _, sigma1 = annealing_endpoints(X, cfg)
    Y = separate_sources(params, X, sigma1)                # (B, J, F, N, 2)
    ys = _istft_core(Y, window, WLEN, HOP, nsamples)       # (B, J, T, 2)
    return ys, logliks


def check_logliks(ll: np.ndarray, label: str) -> None:
    """Finite everywhere; the late iterations rise (monotone to within a
    small relative slack, as the verify recipe asks)."""
    if not np.all(np.isfinite(ll)):
        raise RuntimeError(f"{label}: non-finite loglik")
    late = ll[..., ll.shape[-1] // 2:]
    worst = float(np.min(np.diff(late, axis=-1)))
    if worst < -1e-3 * float(np.max(np.abs(late))):
        raise RuntimeError(f"{label}: loglik falls late in the run "
                           f"(worst step {worst:.6g})")
    if np.any(late[..., -1] <= late[..., 0]):
        raise RuntimeError(f"{label}: loglik did not rise late in the run")


# -- phases --------------------------------------------------------------------

def phase_machine(device):
    import torch
    from pyfasst_tpu_torch.ops import _build
    t0 = time.perf_counter()
    card = smi()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    log(f"phase 0 machine: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvcc {release[0].strip() if release else '?'}"
        f" | {torch.cuda.get_device_name(device)} x{torch.cuda.device_count()}"
        f" | {time.perf_counter() - t0:.2f}s")
    return card


def phase_build():
    from pyfasst_tpu_torch.ops import _build
    t0 = time.perf_counter()
    info = _build.build(verbose=True)
    _build.load()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln
             or "Compiling entry" in ln]
    log(f"phase 1 build: built={info['built']} nvcc {info['seconds']:.2f}s "
        f"| {time.perf_counter() - t0:.2f}s")
    for ln in ptxas:
        log(f"  ptxas: {ln}")


def _estep_inputs(B, F, N, seed, device):
    import torch
    rng = np.random.default_rng(seed)
    FB = 0.5 + rng.random((B, J, F, K))
    TW = 0.5 + rng.random((B, J, K, N))
    arrays = {
        "x4": rng.standard_normal((B, 4, F, N)),
        "v": np.einsum("bjfk,bjkn->bjfn", FB, TW),
        "A": np.abs(rng.standard_normal((B, J, 1, 2))).repeat(F, 2) + 0.3,
        "sigma": 0.01 + 0.005 * rng.random((B, F)),
    }
    return {k: torch.as_tensor(a, dtype=torch.float32, device=device)
            .contiguous() for k, a in arrays.items()}


def _rel_err(got, want):
    """max |got - want| / (|want| + 1e-3 max|want|): relative per element,
    with a floor at a thousandth of the output's scale for exact zeros."""
    floor = 1e-3 * float(want.abs().max()) + 1e-30
    return float(((got - want).abs() / (want.abs() + floor)).max())


def phase_kernel_vs_plain(device):
    import torch
    from pyfasst_tpu_torch.ops import cuda_estep
    t0 = time.perf_counter()
    names = ("xi", "txs", "tss", "t4", "t7")
    main_abs = 0.0
    for (B, F, N) in ((BATCH, 513, 863), (1, 33, 70), (1, 9, 2500)):
        inp = _estep_inputs(B, F, N, seed=F * N, device=device)
        got = cuda_estep.estep_r1_real(**inp)
        want = cuda_estep.estep_r1_real_ref(**inp)
        torch.cuda.synchronize()
        errs = {n: _rel_err(g, w) for n, g, w in zip(names, got, want)}
        ll_g, ll_w = -got[5].sum(-1), -want[5].sum(-1)
        errs["loglik"] = float(((ll_g - ll_w).abs() / ll_w.abs()).max())
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if B == BATCH:
            main_abs = abs_err
        log(f"phase 2 kernel vs plain B={B} F={F} N={N}: "
            + " ".join(f"{n} {e:.2e}<={TOL[n]:.0e}" for n, e in errs.items())
            + f" | max_abs_err {abs_err:.3e}")
        bad = [n for n, e in errs.items() if not e <= TOL[n]]
        if bad:
            raise RuntimeError(f"kernel disagrees with its plain version at "
                               f"B={B} F={F} N={N}: {bad}")
    log(f"phase 2 done | {time.perf_counter() - t0:.2f}s")
    return main_abs


def phase_host_api(device, dur, niter):
    import scipy.io.wavfile
    import torch
    from pyfasst_tpu_torch import MultiChanNMFInst_FASST
    from pyfasst_tpu_torch.ops import cuda_estep
    t0 = time.perf_counter()
    mix, y1, y2 = make_mixture(dur=dur)
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "mix.wav")
        scipy.io.wavfile.write(wav, FS, mix)              # float32 WAV
        model = MultiChanNMFInst_FASST(wav, nbComps=J, nbNMFComps=K,
                                       iter_num=niter, device=device)
        cuda_estep.LAUNCHES = 0
        t1 = time.perf_counter()
        ll = model.estim_param_a_posteriori()
        paths = model.separate_spat_comps(os.path.join(tmp, "out"))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = cuda_estep.LAUNCHES
        ys = model.separated_images()
        written = [p for p in paths if os.path.getsize(p) > 44]
        check_logliks(ll, "host API")
        sdr = float(min_sdr(torch.as_tensor(ys)[None],
                            torch.as_tensor(np.stack([y1, y2]))[None])[0])
        log(f"phase 3 host API: {niter} iters, loglik {ll[0]:.6g} -> "
            f"{ll[-1]:.6g}, E-step kernel launches {launches}, min SDR "
            f"{sdr:.2f} dB, wavs {len(written)}/{J} | run {run_s:.2f}s | "
            f"{time.perf_counter() - t0:.2f}s")
        if launches != niter:
            raise RuntimeError(f"E-step kernel launched {launches} times in "
                               f"{niter} iterations (expected {niter})")
        if not sdr > SDR_GATE:
            raise RuntimeError(f"host API separation {sdr:.2f} dB <= "
                               f"{SDR_GATE} dB")
        if len(written) != J:
            raise RuntimeError(f"expected {J} WAVs, found {paths}")
    return launches


def _event_ms(fn, reps, inner=1):
    """CUDA-event timings of fn() in milliseconds: `reps` samples, each the
    mean over `inner` back-to-back calls. Returns the list of samples."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _i in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return times


def phase_batch(device, dur, niter, batch, card):
    import torch
    from pyfasst_tpu_torch import convert
    from pyfasst_tpu_torch.ops import cuda_estep
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints
    from pyfasst_tpu_torch.tf.stft import (
        _frame_geometry, _stft_core, sine_window,
    )
    from pyfasst_tpu_torch.utils.config import GEMConfig
    t0 = time.perf_counter()
    nsamples = int(FS * dur)
    clips = [make_mixture(dur=dur, seed=b) for b in range(batch)]
    mix = torch.as_tensor(np.stack([c[0] for c in clips]), device=device)
    y_true = torch.as_tensor(np.stack([np.stack(c[1:]) for c in clips]),
                             device=device)
    window = torch.as_tensor(sine_window(WLEN), dtype=torch.float32,
                             device=device)
    F = WLEN // 2 + 1
    N = _frame_geometry(nsamples, WLEN, HOP)[2]
    cfg = GEMConfig(niter=niter)

    def params_for(b_count):
        return convert.params_from_numpy(
            [bench_tree(F, N, seed=b) for b in range(b_count)], device=device)

    ys, logliks = pipeline(mix, params_for(batch), cfg, window, nsamples)
    check_logliks(logliks.cpu().numpy(), f"batch-{batch}")
    sdrs = min_sdr(ys, y_true)
    log(f"phase 4 batch-{batch}: per-clip min SDR "
        + " ".join(f"{s:.2f}" for s in sdrs)
        + f" | {time.perf_counter() - t0:.2f}s")
    if not np.all(sdrs > SDR_GATE):
        raise RuntimeError(f"batch separation below {SDR_GATE} dB: {sdrs}")

    # one E-step at the bench shapes, in turns: plain, kernel, kernel, plain
    X = _stft_core(mix, window, WLEN, HOP, "fft")
    params = params_for(batch)
    inp = {"x4": cuda_estep.pack_x4(X),
           "v": params.all_source_powers().contiguous(),
           "A": cuda_estep.mixing_columns(
               tuple(c.conv_mixing(F) for c in params.spat)),
           "sigma": annealing_endpoints(X, cfg)[1].contiguous()}
    reps, inner = 11, 10
    kern, plain = [], []
    for fn, out in ((cuda_estep.estep_r1_real_ref, plain),
                    (cuda_estep.estep_r1_real, kern),
                    (cuda_estep.estep_r1_real, kern),
                    (cuda_estep.estep_r1_real_ref, plain)):
        fn(**inp)                                          # warm-up
        out.extend(_event_ms(lambda: fn(**inp), reps, inner))
    kernel_ms, plain_ms = statistics.median(kern), statistics.median(plain)
    bins = batch * F * N
    mbytes = bins * (16 + 8 * J) / 1e6
    log(f"phase 4 E-step B={batch} F={F} N={N}: kernel {kernel_ms:.4f} ms "
        f"(min {min(kern):.4f} max {max(kern):.4f}), plain {plain_ms:.4f} ms "
        f"(min {min(plain):.4f} max {max(plain):.4f}); median of "
        f"{len(kern)} samples of {inner} back-to-back calls, in turns "
        f"plain/kernel/kernel/plain | ~{mbytes:.1f} MB moved -> "
        f"{mbytes / 1e3 / (kernel_ms / 1e3):.1f} GB/s | {card}")

    # whole pipeline, B=1 and B=batch, after the warm-up run above
    xrt = {}
    for b_count in (1, batch):
        p_b = params_for(b_count)
        args = (mix[:b_count], p_b, cfg, window, nsamples)
        if b_count != batch:
            pipeline(*args)                                 # warm-up
        ms = _event_ms(lambda: pipeline(*args), 5)
        xrt[b_count] = b_count * dur / (statistics.median(ms) / 1e3)
        log(f"phase 4 pipeline B={b_count}: {niter} iters, "
            + ", ".join(f"{m:.1f}" for m in ms)
            + f" ms -> xRT {xrt[b_count]:.2f} (median of {len(ms)}) | {card}")
    log(f"phase 4 done | {time.perf_counter() - t0:.2f}s")
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "xrt": xrt}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    card = phase_machine(device)
    phase_build()
    main_abs = phase_kernel_vs_plain(device)
    launches = phase_host_api(device, DUR, NITER)
    timing = phase_batch(device, DUR, NITER, BATCH, card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "estep_r1_real",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": main_abs,
        "ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
