"""Command-line interface: `python -m pyfasst_tpu_torch <command>`.

The JAX package's CLI (pyfasst_tpu/__main__.py) on the port: the same
commands, options, defaults and presets, over the port's entry points.
Blind source separation (`separate`), lead/accompaniment (`lead`),
mixing-direction analysis (`demix`), BSS-Eval scoring (`eval`) and WAV
inspection (`info`). `separate` and `lead` run on the card unless
`--device cpu` is given; without a card they exit with code 2 (never
falling back to the CPU). `demix`, `eval` and `info` run NumPy on the host,
as in the JAX package.

`separate --n-devices N` runs the blind pools of `--spatial-init` on
conv/fullrank (and `--batch`'s buckets) on a mesh of N ranks
(parallel/sharding.py): launch it with `torchrun --nproc-per-node N -m
pyfasst_tpu_torch separate ...`. Each rank joins the process group
torchrun describes (NCCL on the card, gloo with `--device cpu`); only
rank 0 writes files (WAVs, checkpoints) and prints the report. Without a
launcher, N > 1 exits with code 2 and says how to launch; so does N > 1
with a mode that shards nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _add_common(p):
    p.add_argument("audio", help="input WAV (stereo for spatial models)")
    p.add_argument("-o", "--out", default="separated",
                   help="output directory for the separated WAVs")
    p.add_argument("--wlen", type=int, default=1024,
                   help="STFT window length (samples)")
    p.add_argument("--iters", type=int, default=200, help="GEM iterations")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the models and tensors live: the card "
                        "(default; exits with code 2 without one) or the "
                        "CPU")


# The JAX package's measured operating points (pyfasst_tpu/__main__.py
# _PRESETS, a copy: tools/speech_sweep.py and tools/speech_lab.py's sweeps,
# docs/design.md §6e/§6g/§6j). Each preset overwrites the listed knobs
# wholesale -- vary knobs by hand instead of combining them with a preset.
_PRESETS = {
    # band-EM pool + learned votes + learned-judge selection, no reseeds
    # (JAX package, seeds 120-124: min SDR worst 6.84 / median 9.46 dB)
    "speech": dict(model="fullrank", spatial_init=True, reseed=0,
                   wlen=2048, multiscale_wlen=None, iters=400,
                   nmf_comps=6, band_em=32, select="learned",
                   learned=True),
    # the multiscale ladder: fine grid 2048 (learned votes and
    # selection), coarse model grid 8192 (JAX package, draws 100-104 of
    # the 3-stem 44.1 kHz fixture: worst/median/best 5.18/8.67/10.74 dB)
    "music": dict(model="fullrank", spatial_init=True, reseed=2,
                  wlen=8192, multiscale_wlen=2048, iters=400,
                  nmf_comps=6, band_em=None, select="learned",
                  learned=True),
    # the configs[2] recipe (JAX package, gate draws 102-106:
    # worst/median/best 10.42/11.33/12.92 dB)
    "reverb": dict(model="fullrank", spatial_init=True, reseed=2,
                   wlen=1024, multiscale_wlen=None, iters=400,
                   nmf_comps=6, band_em=None, select="learned",
                   learned=True),
}


def _apply_preset(args) -> None:
    if getattr(args, "preset", None):
        for k, v in _PRESETS[args.preset].items():
            setattr(args, k, v)


def _report(model, wall, **fields) -> None:
    """Print a separate run's JSON report (the JAX CLI's keys)."""
    print(json.dumps(dict(
        fields, wall_seconds=round(wall, 3),
        xrt=round(model.audio.duration / max(wall, 1e-9), 2))))


def _join_launcher_group(args) -> None:
    """With --n-devices > 1 under torchrun (WORLD_SIZE in the
    environment), join its process group: NCCL on this rank's card, gloo
    on the CPU. make_mesh then checks the group's size."""
    import os

    import torch
    import torch.distributed as dist

    if args.n_devices <= 1 or dist.is_initialized() \
            or "WORLD_SIZE" not in os.environ:
        return
    if args.device == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def _cmd_separate(args) -> int:
    """`separate`; with --trace-dir DIR the whole of it runs under a
    torch profiler (utils/logging.device_trace), which writes a Chrome
    trace of the port's spans (api.*, stft, gem.*, wiener, istft) above
    the kernels into DIR."""
    from pyfasst_tpu_torch.utils.logging import device_trace
    with device_trace(args.trace_dir):
        return _separate(args)


def _separate(args) -> int:
    from pyfasst_tpu_torch.audio import AudioObject, wav_info
    from pyfasst_tpu_torch.models.variants import (
        MultiChanHMM, MultiChanNMFConv, MultiChanNMFInst_FASST,
    )
    from pyfasst_tpu_torch.parallel.sharding import is_writer, make_mesh
    from pyfasst_tpu_torch.utils.device import resolve_device

    _apply_preset(args)
    if args.n_devices > 1 and not (args.batch or (
            args.model in ("conv", "fullrank") and args.spatial_init
            and not args.streaming
            and wav_info(args.audio)["channels"] > 1)):
        raise ValueError(
            f"--n-devices {args.n_devices} shards only --spatial-init's "
            "candidate pools (--model conv or fullrank, multichannel) and "
            "--batch's buckets; this mode runs on one device: drop "
            "--n-devices")
    device = resolve_device(args.device)
    make_mesh(args.n_devices, device=device)   # raises without a launcher
    writer = is_writer()
    if args.batch:
        return _cmd_separate_batch(args)
    if args.streaming:
        return _cmd_separate_streaming(args)

    kw = dict(wlen=args.wlen, iter_num=args.iters, seed=args.seed,
              annealing=args.annealing, verbose=0 if args.quiet else 1,
              device=device)
    if args.transform != "stft":
        fs = wav_info(args.audio)["samplerate"]
        if args.transform == "minqt":
            from pyfasst_tpu_torch.tf.minqt import MinQTransfo
            kw["transform"] = MinQTransfo(fs=fs, wlen=args.wlen * 4,
                                          n_bins=args.tf_bands,
                                          device=device)
        else:
            from pyfasst_tpu_torch.tf.erblet import ERBLetTransform
            kw["transform"] = ERBLetTransform(
                fs=fs, n_bands=args.tf_bands,
                scale="log" if args.transform == "cqlet" else "erb",
                device=device)
    basis = None if args.freq_basis == "none" else args.freq_basis
    if args.spatial_init and wav_info(args.audio)["channels"] == 1:
        # mono: no spatial cues to cluster on -- blind estimation is the
        # mixture-NMF + envelope-clustering spectral init (models/mono.py)
        model = MultiChanNMFInst_FASST(
            args.audio, nbComps=args.sources, nbNMFComps=args.nmf_comps,
            freq_basis=basis, n_bands=args.bands, **kw)
        t0 = time.perf_counter()
        logliks = model.estim_param_blind_mono(seed=args.seed)
        paths = model.separate_spat_comps(args.out) if writer else []
        _report(model, time.perf_counter() - t0, files=paths,
                iterations=int(args.iters), init="mono-nmf-cluster",
                final_loglik=float(logliks[-1]))
        return 0
    if args.model == "inst":
        model = MultiChanNMFInst_FASST(
            args.audio, nbComps=args.sources, nbNMFComps=args.nmf_comps,
            freq_basis=basis, n_bands=args.bands, **kw)
    elif args.model in ("conv", "fullrank"):
        init_mixing = None
        profiles = None
        rank = 2 if args.model == "fullrank" else 1
        if args.spatial_init and args.reseed >= 0:
            if args.transform != "stft" and args.multiscale_wlen:
                # the flat pipeline runs on the model's own plane (any
                # front-end); only the ladder builds its own STFT grids
                raise ValueError("--multiscale-wlen requires the STFT "
                                 "front-end (the ladder re-analyzes on "
                                 "its own fine/coarse STFT grids)")
            model = MultiChanNMFConv(
                args.audio, nbComps=args.sources,
                nbNMFComps=args.nmf_comps, spatial_rank=rank,
                freq_basis=basis, n_bands=args.bands, **kw)
            t0 = time.perf_counter()
            info = model.estim_param_blind_reverb(
                reseed_rounds=args.reseed, verbose=not args.quiet,
                multiscale_wlen=args.multiscale_wlen,
                n_devices=args.n_devices, band_em=args.band_em,
                noalign=args.noalign, select=args.select,
                reseed_select=args.reseed_select, learned=args.learned)
            paths = model.separate_spat_comps(args.out) if writer else []
            _report(model, time.perf_counter() - t0, files=paths,
                    iterations=int(args.iters), picked=info["picked"],
                    stages=[h["picked"] for h in info["history"]],
                    final_loglik=float(info["final_ll"]))
            return 0
        if args.spatial_init:
            # consensus spatial-clustering full-rank init (the blind
            # reverberant recipe; see models/spatial_init.py)
            import numpy as np

            from pyfasst_tpu_torch.models.spatial_init import full_rank_init
            from pyfasst_tpu_torch.tf.stft import STFT
            obj = AudioObject(args.audio)
            tft = kw.get("transform") or STFT(
                wlen=args.wlen, fs=obj.samplerate, device=device)
            Xh = tft.computeTransform(
                obj.data.astype(np.float32)).cpu().numpy()
            init_mixing, tw_prof, fb_prof = full_rank_init(
                Xh, J=args.sources, rank=rank, n_devices=args.n_devices,
                device=device)
            profiles = (tw_prof, fb_prof)
            kw["spatial_hold_frac"] = 0.3
            if not args.quiet:
                print(f"spatial-cluster init: {args.sources} sources, "
                      f"rank {rank}")
        elif args.demix:
            from pyfasst_tpu_torch.models.demix import DEMIX
            dm = DEMIX(args.audio, wlen=args.wlen)
            dm.comp_parameters(K=args.sources)
            init_mixing = dm.mixing(args.wlen // 2 + 1)   # (K, F, 2, 1)
            if not args.quiet:
                print(f"DEMIX init: {init_mixing.shape[0]} directions")
        model = MultiChanNMFConv(
            args.audio, nbComps=args.sources, nbNMFComps=args.nmf_comps,
            spatial_rank=rank, init_mixing=init_mixing, freq_basis=basis,
            n_bands=args.bands, **kw)
        if profiles is not None:
            from pyfasst_tpu_torch.models.spatial_init import apply_profiles
            model.params = apply_profiles(model.params, *profiles)
    else:  # hmm / gsmm
        model = MultiChanHMM(
            args.audio, nbComps=args.sources, nbStates=args.states,
            sparsity="HMM" if args.model == "hmm" else "GMM",
            decode=args.decode, **kw)

    start_iter = 0
    if args.resume:
        start_iter = model.load_checkpoint(args.resume)
        if not args.quiet:
            print(f"resumed from {args.resume} at iteration {start_iter}")
    t0 = time.perf_counter()
    # on a mesh every rank runs this fit; rank 0 alone saves checkpoints
    logliks = model.estim_param_a_posteriori(
        start_iter=start_iter,
        checkpoint_path=args.checkpoint if writer else None,
        checkpoint_every=args.checkpoint_every if writer else None)
    paths = model.separate_spat_comps(args.out) if writer else []
    # a resume from a finished checkpoint runs zero iterations: no loglik
    # was computed this run, so none is reported
    _report(model, time.perf_counter() - t0, files=paths,
            iterations=int(args.iters),
            final_loglik=(float(logliks[-1]) if start_iter < args.iters
                          else None))
    return 0


def _cmd_separate_batch(args) -> int:
    """`separate --batch dir/`: bucketed multi-clip separation
    (BASELINE.json configs[4]) over every WAV in the directory."""
    import glob
    import os

    from pyfasst_tpu_torch.parallel.batch import batch_separate_files
    from pyfasst_tpu_torch.parallel.sharding import make_mesh

    if args.model != "inst":
        raise ValueError("--batch currently supports the inst model only")
    if args.transform != "stft":
        raise ValueError("--batch currently supports the STFT front-end "
                         "only (the bucketing is frame-count based)")
    if not os.path.isdir(args.audio):
        raise ValueError(f"--batch expects a directory of WAVs, got "
                         f"{args.audio!r}")
    paths = sorted(glob.glob(os.path.join(args.audio, "*.wav")))
    if not paths:
        raise ValueError(f"no .wav files in {args.audio!r}")
    basis = None if args.freq_basis == "none" else args.freq_basis
    t0 = time.perf_counter()
    report = batch_separate_files(
        paths, args.out, nbComps=args.sources, nbNMFComps=args.nmf_comps,
        wlen=args.wlen, iters=args.iters, freq_basis=basis,
        n_bands=args.bands, seed=args.seed,
        mesh=make_mesh(args.n_devices, device=args.device))
    print(json.dumps({"clips": len(paths), "iterations": int(args.iters),
                      "wall_seconds": round(time.perf_counter() - t0, 3),
                      "results": report}))
    return 0


def _cmd_separate_streaming(args) -> int:
    """`separate --streaming`: bounded-memory two-pass online separation
    of a long recording (device memory stays O(F x --block-frames)
    whatever the length)."""
    from pyfasst_tpu_torch.models.streaming import separate_streaming

    if args.transform != "stft":
        raise ValueError("--streaming supports the STFT front-end only")
    if args.model not in ("inst", "fullrank"):
        raise ValueError("--streaming learns rank-1 convolutive mixing "
                         "(--model inst, the default) or a full-rank "
                         "spatial covariance per source (--model "
                         "fullrank, Duong online EM)")
    t0 = time.perf_counter()
    ys, info = separate_streaming(
        args.audio, J=args.sources, K=args.nmf_comps, wlen=args.wlen,
        frames_per_block=args.block_frames, seed=args.seed,
        out_dir=args.out, checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every or 0,
        estimate_blocks=args.estimate_blocks,
        spatial_rank=-1 if args.model == "fullrank" else 1,
        init="blind" if args.spatial_init else "random",
        verbose=0 if args.quiet else 1, device=args.device)
    wall = time.perf_counter() - t0
    dur = info["nsamples"] / info["fs"]
    print(json.dumps({
        "files": info["files"], "blocks": info["blocks"],
        "block_frames": info["block_frames"],
        "final_loglik": round(info["logliks"][-1], 2),
        "wall_seconds": round(wall, 3),
        "xrt": round(dur / max(wall, 1e-9), 2),
    }))
    return 0


def _cmd_lead(args) -> int:
    from pyfasst_tpu_torch.models.lead import SeparateLeadStereoTF

    sep = SeparateLeadStereoTF(args.audio, wlen=args.wlen, niter=args.iters,
                               n_f0=args.n_f0, device=args.device)
    sep.runDecomposition()
    p_lead, p_acc = sep.writeSeparatedSignals(args.out)
    print(json.dumps({"files": [p_lead, p_acc],
                      "melody_frames": int(sep.melody.shape[0])}))
    return 0


def _cmd_demix(args) -> int:
    from pyfasst_tpu_torch.models.demix import DEMIX

    dm = DEMIX(args.audio, wlen=args.wlen)
    gains, delays = dm.comp_parameters(K=args.sources)
    print(json.dumps({
        "sources": int(len(gains)),
        "gains": [round(float(g), 4) for g in gains],
        "delays_samples": [round(float(d), 4) for d in delays],
    }))
    return 0


def _cmd_eval(args) -> int:
    import numpy as np

    from pyfasst_tpu_torch.audio import wavread
    from pyfasst_tpu_torch.utils.metrics import bss_eval_sources

    def load_mono(paths):
        sigs, sr0 = [], None
        for p in paths:
            data, sr = wavread(p)
            if sr0 is None:
                sr0 = sr
            elif sr != sr0:
                raise ValueError(f"sample-rate mismatch: {p} has {sr}, "
                                 f"expected {sr0}")
            sigs.append(data.mean(axis=1))       # downmix to mono
        T = min(len(s) for s in sigs)
        return np.stack([s[:T] for s in sigs]), sr0

    est, sr_e = load_mono(args.estimates)
    ref, sr_r = load_mono(args.references)
    if sr_e != sr_r:
        raise ValueError(f"estimate/reference sample rates differ "
                         f"({sr_e} vs {sr_r})")
    if est.shape[0] != ref.shape[0]:
        raise ValueError(f"{est.shape[0]} estimates vs {ref.shape[0]} "
                         "references")
    T = min(est.shape[1], ref.shape[1])
    res = bss_eval_sources(est[:, :T], ref[:, :T],
                           filt_len=args.filt_len)
    print(json.dumps({
        "sdr_db": [round(float(x), 2) for x in res["sdr"]],
        "sir_db": [round(float(x), 2) for x in res["sir"]],
        "sar_db": [round(float(x), 2) for x in res["sar"]],
        "permutation": [int(p) for p in res["perm"]],
    }))
    return 0


def _cmd_info(args) -> int:
    # the header's five fields, as the JAX package's native codec gives
    from pyfasst_tpu_torch.audio import wav_info
    print(json.dumps(wav_info(args.audio)))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="pyfasst_tpu_torch",
        description="FASST audio source separation on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("separate", help="blind source separation")
    _add_common(p)
    p.add_argument("--preset", default=None,
                   choices=("speech", "reverb", "music"),
                   help="measured operating point: overwrites model/wlen/"
                        "iters/init knobs wholesale (see _PRESETS). "
                        "'speech': learned-vote blind pipeline with the "
                        "band-EM pool (3 reverberant speakers, 2 mics); "
                        "'reverb': the configs[2] blind reverberant "
                        "recipe; 'music': multiscale ladder + learned "
                        "votes")
    p.add_argument("--model", default="inst",
                   choices=("inst", "conv", "fullrank", "hmm", "gsmm"),
                   help="spatial/spectral model family")
    p.add_argument("--sources", type=int, default=2,
                   help="number of sources J")
    p.add_argument("--nmf-comps", type=int, default=8,
                   help="NMF components per source")
    p.add_argument("--states", type=int, default=8,
                   help="discrete states (hmm/gsmm)")
    p.add_argument("--decode", choices=("soft", "viterbi"), default="soft",
                   help="HMM state decode: forward-backward posteriors or "
                        "hard Viterbi MAP path")
    p.add_argument("--annealing", default="ann",
                   choices=("ann", "no_ann", "ann_ns_inj"))
    p.add_argument("--freq-basis", default="none",
                   choices=("none", "erb", "mel"),
                   help="fixed log-frequency spectral basis")
    p.add_argument("--transform", default="stft",
                   choices=("stft", "erblet", "cqlet", "minqt"),
                   help="analysis/synthesis front-end: linear-frequency "
                        "STFT, the perfect-reconstruction ERB / constant-Q "
                        "subband transforms, or the Min-Q log-frequency "
                        "transform (separation runs directly in the warped "
                        "domain)")
    p.add_argument("--tf-bands", type=int, default=64,
                   help="subbands for --transform erblet/cqlet")
    p.add_argument("--bands", type=int, default=40,
                   help="bands for --freq-basis")
    p.add_argument("--demix", action="store_true",
                   help="initialize conv mixing from DEMIX directions")
    p.add_argument("--spatial-init", dest="spatial_init",
                   action="store_true",
                   help="blind consensus spatial-clustering init for "
                        "reverberant conv/fullrank models (overrides "
                        "--demix; holds the mixing for the first 30%% of "
                        "iterations)")
    p.add_argument("--reseed", type=int, default=-1, metavar="N",
                   help="with --spatial-init on conv/fullrank: run the "
                        "full blind reverberant pipeline (candidate pool "
                        "at full convergence, selection, N rounds of EM "
                        "posterior reseeding; N=0 runs pool+selection "
                        "with no reseeds) instead of a single init+fit; "
                        "any front-end, any channel count")
    p.add_argument("--n-devices", dest="n_devices", type=int, default=1,
                   metavar="N",
                   help="shard the --spatial-init candidate pool (and "
                        "--batch's buckets) over N devices: launch with "
                        "`torchrun --nproc-per-node N -m pyfasst_tpu_torch "
                        "separate ...`; without a launcher, or in a mode "
                        "that shards nothing, N > 1 exits with code 2")
    p.add_argument("--band-em", dest="band_em", type=int, default=None,
                   metavar="W",
                   help="with --spatial-init --reseed: add the band-local"
                        "-EM vote candidates to the pool (band width W "
                        "bins, e.g. 32)")
    p.add_argument("--noalign", action="store_true",
                   help="with --spatial-init --reseed: add the alignment-"
                        "free consensus candidate")
    p.add_argument("--learned", action="store_true",
                   help="with --spatial-init --reseed: add the LEARNED "
                        "per-bin vote candidate to the pool (models/"
                        "binfeat; pyfasst_tpu_torch/data/binfeat.npz)")
    p.add_argument("--select", default=None,
                   choices=("envcorr", "consistency", "learned"),
                   help="with --spatial-init --reseed: within-tier pool "
                        "selection rule. Default auto: 'consistency' on "
                        "the flat pipeline when --band-em is set, else "
                        "'envcorr'")
    p.add_argument("--reseed-select", dest="reseed_select", default=None,
                   choices=("envcorr", "learned"),
                   help="with --select consistency: guard RESEED "
                        "acceptance by this key instead of consistency")
    p.add_argument("--multiscale-wlen", dest="multiscale_wlen", type=int,
                   default=None, metavar="W",
                   help="with --spatial-init --reseed: run the blind "
                        "pipeline on a finer STFT grid of window W first, "
                        "then re-seed the model's own grid from its "
                        "separation (the multiscale ladder; W must be < "
                        "--wlen)")
    p.add_argument("--streaming", action="store_true",
                   help="bounded-memory two-pass online separation for "
                        "long recordings: blocks are paged off disk, "
                        "learned with exponential forgetting, separated "
                        "and synthesized block by block (any channel "
                        "count; --model inst = rank-1 mixing, --model "
                        "fullrank = full-rank spatial covariances via "
                        "online Duong EM)")
    p.add_argument("--block-frames", type=int, default=64,
                   help="frames per streamed block (with --streaming)")
    p.add_argument("--estimate-blocks", type=int, default=None,
                   help="with --streaming: learn parameters from the "
                        "first N blocks only, then separate the whole "
                        "recording")
    p.add_argument("--batch", action="store_true",
                   help="treat AUDIO as a directory of WAVs and separate "
                        "them as one bucketed batch (inst model)")
    p.add_argument("--checkpoint", default=None,
                   help="write final parameters to this .npz (the JAX "
                        "package's layout: either CLI resumes the other's)")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint written by --checkpoint "
                        "(exact when run with the same --iters)")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="with --checkpoint: persist every K iterations and "
                        "roll back to the last checkpoint on divergence")
    p.add_argument("--trace-dir", dest="trace_dir", default=None,
                   metavar="DIR",
                   help="run under torch.profiler and write a Chrome trace "
                        "of the stages' spans and the kernels into DIR "
                        "(large: try it with --iters 20)")
    p.set_defaults(fn=_cmd_separate)

    p = sub.add_parser("lead", help="lead/accompaniment separation (SIMM)")
    _add_common(p)
    p.add_argument("--n-f0", type=int, default=120,
                   help="F0 grid size for the lead source")
    p.set_defaults(fn=_cmd_lead, wlen=2048, iters=50)

    p = sub.add_parser("demix", help="estimate mixing directions / count")
    p.add_argument("audio")
    p.add_argument("--wlen", type=int, default=1024)
    p.add_argument("--sources", type=int, default=None,
                   help="fix the source count (default: estimate)")
    p.set_defaults(fn=_cmd_demix)

    p = sub.add_parser("eval", help="BSS-Eval estimated stems vs references")
    p.add_argument("-e", "--estimates", nargs="+", required=True,
                   help="estimated source WAVs (order-free: the best "
                        "permutation is scored)")
    p.add_argument("-r", "--references", nargs="+", required=True,
                   help="ground-truth source WAVs")
    p.add_argument("--filt-len", type=int, default=512,
                   help="allowed-distortion filter taps (512 = the BSS-Eval "
                        "literature operating point)")
    p.set_defaults(fn=_cmd_eval)

    p = sub.add_parser("info", help="inspect a WAV file")
    p.add_argument("audio")
    p.set_defaults(fn=_cmd_info)
    return ap


def main(argv=None) -> int:
    import contextlib
    import io

    import torch.distributed as dist

    from pyfasst_tpu_torch.parallel.sharding import is_writer

    args = build_parser().parse_args(argv)
    joined = dist.is_initialized()
    try:
        if getattr(args, "n_devices", 1) > 1:
            _join_launcher_group(args)
        # on a mesh only rank 0 prints its report
        with (contextlib.nullcontext() if is_writer()
              else contextlib.redirect_stdout(io.StringIO())):
            return args.fn(args)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
