#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (each prints one line with its numbers and seconds):
  0. the machine: nvidia-smi name and power limit, torch, CUDA and nvcc;
  1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel,
     sm_90a), with ptxas' register and spill report, and the resident warps
     per SM, registers and local bytes of every instantiation of the
     general E-step kernel, of fb_stats, of tw_stats and of estep_r1_real,
     as the runtime reports them;
  2. each kernel against its plain PyTorch version on the card, with
     CUDA-event timings of kernel and plain version in turns (the kernel's
     by CUDA-graph replay: device time), each kernel's bound from its
     bytes and operations: the E-step variants a
     (real rank-1 mixing: at R1_SHAPES, J=2 and 3, across its 32-frame
     tiles, with each flag, xi bit for bit and two runs bit for bit),
     b (complex mixing, J=3), c (rank 2, J=4, and
     mixed ranks), d (ann_ns_inj, rank 1 and rank 2) at the bench shapes
     (B=8, F=513, N=863), at the conv paths' own shapes (B=1, F=513, the
     N of phases 5 and 6; the buckets of phases 9 and 10, B=8 for c and
     B=4 for b at 256 frames; phase 16's pool chunk, B=24 for c at 189
     frames, also two runs bit for bit; all timed too) and two ragged
     ones; e (fast_recip) and f (no_ll) in variant a's kernel and in
     the general one, at the bench shapes and a ragged one; the spectral
     kernels fb_stats and tw_stats at the bench shapes (J=2, K=8), the
     JAX suite's (37, 95), (130, 300) and J=3, K=4 (70, 211), and across
     their tiles, strips, batches and chunks with K=16 and 32
     (SPECTRAL_SHAPES), two runs bit for bit; variant a at
     phase 13's shape (1, 48, 98304), timed; variant b at J=2 and
     phase 15's block shape (1, 513, 64), two runs bit for bit, timed;
     and every shape phase 17 launches (cli_shapes: 1c at J=3, ranks
     (2, 2, 2), at the speech pool's (24, 1025, 158) and its band
     probes' (66, 32, 158), at the music ladder's fine (24 and 2, 1025,
     260) and coarse (6 and 2, 4097, 66) stages; 1a at the inst and
     batch commands' shapes; 1b at the stream block), two runs bit for
     bit, timed with the bound; the general kernel at J = 5 to 8
     (WIDE_CASES: real rank 1 and complex rank 2 at each J, mixed ranks
     and ns_inj at J = 5) at the bench shapes, two runs bit for bit,
     timed, and at a ragged one, and at phase 19's path shapes; fb_stats
     and tw_stats at K = 40 and 64 (their tiled form past 32: V once per
     tile over all K) at the bench shapes and at the host API's B = 1
     (a split contracted axis), timed with the floor without FMA, and at
     ragged shapes across its blocks, tiles, register budget, chunks
     and splits;
  3. the host API: MultiChanNMFInst_FASST on a 10 s stereo WAV, 500 GEM
     iterations, WAVs written; the kernel must carry every E-step and the
     separation must reach 60 dB SDR;
  4. the bench pipeline (STFT, 500 GEM iterations, Wiener, ISTFT) over 8
     clips at once, with the same SDR gate, and CUDA-event timings of one
     E-step (kernel and plain) and of the whole pipeline at B=1 and B=8;
  5. BASELINE configs[1]: MultiChanNMFConv (3 sources, rank 1, ERB basis,
     DEMIX init) on a 6 s anechoic mixture, 400 iterations, WAVs written;
     400 launches of variant b, and the min SDR must reach 10 dB and lie
     within 1 dB of the port's CPU run of the same recipe; then a
     torch.profiler window of 20 iterations (as phase 8's), here and in
     phase 6;
  6. the configs[2] model: MultiChanNMFConv (4 sources, full rank 2) on a
     6 s reverberant mixture, started from the true images' principal
     directions, 400 iterations; 400 launches of variant c, min SDR at
     least 5 dB and within 1 dB of the CPU run;
  7. phase 5's model under 'ann_ns_inj' annealing, 100 iterations: 100
     launches of variant d, finite loglik;
  8. the bench pipeline of phase 4 (B=8, 500 iterations) with the fused
     spectral M-step, then with it and fast_recip (the configurations
     tools/fuse_batch_probe.py sweeps): 500 launches each of fb_stats and
     tw_stats, 500 E-step launches (500 of variant e with fast_recip), the
     60 dB gate; pipeline time and xRT beside phase 4's unfused figure, and
     a torch.profiler window of 20 iterations with fusion off and on (wall
     and host-enqueue ms, device busy ms and kernels per iteration);
  3b. (run inside phase 3) resume on the card: a new host-API model cut
     off after its checkpoint at iteration 250 (one every 125), a second
     one loading it and resuming: logliks and every parameter leaf equal
     phase 3's uninterrupted run bit for bit, 500 E-step launches over the
     two legs;
  9. the configs[2] model at B=8: batch_separate over the reverberant
     recipe at seeds 102-109, each clip from its own principal-direction
     init, N = 189 padded to 256 frames in one bucket: 400 launches of
     variant c, each B = 8 wide; every clip within 1 dB of its own B = 1
     run of the same init on the same padded frames, and >= 5 dB where
     its unpadded B = 1 host-API run reaches 5 dB (that run's SDR, the
     padding's cost, is printed beside); a profiler window at B=8;
  10. configs[1] at B=4 in the same way (anechoic recipe, DEMIX init, seeds
     101-104; cut from 8 clips for time, see CONV_BATCH_SEEDS): 400 launches
     of variant b, each B = 4 wide, the same comparisons, 10 dB;
  11. the general-I engine on the card: bench.py's general-I3 row (10 s,
     3 channels, 500 iterations) through run_gem and separate_sources, and
     the mono fixture of tests/test_multichannel.py (200 iterations): no
     kernel launch, finite loglik, the I3 images summing to the mixture,
     min SDR within 1 dB of the port's CPU runs; a profiler window of the
     I3 loop;
  12. the bench pipeline (B = 8, 500 iterations) at K = 40 and 64 with
     fuse_spectral: 500 launches each of fb_stats and tw_stats (their tiled
     form), every clip over 60 dB, logliks within 2e-4 of the unfused run
     at the same K over the first 50 iterations and K_BIG_DRIFT_RTOL over
     the run (the unfused run in two halves printed beside, the witness of
     float32 drift); a profiler window of 20 iterations of the unfused and
     the fused run at K = 64;
  13. erblet48 (bench.py:187-220's row): the bench mixture through
     MultiChanNMFInst_FASST over ERBLetTransform(fs=44100, n_bands=48),
     J = 2, K = 8, 200 iterations unfused: 200 launches of variant a at
     F = 48, N = 98304 (phase 2 checks and times the kernel at that shape:
     48 long rows, one block each), min SDR within 1 dB of the port's CPU
     run, a profiler window, xRT; then 30 iterations over MinQTransfo on 2 s
     of the mixture (a check of the path: launches, finite images);
  14. BASELINE configs[3] (tools/validate_hw.py:554-600, seed 103): the
     6-state HMM (wlen 1024, 300 iterations), the co-located state-switch
     row (2-state Viterbi HMM beside the equal-K NMF, wlen 512, 300 each),
     multiChanSourceF0Filter (100 iterations) and SeparateLeadStereoTF
     (40 per pass) on tests/test_lead.py's 3 s vibrato mixture: one
     variant-a launch per GEM iteration (none in the lead pipeline), every
     min SDR within 1 dB of the port's CPU run (the Viterbi row: at least
     20 dB and 20 dB above the equal-K NMF, see CPU_SDR_SLICE), a
     profiler window of the HMM (kernels per iteration: the
     forward-backward recursion's);
  15. the long-form rows of tools/validate_hw.py (16 kHz, wlen 1024, 64
     frames per block, J = 2, K = 8, 6 inner iterations) on the card: the
     120 s stereo
     stream through the host-driven online_block loop (two passes) and
     through separate_streaming(init="blind") (DEMIX on its first 12 s),
     variant b launched 7 times per block step of each; an
     estimate_blocks cut of the stream resumed from its checkpoint, equal
     to the uninterrupted run bit for bit; the 60 s diffuse stream with
     spatial_rank=-1 (no E-step launch) and its rank-1 twin; and the
     blind mono row (estim_param_blind_mono, 300 iterations, no launch):
     every min SDR within 1 dB of the port's CPU run of the same recipe
     (CPU_SDR_STREAM, cpu_reference_stream()); the streams' xRT, a
     profiler window of 10 block steps and the bounded path's peak
     device memory beside the full plane's bytes;
  16. BASELINE configs[2] blind (tools/validate_hw.py:374-410, the CLI's
     --preset reverb point): phase 6's mixture through MultiChanNMFConv(
     nbComps=4, nbNMFComps=6, spatial_rank=2, iter_num=400).
     estim_param_blind_reverb(learned=True, select="learned"), WAVs
     written: the candidate pool in chunks of 24 runs, em_seeds 2, two
     reseed rounds; variant c launched 400 times per pool chunk (24 wide)
     and per reseed stage (2 wide); min SDR at least 5 dB and within 1 dB
     of CPU_SDR_BLIND, the port's CPU run of the recipe from the card's
     pool pick onward (that candidate's two EM seeds and the reseed
     rounds; cpu_reference_blind_pick() measures it), the JAX package's
     TPU row beside; the wall seconds of each stage; a profiler window of
     20 iterations of the first pool chunk; then reduced-depth checks of
     three paths: _embed_nodes_device against the host eigh at F*J =
     3075, band_em=32 and multiscale_wlen=512 (50 iterations each:
     finite images, launches);
  17. the CLI, in this process through pyfasst_tpu_torch.__main__.main,
     its JSON reports captured: (a) `separate --preset speech --sources 3`
     at full width and depth on tools/speech_lab.py's SiSEC-regime speech
     fixture (10 s, 16 kHz, three speakers, T60 0.25 s; wlen 2048,
     band_em=32, learned votes and selection, no reseed, 400 iterations):
     variant c launched 400 times per pool chunk and 150 times by the
     band probes, the WAVs it writes scored against the true images: min
     SDR within 1 dB of CPU_SDR_SPEECH (the port's CPU run from the
     card's pool pick, cpu_reference_speech()), the picks, wall, xRT and
     a profile of the first pool chunk beside the JAX package's TPU row,
     and at least 5 dB; then fixture seeds 121-124 through the same
     command: the median min SDR of the five draws at least 5 dB, beside
     the JAX package's five;
     (b) `--preset music --sources 3` on
     tools/validate_hw.py's 3-stem music row cut from 20 s to 6 s (fine
     grid 2048, coarse 8192 kept): finite images, launches on both grids
     as the stages ask, SDR printed; (c) `separate` (inst, with a
     checkpoint, then its --resume: zero iterations), `--streaming`,
     `--batch`, `lead`, `demix`, `eval` (on (a)'s WAVs: (a)'s
     permutation) and `info` (also as `python -m pyfasst_tpu_torch` in a
     subprocess), each exiting 0 with a JSON report and launching the
     kernels it should; every kernel call of the phase at a shape phase
     2 checked;
  18. the sharded path (parallel/sharding.py): (a) a process group of one
     rank on NCCL in this process: phase 9's bucket through
     batch_separate(mesh=make_mesh(1)) and one chunk of phase 16's pool
     (24 runs at J = 4, F = 513, N = 189, 50 iterations) equal the
     unsharded runs bit for bit; (b) two gloo ranks on cuda:0, spawned by
     parallel/dryrun.py: the bench path (B = 8, 500 iterations) at fp = 2,
     unfused and fused, logliks against phases 4 and 8 (rtol 2e-4 over
     the first 5 iterations, 1e-3 of each clip's scale over the run) and
     rank 0's images over 60 dB, and phase 9's bucket at dp = 2 at the
     same loglik bars, every clip within 1 dB of phase 9's; each rank's
     launches counted and printed (phase 2 checks variant a and the
     spectral kernels at the 257- and 256-row slices and variant c at the
     half bucket); (c) the same two ranks on phase 14's recipes at reduced
     depth (50 iterations): configs[3]'s 6-state HMM, its Viterbi row and
     the source-filter model, each at fp = 2 and sp = 2, logliks within
     rtol 2e-4 of the unsharded run on the card (the unsharded run of the
     clip twice, B = 2, printed beside as the witness of float32 drift),
     one E-step launch per iteration per rank;
  19. five sources at full width: (a) a 10 s, 44.1 kHz stereo mix of five
     sources panned apart (five_mixture) through the CLI, `separate
     mix.wav --sources 5 --iters 500` (F = 513, N = 863): 500 launches of
     the general kernel at J = 5 (real rank 1), WAVs written and scored;
     (b) configs[2]'s recipe with a fifth source (16 kHz, 6 s, wlen 1024:
     F = 513, N = 189; rank 2, principal-direction init, 400 iterations):
     400 launches of variant c at J = 5; each min SDR within 1 dB of the
     port's CPU run (CPU_SDR_FIVE, cpu_reference_five()).

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
# phase 12: the bench pipeline at NMF ranks past 32 (the spectral kernels'
# tiled form, csrc/spectral.cu), with fuse_spectral, against the unfused
# run at the same K
K_BIG = (40, 64)
# phase 12's bar over the whole run. Float32 EM carries the kernels'
# order of summation through the run as it carries any other: the first
# card run of the phase (NVIDIA H100 80GB HBM3, 700.00 W) read the fused
# runs 2.19e-3 (K = 40) and 4.06e-4 (K = 64) from the unfused ones over
# 500 iterations, and the witnesses, the unfused runs in two halves of
# four clips, 2.87e-3 and 5.80e-4: 1.5 times the largest, as phase 18's
# MESH_DRIFT_RTOL was set. Over the first MESH_EARLY_ITERS iterations the
# fused runs read 1.0e-6 and 3.6e-7, held at MESH_EARLY_RTOL
K_BIG_DRIFT_RTOL = 4.3e-3
REPLACES = "pyfasst_tpu/ops/pallas_estep.py:108"
KERNEL_SOURCE = "pyfasst_tpu_torch/csrc/estep.cu"
GENERAL_SOURCE = "pyfasst_tpu_torch/csrc/estep_general.cuh"
# BASELINE configs[1] and configs[2] (tools/validate_hw.py's anechoic and
# reverberant recipes, seeds 101 and 102)
FS_CONV = 16000
DUR_CONV = 6.0
WLEN_CONV = 1024
NITER_CONV = 400
NITER_NS = 100
SDR_FLOOR = {"anechoic": 10.0, "reverb": 5.0}
# min SDR (dB) of the port's own CPU run of phases 5 and 6, same mixture
# and seed (python3 -c "import chip_smoke; chip_smoke.cpu_reference()",
# measured on the 8-core host of an H100 machine; re-measured when the
# models' NMF draws became the JAX package's); the card's run must lie
# within SDR_SLACK of it
CONV_LL_TAIL = NITER_CONV // 50
CPU_SDR = {"anechoic": 14.75, "reverb": 13.86}
SDR_SLACK = 1.0
# Bars of tests/test_pallas_estep.py: xi 2e-4, frame-reduced statistics
# 5e-4 (its multi-tile case), loglik 1e-4.
TOL = {"xi": 2e-4, "txs": 5e-4, "tss": 5e-4, "t4": 5e-4, "t7": 5e-4,
       "loglik": 1e-4}
# the new variants: (key, label, J, ranks, real_cov, ns_inj); rank 2 holds
# xi at 3e-4 (test_pallas_estep.py's rank-2 bar)
GENERAL_CASES = (
    ("b", "complex J=3 rank 1", 3, (1, 1, 1), False, False),
    ("c", "complex J=4 rank 2", 4, (2, 2, 2, 2), False, False),
    ("c", "complex J=4 ranks (1,2,2,1)", 4, (1, 2, 2, 1), False, False),
    ("d", "ns_inj complex J=3 rank 1", 3, (1, 1, 1), False, True),
    ("d", "ns_inj complex J=4 rank 2", 4, (2, 2, 2, 2), False, True),
)
# the case whose numbers stand for each variant in the kernels line
GENERAL_HEADLINE = {"b": "complex J=3 rank 1", "c": "complex J=4 rank 2",
                    "d": "ns_inj complex J=3 rank 1"}
GENERAL_REPLACES = {
    "b": f"{REPLACES} (variant b: real_cov=False)",
    "c": f"{REPLACES} (variant c: ranks 2 and mixed, :283-303)",
    "d": f"{REPLACES} (variant d: ns_inj, :235-237 :252-255 :313-315 "
         ":332-337)",
    "e": f"{REPLACES} (variant e: fast_recip, _recip :114-124)",
    "f": f"{REPLACES} (variant f: no_ll, :239)"}
# variants e and f: (label, kernel, J, ranks, real_cov, ns_inj), the kernel
# "a" (estep_r1_real) or "general"; each at the bench shapes and a ragged one
EF_CASES = (("variant a", "a", 2, (1, 1), True, False),
            ("complex J=3 rank 1", "general", 3, (1, 1, 1), False, False),
            ("complex J=4 rank 2", "general", 4, (2, 2, 2, 2), False, False))
SPECTRAL_SOURCE = "pyfasst_tpu_torch/csrc/spectral.cu"
SPECTRAL_REPLACES = {
    "fb_stats": "pyfasst_tpu/ops/pallas_spectral.py:117 (fb_stats; body "
                "_make_fb_kernel :55)",
    "tw_stats": "pyfasst_tpu/ops/pallas_spectral.py:155 (tw_stats; body "
                "_make_tw_kernel :90)"}
# phase 18 cuts the bench path's F = 513 over fp = 2 ranks
# (ops/collectives.span: 257 rows and 256): variant a and the spectral
# kernels run at these slices, which phase 2 checks too
MESH_F = (257, 256)
# (B, J, F, N, K): the bench shapes, tests/test_pallas_spectral.py's, two
# that cross fb_stats' tiles of 8 rows and 128 frames, and the ones that
# cross tw_stats' strips of 16 frames (N = 1, 31, 33, 7), its batches of 128
# rows (F = 3 and 64 below one, 129 one past one) and its chunk of FB in
# shared memory (F = 530 at K = 32: two chunks), with K = 16 and 32; then
# phase 12's ranks past 32 (the tiled kernel) at the bench shapes and the
# host API's B = 1 (its contracted axis split), timed, and ragged ones:
# F, N off its 16-row blocks and 64-position tiles, K = 48 and 56 (the
# other register instantiations), 100 and 130 (chunks of 64 past the
# register budget), uneven splits (1056 x 300)
SPECTRAL_WIDE = tuple((b, J, 513, 863, k) for k in K_BIG
                      for b in (BATCH, 1))
SPECTRAL_SHAPES = ((BATCH, J, 513, 863, K), (2, 2, 37, 95, 5),
                   (2, 2, 130, 300, 5), (2, 3, 70, 211, 4),
                   (2, 2, 13, 31, 8), (1, 2, 513, 189, 8),
                   (1, 2, 3, 1, 8), (1, 2, 129, 33, 16), (2, 1, 64, 7, 32),
                   (1, 2, 530, 45, 32), (1, 2, 513, 863, 16)) + tuple(
                      (BATCH, J, f, 863, K) for f in MESH_F) \
    + SPECTRAL_WIDE + ((2, 2, 37, 95, 40), (1, 3, 130, 33, 64),
                       (1, 2, 70, 129, 48), (2, 1, 33, 200, 56),
                       (1, 2, 100, 300, 100), (1, 1, 65, 17, 130),
                       (1, 2, 1056, 300, 40))
# (B, J, F, N) of estep_r1_real's checks: the bench shape, two ragged ones,
# and the ones that cross its tiles of 32 frames (N = 1, 31, 33, and 7 below
# one tile), at J = 2 and 3; each of the small ones also with each flag
R1_SHAPES = ((BATCH, 2, 513, 863), (1, 2, 33, 70), (1, 2, 9, 2500),
             (2, 2, 5, 1), (1, 2, 13, 31), (2, 2, 13, 33), (1, 2, 3, 7),
             (1, 3, 13, 31), (2, 3, 9, 33), (1, 3, 17, 200))
R1_SHAPES += tuple((BATCH, 2, f, 863) for f in MESH_F)
# phase 13: bench.py:187-220's erblet48 row through the host API (the bench
# mixture, seed 0; ERBLetTransform(fs=44100, n_bands=48); J = 2, K = 8;
# bench.py::build_params' factors; 200 iterations, unfused); ERB_SHAPE
# (B, J, F, N) is estep_r1_real's shape there, checked and timed in phase
# 2: 48 long rows, one block each
NITER_ERB, BANDS_ERB = 200, 48
ERB_SHAPE = (1, 2, BANDS_ERB, 98304)
# its short MinQT check: the first 2 s of the bench mixture, 30 iterations
DUR_MINQT, NITER_MINQT = 2.0, 30
# phase 14: BASELINE configs[3], tools/validate_hw.py:554-600 (seed 103;
# 6 s at 16 kHz): a 6-state HMM at wlen 1024, then the co-located state-
# switch mixture with a 2-state Viterbi HMM and the equal-K NMF at wlen
# 512, 300 iterations each (the Viterbi HMM from the recipe's seed-0
# draw, the JAX package's jax.random numbers through utils/prng.py); and
# the source-filter model and the lead pipeline on tests/test_lead.py's
# 3 s vibrato mixture
SEED_HMM, NITER_HMM, NITER_SIMM, NITER_LEAD = 103, 300, 100, 40
# min SDR (dB) of the port's own CPU runs of phases 13 and 14 (python3 -c
# "import chip_smoke; chip_smoke.cpu_reference_slice()" on the host of an
# H100 machine: the HMM, Viterbi, NMF and source-filter rows with 8
# threads from the JAX package's draws; erblet48 and the lead pipeline,
# which draw nothing, with 5 threads); the card's runs must lie within
# SDR_SLACK of them, but for the Viterbi row: its hard state decisions
# turn the kernel's float32 rounding into a different path (from other
# factors the card's run once ended 1.70 dB from the CPU's). It is held
# to the recipe's purpose instead: HARD_FLOOR, and HARD_MARGIN above the
# equal-K NMF on the same mixture
CPU_SDR_SLICE = {"erblet48": 77.70, "hmm": 62.76, "hmm_hard": 25.20,
                 "nmf_hard": 0.01, "simm": 24.29, "lead": 7.11}
HARD_FLOOR, HARD_MARGIN = 20.0, 20.0
SPECTRAL_RTOL = 2e-5          # tests/test_pallas_spectral.py's bar
# an H100 SXM's published peaks (NVIDIA's data sheet; 700 W): device
# memory bandwidth and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the float32 rate open to kernels built with --fmad=false: each multiply
# and add issues on its own, so half the FMA rate above
FP32_NOFMA_OPS_PER_S = FP32_OPS_PER_S / 2
# phases 9 and 10: the configs[2] model at B = 8 and configs[1] at B = 4,
# one clip per seed, padded by batch_separate into one bucket of frames.
# configs[1] is cut from 8 clips to 4: its DEMIX init is ~10 s of host
# NumPy per clip, and with 8 clips the script ran 459 s on an H100
# machine's host, past the ~6 minutes the script aims at
CONV_BATCH_SEEDS = {"reverb": tuple(range(102, 110)),
                 "anechoic": tuple(range(101, 105))}
GRANULARITY = 128
# phase 11: bench.py:223-262's general-I3 row (two sources at these
# 3-channel directions, 10 s at 44.1 kHz, 500 iterations) and the mono
# fixture of tests/test_multichannel.py:71 (4 s at 16 kHz, 200 iterations)
GENERAL_DIRS = ((0.9, 0.5, 0.2), (0.2, 0.6, 0.95))
NITER_MONO = 200
# min SDR (dB) of the port's own CPU run of phase 11's two recipes
# (python3 -c "import chip_smoke; chip_smoke.cpu_reference_general()" on
# the host of an H100 machine: 80.18, from numpy-drawn factors, and 3.196,
# from the host API's seed-0 draw, the JAX package's); the card's runs
# must lie within SDR_SLACK of them
CPU_SDR_GENERAL = {"I3": 80.18, "mono": 3.20}
# phase 2's cases of the general kernel at J = 5 to 8 (csrc/estep_j5.cu ..
# estep_j8.cu): (key, label, J, ranks, real_cov, ns_inj, path); each at the
# bench shapes, timed and run twice bit for bit, and at one ragged shape;
# path names the phase-19 run whose shape is checked and timed too ("inst":
# `separate --sources 5` at (1, 513, 863); "reverb5": the five-source
# configs[2] model at (1, 513, 189)). Variant a's model (real rank 1, no
# ns_inj) counts as variant a in cuda_estep.VARIANT_LAUNCHES
WIDE_CASES = (
    ("a", "real J=5 rank 1", 5, (1,) * 5, True, False, "inst"),
    ("c", "complex J=5 rank 2", 5, (2,) * 5, False, False, "reverb5"),
    ("c", "complex J=5 ranks (1,2,2,1,2)", 5, (1, 2, 2, 1, 2), False, False,
     None),
    ("d", "ns_inj complex J=5 rank 1", 5, (1,) * 5, False, True, None),
    ("a", "real J=6 rank 1", 6, (1,) * 6, True, False, None),
    ("c", "complex J=6 rank 2", 6, (2,) * 6, False, False, None),
    ("a", "real J=7 rank 1", 7, (1,) * 7, True, False, None),
    ("c", "complex J=7 rank 2", 7, (2,) * 7, False, False, None),
    ("a", "real J=8 rank 1", 8, (1,) * 8, True, False, None),
    ("c", "complex J=8 rank 2", 8, (2,) * 8, False, False, None),
)
WIDE_RAGGED = (1, 33, 70)
# phase 19: five sources at full width. (a) a 10 s, 44.1 kHz stereo mix of
# five of band_sources' kinds panned apart at FIVE_PANS degrees
# (instantaneous, rank 1; five_mixture, seed SEED_FIVE) through the CLI,
# `separate mix.wav --sources 5 --iters 500` (wlen 1024: F = 513, N = 863):
# 500 launches of kernel 1 at J = 5; (b) reverb_mixture's recipe (seed 102)
# with a fifth source (tone_switch) at configs[2]'s widths (16 kHz, 6 s,
# wlen 1024: F = 513, N = 189; 100-tap rooms), rank 2, started from the
# true images' principal directions, 400 iterations: 400 launches of
# variant c at J = 5. Not cut
FIVE_KINDS = ("harm", "noise_lo", "noise_hi", "clicks", "tone_switch")
FIVE_PANS = (10.0, 28.0, 45.0, 62.0, 80.0)
SEED_FIVE = 130
# min SDR (dB) of the port's CPU run of each recipe (python3 -c "import
# chip_smoke; chip_smoke.cpu_reference_five()" on the 8-core host of an
# H100 machine: 14.2555 and 11.8711 dB, 191 s and 76 s); the card's runs
# must lie within SDR_SLACK of them
CPU_SDR_FIVE = {"inst": 14.26, "reverb5": 11.87}
# phase 15: the long-form rows of tools/validate_hw.py at 16 kHz, wlen 1024:
# scenario_streaming (:677-806, seed 112: 120 s of two panned dense-band
# noises; 64 frames per block, J = 2, K = 8, forgetting 0.95, 6 inner
# iterations; the host-driven online_block loop from the default init, and
# separate_streaming(init="blind") with its 12 s DEMIX prefix), its
# estimate_blocks cut and resume, scenario_streaming_fullrank (:809-865,
# seed 113: 60 s of diffuse rank-2 sources, spatial_rank=-1 and 1 on the
# same file) and the mono row of scenario_general_I (:626-640, seed 110:
# estim_param_blind_mono, K = 6, 300 iterations). Not cut. Each row's min
# SDR must lie within SDR_SLACK of the port's CPU run of the same recipe,
# made in the same phase
SEED_STREAM, SEED_STREAM_FR, SEED_MONO = 112, 113, 110
DUR_STREAM, DUR_STREAM_FR = 120.0, 60.0
NB_STREAM, K_STREAM, INNER_STREAM, FORGET_STREAM = 64, 8, 6, 0.95
# min SDR (dB) of the port's CPU run of each row (python3 -c "import
# chip_smoke; chip_smoke.cpu_reference_stream()" on the 8-core host of an
# H100 machine, ~97 s: 6.68, 37.77, 7.49, -0.94 and 10.65 dB); the card's
# rows must lie within SDR_SLACK of them
CPU_SDR_STREAM = {"stream": 6.68, "blind": 37.77, "fullrank": 7.49,
                  "fullrank_r1": -0.94, "mono": 10.65}
NOISE_STREAM = 1e-3                # the host loop's sigma: validate_hw's
STREAM_CUT, STREAM_CK_EVERY = 20, 10
NITER_BLIND_MONO = 300
# phase 16: BASELINE configs[2] blind, tools/validate_hw.py:374-410 at the
# CLI's --preset reverb point: phase 6's mixture (seed 102) through
# MultiChanNMFConv(nbComps=4, nbNMFComps=6, spatial_rank=2, iter_num=400,
# spatial_hold_frac=0.3).estim_param_blind_reverb(learned=True,
# select="learned") (em_seeds 2, reseed_rounds 2, chunks of 24 runs). Not
# cut. The pool runs variant c at (POOL_CHUNK, J = 4, F, N = 189), which
# phase 2 checks and times
POOL_CHUNK = 24
# The card's run is held against the port's CPU run of the same recipe
# from the card's pool pick onward: that candidate's EM seeds and the
# reseed rounds, under the same selection (cpu_reference_blind_pick(), one
# card run and 193.7 s of an H100 machine's 8 host cores: the same stages
# as the card, 10.676 dB against the card's 10.676; the JAX package's EM
# draws). The whole recipe on the CPU (cpu_reference_blind:
# 78 runs of 400 iterations at F = 513, N = 189) takes ~50-60 min of those
# cores, more than one chip call could hold beside the script
CPU_SDR_BLIND = 10.68
# the JAX package's row for the same recipe (docs/validation.md:9, taken on
# a TPU): a quality figure, printed beside the card's for reference
JAX_BLIND_MIN_SDR = 10.68
# the reduced-depth check of the alignment's device path: planted
# per-frequency permutations over F * J = 3075 nodes (a wlen-2048 grid,
# J = 3), above spatial_init's host-path cutoff of 2052
EMBED_CHECK = (1025, 3, 189)
# the reduced-depth checks of the band-EM candidate and the multiscale
# ladder on phase 16's mixture: pool iterations (cut from 100 to 50 when
# phase 18 came: with 100 the script ran 1069 s of its 1200 s on an H100
# machine whose host enqueued 7.6 ms per bench iteration against the
# usual ~3.5), and the band probes' iterations (spatial_init.band_em_votes'
# default)
NITER_LADDER = 50
BAND_PROBE_ITERS = 150
# variant b's shape on the streaming path: one block of one clip
STREAM_SHAPE = (1, 2, WLEN_CONV // 2 + 1, NB_STREAM)
# general E-step instantiations the paths take: (J, rmax, real_cov, ns_inj)
GENERAL_PATH_INSTANCES = {"b": (3, 1, 0, 0), "c": (4, 2, 0, 0),
                          "d": (3, 1, 0, 1), "b stream": (2, 1, 0, 0),
                          "c cli": (3, 2, 0, 0), "a five": (5, 1, 1, 0),
                          "c five": (5, 2, 0, 0)}
# phase 17: the CLI, in this process through pyfasst_tpu_torch.__main__.main.
# (a) `separate --preset speech --sources 3` at full width and depth on the
# SiSEC-regime speech fixture, tools/speech_lab.py::_fixture(3, 0.25, 120)
# (tools/validate_hw.py's speech row: 10 s at 16 kHz, stereo, three
# speakers, T60 0.25 s). Not cut. The preset: wlen 2048 (F = 1025), full
# rank 2, K = 6, band_em=32, no reseed, learned votes and selection, 400
# iterations; the pool runs variant c at (POOL_CHUNK, J = 3, F, N)
SPEECH = dict(n_spk=3, t60=0.25, seed=120, fs=16000, dur=10.0)
# min SDR of the port's CPU run of the recipe from the card's pool pick
# onward (cpu_reference_speech(): the picked candidate's EM seeds on the
# CPU; 9.4569 dB on the host of an H100 machine against the card's
# 9.4567); the card's run must lie within SDR_SLACK of it. The JAX
# package's row for the same fixture (docs/validation.md:21, taken on a
# TPU) is printed beside
CPU_SDR_SPEECH = 9.46
JAX_SPEECH_MIN_SDR = 9.46
# The preset's quality gates: seed 120's min SDR and the median over the
# fixture's five draws, seeds 120-124 (the draws docs/validation.md:37
# quotes for the JAX package: min SDR 9.46, 9.25, 6.84, 12.77, 11.38 on a
# TPU, median 9.46), each at least SPEECH_FLOOR. The EM seeds' spectral
# draws are the JAX package's own (utils/prng.py, bit for bit)
SPEECH_SEEDS = (120, 121, 122, 123, 124)
JAX_SPEECH_SEEDS_MIN_SDR = (9.46, 9.25, 6.84, 12.77, 11.38)
SPEECH_FLOOR = 5.0
# (b) `separate --preset music --sources 3` on the 3-stem row of
# tools/validate_hw.py::scenario_music (seed 105; bass, lead and drums;
# T60 0.12 s; 44.1 kHz), cut in depth only: the row's generator run for
# DUR of its 20 s. The preset's widths stay: fine grid 2048 (F = 1025),
# coarse grid 8192 (F = 4097), J = 3. Its SDR is printed, not gated (the
# JAX package's 20 s row, report-only there as here)
MUSIC = dict(seed=105, kinds=(0, 2, 3), t60=0.12, fs=44100, dur=6.0,
             pans=((0.9, 1.0), (-0.9, 1.0), (0.0, 1.0)))
JAX_MUSIC_MIN_SDR = 6.33
# (c) the other commands once each, at reduced depth: `separate` (inst)
# on phase 3's 10 s bench WAV with a checkpoint, then its resume;
# `--streaming` on the first DUR_CLI_STREAM s of it; `--batch` on a
# directory of clips of CLI_BATCH_DURS s (one bucket of 128 frames); `lead`
# and `demix` on phase 14's 3 s vibrato mixture; `eval` on (a)'s WAVs;
# `info`, also as `python -m pyfasst_tpu_torch` in a subprocess
NITER_CLI, NITER_CLI_LEAD = 50, 10
DUR_CLI_STREAM = 5.0
CLI_BATCH_DURS = (0.8, 1.0, 1.2, 1.4)


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


def bench_tree(F, N, seed=0, K_=K):
    """bench.py::build_params as a parameter tree for convert (NMF rank K_,
    K by default)."""
    from pyfasst_tpu_torch.models.components import init_inst_mixing
    rng = np.random.default_rng(seed)
    spat = [{"A": a.numpy(), "mix_type": "inst", "free": True}
            for a in init_inst_mixing(None, 2, 1, J)]
    spec = [{"FB": (0.5 + rng.random((F, K_))).astype(np.float32),
             "TW": (0.5 + rng.random((K_, N))).astype(np.float32),
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


def check_logliks(ll: np.ndarray, label: str, tail: int = 0) -> None:
    """Finite everywhere; the late iterations rise (monotone to within a
    small relative slack, as the verify recipe asks). The last `tail`
    iterations are left out of the rise: there the conv models' loglik
    falls as the annealed noise floor reaches its end value, in the JAX
    package as in the port (iterations 395-398 of 400 on configs[1])."""
    if not np.all(np.isfinite(ll)):
        raise RuntimeError(f"{label}: non-finite loglik")
    late = ll[..., ll.shape[-1] // 2:ll.shape[-1] - tail]
    worst = float(np.min(np.diff(late, axis=-1)))
    if worst < -1e-3 * float(np.max(np.abs(late))):
        raise RuntimeError(f"{label}: loglik falls late in the run "
                           f"(worst step {worst:.6g})")
    if np.any(late[..., -1] <= late[..., 0]):
        raise RuntimeError(f"{label}: loglik did not rise late in the run")


def band_sources(rng, n, kinds, fs=FS_CONV):
    """tools/validate_hw.py::_sources: spectrally distinct, amplitude-
    modulated (or state-switching) test sources, each scaled to unit
    standard deviation."""
    from scipy.signal import butter, lfilter
    t = np.arange(n) / fs
    out = []
    for kind in kinds:
        if kind == "harm":
            s = sum(np.sin(2 * np.pi * 220 * (k + 1) * t) / (k + 1)
                    for k in range(5)) * (1 + 0.4 * np.sin(2 * np.pi * 2 * t))
        elif kind.startswith("band:"):       # dense band-limited noise
            lo, hi = (float(x) for x in kind.split(":")[1].split("-"))
            b, a = butter(4, [lo, hi], btype="band")
            s = lfilter(b, a, rng.standard_normal(n))
        elif kind == "noise_lo":
            s = np.convolve(rng.standard_normal(n), np.ones(24) / 24,
                            "same") * (np.sin(2 * np.pi * 1.3 * t) > 0)
        elif kind == "noise_hi":
            w = rng.standard_normal(n)
            s = (w - np.convolve(w, np.ones(8) / 8, "same")) \
                * (1 + 0.5 * np.sin(2 * np.pi * 0.7 * t + 1))
        elif kind == "tone_switch":   # state-switching spectra (HMM)
            seg = int(0.25 * fs)
            freqs = [330, 660, 495]
            s = np.concatenate([
                np.sin(2 * np.pi * freqs[i % 3] * np.arange(seg) / fs)
                for i in range(n // seg + 1)])[:n]
        elif kind == "clicks":
            s = np.zeros(n)
            s[::int(0.21 * fs)] = 1.0
            s = np.convolve(s, np.hanning(64), "same") \
                * rng.standard_normal(n) * 0.5 + s
        else:
            raise ValueError(kind)
        out.append(s / (np.std(s) + 1e-9))
    return out


def anechoic_mixture(seed=101):
    """configs[1]: three band-limited noises, gains [0.5, 1, 1.8] and
    integer delays [-4, 0, 5] samples on the second channel (exact images).
    Returns (mix (T, 2) float32, true images (3, T, 2))."""
    rng = np.random.default_rng(seed)
    n = int(FS_CONV * DUR_CONV)
    srcs = band_sources(rng, n, ["band:0.01-0.2", "band:0.15-0.55",
                                 "band:0.45-0.95"])
    ys = np.stack([np.stack([s, g * np.roll(s, d)], 1)
                   for s, g, d in zip(srcs, [0.5, 1.0, 1.8], [-4, 0, 5])])
    return ys.sum(0).astype(np.float32), ys


def reverb_mixture(seed=102, kinds=("harm", "noise_lo", "noise_hi",
                                     "clicks")):
    """configs[2]: four sources, each convolved with 100-tap two-channel
    responses (a direct path plus a decaying tail). With more `kinds` the
    first four sources and rooms are the same draws (phase 19's fifth
    source)."""
    rng = np.random.default_rng(seed)
    n = int(FS_CONV * DUR_CONV)
    srcs = band_sources(rng, n, list(kinds))
    ys = []
    for j, s in enumerate(srcs):
        chs = []
        for ch in range(2):
            h = rng.standard_normal(100) * np.exp(-np.arange(100) / 20.0)
            h[0] += 1.5 if ch == (j % 2) else 0.4
            chs.append(np.convolve(s, h, "same"))
        ys.append(np.stack(chs, 1))
    ys = np.stack(ys)
    return ys.sum(0).astype(np.float32), ys


def principal_directions(ys_true, wlen=WLEN_CONV):
    """Each true image's per-frequency principal direction, (J, F, 2, 1)
    complex: the top eigenvector of sum_n y y^H, first entry made real."""
    from pyfasst_tpu_torch.tf.stft import stft
    out = []
    for y in ys_true:
        Y = stft(y, wlen, device="cpu").numpy()             # (F, N, 2)
        R = np.einsum("fni,fnk->fik", Y, Y.conj())
        u = np.linalg.eigh(R)[1][..., -1]                  # (F, 2)
        u = u * np.exp(-1j * np.angle(u[:, :1]))
        out.append(u[..., None])
    return np.stack(out)


def best_perm(ys, ys_true):
    """(permutation, image SDR of each source) at the permutation with the
    best total SDR: ys[perm[j]] is source j's estimate."""
    import itertools

    def sdr(a, b):
        return 10 * np.log10(np.sum(b ** 2)
                             / max(np.sum((a - b) ** 2), 1e-12))

    J = len(ys_true)
    return max(((p, tuple(sdr(ys[p[j]], ys_true[j]) for j in range(J)))
                for p in itertools.permutations(range(J))),
               key=lambda c: sum(c[1]))


def best_perm_sdr(ys, ys_true):
    """(min, mean) image SDR over sources at the permutation with the best
    total SDR (tools/validate_hw.py::_best_perm_sdr)."""
    best = best_perm(ys, ys_true)[1]
    return float(min(best)), float(np.mean(best))


def conv_model(case, device, niter=NITER_CONV, annealing="ann"):
    """(model, true images) for configs[1] ("anechoic": DEMIX init, rank 1,
    ERB basis), configs[2] ("reverb": principal-direction init, rank 2) or
    its five-source recipe ("reverb5", phase 19) on `device`."""
    from pyfasst_tpu_torch import DEMIX, MultiChanNMFConv
    kw = dict(fs=FS_CONV, nbNMFComps=6, wlen=WLEN_CONV, iter_num=niter,
              spatial_hold_frac=0.3, annealing=annealing, device=device)
    if case == "anechoic":
        mix, ys_true = anechoic_mixture()
        dm = DEMIX(mix, fs=FS_CONV, wlen=WLEN_CONV)
        dm.comp_parameters(K=3)
        model = MultiChanNMFConv(mix, nbComps=3,
                                 init_mixing=dm.mixing(WLEN_CONV // 2 + 1),
                                 freq_basis="erb", n_bands=32, **kw)
    else:
        mix, ys_true = (reverb_mixture(kinds=FIVE_KINDS) if case == "reverb5"
                        else reverb_mixture())
        model = MultiChanNMFConv(mix, nbComps=len(ys_true), spatial_rank=2,
                                 init_mixing=principal_directions(ys_true),
                                 **kw)
    return model, ys_true


def drive_conv(model, ys_true, out_dir):
    """Estimate, write the WAVs and score: returns the logliks, the (min,
    mean) SDR, the seconds of estimation and separation, and the WAVs."""
    import torch
    t0 = time.perf_counter()
    ll = model.estim_param_a_posteriori()
    paths = model.separate_spat_comps(out_dir)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sdr = best_perm_sdr(model.separated_images(), ys_true)
    return ll, sdr, seconds, paths


def cpu_reference():
    """Phases 5 and 6 on the CPU: the figures CPU_SDR holds."""
    for case in ("anechoic", "reverb"):
        model, ys_true = conv_model(case, "cpu")
        with tempfile.TemporaryDirectory() as tmp:
            ll, sdr, seconds, _ = drive_conv(model, ys_true, tmp)
        print(json.dumps({"case": case, "min_sdr": sdr[0],
                          "mean_sdr": sdr[1], "seconds": seconds,
                          "final_loglik": float(ll[-1])}), flush=True)


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
    occupancy_report()


def occupancy_report():
    """Resident warps per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    and registers / local bytes per thread of the 56 general E-step
    instantiations (J = 2 to 8; with shared bytes, static and dynamic), the
    three each of fb_stats and tw_stats and their tiled form at K_BIG, and
    the two of estep_r1_real; the ones a path takes are marked."""
    import itertools
    from pyfasst_tpu_torch.ops import _build
    path = {v: k for k, v in GENERAL_PATH_INSTANCES.items()}
    for J_ in range(2, 9):
        cells = []
        for rmax, real, ns in itertools.product((1, 2), (0, 1), (0, 1)):
            i = _build.kernel_info(f"estep_j{J_}", rmax, real, ns)
            tag = path.get((J_, rmax, real, ns), "")
            cells.append(f"R{rmax}{'real' if real else 'cplx'}"
                         f"{'+ns' if ns else ''}{'[' + tag + ']' if tag else ''}"
                         f" {i['warps_per_sm']}w/{i['registers']}r/"
                         f"{i['local_bytes']}B/{i['shared_bytes']}B")
        log(f"  occupancy estep_general J={J_} (warps per SM / registers / "
            f"local bytes / shared bytes): " + ", ".join(cells))
    F = WLEN // 2 + 1
    for label, kernel, cases in (
            ("fb_stats", "fb_stats",
             [(f"KMAX={k}", (k,), k == K) for k in (8, 16, 32)]
             + [(f"tiled K={k}", (k,), True) for k in K_BIG]),
            (f"tw_stats (F={F})", "tw_stats",
             [(f"KMAX={k}", (k, F), k == K) for k in (8, 16, 32)]
             + [(f"tiled K={k}", (k, F), True) for k in K_BIG]),
            ("estep_r1_real", "estep_r1_real",
             [(f"J={j}", (j,), j == J) for j in (2, 3)])):
        cells = []
        for tag, args, on_path in cases:
            i = _build.kernel_info(kernel, *args)
            cells.append(f"{tag}{'[path]' if on_path else ''} "
                         f"{i['warps_per_sm']}w/{i['registers']}r/"
                         f"{i['local_bytes']}B/{i['shared_bytes']}B smem")
        log(f"  occupancy {label}: " + ", ".join(cells))


def _estep_inputs(B, F, N, seed, device, J_=J):
    import torch
    rng = np.random.default_rng(seed)
    FB = 0.5 + rng.random((B, J_, F, K))
    TW = 0.5 + rng.random((B, J_, K, N))
    arrays = {
        "x4": rng.standard_normal((B, 4, F, N)),
        "v": np.einsum("bjfk,bjkn->bjfn", FB, TW),
        "A": np.abs(rng.standard_normal((B, J_, 1, 2))).repeat(F, 2) + 0.3,
        "sigma": 0.01 + 0.005 * rng.random((B, F)),
    }
    return {k: torch.as_tensor(a, dtype=torch.float32, device=device)
            .contiguous() for k, a in arrays.items()}


def _rel_err(got, want):
    """max |got - want| / (|want| + 1e-3 max|want|): relative per element,
    with a floor at a thousandth of the output's scale for exact zeros."""
    floor = 1e-3 * float(want.abs().max()) + 1e-30
    return float(((got - want).abs() / (want.abs() + floor)).max())


def _estep_errors(got, want):
    """(errors by output name, the largest absolute error) of an E-step
    kernel's (xi, txs, tss, t4, t7, ll) against its plain version's: each
    output relative per element (_rel_err), the loglik relative."""
    errs = {n: _rel_err(g, w) for n, g, w in zip(
        ("xi", "txs", "tss", "t4", "t7"), got, want)}
    ll_g, ll_w = -got[5].sum(-1), -want[5].sum(-1)
    errs["loglik"] = float(((ll_g - ll_w).abs() / ll_w.abs()).max())
    return errs, max(float((g - w).abs().max()) for g, w in zip(got, want))


def count_ops(fn, *args, **kw) -> int:
    """Arithmetic operations of one call of a plain version, counted while
    it runs: each elementwise operation counts its output's elements, each
    sum or mean its input's, a matrix product 2 M K N; views, copies and
    allocations count nothing. The plain versions repeat their kernel's
    arithmetic term by term, so this is the kernel's count on these inputs
    (a little more where the kernel shares a term, as Tss_kj = Tss_jk^H)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    free = {aten.copy_, aten.clone, aten._to_copy, aten.fill_, aten.zero_,
            aten.lift_fresh}

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            pkt = func.overloadpacket
            if pkt in (aten.mm, aten.bmm):
                self.ops += 2 * args[0].numel() * args[1].shape[-1]
            elif pkt in (aten.sum, aten.mean):
                self.ops += args[0].numel()
            elif (pkt not in free and torch.Tag.pointwise in func.tags
                  and isinstance(out, torch.Tensor)):
                self.ops += out.numel()
            return out

    with Count() as counter:
        fn(*args, **kw)
    return counter.ops


def general_ops(inp, ranks, **kw) -> int:
    """Operations of one general E-step on inputs `inp`: those of its plain
    version (count_ops), less the ones estep_ref spends on Tss_jk for
    j > k, which the function does not need: the kernel takes them from
    Tss_kj, since Tss_jk = Tss_kj^H bit for bit. That part is counted by
    repeating estep_ref's Tss products and sums for one (j > k, r, s)
    pair, with its own helpers, on tensors of the input's (B, F, N)."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_estep as ce
    ops = count_ops(ce.estep_ref, *inp, ranks, **kw)
    B, _, F, N = inp[1].shape
    t = torch.empty((B, F, N), device="meta")
    sig = torch.empty((B, F, 1), device="meta")
    w = (t, t)                               # w_jr = A_jr^H y: complex
    z = (t, None) if kw.get("real_cov") else (t, t)   # Sigma_x^-1 A_jr

    def pair():
        pr = ce._cmul(w, ce._cconj(w))
        if kw.get("ns_inj"):
            zc = ce._cadd(ce._cdot_conj(z, z), ce._cdot_conj(z, z))
            pr = ce._cadd(pr, ce._cscale(sig, zc))
        for part in pr:
            torch.sum(ce._m(t, part), dim=-1)

    lower = sum(ranks[j] * ranks[k] for j in range(len(ranks))
                for k in range(j))
    return ops - lower * count_ops(pair)


def bound(tensors, ops):
    """(bound_ms, bound_by, bytes): the least time an H100 SXM could take
    for a call that reads each of its inputs once and writes each of its
    outputs once (`tensors`, both) and does `ops` float32 operations:
    the larger of bytes over the memory rate and operations over the
    float32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes)


def _graph_ms(fn, reps, inner):
    """CUDA-event ms samples of fn(), each the mean of `inner` calls captured
    in one CUDA graph and replayed: the device's time for the calls, without
    the host's cost of launching them (which is what an eager loop of a
    short kernel measures)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # warm-up off the capture, as capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    return [t / inner for t in _event_ms(graph.replay, reps)]


def _turns(kernel, plain, reps=11, inner=10, plain_reps=3, plain_inner=2):
    """CUDA-event ms samples of kernel() and plain(), in turns (plain,
    kernel, kernel, plain), each after a warm-up call: (kernel samples,
    plain samples). A kernel sample is the mean of `inner` calls replayed
    from one CUDA graph (_graph_ms); a plain sample the mean of
    `plain_inner` back-to-back eager calls, as its callers run it."""
    kern, ref = [], []
    for fn, out, timer, r, i in ((plain, ref, _event_ms, plain_reps,
                                  plain_inner),
                                 (kernel, kern, _graph_ms, reps, inner),
                                 (kernel, kern, _graph_ms, reps, inner),
                                 (plain, ref, _event_ms, plain_reps,
                                  plain_inner)):
        fn()
        out.extend(timer(fn, r, i))
    return kern, ref


def phase_kernel_vs_plain(device):
    """estep_r1_real against its plain version at R1_SHAPES and at the
    ERBlet path's shape, which it also times (the bench shape is timed in
    phase 4). Returns the bench shape's max_abs_err and the ERBlet shape's
    numbers."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_estep
    t0 = time.perf_counter()
    main_abs = 0.0
    erb = None
    for (B, J_, F, N) in R1_SHAPES + (ERB_SHAPE,):
        inp = _estep_inputs(B, F, N, seed=F * N, device=device, J_=J_)
        for flag in (("",) if B == BATCH or N > 1000
                     else ("", "fast_recip", "no_ll")):
            kw = {flag: True} if flag else {}
            got = cuda_estep.estep_r1_real(**inp, **kw)
            want = cuda_estep.estep_r1_real_ref(**inp,
                                                no_ll=flag == "no_ll")
            again = cuda_estep.estep_r1_real(**inp, **kw)
            torch.cuda.synchronize()
            errs, abs_err = _estep_errors(got, want)
            xi_bits = bool(torch.equal(got[0], want[0]))
            if (B, J_, F, N) == R1_SHAPES[0]:
                main_abs = abs_err
            log(f"phase 2 kernel vs plain B={B} J={J_} F={F} N={N}"
                f"{' ' + flag if flag else ''}: "
                + " ".join(f"{n} {e:.2e}<={TOL[n]:.0e}"
                           for n, e in errs.items())
                + f" | max_abs_err {abs_err:.3e} | xi bit-identical "
                f"{xi_bits}")
            bad = [n for n, e in errs.items() if not e <= TOL[n]]
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                bad.append("two runs differ")
            if flag != "fast_recip" and not xi_bits:
                bad.append("xi differs from the plain version's bits")
            if bad:
                raise RuntimeError(f"kernel disagrees with its plain version "
                                   f"at B={B} J={J_} F={F} N={N} {flag}: "
                                   f"{bad}")
            if (B, J_, F, N) == ERB_SHAPE:
                erb = erblet_kernel_timing(inp, got, abs_err)
    log(f"phase 2 done | {time.perf_counter() - t0:.2f}s")
    return main_abs, erb


def erblet_kernel_timing(inp, got, abs_err):
    """estep_r1_real at ERB_SHAPE: kernel and plain in turns, the bound
    and the float32 floor without FMA."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_estep
    kern, plain = _turns(lambda: cuda_estep.estep_r1_real(**inp),
                         lambda: cuda_estep.estep_r1_real_ref(**inp))
    ops = count_ops(cuda_estep.estep_r1_real_ref, **inp)
    b_ms, b_by, nbytes = bound(list(inp.values()) + list(got), ops)
    nums = {"shape": list(ERB_SHAPE), "max_abs_err": abs_err,
            "ms": statistics.median(kern), "plain_ms": statistics.median(plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "nofma_floor_ms": ops / FP32_NOFMA_OPS_PER_S * 1e3}
    log(f"phase 2 kernel at the erblet48 shape B,J,F,N={ERB_SHAPE}: kernel "
        f"{nums['ms']:.4f} ms (min {min(kern):.4f} max {max(kern):.4f}), "
        f"plain {nums['plain_ms']:.3f} ms (min {min(plain):.3f}), medians "
        f"in turns | bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} Gop; without FMA {nums['nofma_floor_ms']:.4f} ms)"
        f" | {ERB_SHAPE[0] * ERB_SHAPE[2]} blocks, one per frequency row, on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    return nums


def conv_frames():
    """N of the conv paths (phases 5-7): the 6 s, 16 kHz clip, wlen 1024,
    hop 512."""
    from pyfasst_tpu_torch.tf.stft import _frame_geometry
    return _frame_geometry(int(FS_CONV * DUR_CONV), WLEN_CONV,
                           WLEN_CONV // 2)[2]


def padded_frames(n):
    """The frame count of batch_separate's bucket for n frames (its
    default granularity)."""
    from pyfasst_tpu_torch.parallel.batch import frame_buckets
    return next(iter(frame_buckets([n], GRANULARITY)))


def phase_general_vs_plain(device):
    """Variants b, c and d against the plain version, at the bench shapes,
    at the conv paths' own shape and at two ragged ones; times kernel and
    plain at the bench and path shapes, in turns (plain, kernel, kernel,
    plain). Returns the bench-shape numbers by label, each with its
    path-shape numbers under "path"."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_estep
    t0 = time.perf_counter()
    path_shape = (1, 513, conv_frames())
    out = {}
    for key, label, J_, ranks, real, ns in GENERAL_CASES:
        tol = dict(TOL, xi=3e-4 if max(ranks) == 2 else TOL["xi"])
        # the batch paths' shape: phase 9's bucket (variant c), phase 10's
        # (b); variant d runs at B = 1 only
        batch = {"b": "anechoic", "c": "reverb"}.get(key)
        timed = ((BATCH, 513, 863), path_shape) + (
            ((len(CONV_BATCH_SEEDS[batch]), 513, padded_frames(conv_frames())),)
            if batch else ())
        # phase 16's pool: chunks of POOL_CHUNK runs, unpadded frames
        pool_shape = (POOL_CHUNK, 513, conv_frames())
        on_pool = label == GENERAL_HEADLINE["c"]
        if on_pool:
            timed = timed + (pool_shape,)
        # phase 18's dp = 2 leg: each rank runs half of phase 9's bucket
        mesh = (((len(CONV_BATCH_SEEDS["reverb"]) // 2, 513,
                  padded_frames(conv_frames())),) if on_pool else ())
        for (B, F, N) in timed + mesh + ((1, 33, 70), (1, 9, 2500)):
            inp = _general_inputs(B, J_, F, N, ranks, real, seed=F * N + J_,
                                  device=device)
            kw = dict(ns_inj=ns, real_cov=real)
            got = cuda_estep.estep_general(*inp, ranks, **kw)
            want = cuda_estep.estep_ref(*inp, ranks, **kw)
            torch.cuda.synchronize()
            errs, abs_err = _estep_errors(got, want)
            timing = ""
            if (B, F, N) in timed:
                kern, plain = _turns(
                    lambda: cuda_estep.estep_general(*inp, ranks, **kw),
                    lambda: cuda_estep.estep_ref(*inp, ranks, **kw))
                ops = general_ops(inp, ranks, **kw)
                b_ms, b_by, nbytes = bound(list(inp) + list(got), ops)
                nums = {"max_abs_err": abs_err,
                        "ms": statistics.median(kern),
                        "plain_ms": statistics.median(plain),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "nofma_floor_ms": ops / FP32_NOFMA_OPS_PER_S * 1e3}
                if (B, F, N) == timed[0]:
                    out[label] = dict(nums, key=key)
                else:
                    where = ("path" if (B, F, N) == path_shape else
                             "pool_path"
                             if on_pool and (B, F, N) == pool_shape
                             else "batch_path")
                    out[label][where] = dict(nums, shape=[B, F, N])
                timing = (f" | kernel {nums['ms']:.4f} ms (min "
                          f"{min(kern):.4f}), "
                          f"plain {nums['plain_ms']:.3f} ms (min "
                          f"{min(plain):.3f}), medians in turns | "
                          f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f}"
                          f" MB, {ops / 1e9:.3f} Gop; without FMA "
                          f"{nums['nofma_floor_ms']:.4f} ms)")
            log(f"phase 2 {key} {label} B={B} F={F} N={N}: "
                + " ".join(f"{n} {e:.2e}<={tol[n]:.0e}"
                           for n, e in errs.items())
                + f" | max_abs_err {abs_err:.3e}{timing}")
            bad = [n for n, e in errs.items() if not e <= tol[n]]
            if on_pool and (B, F, N) == pool_shape:
                again = cuda_estep.estep_general(*inp, ranks, **kw)
                same = all(torch.equal(g, a) for g, a in zip(got, again))
                log(f"phase 2 {key} at the pool shape: two runs bit for bit "
                    f"{same}")
                if not same:
                    bad.append("two runs differ")
            if bad:
                raise RuntimeError(f"variant {key} ({label}) disagrees with "
                                   f"its plain version at B={B} F={F} "
                                   f"N={N}: {bad}")
    log(f"phase 2 new variants done | {time.perf_counter() - t0:.2f}s")
    return out


def wide_path_shapes():
    """(B, F, N) of phase 19's E-steps by run: `separate --sources 5` on the
    10 s, 44.1 kHz mix (wlen 1024) and the five-source configs[2] model."""
    from pyfasst_tpu_torch.tf.stft import _frame_geometry
    return {"inst": (1, WLEN // 2 + 1,
                     _frame_geometry(int(FS * DUR), WLEN, HOP)[2]),
            "reverb5": (1, WLEN_CONV // 2 + 1, conv_frames())}


def phase_wide_vs_plain(device):
    """The general kernel at J = 5 to 8 (WIDE_CASES) against its plain
    version at the bench shapes (timed in turns, with its bound and
    float32 floor without FMA, two runs bit for bit), at phase 19's path
    shape where it has one (timed too) and at WIDE_RAGGED. Returns the
    bench-shape numbers by label, with "path" where timed there, and the
    launches of each case in this phase ("phase2_launches": checks,
    warm-ups and the timing's eager calls; replays do not count)."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_estep
    t0 = time.perf_counter()
    paths = wide_path_shapes()
    out = {}
    for key, label, J_, ranks, real, ns, path in WIDE_CASES:
        tol = dict(TOL, xi=3e-4 if max(ranks) == 2 else TOL["xi"])
        kw = dict(ns_inj=ns, real_cov=real)
        before = cuda_estep.LAUNCHES
        timed = ((BATCH, 513, 863),) + ((paths[path],) if path else ())
        for (B, F, N) in timed + (WIDE_RAGGED,):
            inp = _general_inputs(B, J_, F, N, ranks, real,
                                  seed=F * N + 10 * J_ + max(ranks),
                                  device=device)
            got = cuda_estep.estep_general(*inp, ranks, **kw)
            want = cuda_estep.estep_ref(*inp, ranks, **kw)
            torch.cuda.synchronize()
            errs, abs_err = _estep_errors(got, want)
            bad = [n for n, e in errs.items() if not e <= tol[n]]
            timing = ""
            if (B, F, N) in timed:
                again = cuda_estep.estep_general(*inp, ranks, **kw)
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    bad.append("two runs differ")
                kern, plain = _turns(
                    lambda: cuda_estep.estep_general(*inp, ranks, **kw),
                    lambda: cuda_estep.estep_ref(*inp, ranks, **kw),
                    plain_reps=2, plain_inner=1)
                ops = general_ops(inp, ranks, **kw)
                b_ms, b_by, nbytes = bound(list(inp) + list(got), ops)
                nums = {"max_abs_err": abs_err, "shape": [B, F, N],
                        "ms": statistics.median(kern),
                        "plain_ms": statistics.median(plain),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "nofma_floor_ms": ops / FP32_NOFMA_OPS_PER_S * 1e3}
                if (B, F, N) == timed[0]:
                    out[label] = dict(nums, key=key, J=J_, ranks=list(ranks))
                else:
                    out[label]["path"] = nums
                timing = (f" | kernel {nums['ms']:.4f} ms (min "
                          f"{min(kern):.4f}), plain {nums['plain_ms']:.3f} "
                          f"ms, medians in turns | bound {b_ms:.4f} ms by "
                          f"{b_by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} "
                          f"Gop; without FMA {nums['nofma_floor_ms']:.4f} "
                          "ms) | two runs bit for bit")
            log(f"phase 2 {key} {label} B={B} F={F} N={N}: "
                + " ".join(f"{n} {e:.2e}<={tol[n]:.0e}"
                           for n, e in errs.items())
                + f" | max_abs_err {abs_err:.3e}{timing}")
            if bad:
                raise RuntimeError(f"the general kernel ({label}) disagrees "
                                   f"with its plain version at B={B} F={F} "
                                   f"N={N}: {bad}")
        out[label]["phase2_launches"] = cuda_estep.LAUNCHES - before
    log(f"phase 2 J = 5..8 done | {time.perf_counter() - t0:.2f}s")
    return out


def phase_variants_ef(device):
    """Variants e (fast_recip) and f (no_ll) against the plain versions (the
    exact reciprocal; the loglik without log det), in variant a's kernel and
    in the general kernel, at the bench shapes and a ragged one; times the
    bench shapes in turns. Returns the numbers of each variant in variant
    a's kernel, and the launches of variant f in this phase (no path sets
    no_ll)."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_estep
    t0 = time.perf_counter()
    out = {}
    f_before = cuda_estep.VARIANT_LAUNCHES["f"]
    for label, kern_name, J_, ranks, real, ns in EF_CASES:
        tol = dict(TOL, xi=3e-4 if max(ranks) == 2 else TOL["xi"])
        for (B, F, N) in ((BATCH, 513, 863), (1, 33, 70)):
            if kern_name == "a":
                inp = list(_estep_inputs(B, F, N, seed=F * N + 5,
                                         device=device).values())
                kernel, plain = (cuda_estep.estep_r1_real,
                                 cuda_estep.estep_r1_real_ref)
                args, kw = (), {}
            else:
                inp = _general_inputs(B, J_, F, N, ranks, real,
                                      seed=F * N + J_ + 5, device=device)
                kernel, plain = cuda_estep.estep_general, cuda_estep.estep_ref
                args, kw = (ranks,), dict(ns_inj=ns, real_cov=real)
            for key, flag in (("e", "fast_recip"), ("f", "no_ll")):
                got = kernel(*inp, *args, **kw, **{flag: True})
                want = plain(*inp, *args, **kw, no_ll=flag == "no_ll")
                torch.cuda.synchronize()
                errs, abs_err = _estep_errors(got, want)
                timing = ""
                if B == BATCH:
                    ms, plain_ms = map(statistics.median, _turns(
                        lambda: kernel(*inp, *args, **kw, **{flag: True}),
                        lambda: plain(*inp, *args, **kw,
                                      no_ll=flag == "no_ll")))
                    no_ll = dict(no_ll=flag == "no_ll")
                    b_ms, b_by, nbytes = bound(
                        list(inp) + list(got),
                        count_ops(plain, *inp, **no_ll) if kern_name == "a"
                        else general_ops(inp, ranks, **kw, **no_ll))
                    if kern_name == "a":
                        out[key] = {"max_abs_err": abs_err, "ms": ms,
                                    "plain_ms": plain_ms, "bound_ms": b_ms,
                                    "bound_by": b_by}
                    timing = (f" | kernel {ms:.4f} ms, plain {plain_ms:.3f}"
                              f" ms, medians in turns | bound {b_ms:.4f} ms"
                              f" by {b_by} ({nbytes / 1e6:.1f} MB)")
                log(f"phase 2 {key} ({flag}) {label} B={B} F={F} N={N}: "
                    + " ".join(f"{n} {e:.2e}<={tol[n]:.0e}"
                               for n, e in errs.items())
                    + f" | max_abs_err {abs_err:.3e}{timing}")
                bad = [n for n, e in errs.items() if not e <= tol[n]]
                if bad:
                    raise RuntimeError(
                        f"variant {key} ({label}) disagrees with its plain "
                        f"version at B={B} F={F} N={N}: {bad}")
    f_launches = cuda_estep.VARIANT_LAUNCHES["f"] - f_before
    log(f"phase 2 variants e, f done | {time.perf_counter() - t0:.2f}s")
    return out, f_launches


def _spectral_inputs(B, J_, F, N, K_, seed, device):
    """fb_stats/tw_stats inputs: xi scattered around V = FB TW, and a floor
    that clamps V in clip 0 (its 30th percentile) and not in the others
    (fused_spectral_update's 1e-12 mean + eps)."""
    import torch
    rng = np.random.default_rng(seed)
    FB = 0.5 + rng.random((B, J_, F, K_))
    TW = 0.5 + rng.random((B, J_, K_, N))
    V = np.einsum("bjfk,bjkn->bjfn", FB, TW)
    xi = V * (0.1 + rng.exponential(size=V.shape))
    vfloor = 1e-12 * xi.mean(axis=(2, 3)) + 1e-30
    vfloor[0] = np.quantile(V[0], 0.3, axis=(1, 2))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            .contiguous() for a in (xi, FB, TW, vfloor)]


def phase_spectral_vs_plain(device):
    """fb_stats and tw_stats against their plain versions at
    SPECTRAL_SHAPES, relative per element (every output is positive) at
    rtol 2e-5; times the bench shapes in turns (K = 8, and K_BIG's under
    "<name> K=<k>", their B = 1 shapes under "<name> K=<k> B=1")."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_spectral
    t0 = time.perf_counter()
    card = smi()
    out = {}
    for (B, J_, F, N, K_) in SPECTRAL_SHAPES:
        inp = _spectral_inputs(B, J_, F, N, K_, seed=F * N + K_,
                               device=device)
        for name in ("fb_stats", "tw_stats"):
            kernel = getattr(cuda_spectral, name)
            plain = getattr(cuda_spectral, f"{name}_ref")
            got = kernel(*inp)
            want = plain(*inp)
            again = kernel(*inp)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise RuntimeError(f"two runs of {name} differ at B={B} "
                                   f"J={J_} F={F} N={N} K={K_}")
            err = max(float(((g - w).abs() / w.abs()).max())
                      for g, w in zip(got, want))
            abs_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            timing = ""
            shape = (B, J_, F, N, K_)
            if shape == SPECTRAL_SHAPES[0] or shape in SPECTRAL_WIDE:
                ms, plain_ms = map(statistics.median, _turns(
                    lambda: kernel(*inp), lambda: plain(*inp),
                    plain_reps=11, plain_inner=10))
                ops = count_ops(plain, *inp)
                b_ms, b_by, nbytes = bound(list(inp) + list(got), ops)
                key = (name if K_ == K else f"{name} K={K_}"
                       + ("" if B == BATCH else f" B={B}"))
                out[key] = {"max_abs_err": abs_err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "shape": list(shape),
                            "nofma_floor_ms":
                                ops / FP32_NOFMA_OPS_PER_S * 1e3}
                timing = (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
                          f" medians in turns | bound {b_ms:.4f} ms by "
                          f"{b_by} ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} "
                          f"Gop; without FMA "
                          f"{ops / FP32_NOFMA_OPS_PER_S * 1e3:.4f} ms) | "
                          f"{card}")
            log(f"phase 2 {name} B={B} J={J_} F={F} N={N} K={K_}: rel "
                f"{err:.2e}<={SPECTRAL_RTOL:.0e} | max_abs_err "
                f"{abs_err:.3e}{timing}")
            if not err <= SPECTRAL_RTOL:
                raise RuntimeError(f"{name} disagrees with its plain version"
                                   f" at B={B} J={J_} F={F} N={N} K={K_}")
    log(f"phase 2 spectral kernels done | {time.perf_counter() - t0:.2f}s")
    return out


def _general_inputs(B, J_, F, N, ranks, real, seed, device):
    """Random E-step inputs for the general kernel: x4, v = FB TW, complex
    (or real) per-frequency mixing columns A4, sigma."""
    import torch
    rng = np.random.default_rng(seed)
    FB = 0.5 + rng.random((B, J_, F, K))
    TW = 0.5 + rng.random((B, J_, K, N))
    A4 = np.zeros((B, J_, F, 4 * max(ranks)))
    for j, R in enumerate(ranks):
        a = 0.7 * rng.standard_normal((B, F, 4 * R))
        if real:
            a[..., 1::2] = 0.0
        A4[:, j, :, :4 * R] = a
    arrays = (rng.standard_normal((B, 4, F, N)),
              np.einsum("bjfk,bjkn->bjfn", FB, TW), A4,
              0.01 + 0.005 * rng.random((B, F)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            .contiguous() for a in arrays]


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
        phase_resume(device, wav, niter, model, ll)
    return launches


class _Stopped(Exception):
    """Raised by phase 3b's checkpoint hook: the run is cut off there, as a
    killed job is."""


def phase_resume(device, wav, niter, straight, ll_straight):
    """Phase 3b: a new model runs iterations 0 -> niter/2 with a checkpoint
    every niter/4 and is cut off after the save at niter/2; a second new
    model loads that checkpoint and resumes. Its logliks from niter/2 on
    and every leaf of its final parameters must equal phase 3's
    uninterrupted run (`straight`) bit for bit."""
    import torch
    from pyfasst_tpu_torch import MultiChanNMFInst_FASST, convert
    from pyfasst_tpu_torch.ops import cuda_estep
    t0 = time.perf_counter()
    half, every = niter // 2, niter // 4
    ck = os.path.join(os.path.dirname(wav), "resume.npz")
    kw = dict(nbComps=J, nbNMFComps=K, iter_num=niter, device=device)
    first = MultiChanNMFInst_FASST(wav, **kw)
    save = first.save_checkpoint

    def save_then_stop(path, iteration=None):
        out = save(path, iteration)
        if iteration == half:
            raise _Stopped(iteration)
        return out

    first.save_checkpoint = save_then_stop
    cuda_estep.LAUNCHES = 0
    try:
        first.estim_param_a_posteriori(checkpoint_path=ck,
                                       checkpoint_every=every)
        raise RuntimeError("phase 3b: the run was not cut off at its "
                           f"checkpoint of iteration {half}")
    except _Stopped:
        pass
    resumed = MultiChanNMFInst_FASST(wav, **kw)
    start = resumed.load_checkpoint(ck)
    ll = resumed.estim_param_a_posteriori(start_iter=start,
                                          checkpoint_path=ck,
                                          checkpoint_every=every)
    torch.cuda.synchronize()
    launches = cuda_estep.LAUNCHES
    same_ll = bool(np.array_equal(ll[half:], ll_straight[half:]))
    trees = [convert.params_to_numpy(m.params)[0]
             for m in (straight, resumed)]
    leaves = [(c[n], d[n]) for part in ("spat", "spec")
              for c, d in zip(trees[0][part], trees[1][part])
              for n in c if isinstance(c[n], np.ndarray)]
    same_leaves = sum(bool(np.array_equal(a, b)) for a, b in leaves)
    log(f"phase 3b resume: cut off after the checkpoint at iteration "
        f"{half} (every {every}), resumed from {start}; logliks "
        f"{half}-{niter} bit-identical {same_ll}, parameter leaves "
        f"bit-identical {same_leaves}/{len(leaves)}; E-step launches "
        f"{launches} (both legs) | {time.perf_counter() - t0:.2f}s")
    if start != half or not same_ll or same_leaves != len(leaves):
        raise RuntimeError("phase 3b: the resumed run is not the "
                           "uninterrupted one bit for bit")
    if launches != niter:
        raise RuntimeError(f"phase 3b: {launches} E-step launches in "
                           f"{niter} iterations over both legs")


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


def bench_setup(device, dur, batch):
    """The bench pipeline's inputs: `batch` clips (seeds 0..batch-1) on the
    card, their true images, the window, and a params(b_count) maker."""
    import torch
    from pyfasst_tpu_torch import convert
    from pyfasst_tpu_torch.tf.stft import _frame_geometry, sine_window
    nsamples = int(FS * dur)
    clips = [make_mixture(dur=dur, seed=b) for b in range(batch)]
    mix = torch.as_tensor(np.stack([c[0] for c in clips]), device=device)
    y_true = torch.as_tensor(np.stack([np.stack(c[1:]) for c in clips]),
                             device=device)
    window = torch.as_tensor(sine_window(WLEN), dtype=torch.float32,
                             device=device)
    F = WLEN // 2 + 1
    N = _frame_geometry(nsamples, WLEN, HOP)[2]

    def params_for(b_count):
        return convert.params_from_numpy(
            [bench_tree(F, N, seed=b) for b in range(b_count)], device=device)

    return mix, y_true, window, nsamples, F, N, params_for


def phase_batch(device, dur, niter, batch, card):
    from pyfasst_tpu_torch.ops import cuda_estep
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints
    from pyfasst_tpu_torch.tf.stft import _stft_core
    from pyfasst_tpu_torch.utils.config import GEMConfig
    t0 = time.perf_counter()
    mix, y_true, window, nsamples, F, N, params_for = bench_setup(
        device, dur, batch)
    cfg = GEMConfig(niter=niter)

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
    kern, plain = _turns(lambda: cuda_estep.estep_r1_real(**inp),
                         lambda: cuda_estep.estep_r1_real_ref(**inp),
                         plain_reps=11, plain_inner=10)
    kernel_ms, plain_ms = statistics.median(kern), statistics.median(plain)
    b_ms, b_by, nbytes = bound(
        list(inp.values()) + list(cuda_estep.estep_r1_real(**inp)),
        count_ops(cuda_estep.estep_r1_real_ref, **inp))
    log(f"phase 4 E-step B={batch} F={F} N={N}: kernel {kernel_ms:.4f} ms "
        f"(min {min(kern):.4f} max {max(kern):.4f}), plain {plain_ms:.4f} ms "
        f"(min {min(plain):.4f} max {max(plain):.4f}); median of "
        f"{len(kern)} samples of 10 calls by graph replay, in turns "
        f"plain/kernel/kernel/plain | {nbytes / 1e6:.1f} MB moved -> "
        f"{nbytes / 1e3 / (kernel_ms / 1e3) / 1e6:.1f} GB/s | bound "
        f"{b_ms:.4f} ms by {b_by} | {card}")

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
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "xrt": xrt,
            "bound_ms": b_ms, "bound_by": b_by,
            "pipeline_ms": statistics.median(ms),
            "logliks": logliks.cpu().numpy()}


def _profile(window, n):
    """Per step of window() (n steps): wall ms (to the last kernel's end),
    host enqueue ms (window's return, before the device finishes), and,
    from torch.profiler, the device's busy ms (the sum of its kernels'
    times) and kernel count (memsets and copies included). After one
    unprofiled pass over the same window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return {"wall_ms": wall * 1e3 / n, "enqueue_ms": enqueue * 1e3 / n,
            "busy_ms": busy / n if dev else None,
            "kernels": len(dev) / n if dev else None}


def gem_window(params, X, cfg, start=60, stop=80):
    """(window, steps): GEM iterations [start, stop) of one run."""
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints, run_gem
    sig = annealing_endpoints(X, cfg)

    def window():
        return run_gem(params, X, cfg, start_iter=start, end_iter=stop,
                       sigma_endpoints=sig)

    return window, stop - start


def profile_gem(params, X, cfg, start=60, stop=80):
    """GEM iterations [start, stop) of one run, per iteration (_profile)."""
    return _profile(*gem_window(params, X, cfg, start, stop))


def _profile_line(label, prof, card,
                  window="iterations 60-80, per iteration"):
    return (f"{label}, {window}: wall "
            f"{prof['wall_ms']:.3f} ms, host enqueue {prof['enqueue_ms']:.3f}"
            f" ms, device busy "
            + (f"{prof['busy_ms']:.4f} ms ({prof['kernels']:.1f} kernels)"
               if prof["kernels"] else "not measured (no device events)")
            + f" | {card}")


def phase_fused(device, dur, niter, batch, card, unfused):
    """Phase 8: the bench pipeline with the fused spectral M-step, then with
    it and fast_recip, with their launch and SDR gates; pipeline times
    beside phase 4's unfused one, and a profile of 20 iterations with
    fusion off and on. Returns each run's launch counts and times."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_spectral
    from pyfasst_tpu_torch.tf.stft import _stft_core
    from pyfasst_tpu_torch.utils.config import GEMConfig
    t0 = time.perf_counter()
    mix, y_true, window, nsamples, F, N, params_for = bench_setup(
        device, dur, batch)
    runs = {}
    configs = (("fused", GEMConfig(niter=niter, fuse_spectral=True)),
               ("fused+fast_recip", GEMConfig(niter=niter, fuse_spectral=True,
                                              fast_recip=True)))
    for label, cfg in configs:
        _reset_counts()
        ys, logliks = pipeline(mix, params_for(batch), cfg, window, nsamples)
        torch.cuda.synchronize()
        total, counts = _counts()
        spectral = dict(cuda_spectral.LAUNCHES)
        check_logliks(logliks.cpu().numpy(), f"phase 8 {label}")
        sdrs = min_sdr(ys, y_true)
        ms = _event_ms(lambda: pipeline(mix, params_for(batch), cfg, window,
                                        nsamples), 5)
        xrt = batch * dur / (statistics.median(ms) / 1e3)
        log(f"phase 8 {label} batch-{batch}: {niter} iters, launches E-step "
            f"{total} {counts}, {spectral}; per-clip min SDR "
            + " ".join(f"{x:.2f}" for x in sdrs)
            + " | pipeline " + ", ".join(f"{m:.1f}" for m in ms)
            + f" ms -> xRT {xrt:.2f} (median of {len(ms)}); unfused (phase 4)"
            f" {unfused['pipeline_ms']:.1f} ms, xRT "
            f"{unfused['xrt'][batch]:.2f} | {card}")
        want_e = niter if cfg.fast_recip else 0
        if (total != niter or counts["e"] != want_e
                or spectral != {"fb_stats": niter, "tw_stats": niter}):
            raise RuntimeError(
                f"phase 8 {label}: launches E-step {total} {counts}, "
                f"spectral {spectral} in {niter} iterations (expected "
                f"{niter} each, {want_e} of variant e)")
        if not np.all(sdrs > SDR_GATE):
            raise RuntimeError(f"phase 8 {label}: separation below "
                               f"{SDR_GATE} dB: {sdrs}")
        runs[label] = {"counts": counts, "spectral": spectral,
                       "pipeline_ms": statistics.median(ms), "xrt": xrt,
                       "logliks": logliks.cpu().numpy()}

    X = _stft_core(mix, window, WLEN, HOP, "fft")
    for label, cfg in ((("unfused", GEMConfig(niter=niter)),) + configs):
        prof = profile_gem(params_for(batch), X, cfg)
        log(_profile_line(f"phase 8 profile {label} B={batch} (of {niter})",
                          prof, card))
    log(f"phase 8 done | {time.perf_counter() - t0:.2f}s")
    return runs


def _reset_counts():
    from pyfasst_tpu_torch.ops import cuda_estep, cuda_spectral
    cuda_estep.LAUNCHES = 0
    for k in cuda_estep.VARIANT_LAUNCHES:
        cuda_estep.VARIANT_LAUNCHES[k] = 0
    for k in cuda_spectral.LAUNCHES:
        cuda_spectral.LAUNCHES[k] = 0


def _counts():
    from pyfasst_tpu_torch.ops import cuda_estep
    return cuda_estep.LAUNCHES, dict(cuda_estep.VARIANT_LAUNCHES)


def phase_conv(device, case, card):
    """Phase 5 (case "anechoic", configs[1]) or 6 ("reverb", the configs[2]
    model) through the host API on the card, with the launch and SDR
    gates. Returns the variant launch counts of the run."""
    t0 = time.perf_counter()
    phase = 5 if case == "anechoic" else 6
    model, ys_true = conv_model(case, device)
    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        ll, (smin, smean), secs, paths = drive_conv(model, ys_true, tmp)
        total, counts = _counts()
        written = [p for p in paths if os.path.getsize(p) > 44]
    check_logliks(ll, f"phase {phase} {case}", tail=CONV_LL_TAIL)
    cpu = CPU_SDR[case]
    log(f"phase {phase} {case}: J={model.params.n_spat} rank "
        f"{model.params.spat[0].rank} F={model.F} N={model.N}, "
        f"{NITER_CONV} iters, loglik {ll[0]:.6g} -> {ll[-1]:.6g}, launches "
        f"{total} {counts}, min SDR {smin:.2f} dB (mean {smean:.2f}; CPU "
        f"run {cpu} dB), wavs {len(written)}, run {secs:.2f}s -> xRT "
        f"{DUR_CONV / secs:.2f} (first run, B=1) | {card} | "
        f"{time.perf_counter() - t0:.2f}s")
    prof = profile_gem(model.params, model.Xs, model.cfg)
    log(_profile_line(f"phase {phase} profile {case} B=1 (of {NITER_CONV})",
                      prof, card))
    key = "b" if case == "anechoic" else "c"
    if model.N != conv_frames():
        raise RuntimeError(f"phase {phase}: N = {model.N}, but phase 2 "
                           f"timed the path's shape at N = {conv_frames()}")
    if total != NITER_CONV or counts[key] != NITER_CONV:
        raise RuntimeError(f"phase {phase}: {total} kernel launches "
                           f"({counts}) in {NITER_CONV} iterations")
    if not smin >= SDR_FLOOR[case]:
        raise RuntimeError(f"phase {phase}: min SDR {smin:.2f} dB < "
                           f"{SDR_FLOOR[case]} dB")
    if abs(smin - cpu) > SDR_SLACK:
        raise RuntimeError(f"phase {phase}: min SDR {smin:.2f} dB not "
                           f"within {SDR_SLACK} dB of the CPU run ({cpu})")
    if len(written) != model.params.n_spat:
        raise RuntimeError(f"phase {phase}: expected "
                           f"{model.params.n_spat} WAVs, found {paths}")
    return counts


def phase_ns_inj(device):
    """Phase 7: phase 5's model under 'ann_ns_inj', through the kernel."""
    t0 = time.perf_counter()
    model, _ = conv_model("anechoic", device, niter=NITER_NS,
                          annealing="ann_ns_inj")
    _reset_counts()
    ll = model.estim_param_a_posteriori()
    total, counts = _counts()
    log(f"phase 7 ann_ns_inj: {NITER_NS} iters, loglik {ll[0]:.6g} -> "
        f"{ll[-1]:.6g}, launches {total} {counts} | "
        f"{time.perf_counter() - t0:.2f}s")
    if not np.all(np.isfinite(ll)):
        raise RuntimeError("phase 7: non-finite loglik")
    if total != NITER_NS or counts["d"] != NITER_NS:
        raise RuntimeError(f"phase 7: {total} kernel launches ({counts}) "
                           f"in {NITER_NS} iterations")
    return counts


def conv_recipe(case, seed):
    """One clip of phase 5's ("anechoic": DEMIX init, ERB basis) or phase
    6's ("reverb": principal-direction init, rank 2) recipe with its own
    seed, on the host: (mixture, true images, the model's keywords)."""
    from pyfasst_tpu_torch import DEMIX
    if case == "anechoic":
        mix, ys_true = anechoic_mixture(seed)
        dm = DEMIX(mix, fs=FS_CONV, wlen=WLEN_CONV)
        dm.comp_parameters(K=3)
        kw = dict(nbComps=3, init_mixing=dm.mixing(WLEN_CONV // 2 + 1),
                  freq_basis="erb", n_bands=32)
    else:
        mix, ys_true = reverb_mixture(seed)
        kw = dict(nbComps=4, spatial_rank=2,
                  init_mixing=principal_directions(ys_true))
    return mix, ys_true, kw


def conv_clips(case, seeds, device):
    """conv_recipe's clips of `seeds` as (host-API model on `device`, true
    images). The recipes run in one host thread each: DEMIX is NumPy, which
    lets go of the GIL, and its ~10 s a clip is most of phase 10's
    set-up; the models are built in turn."""
    from concurrent.futures import ThreadPoolExecutor
    from pyfasst_tpu_torch import MultiChanNMFConv
    with ThreadPoolExecutor(len(seeds)) as pool:
        recipes = list(pool.map(lambda sd: conv_recipe(case, sd), seeds))
    return [(MultiChanNMFConv(mix, fs=FS_CONV, nbNMFComps=6, wlen=WLEN_CONV,
                              iter_num=NITER_CONV, spatial_hold_frac=0.3,
                              device=device, **kw), ys_true)
            for mix, ys_true, kw in recipes]


def conv_init_tree(model, n_frames, seed):
    """The model's initial mixing with spectral factors for `n_frames`
    frames drawn with numpy from `seed` (FB, or the ERB weights FW, and TW
    of each component in turn), as a parameter tree."""
    from pyfasst_tpu_torch import convert
    tree = convert.params_to_numpy(model.params)[0]
    rng = np.random.default_rng(seed)
    for c in tree["spec"]:
        name = "FB" if c["FW"] is None else "FW"
        c[name] = (0.5 + rng.random(c[name].shape)).astype(np.float32)
        c["TW"] = (0.5 + rng.random((c["TW"].shape[0], n_frames))
                   ).astype(np.float32)
    return tree


def phase_conv_batch(device, case, card):
    """Phase 9 (case "reverb", the configs[2] model, B = 8) or 10
    ("anechoic", configs[1], B = 4): one clip per seed of CONV_BATCH_SEEDS,
    each from its own init, through batch_separate (one bucket of padded
    frames). Gates: every launch of the E-step kernel B wide; every clip within SDR_SLACK of
    its own B = 1 run of the same init on the same padded frames
    (batch_separate of that clip alone); and the phase's SDR floor on every
    clip whose recipe reaches it unbatched (the host API on the unpadded
    clip, B = 1). The padding's cost, the batch against the unpadded B = 1
    run, is printed. Returns the variant's launch count and the run's
    numbers."""
    import torch
    from pyfasst_tpu_torch import batch_separate, convert
    from pyfasst_tpu_torch.ops import cuda_estep
    from pyfasst_tpu_torch.parallel.batch import _pad_frames, batch_params
    phase, key = (9, "c") if case == "reverb" else (10, "b")
    seeds = CONV_BATCH_SEEDS[case]
    B = len(seeds)
    t0 = time.perf_counter()
    clips = conv_clips(case, seeds, device)
    setup_s = time.perf_counter() - t0
    N = clips[0][0].N
    Npad = padded_frames(N)
    trees = [conv_init_tree(m, Npad, sd) for (m, _), sd in zip(clips, seeds)]
    cfg = clips[0][0].cfg
    Xs = [m.Xs[0] for m, _ in clips]

    def make_params(F, n_pad, i):
        return convert.params_from_numpy(trees[i], device=device)

    def sdrs(imgs):
        return [best_perm_sdr(m._to_time(torch.as_tensor(Y, device=device)),
                              ys_true)[0]
                for (m, ys_true), Y in zip(clips, imgs)]

    widths = []
    kernel = cuda_estep.estep_general

    def spy(x4, *args, **kw):
        widths.append(int(x4.shape[0]))
        return kernel(x4, *args, **kw)

    _reset_counts()
    cuda_estep.estep_general = spy
    try:
        t1 = time.perf_counter()
        imgs, lls = batch_separate(Xs, make_params, cfg, device=device)
        batch_s = time.perf_counter() - t1      # results are on the host
    finally:
        cuda_estep.estep_general = kernel
    total, counts = _counts()
    if not np.all(np.isfinite(np.stack(lls))):
        raise RuntimeError(f"phase {phase}: non-finite loglik in the batch")
    sdr_b = sdrs(imgs)
    one = [batch_separate([Xs[i]], lambda F, n, _, i=i: make_params(F, n, i),
                          cfg, device=device)[0][0] for i in range(B)]
    sdr1 = sdrs(one)
    unpadded, b1_s = [], 0.0
    for (m, ys_true), tree in zip(clips, trees):
        spec = [dict(c, TW=c["TW"][:, :N]) for c in tree["spec"]]
        m.params = convert.params_from_numpy(dict(tree, spec=spec),
                                             device=device)
        t2 = time.perf_counter()
        ll = m.estim_param_a_posteriori()
        ys = m.separated_images()
        b1_s += time.perf_counter() - t2
        if not np.all(np.isfinite(ll)):
            raise RuntimeError(f"phase {phase}: non-finite loglik at B = 1")
        unpadded.append(best_perm_sdr(ys, ys_true)[0])
    params_b = batch_params([make_params(0, Npad, i) for i in range(B)])
    X_b = torch.stack([_pad_frames(x, Npad) for x in Xs])
    prof = profile_gem(params_b, X_b, cfg)

    def row(v):
        return " ".join(f"{x:.2f}" for x in v)

    log(f"phase {phase} {case} B={B} (seeds {seeds[0]}-{seeds[-1]}): "
        f"J={clips[0][0].params.n_spat} F={clips[0][0].F} N={N} padded to "
        f"{Npad}, {NITER_CONV} iters, launches {total} {counts}, launch "
        f"widths {sorted(set(widths))}; per-clip min SDR B={B} {row(sdr_b)} | "
        f"B=1 padded {row(sdr1)} | B=1 unpadded (host API) {row(unpadded)}"
        f" | B={B} run {batch_s:.2f}s -> xRT {B * DUR_CONV / batch_s:.2f}; B=1 "
        f"unpadded runs {b1_s:.2f}s -> xRT {B * DUR_CONV / b1_s:.2f}; set-up "
        f"{setup_s:.2f}s | {card} | {time.perf_counter() - t0:.2f}s")
    log(_profile_line(f"phase {phase} profile {case} B={B}", prof, card))
    if total != NITER_CONV or counts[key] != NITER_CONV \
            or widths != [B] * NITER_CONV:
        raise RuntimeError(f"phase {phase}: launches {total} {counts}, "
                           f"widths {sorted(set(widths))} in {NITER_CONV} "
                           f"iterations (expected {NITER_CONV} of variant "
                           f"{key}, each B = {B} wide)")
    floor = SDR_FLOOR[case]
    if any(abs(a - b) > SDR_SLACK for a, b in zip(sdr_b, sdr1)) or any(
            a < floor <= u for a, u in zip(sdr_b, unpadded)):
        raise RuntimeError(f"phase {phase}: per-clip min SDR in the batch "
                           f"{sdr_b} against B = 1 {sdr1} (slack "
                           f"{SDR_SLACK} dB) and unpadded {unpadded} (floor "
                           f"{floor} dB)")
    return counts[key], {"xrt": B * DUR_CONV / batch_s, "profile": prof,
                         "bucket": {"Xs": Xs, "trees": trees, "cfg": cfg,
                                    "images": imgs, "logliks": lls,
                                    "sdrs": sdrs, "sdr": sdr_b}}


def general_i3_case(device):
    """bench.py:223-262's general-I3 row on `device`: (mix (1, T, 3)
    tensor, true images (J, T, 3), initial params)."""
    import torch
    from pyfasst_tpu_torch import convert
    from pyfasst_tpu_torch.tf.stft import _frame_geometry
    rng = np.random.default_rng(3)
    n = int(FS * DUR)
    t = np.arange(n) / FS
    s1 = np.sin(2 * np.pi * (200 * t + 3 * np.sin(2 * np.pi * 0.5 * t)))
    s2 = rng.standard_normal(n) * (np.sin(2 * np.pi * 1.3 * t) > 0)
    ys = np.stack([np.outer(s1, GENERAL_DIRS[0]),
                   np.outer(s2, GENERAL_DIRS[1])])
    mix = ys.sum(0).astype(np.float32)
    scale = np.max(np.abs(mix))
    mix /= scale
    F, N = WLEN // 2 + 1, _frame_geometry(n, WLEN, HOP)[2]
    rngp = np.random.default_rng(0)
    spat = [{"A": (0.4 + np.abs(rngp.standard_normal((3, 1))))
             .astype(np.float32), "mix_type": "inst"} for _ in range(J)]
    spec = [{"FB": (0.5 + rngp.random((F, K))).astype(np.float32),
             "TW": (0.5 + rngp.random((K, N))).astype(np.float32),
             "spat_ind": j} for j in range(J)]
    params = convert.params_from_numpy({"spat": spat, "spec": spec},
                                       device=device)
    return (torch.as_tensor(mix, device=device)[None], ys / scale, params)


def mono_case():
    """tests/test_multichannel.py:71's mono fixture: (mix (T,), s1, s2)."""
    fs, n = 16000, 4 * 16000
    rng = np.random.default_rng(0)
    t = np.arange(n) / fs
    s1 = np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(
        2 * np.pi * 1.3 * t))
    w = rng.standard_normal(n)
    s2 = (w - np.convolve(w, np.ones(8) / 8, "same")) \
        * (np.sin(2 * np.pi * 0.7 * t + 1) > 0) * 0.5
    return (s1 + s2).astype(np.float32), s1, s2


def general_runs(device):
    """Phase 11's two runs on `device`: the general-I3 row (run_gem and
    separate_sources through chip_smoke.pipeline) and the mono fixture
    (the host API). Returns their numbers and the I3 inputs."""
    import torch
    from pyfasst_tpu_torch import MultiChanNMFInst_FASST
    from pyfasst_tpu_torch.tf.stft import sine_window
    from pyfasst_tpu_torch.utils.config import GEMConfig
    mix, ys_true, params = general_i3_case(device)
    window = torch.as_tensor(sine_window(WLEN), dtype=torch.float32,
                             device=device)
    cfg = GEMConfig(niter=NITER)
    t0 = time.perf_counter()
    ys, ll = pipeline(mix, params, cfg, window, mix.shape[1])
    ys = ys[0].cpu().numpy()
    ll = ll[0].cpu().numpy()
    i3_s = time.perf_counter() - t0
    x = mix[0].cpu().numpy()
    out = {"I3": {"min_sdr": best_perm_sdr(ys, ys_true)[0],
                  "residual": float(np.linalg.norm(ys.sum(0) - x)
                                    / np.linalg.norm(x)),
                  "finite": bool(np.all(np.isfinite(ll))),
                  "loglik": (float(ll[0]), float(ll[-1])),
                  "seconds": i3_s}}
    mono, s1, s2 = mono_case()
    t1 = time.perf_counter()
    m = MultiChanNMFInst_FASST(mono[:, None], fs=16000, nbComps=2,
                               nbNMFComps=6, wlen=1024, iter_num=NITER_MONO,
                               seed=0, device=device)
    ll_m = m.estim_param_a_posteriori()
    ym = m.separated_images()

    def sdr(a, b):
        return 10 * np.log10(np.sum(b ** 2)
                             / max(np.sum((a - b) ** 2), 1e-12))

    out["mono"] = {"min_sdr": float(max(
        min(sdr(ym[p[0], :, 0], s1), sdr(ym[p[1], :, 0], s2))
        for p in ((0, 1), (1, 0)))),
        "finite": bool(np.all(np.isfinite(ll_m))),
        "seconds": time.perf_counter() - t1}
    return out, (mix, params, cfg)


def cpu_reference_general():
    """Phase 11's runs on the CPU: the figures CPU_SDR_GENERAL holds."""
    out, _ = general_runs("cpu")
    print(json.dumps(out), flush=True)


def phase_general(device, card):
    """Phase 11: the general-I engine on the card. The general-I3 row and
    the mono fixture: finite loglik, no E-step or spectral kernel launch,
    the images summing back to the mixture (I3), min SDR within SDR_SLACK
    of the port's CPU runs; then a profiler window of the I3 loop."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_spectral
    from pyfasst_tpu_torch.tf.stft import _stft_core, sine_window
    t0 = time.perf_counter()
    _reset_counts()
    out, (mix, params, cfg) = general_runs(device)
    total, counts = _counts()
    spectral = dict(cuda_spectral.LAUNCHES)
    i3, mono = out["I3"], out["mono"]
    window = torch.as_tensor(sine_window(WLEN), dtype=torch.float32,
                             device=device)
    X = _stft_core(mix, window, WLEN, HOP, "fft")
    prof = profile_gem(params, X, cfg)
    log(f"phase 11 general-I3: I=3 F={X.shape[1]} N={X.shape[2]} J={J} "
        f"K={K}, {NITER} iters, loglik {i3['loglik'][0]:.6g} -> "
        f"{i3['loglik'][1]:.6g}, launches E-step {total} {counts}, spectral "
        f"{spectral}, residual {i3['residual']:.3e}, min SDR "
        f"{i3['min_sdr']:.2f} dB (CPU run {CPU_SDR_GENERAL['I3']} dB), "
        f"pipeline {i3['seconds']:.2f}s -> xRT {DUR / i3['seconds']:.2f} "
        f"(first run, B=1); mono: {NITER_MONO} iters, min SDR "
        f"{mono['min_sdr']:.2f} dB (CPU run {CPU_SDR_GENERAL['mono']} dB), "
        f"{mono['seconds']:.2f}s | {card} | {time.perf_counter() - t0:.2f}s")
    log(_profile_line(f"phase 11 profile general-I3 B=1 (of {NITER})", prof,
                      card))
    if not (i3["finite"] and mono["finite"]):
        raise RuntimeError("phase 11: non-finite loglik")
    if total or any(spectral.values()):
        raise RuntimeError(f"phase 11: kernel launches at I != 2: E-step "
                           f"{total}, spectral {spectral}")
    if not i3["residual"] < 5e-2:
        raise RuntimeError(f"phase 11: images do not sum to the mixture "
                           f"(residual {i3['residual']:.3e})")
    for name in ("I3", "mono"):
        cpu = CPU_SDR_GENERAL[name]
        if cpu is None or abs(out[name]["min_sdr"] - cpu) > SDR_SLACK:
            raise RuntimeError(f"phase 11 {name}: min SDR "
                               f"{out[name]['min_sdr']:.2f} dB not within "
                               f"{SDR_SLACK} dB of the CPU run ({cpu})")
    return {"xrt": DUR / i3["seconds"], "profile": prof}


def phase_k_big(device, card):
    """Phase 12: the bench pipeline (B = 8 clips, NITER iterations) at each
    NMF rank of K_BIG (past 32 components: the spectral kernels' tiled
    form) with fuse_spectral, and the same pipeline unfused:
    NITER launches each of fb_stats and tw_stats in the fused run, none in
    the unfused one, every clip over SDR_GATE in both, and the fused
    logliks within MESH_EARLY_RTOL of the unfused run's over the first
    MESH_EARLY_ITERS iterations and K_BIG_DRIFT_RTOL over the run
    (loglik_rel; the kernels sum in another order than cuBLAS). The
    witness of float32 drift: the unfused run in two halves of four clips
    against the whole batch. Then a profiler window (iterations 60-80) of
    the unfused and the fused run at the last K. Returns the fused runs'
    launches by K."""
    import torch
    from pyfasst_tpu_torch import convert
    from pyfasst_tpu_torch.ops import cuda_spectral
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints, run_gem
    from pyfasst_tpu_torch.tf.stft import _stft_core
    from pyfasst_tpu_torch.utils.config import GEMConfig
    t0 = time.perf_counter()
    mix, y_true, window, nsamples, F, N, _ = bench_setup(device, DUR, BATCH)
    X = _stft_core(mix, window, WLEN, HOP, "fft")
    half = BATCH // 2
    bad, launches = [], {}
    for K_ in K_BIG:
        def params(lo=0, hi=BATCH):
            return convert.params_from_numpy(
                [bench_tree(F, N, seed=b, K_=K_) for b in range(lo, hi)],
                device=device)
        runs = {}
        for fuse in (True, False):
            cfg = GEMConfig(niter=NITER, fuse_spectral=fuse)
            _reset_counts()
            t1 = time.perf_counter()
            ys, ll = pipeline(mix, params(), cfg, window, nsamples)
            torch.cuda.synchronize()
            runs[fuse] = {"ll": ll.cpu().numpy(), "sdr": min_sdr(ys, y_true),
                          "spectral": dict(cuda_spectral.LAUNCHES),
                          "estep": _counts()[0],
                          "seconds": time.perf_counter() - t1}
        cfg = GEMConfig(niter=NITER)
        sig = annealing_endpoints(X, cfg)
        wit = np.concatenate([run_gem(
            params(lo, lo + half), X[lo:lo + half].contiguous(), cfg,
            sigma_endpoints=tuple(s_[lo:lo + half].contiguous()
                                  for s_ in sig))[1].cpu().numpy()
            for lo in (0, half)])
        if K_ == K_BIG[-1]:      # where item 7's fuse_spectral choice is
            for label, fuse in (("unfused", False), ("fused", True)):
                prof = profile_gem(params(), X, GEMConfig(
                    niter=NITER, fuse_spectral=fuse))
                log(_profile_line(f"phase 12 profile K={K_} {label} "
                                  f"B={BATCH} (of {NITER})", prof, card))
        fused, unfused = runs[True], runs[False]
        k = MESH_EARLY_ITERS
        early = loglik_rel(fused["ll"][:, :k], unfused["ll"][:, :k])
        whole = loglik_rel(fused["ll"], unfused["ll"])
        witness = loglik_rel(wit, unfused["ll"])
        launches[K_] = fused["spectral"]
        log(f"phase 12 K={K_} B={BATCH} {NITER} iters fuse_spectral: "
            f"launches {fused['spectral']}, E-step {fused['estep']}; per-clip"
            " min SDR " + " ".join(f"{x:.2f}" for x in fused["sdr"])
            + f" ({fused['seconds']:.2f}s) | unfused: launches "
            f"{unfused['spectral']}, min SDR "
            + " ".join(f"{x:.2f}" for x in unfused["sdr"])
            + f" ({unfused['seconds']:.2f}s) | logliks rel fused from "
            f"unfused: first {k} iterations {early:.2e} (<= "
            f"{MESH_EARLY_RTOL:.0e}), the run {whole:.2e} (<= "
            f"{K_BIG_DRIFT_RTOL:.1e}); the witness, unfused in two halves of "
            f"{half} clips: {witness:.2e} | {card}")
        if fused["spectral"] != {"fb_stats": NITER, "tw_stats": NITER} \
                or fused["estep"] != NITER or any(
                    unfused["spectral"].values()):
            bad.append(f"K={K_}: launches fused {fused['spectral']} E-step "
                       f"{fused['estep']}, unfused {unfused['spectral']}")
        for label, r in (("fused", fused), ("unfused", unfused)):
            if not (np.all(np.isfinite(r["ll"])) and np.all(
                    r["sdr"] > SDR_GATE)):
                bad.append(f"K={K_} {label}: per-clip min SDR {r['sdr']} "
                           f"(needs > {SDR_GATE} dB), finite "
                           f"{bool(np.all(np.isfinite(r['ll'])))}")
        if not (early <= MESH_EARLY_RTOL and whole <= K_BIG_DRIFT_RTOL):
            bad.append(f"K={K_}: fused logliks rel {early:.2e} over the "
                       f"first {k} iterations, {whole:.2e} over the run")
    log(f"phase 12 done | {time.perf_counter() - t0:.2f}s")
    if bad:
        raise RuntimeError("phase 12: " + "; ".join(bad))
    return launches


# -- phases 13 and 14: the front-ends and the state models --------------------

def erblet_runs(device):
    """Phase 13's runs on `device`: erblet48 (bench.py:187-220's row
    through the host API) and the short MinQT check. Returns their numbers
    and the erblet48 model."""
    import torch
    from pyfasst_tpu_torch import (
        ERBLetTransform, MinQTransfo, MultiChanNMFInst_FASST,
    )
    from pyfasst_tpu_torch import convert
    mix, y1, y2 = make_mixture()
    ys_true = np.stack([y1, y2])
    out = {}
    t0 = time.perf_counter()
    model = MultiChanNMFInst_FASST(
        mix, fs=FS, nbComps=J, nbNMFComps=K, iter_num=NITER_ERB,
        transform=ERBLetTransform(fs=FS, n_bands=BANDS_ERB, device=device),
        device=device)
    # bench.py's row starts from build_params, not the host API's draw
    model.params = convert.params_from_numpy(bench_tree(model.F, model.N),
                                             device=device)
    setup = time.perf_counter() - t0
    _reset_counts()
    t1 = time.perf_counter()
    ll = model.estim_param_a_posteriori()
    ys = model.separated_images()
    run = time.perf_counter() - t1           # images are on the host
    out["erblet48"] = {"min_sdr": best_perm_sdr(ys, ys_true)[0],
                       "loglik": ll, "seconds": run, "setup": setup,
                       "counts": _counts(), "F": model.F, "N": model.N}
    n = int(FS * DUR_MINQT)
    t2 = time.perf_counter()
    mq = MultiChanNMFInst_FASST(
        mix[:n], fs=FS, nbComps=J, nbNMFComps=K, iter_num=NITER_MINQT,
        transform=MinQTransfo(fs=FS, device=device), device=device)
    _reset_counts()
    ll_mq = mq.estim_param_a_posteriori()
    ys_mq = mq.separated_images()
    out["minqt"] = {"min_sdr": best_perm_sdr(ys_mq, ys_true[:, :n])[0],
                    "loglik": ll_mq, "finite": bool(np.all(np.isfinite(ys_mq))),
                    "shape": ys_mq.shape, "counts": _counts(), "F": mq.F,
                    "N": mq.N, "seconds": time.perf_counter() - t2}
    return out, model


def hmm_mixtures(seed=SEED_HMM):
    """tools/validate_hw.py::scenario_hmm's two mixtures (one rng): the
    state-switching tone and high noise at well-separated directions, and
    _state_switch_fixture's co-located Markov sources. Each (mix, true
    images)."""
    rng = np.random.default_rng(seed)
    n = int(FS_CONV * DUR_CONV)
    s1, s2 = band_sources(rng, n, ["tone_switch", "noise_hi"])
    A = np.array([[0.9, 0.35], [0.35, 0.9]])
    ys_true = np.stack([np.outer(s1, A[:, 0]), np.outer(s2, A[:, 1])])
    t = np.arange(n) / FS_CONV

    def markov_states(dwell_s, n_states):
        out = np.zeros(n, int)
        pos = 0
        q = rng.integers(n_states)
        while pos < n:
            d = int(FS_CONV * rng.uniform(0.7 * dwell_s, 1.3 * dwell_s))
            out[pos:pos + d] = q
            pos += d
            q = (q + rng.integers(1, n_states)) % n_states
        return out

    def tone(f0, harmonics):
        x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
                / h for h in harmonics)
        return x / np.max(np.abs(x))

    def noiseband(lo, hi):
        x = rng.standard_normal(n)
        Xf = np.fft.rfft(x)
        f = np.fft.rfftfreq(n, 1 / FS_CONV)
        Xf[(f < lo) | (f > hi)] = 0
        x = np.fft.irfft(Xf, n)
        return x / np.max(np.abs(x))

    TA = [tone(250, [2, 6, 10]), tone(330, [1, 3, 5])]
    TB = [tone(250, [2, 8, 14]), noiseband(900, 1800)]
    sA = np.where(markov_states(0.45, 2) == 0, TA[0], TA[1])
    sB = np.where(markov_states(0.6, 2) == 0, TB[0], TB[1])
    aA = np.array([np.cos(np.deg2rad(35)), np.sin(np.deg2rad(35))])
    aB = np.array([np.cos(np.deg2rad(60)), np.sin(np.deg2rad(60))])
    ys2 = np.stack([sA[:, None] * aA, sB[:, None] * aB])
    return ((ys_true.sum(0), ys_true),
            (ys2.sum(0).astype(np.float32), ys2))


def vibrato_mixture(seed=0, fs=FS_CONV, dur=3.0):
    """tests/test_lead.py::_vibrato_mixture: a vibrato harmonic lead over a
    low-passed noise and drone accompaniment, panned apart. Returns (mix,
    true lead image, true accompaniment image)."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    f0 = 220 * 2 ** (0.25 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    lead = sum((0.5 / h) * np.sin(h * phase) for h in range(1, 6))
    acc = lfilter([1], [1, -0.95], 0.05 * rng.standard_normal(n))
    acc += 0.15 * np.sin(2 * np.pi * 110 * t)
    y_lead = np.stack([0.8 * lead, 0.6 * lead], axis=1)
    y_acc = np.stack([0.7 * acc, 0.8 * acc], axis=1)
    return (y_lead + y_acc).astype(np.float32), y_lead, y_acc


def hmm_runs(device):
    """Phase 14's runs on `device`: configs[3]'s two rows (the 6-state HMM;
    the co-located 2-state Viterbi HMM beside the equal-K NMF), the
    source-filter model and the lead pipeline. Each with its min SDR, its
    E-step launches and its seconds; and the first row's model."""
    from pyfasst_tpu_torch import (
        MultiChanHMM, MultiChanNMFInst_FASST, SeparateLeadStereoTF,
        multiChanSourceF0Filter,
    )
    (mix, ys_true), (mix2, ys2_true) = hmm_mixtures()
    out = {}

    def drive(name, model, truth):
        _reset_counts()
        t0 = time.perf_counter()
        ll = model.estim_param_a_posteriori()
        ys = model.separated_images()
        out[name] = {"min_sdr": best_perm_sdr(ys, truth)[0], "loglik": ll,
                     "counts": _counts(),
                     "seconds": time.perf_counter() - t0,
                     "F": model.F, "N": model.N}
        return model

    first = drive("hmm", MultiChanHMM(
        mix, fs=FS_CONV, nbComps=2, nbStates=6, wlen=WLEN_CONV,
        iter_num=NITER_HMM, sparsity="HMM", device=device), ys_true)
    kw = dict(fs=FS_CONV, wlen=512, iter_num=NITER_HMM, nbComps=2, seed=0,
              device=device)
    # from the recipe's own seed-0 draw (the JAX package's jax.random
    # numbers, utils/prng.py)
    drive("hmm_hard", MultiChanHMM(mix2, nbStates=2, sparsity="HMM",
                                   self_trans=0.97, decode="viterbi", **kw),
          ys2_true)
    drive("nmf_hard", MultiChanNMFInst_FASST(mix2, nbNMFComps=2, **kw),
          ys2_true)
    vmix, y_lead, y_acc = vibrato_mixture()
    truth = np.stack([y_lead, y_acc])
    drive("simm", multiChanSourceF0Filter(
        vmix, fs=FS_CONV, nbComps=2, nbNMFComps=4, wlen=WLEN_CONV, n_f0=60,
        f0_min=100, f0_max=500, iter_num=NITER_SIMM, device=device), truth)
    _reset_counts()
    t0 = time.perf_counter()
    sep = SeparateLeadStereoTF(audio=vmix, fs=FS_CONV, wlen=WLEN_CONV,
                               niter=NITER_LEAD, n_f0=80, f0_min=100,
                               f0_max=500, device=device)
    melody = sep.runDecomposition()
    lead, acc = sep.separated_signals()
    out["lead"] = {"min_sdr": best_perm_sdr(np.stack([lead, acc]),
                                            truth)[0],
                   "melody_frames": int(melody.shape[0]), "N": sep.N,
                   "counts": _counts(),
                   "seconds": time.perf_counter() - t0}
    return out, first


def cpu_reference_slice():
    """Phases 13 and 14 on the CPU: the figures CPU_SDR_SLICE holds."""
    import torch
    print(f"threads {torch.get_num_threads()}", flush=True)
    erb, _ = erblet_runs("cpu")
    hmm, _ = hmm_runs("cpu")
    print(json.dumps({k: {"min_sdr": v["min_sdr"], "seconds": v["seconds"]}
                      for k, v in {**erb, **hmm}.items()}), flush=True)


def _within_cpu(phase, name, sdr):
    cpu = CPU_SDR_SLICE[name]
    if cpu is None or abs(sdr - cpu) > SDR_SLACK:
        raise RuntimeError(f"phase {phase} {name}: min SDR {sdr:.2f} dB not "
                           f"within {SDR_SLACK} dB of the CPU run ({cpu})")


def phase_erblet(device, card):
    """Phase 13: erblet48 on the card (200 launches of estep_r1_real at
    F = 48, N = 98304; min SDR within SDR_SLACK of the CPU run; a profile
    window; xRT) and the short MinQT check (one launch per iteration,
    finite images of the clip's shape). Returns the erblet48 launches and
    profile."""
    t0 = time.perf_counter()
    out, model = erblet_runs(device)
    e, mq = out["erblet48"], out["minqt"]
    prof = profile_gem(model.params, model.Xs, model.cfg)
    total, counts = e["counts"]
    log(f"phase 13 erblet48: F={e['F']} N={e['N']} J={J} K={K}, "
        f"{NITER_ERB} iters, loglik {e['loglik'][0]:.6g} -> "
        f"{e['loglik'][-1]:.6g}, launches {total} {counts}, min SDR "
        f"{e['min_sdr']:.2f} dB (CPU run {CPU_SDR_SLICE['erblet48']} dB), "
        f"run {e['seconds']:.2f}s -> xRT {DUR / e['seconds']:.2f} (first "
        f"run, B=1; set-up {e['setup']:.2f}s) | minqt: F={mq['F']} "
        f"N={mq['N']}, {NITER_MINQT} iters, loglik {mq['loglik'][0]:.6g} -> "
        f"{mq['loglik'][-1]:.6g}, launches {mq['counts'][0]}, min SDR "
        f"{mq['min_sdr']:.2f} dB, {mq['seconds']:.2f}s | {card} | "
        f"{time.perf_counter() - t0:.2f}s")
    log(_profile_line(f"phase 13 profile erblet48 B=1 (of {NITER_ERB})",
                      prof, card))
    if (e["F"], e["N"]) != ERB_SHAPE[2:]:
        raise RuntimeError(f"phase 13: F, N = {e['F']}, {e['N']}, but phase "
                           f"2 checked the path's shape at {ERB_SHAPE}")
    if total != NITER_ERB or counts["a"] != NITER_ERB:
        raise RuntimeError(f"phase 13: {total} kernel launches ({counts}) "
                           f"in {NITER_ERB} iterations")
    if not np.all(np.isfinite(e["loglik"])):
        raise RuntimeError("phase 13: non-finite loglik")
    _within_cpu(13, "erblet48", e["min_sdr"])
    if not (np.all(np.isfinite(mq["loglik"])) and mq["finite"]
            and mq["counts"][0] == NITER_MINQT
            and mq["shape"] == (J, int(FS * DUR_MINQT), 2)):
        raise RuntimeError(f"phase 13 minqt: launches {mq['counts']}, "
                           f"images {mq['shape']} finite {mq['finite']}")
    return counts["a"], prof


def phase_hmm(device, card):
    """Phase 14: configs[3] on the card: both rows, the source-filter model
    and the lead pipeline; each model's E-step through estep_r1_real (one
    launch per iteration), the lead pipeline with no E-step launch; every
    min SDR within SDR_SLACK of the CPU run; a profile window of the
    6-state HMM (kernels per iteration: the forward-backward recursion
    enqueues ~10 per frame and pass). Returns the launches and profile."""
    t0 = time.perf_counter()
    out, model = hmm_runs(device)
    # 5 iterations, not 20 (cut for the run's time): each enqueues ~9,270
    # kernels, so the window still holds ~46,000 device events
    prof = profile_gem(model.params, model.Xs, model.cfg, stop=65)
    niter = {"hmm": NITER_HMM, "hmm_hard": NITER_HMM, "nmf_hard": NITER_HMM,
             "simm": NITER_SIMM, "lead": 0}
    parts = []
    for name, r in out.items():
        total, counts = r["counts"]
        parts.append(f"{name}: min SDR {r['min_sdr']:.2f} dB (CPU run "
                     f"{CPU_SDR_SLICE[name]} dB), launches {total}, "
                     f"{r['seconds']:.2f}s")
        if total != niter[name] or counts["a"] != niter[name]:
            raise RuntimeError(f"phase 14 {name}: launches {total} {counts} "
                               f"(expected {niter[name]} of variant a)")
        if "loglik" in r and not np.all(np.isfinite(r["loglik"])):
            raise RuntimeError(f"phase 14 {name}: non-finite loglik")
    h = out["hmm"]
    log(f"phase 14 configs[3]: HMM 6 states F={h['F']} N={h['N']} "
        f"{NITER_HMM} iters, loglik {h['loglik'][0]:.6g} -> "
        f"{h['loglik'][-1]:.6g}; " + "; ".join(parts)
        + f"; hard row N={out['hmm_hard']['N']} | {card} | "
        f"{time.perf_counter() - t0:.2f}s")
    log(_profile_line(f"phase 14 profile configs[3] HMM B=1 (of {NITER_HMM})",
                      prof, card, "iterations 60-65, per iteration"))
    for name, r in out.items():
        if name != "hmm_hard":
            _within_cpu(14, name, r["min_sdr"])
    hard, nmf = out["hmm_hard"]["min_sdr"], out["nmf_hard"]["min_sdr"]
    if not (hard >= HARD_FLOOR and hard >= nmf + HARD_MARGIN):
        raise RuntimeError(f"phase 14 hmm_hard: min SDR {hard:.2f} dB, "
                           f"equal-K NMF {nmf:.2f} dB (needs {HARD_FLOOR} "
                           f"dB and {HARD_MARGIN} dB above the NMF)")
    return {k: r["counts"][1]["a"] for k, r in out.items()}, prof


# -- phase 15: streaming separation and the blind mono init -------------------

def stream_kernel_check(device):
    """Variant b at the streaming path's shape STREAM_SHAPE (J = 2, complex
    rank-1 mixing, one block of 64 frames): against its plain version at
    the E-step bars and two runs bit for bit; kernel and plain timed in
    turns, with the bound and the float32 floor without FMA."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_estep
    B, J_, F, N = STREAM_SHAPE
    ranks = (1,) * J_
    inp = _general_inputs(B, J_, F, N, ranks, False, seed=F * N + J_,
                          device=device)
    kw = dict(ns_inj=False, real_cov=False)

    def kernel():
        return cuda_estep.estep_general(*inp, ranks, **kw)

    def plain():
        return cuda_estep.estep_ref(*inp, ranks, **kw)

    got, want, again = kernel(), plain(), kernel()
    torch.cuda.synchronize()
    errs, abs_err = _estep_errors(got, want)
    kern, ref = _turns(kernel, plain)
    ops = general_ops(inp, ranks, **kw)
    b_ms, b_by, nbytes = bound(list(inp) + list(got), ops)
    nums = {"shape": list(STREAM_SHAPE), "max_abs_err": abs_err,
            "ms": statistics.median(kern), "plain_ms": statistics.median(ref),
            "bound_ms": b_ms, "bound_by": b_by,
            "nofma_floor_ms": ops / FP32_NOFMA_OPS_PER_S * 1e3}
    log(f"phase 2 b complex J=2 rank 1 at the streaming shape B,J,F,N="
        f"{STREAM_SHAPE}: " + " ".join(f"{n} {e:.2e}<={TOL[n]:.0e}"
                                       for n, e in errs.items())
        + f" | max_abs_err {abs_err:.3e} | kernel {nums['ms']:.4f} ms (min "
        f"{min(kern):.4f}), plain {nums['plain_ms']:.3f} ms (min "
        f"{min(ref):.3f}), medians in turns | bound {b_ms:.4f} ms by {b_by} "
        f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} Gop; without FMA "
        f"{nums['nofma_floor_ms']:.4f} ms) | {B * F} blocks")
    bad = [n for n, e in errs.items() if not e <= TOL[n]]
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        bad.append("two runs differ")
    if bad:
        raise RuntimeError(f"variant b disagrees with its plain version at "
                           f"the streaming shape {STREAM_SHAPE}: {bad}")
    return nums


def stream_mixture(seed=SEED_STREAM):
    """scenario_streaming's mixture, scaled as the recipe scales it:
    (mix (T, 2), true images (2, T, 2))."""
    rng = np.random.default_rng(seed)
    n = int(FS_CONV * DUR_STREAM)
    s1, s2 = band_sources(rng, n, ["band:0.02-0.3", "band:0.25-0.8"])
    A = np.array([[0.95, 0.31], [0.31, 0.95]])
    ys = np.stack([np.outer(s1, A[:, 0]), np.outer(s2, A[:, 1])])
    mix = ys.sum(0)
    return (mix / (np.max(np.abs(mix)) * 1.05),
            ys / (np.max(np.abs(ys.sum(0))) * 1.05))


def stream_fullrank_mixture(seed=SEED_STREAM_FR):
    """scenario_streaming_fullrank's mixture: each source two decorrelated
    same-band signals at two pannings (rank-2 per bin)."""
    rng = np.random.default_rng(seed)
    n = int(FS_CONV * DUR_STREAM_FR)
    s1a, s1b = band_sources(rng, n, ["band:0.02-0.3", "band:0.02-0.3"])
    s2a, s2b = band_sources(rng, n, ["band:0.25-0.8", "band:0.25-0.8"])
    pans = ((np.array([0.95, 0.31]), np.array([0.55, -0.45])),
            (np.array([0.31, 0.95]), np.array([-0.45, 0.55])))
    ys = np.stack([np.outer(a, p[0]) + 0.6 * np.outer(b, p[1])
                   for (a, b), p in zip(((s1a, s1b), (s2a, s2b)), pans)])
    sc = np.max(np.abs(ys.sum(0))) * 1.05
    return ys.sum(0) / sc, ys / sc


def blind_mono_mixture(seed=SEED_MONO):
    """scenario_general_I's mono row (its rng draws the 3-channel row's
    sources first): (mix (T, 1) float32, true images (2, T, 1))."""
    rng = np.random.default_rng(seed)
    n = int(FS_CONV * DUR_CONV)
    band_sources(rng, n, ["harm", "noise_hi"])
    s1, s2 = band_sources(rng, n, ["harm", "noise_lo"])
    ys = np.stack([s1[:, None], s2[:, None]])
    return ys.sum(0).astype(np.float32), ys


def stream_host_loop(path, ys_true, device):
    """scenario_streaming's first row on `device`: the full blocks of the
    WAV through the host-driven online_block loop from the default
    directions (pass 1), then again under the frozen parameters with each
    block Wiener-separated (pass 2); the separated blocks inverted once and
    scored inside the streamed region. Returns its numbers and the inputs
    of profile_stream."""
    import torch
    from pyfasst_tpu_torch.models.components import (
        CONV, FasstParams, SpatialComp, SpectralComp, init_inst_mixing,
    )
    from pyfasst_tpu_torch.ops.online import online_block, online_init
    from pyfasst_tpu_torch.ops.wiener import separate_sources
    from pyfasst_tpu_torch.tf.stft import STFT
    tft = STFT(wlen=WLEN_CONV, fs=FS_CONV, device=device)
    F, Nb = tft.F, NB_STREAM
    A0 = torch.stack([
        torch.as_tensor(a.numpy()[:, 0]).to(torch.complex64).expand(F, 2)
        for a in init_inst_mixing(None, 2, 1, J)]).to(device)[None]
    rng = np.random.default_rng(7)
    FB0 = torch.as_tensor((0.5 + rng.random((J, F, K_STREAM)))
                          .astype(np.float32), device=device)[None]
    TW0 = torch.as_tensor((0.5 + rng.random((J, K_STREAM, Nb)))
                          .astype(np.float32), device=device)[None]
    t0 = time.perf_counter()
    blocks = [Xb[None] for Xb in tft.stream_blocks(path, Nb)
              if Xb.shape[1] == Nb]                  # the ragged tail out
    sigma = torch.full((1, F), NOISE_STREAM * float(
        torch.mean(blocks[0].abs() ** 2)), dtype=torch.float32,
        device=device)
    read_s = time.perf_counter() - t0
    step = dict(forgetting=FORGET_STREAM, inner_iters=INNER_STREAM)

    def sep_block(state, TWb, Xb):
        spat = tuple(SpatialComp(A=state.A[:, j][..., None], mix_type=CONV)
                     for j in range(J))
        spec = tuple(SpectralComp(FB=state.FB[:, j], TW=TWb[:, j],
                                  spat_ind=j) for j in range(J))
        return separate_sources(FasstParams(spat=spat, spec=spec), Xb,
                                sigma)[0]

    _reset_counts()
    t1 = time.perf_counter()
    state = online_init(A0, FB0)
    lls = []
    for Xb in blocks:                                 # pass 1: learn A, FB
        state, (_, ll) = online_block(state, Xb, TW0, sigma, **step)
        lls.append(ll)
    outs = []
    for Xb in blocks:                                 # pass 2: frozen
        _, (TWb, _) = online_block(state, Xb, TW0, sigma, **step)
        outs.append(sep_block(state, TWb, Xb))
    if device.type == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    counts = _counts()
    lls = torch.cat(lls).cpu().numpy()
    n = ys_true.shape[1]
    Y = torch.cat(outs, dim=2)                        # (J, F, frames, 2)
    Y = torch.nn.functional.pad(Y, (0, 0, 0, tft.n_frames(n) - Y.shape[2]))
    n_sep = min(n, len(blocks) * Nb * tft.hop - tft.wlen)
    ys = tft.invertTransform(Y, nsamples=n).cpu().numpy()[:, :n_sep]
    return ({"min_sdr": best_perm_sdr(ys, ys_true[:, :n_sep])[0],
             "seconds": run_s, "read_seconds": read_s, "counts": counts,
             "steps": 2 * len(blocks), "blocks": len(blocks),
             "loglik": lls, "n_sep": n_sep,
             "plane_bytes": F * tft.n_frames(n) * 2 * 8},
            (blocks, A0, FB0, TW0, sigma))


def stream_window(blocks, A0, FB0, TW0, sigma, start=10, stop=20):
    """(window, steps): block steps [start, stop) of the host loop's pass
    1, from the state its first `start` blocks reach."""
    from pyfasst_tpu_torch.ops.online import online_block, online_init
    step = dict(forgetting=FORGET_STREAM, inner_iters=INNER_STREAM)
    state0 = online_init(A0, FB0)
    for Xb in blocks[:start]:
        state0, _ = online_block(state0, Xb, TW0, sigma, **step)

    def window():
        state = state0
        for Xb in blocks[start:stop]:
            state, _ = online_block(state, Xb, TW0, sigma, **step)

    return window, stop - start


def stream_runs(device, tmp, resume=False):
    """Phase 15's rows on `device`, each from its WAV in `tmp`: the host
    loop and separate_streaming(init="blind") on the 120 s stream (with the
    peak device memory of the latter), with resume=True the estimate_blocks
    cut and resume beside the uninterrupted run, the full-rank row and its
    rank-1 twin, and the blind mono row. Returns the rows' numbers and, on
    the card, profile windows by label ((window, steps): 10 block steps of
    the host loop's pass 1; the whole full-rank stream, per block step of
    both passes; 20 iterations of the blind mono fit)."""
    import torch
    from pyfasst_tpu_torch import MultiChanNMFInst_FASST, separate_streaming
    from pyfasst_tpu_torch.audio import wavwrite
    from pyfasst_tpu_torch.tf.stft import _frame_geometry
    cuda = device.type == "cuda"

    def blocks_of(n):
        return -(-_frame_geometry(n, WLEN_CONV, WLEN_CONV // 2)[2]
                 // NB_STREAM)

    recipe = dict(J=J, K=K_STREAM, wlen=WLEN_CONV, frames_per_block=NB_STREAM,
                  forgetting=FORGET_STREAM, inner_iters=INNER_STREAM,
                  verbose=0, device=device)

    def run(path, ys_true, n_sep=None, **kw):
        _reset_counts()
        t0 = time.perf_counter()
        ys, info = separate_streaming(path, **recipe, **kw)
        seconds = time.perf_counter() - t0
        sl = slice(None, n_sep)
        return ys, info, {
            "min_sdr": best_perm_sdr(ys[:, sl], ys_true[:, sl])[0],
            "seconds": seconds, "parts": info["seconds"],
            "counts": _counts(), "blocks": info["blocks"],
            "pass2_blocks": blocks_of(ys_true.shape[1]),
            "loglik": np.asarray(info["logliks"]),
            "rank": info["spatial_rank"]}

    out = {}
    mix, ys_true = stream_mixture()
    path = os.path.join(tmp, "stream.wav")
    wavwrite(mix, FS_CONV, path)
    out["stream"], loop = stream_host_loop(path, ys_true, device)
    n_sep = out["stream"]["n_sep"]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    _, info, out["blind"] = run(path, ys_true, n_sep, init="blind",
                                out_dir=os.path.join(tmp, "blind"))
    out["blind"]["wavs"] = len(info["files"])
    out["blind"]["peak_bytes"] = (torch.cuda.max_memory_allocated() - base
                                  if cuda else None)
    if resume:
        ys_u, info_u, out["random"] = run(path, ys_true, n_sep)
        ck = os.path.join(tmp, "stream_ck.npz")
        _, info_c, _ = run(path, ys_true, n_sep, checkpoint_path=ck,
                           checkpoint_every=STREAM_CK_EVERY,
                           estimate_blocks=STREAM_CUT)
        ys_r, info_r, _ = run(path, ys_true, n_sep, checkpoint_path=ck,
                              checkpoint_every=STREAM_CK_EVERY)
        out["resume"] = {
            "equal": bool(np.array_equal(ys_r, ys_u)
                          and info_r["logliks"] == info_u["logliks"]),
            "cut": info_c["blocks"], "resumed_at": info_r["resumed_at"],
            "blocks": (info_r["blocks"], info_u["blocks"])}
    mix_fr, ys_fr = stream_fullrank_mixture()
    path_fr = os.path.join(tmp, "stream_fr.wav")
    wavwrite(mix_fr, FS_CONV, path_fr)
    _, _, out["fullrank"] = run(path_fr, ys_fr, spatial_rank=-1)
    _, _, out["fullrank_r1"] = run(path_fr, ys_fr, spatial_rank=1)
    fr = out["fullrank"]
    mix_m, ys_m = blind_mono_mixture()
    _reset_counts()
    t0 = time.perf_counter()
    m = MultiChanNMFInst_FASST(mix_m, fs=FS_CONV, nbComps=2, nbNMFComps=6,
                               wlen=WLEN_CONV, iter_num=NITER_BLIND_MONO,
                               seed=0, device=device)
    ll = m.estim_param_blind_mono()
    ys = m.separated_images()
    out["mono"] = {"min_sdr": best_perm_sdr(ys, ys_m)[0],
                   "seconds": time.perf_counter() - t0, "counts": _counts(),
                   "loglik": ll}
    if not cuda:
        return out, {}
    return out, {
        "stream 120 s pass 1, block steps 10-20, per block step":
            stream_window(*loop),
        "stream 60 s full rank, both passes, per block step": (
            lambda: separate_streaming(path_fr, spatial_rank=-1, **recipe),
            fr["blocks"] + fr["pass2_blocks"]),
        f"blind mono (of {NITER_BLIND_MONO}), iterations 60-80, per "
        "iteration": gem_window(m.params, m.Xs, m.cfg)}


def cpu_reference_stream():
    """Phase 15's rows on the CPU (the figures its gates compare with)."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        out, _ = stream_runs(torch.device("cpu"), tmp)
    print(json.dumps({k: {"min_sdr": v["min_sdr"], "seconds": v["seconds"]}
                      for k, v in out.items()}), flush=True)


def phase_stream(device, card):
    """Phase 15: the long-form rows on the card. Gates:
    variant b launched 7 times per block step of every rank-1 stereo row
    (pass 1 and pass 2) and nothing else launched; no launch in the
    full-rank and mono rows; the resumed stream equal to the uninterrupted
    one bit for bit; finite logliks; every row's min SDR within SDR_SLACK
    of the CPU run (CPU_SDR_STREAM). Prints the streams' xRT, the profile
    window and the peak device memory of the bounded path beside the full
    plane's bytes. Returns the host loop's variant-b launches and the
    profile."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        card_rows, windows = stream_runs(device, tmp, resume=True)
        profs = {label: _profile(*w) for label, w in windows.items()}
        del windows
    card_s = time.perf_counter() - t0
    cpu_rows = {k: {"min_sdr": v} for k, v in CPU_SDR_STREAM.items()}
    per_step = INNER_STREAM + 1
    s, b = card_rows["stream"], card_rows["blind"]
    b_run = b["parts"]["pass1"] + b["parts"]["pass2"]
    log(f"phase 15 stream {DUR_STREAM:.0f} s host loop: {s['blocks']} blocks"
        f" of {NB_STREAM} frames, {s['steps']} block steps, launches "
        f"{s['counts'][0]} {s['counts'][1]}, loglik {s['loglik'][0]:.6g} -> "
        f"{s['loglik'][-1]:.6g}, min SDR {s['min_sdr']:.2f} dB (CPU run "
        f"{cpu_rows['stream']['min_sdr']:.2f} dB), both passes "
        f"{s['seconds']:.2f}s -> stream xRT {DUR_STREAM / s['seconds']:.2f} "
        f"(reading the blocks {s['read_seconds']:.2f}s apart) | {card}")
    log(f"phase 15 stream blind (separate_streaming, DEMIX on the first 12 "
        f"s): blocks {b['blocks']} + {b['pass2_blocks']}, launches "
        f"{b['counts'][0]}, min SDR {b['min_sdr']:.2f} dB (CPU run "
        f"{cpu_rows['blind']['min_sdr']:.2f} dB), init {b['parts']['init']:.2f}"
        f"s (host), pass 1 {b['parts']['pass1']:.2f}s, pass 2 "
        f"{b['parts']['pass2']:.2f}s -> stream xRT {DUR_STREAM / b_run:.2f} "
        f"(init apart), wavs {b['wavs']} | peak device memory "
        + (f"{b['peak_bytes'] / 1e6:.1f} MB" if b["peak_bytes"] is not None
           else "not measured")
        + f" above the run's start, the full (F, N, I) plane "
        f"{s['plane_bytes'] / 1e6:.1f} MB | {card}")
    r = card_rows["resume"]
    log(f"phase 15 stream resume: cut after block {r['cut']} (checkpoints "
        f"every {STREAM_CK_EVERY}), resumed at {r['resumed_at']}, blocks "
        f"{r['blocks'][0]} (uninterrupted {r['blocks'][1]}), equal to the "
        f"uninterrupted run bit for bit {r['equal']}; uninterrupted random "
        f"init min SDR {card_rows['random']['min_sdr']:.2f} dB")
    for name, label in (("fullrank", "full rank (spatial_rank=-1)"),
                        ("fullrank_r1", "its rank-1 twin")):
        f = card_rows[name]
        log(f"phase 15 stream {DUR_STREAM_FR:.0f} s {label}: rank "
            f"{f['rank']}, blocks {f['blocks']} + {f['pass2_blocks']}, "
            f"launches {f['counts'][0]}, min SDR {f['min_sdr']:.2f} dB (CPU "
            f"run {cpu_rows[name]['min_sdr']:.2f} dB), {f['seconds']:.2f}s "
            f"-> stream xRT {DUR_STREAM_FR / f['seconds']:.2f} | {card}")
    mo = card_rows["mono"]
    log(f"phase 15 blind mono (estim_param_blind_mono, K = 6, "
        f"{NITER_BLIND_MONO} iters): launches {mo['counts'][0]}, loglik "
        f"{mo['loglik'][0]:.6g} -> {mo['loglik'][-1]:.6g}, min SDR "
        f"{mo['min_sdr']:.2f} dB (CPU run {cpu_rows['mono']['min_sdr']:.2f} "
        f"dB), {mo['seconds']:.2f}s | {card}")
    for label, prof in profs.items():
        name, window = label.split(", ", 1)
        log(_profile_line(f"phase 15 profile {name}", prof, card, window))
    log(f"phase 15 done | {card_s:.2f}s")
    bad = []
    for name, steps in (("stream", s["steps"]),
                        ("blind", b["blocks"] + b["pass2_blocks"]),
                        ("fullrank_r1", card_rows["fullrank_r1"]["blocks"]
                         + card_rows["fullrank_r1"]["pass2_blocks"])):
        total, counts = card_rows[name]["counts"]
        want = per_step * steps
        if total != want or counts["b"] != want or any(
                v for k, v in counts.items() if k != "b"):
            bad.append(f"{name}: launches {total} {counts}, expected {want} "
                       f"of variant b")
    for name in ("fullrank", "mono"):
        if card_rows[name]["counts"][0]:
            bad.append(f"{name}: {card_rows[name]['counts'][0]} E-step "
                       f"launches (expected none)")
    if card_rows["fullrank"]["rank"] != 2:
        bad.append("fullrank: not the full-rank path")
    if not (r["equal"] and r["cut"] == STREAM_CUT
            and r["resumed_at"] == STREAM_CUT):
        bad.append(f"resume: {r}")
    for name, row in card_rows.items():
        if "loglik" in row and not np.all(np.isfinite(row["loglik"])):
            bad.append(f"{name}: non-finite loglik")
        cpu = cpu_rows.get(name)
        if cpu and abs(row["min_sdr"] - cpu["min_sdr"]) > SDR_SLACK:
            bad.append(f"{name}: min SDR {row['min_sdr']:.2f} dB not within "
                       f"{SDR_SLACK} dB of the CPU run "
                       f"({cpu['min_sdr']:.2f} dB)")
    if bad:
        raise RuntimeError("phase 15: " + "; ".join(bad))
    return s["counts"][1]["b"], profs


def blind_model(device, niter=None):
    """(model, true images) of phase 16's recipe on `device` (NITER_CONV
    iterations unless `niter`): the configs[2] mixture and model, left at
    the model's own init (the blind pipeline replaces it)."""
    from pyfasst_tpu_torch import MultiChanNMFConv
    mix, ys_true = reverb_mixture()
    model = MultiChanNMFConv(mix, fs=FS_CONV, nbComps=4, nbNMFComps=6,
                             spatial_rank=2, wlen=WLEN_CONV,
                             iter_num=niter or NITER_CONV,
                             spatial_hold_frac=0.3, device=device)
    return model, ys_true


def drive_blind(model, ys_true, out_dir, verbose=False):
    """The blind pipeline, WAVs written, scored: (info, (min, mean) SDR,
    wall seconds by stage, WAV paths)."""
    import torch
    t0 = time.perf_counter()
    info = model.estim_param_blind_reverb(learned=True, select="learned",
                                          verbose=verbose)
    t1 = time.perf_counter()
    paths = model.separate_spat_comps(out_dir)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    sdr = best_perm_sdr(model.separated_images(), ys_true)
    split = dict(info["stage_seconds"], separation=t2 - t1, total=t2 - t0)
    return info, sdr, split, paths


def cpu_reference_blind():
    """Phase 16's whole recipe on the CPU (each run's record is printed as
    its chunk ends); ~50-60 min of an H100 machine's host."""
    import torch
    model, ys_true = blind_model("cpu")
    with tempfile.TemporaryDirectory() as tmp:
        info, sdr, split, _ = drive_blind(model, ys_true, tmp, verbose=True)
    print(json.dumps({"min_sdr": sdr[0], "mean_sdr": sdr[1],
                      "picked": info["picked"],
                      "history": [h["picked"] for h in info["history"]],
                      "pool": info["history"][0]["pool"],
                      "seconds": split, "threads": torch.get_num_threads()}),
          flush=True)


def embed_device_check(device):
    """Reduced-depth check of the alignment's device path: the graph build
    and Lanczos (_embed_nodes_device) against the host path's dense eigh
    at EMBED_CHECK, on three sources with distinct envelopes under planted
    per-frequency permutations (tests/test_spatial_init.py:372's problem,
    wider): each path must undo the permutations into one relabeling.
    Returns the two paths' seconds."""
    import torch
    from pyfasst_tpu_torch.models import spatial_init as si
    F, J_, N = EMBED_CHECK
    rng = np.random.default_rng(F * J_)
    base = np.stack([1.0 + 0.9 * np.sin(2 * np.pi * np.arange(N) / p)
                     for p in (7.0, 13.0, 29.0)])
    perms = np.stack([rng.permutation(J_) for _ in range(F)])
    act = base[perms] * rng.uniform(0.5, 2.0, (F, 1, 1))
    act += 0.05 * rng.uniform(size=act.shape)
    seconds, ok = {}, {}
    for name in ("host", "device"):
        t0 = time.perf_counter()
        if name == "host":
            lim = si._EMBED_DEVICE_MIN_NODES
            si._EMBED_DEVICE_MIN_NODES = F * J_
            try:
                U, npow = si._embed_nodes(act, None)
            finally:
                si._EMBED_DEVICE_MIN_NODES = lim
        else:
            U, npow = si._embed_nodes(act, None, device=device)
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        cent = si._spherical_kmeans(U, npow, J_, seed=0)
        sel = si._assignment_from_embedding(U, cent, F, J_)
        comp = np.take_along_axis(perms, sel, axis=1)
        ok[name] = float((comp == comp[0]).all(axis=1).mean())
    log(f"phase 16 reduced-depth check _embed_nodes_device F*J={F * J_} "
        f"(F={F}, J={J_}, N={N}): planted permutations undone on "
        f"{ok['device']:.4f} of frequencies (host eigh {ok['host']:.4f}); "
        f"device {seconds['device']:.2f}s, host {seconds['host']:.2f}s")
    if ok != {"host": 1.0, "device": 1.0}:
        raise RuntimeError(f"phase 16: _embed_nodes_device check {ok}")
    return seconds


def ladder_checks(device, card):
    """Reduced-depth checks of two paths on phase 16's mixture (each named
    as such): the band-EM candidate (band_em=32: its probes, 150
    iterations over every (band, seed) run in one batch, then a pool of
    NITER_LADDER iterations, em_seeds 1, no reseed) and the multiscale
    ladder (multiscale_wlen=512 on the model's wlen-1024 grid,
    NITER_LADDER iterations, em_seeds 1, no reseed). Gates: finite
    images, every E-step launch of variant c, as many as the stages'
    iterations. Returns the launches."""
    t0 = time.perf_counter()
    out = {}
    for name, kw in (("band_em=32", dict(band_em=32)),
                     ("multiscale_wlen=512", dict(multiscale_wlen=512))):
        model, _ = blind_model(device, NITER_LADDER)
        t1 = time.perf_counter()
        _reset_counts()
        info = model.estim_param_blind_reverb(em_seeds=1, reseed_rounds=0,
                                              **kw)
        total, counts = _counts()
        ys = model.separated_images()
        secs = time.perf_counter() - t1
        stages = [info["history"][0]["pool"]] + (
            [info["fine"]["history"][0]["pool"]] if "fine" in info else [])
        chunks = sum(-(-r // POOL_CHUNK) for r in stages)
        want = NITER_LADDER * chunks + (BAND_PROBE_ITERS if "band_em" in kw
                                        else 0)
        log(f"phase 16 reduced-depth check {name} ({NITER_LADDER} iters, "
            f"em_seeds 1, no reseed): picked {info['picked']}, pool runs "
            f"{stages}, launches {total} {counts} (expected {want}), "
            f"finite images {bool(np.all(np.isfinite(ys)))}, {secs:.2f}s | "
            f"{card}")
        if not np.all(np.isfinite(ys)) or total != want \
                or counts["c"] != want:
            raise RuntimeError(f"phase 16 {name}: launches {total} {counts} "
                               f"(expected {want}) or non-finite images")
        out[name] = total
    log(f"phase 16 reduced-depth checks done | "
        f"{time.perf_counter() - t0:.2f}s")
    return out


def cpu_from_pick(model, ys_true, pool):
    """The port's CPU run of a flat blind recipe from the card's pool pick
    onward: reverb._pool_and_reseed on the CPU over the pool's candidate
    that the card picked (its EM seeds, then the reseed rounds), with the
    card run's arguments and learned judge; `pool` holds the card call's
    arguments ("args") and its pool pick ("picked"), `model` the card's
    model (its STFT and scale). Returns (info, (min, mean) SDR,
    seconds)."""
    import torch
    from pyfasst_tpu_torch.models import reverb
    from pyfasst_tpu_torch.tf.stft import STFT
    t0 = time.perf_counter()
    X, cands, J_, kw = pool["args"]
    name = pool["picked"].split("|")[0]
    Y, info = reverb._pool_and_reseed(
        X, [c for c in cands if c[0] == name], J_,
        **dict(kw, device="cpu"))
    ys = STFT(wlen=model.tft.wlen, fs=model.fs,
              device="cpu").invertTransform(
        torch.as_tensor(Y), nsamples=model.audio.nsamples).numpy()
    return (info, best_perm_sdr(ys * model._scale, ys_true),
            time.perf_counter() - t0)


class keep_blind_run:
    """Context in which the port's blind pipeline keeps what a CPU rerun
    from the pool pick needs: the model whose estim_param_blind_reverb
    runs ("model") and the arguments of the first reverb._pool_and_reseed
    call ("args"), beside each call's pool history ("histories") and the
    run's wall seconds by stage ("stage_seconds")."""

    def __enter__(self):
        from pyfasst_tpu_torch.models import fasst, reverb
        self.held = {"histories": []}
        self._blind = fasst.FASST.estim_param_blind_reverb
        self._pool = reverb._pool_and_reseed
        held, blind, pool = self.held, self._blind, self._pool

        def keep_model(model, *a, **kw):
            held["model"] = model
            info = blind(model, *a, **kw)
            held["stage_seconds"] = info["stage_seconds"]
            return info

        def keep_pool(X, cands, J_, **kw):
            held.setdefault("args", (X, cands, J_, kw))
            Y, info = pool(X, cands, J_, **kw)
            held["histories"].append(info["history"])
            return Y, info

        fasst.FASST.estim_param_blind_reverb = keep_model
        reverb._pool_and_reseed = keep_pool
        return self.held

    def __exit__(self, *exc):
        from pyfasst_tpu_torch.models import fasst, reverb
        fasst.FASST.estim_param_blind_reverb = self._blind
        reverb._pool_and_reseed = self._pool
        return False


class keep_first_chunk:
    """Context in which gem.run_gem keeps the arguments of its first call
    at the pool's width and depth (POOL_CHUNK runs, NITER_CONV
    iterations): a pool chunk to profile afterwards (profile_gem)."""

    def __enter__(self):
        from pyfasst_tpu_torch.ops import gem
        self.first = {}
        self._run_gem = gem.run_gem
        first, run_gem = self.first, self._run_gem

        def keep_first(params, X, cfg, **kw):
            if not first and X.shape[0] == POOL_CHUNK \
                    and cfg.niter == NITER_CONV:
                first.update(params=params, X=X, cfg=cfg)
            return run_gem(params, X, cfg, **kw)

        gem.run_gem = keep_first
        return self.first

    def __exit__(self, *exc):
        from pyfasst_tpu_torch.ops import gem
        gem.run_gem = self._run_gem
        return False


class spy_kernels:
    """Context in which each E-step wrapper records the shape of every call
    it gets: ("general" or "r1", B, J, F, N, ranks, real_cov, ns_inj),
    in `shapes`. The wrappers still launch (and count) as before."""

    def __enter__(self):
        from pyfasst_tpu_torch.ops import cuda_estep
        self.shapes = []
        self._general = cuda_estep.estep_general
        self._r1 = cuda_estep.estep_r1_real
        general, r1, shapes = self._general, self._r1, self.shapes

        def spy_general(x4, v, A4, sigma, ranks, **kw):
            shapes.append(("general",) + tuple(v.shape) + (
                tuple(int(r) for r in ranks), bool(kw.get("real_cov")),
                bool(kw.get("ns_inj"))))
            return general(x4, v, A4, sigma, ranks, **kw)

        def spy_r1(x4, v, *a, **kw):
            shapes.append(("r1",) + tuple(v.shape)
                          + ((1,) * v.shape[1], True, False))
            return r1(x4, v, *a, **kw)

        cuda_estep.estep_general = spy_general
        cuda_estep.estep_r1_real = spy_r1
        return self.shapes

    def __exit__(self, *exc):
        from pyfasst_tpu_torch.ops import cuda_estep
        cuda_estep.estep_general = self._general
        cuda_estep.estep_r1_real = self._r1
        return False


def cpu_reference_blind_pick():
    """Phase 16's recipe on the card, then the port's CPU run from the
    card's pool pick onward (cpu_from_pick): the figure CPU_SDR_BLIND
    holds. One card run and ~3 min of an H100 machine's 8 host cores."""
    import torch
    device = torch.device("cuda", 0)
    model, ys_true = blind_model(device)
    with tempfile.TemporaryDirectory() as tmp, keep_blind_run() as held:
        info, (smin, _), _, _ = drive_blind(model, ys_true, tmp)
    held["picked"] = info["history"][0]["picked"]
    info_c, (cmin, cmean), cpu_s = cpu_from_pick(model, ys_true, held)
    print(json.dumps({"card_min_sdr": smin, "card_picked": info["picked"],
                      "cpu_min_sdr": cmin, "cpu_mean_sdr": cmean,
                      "cpu_history": [h["picked"]
                                      for h in info_c["history"]],
                      "cpu_seconds": cpu_s,
                      "threads": torch.get_num_threads()}), flush=True)


def phase_blind(device, card):
    """Phase 16: configs[2] blind on the card through the host API, WAVs
    written. Gates: every E-step launch is variant c, 400 per pool chunk
    (each POOL_CHUNK wide) and 400 per reseed stage of info["history"]
    (each em_seeds wide); min SDR at least SDR_FLOOR["reverb"] and within
    SDR_SLACK of CPU_SDR_BLIND, the port's CPU run from the card's pool
    pick onward (cpu_reference_blind_pick); WAVs written. Prints the
    picks, the wall seconds of each stage, and a profile of 20 iterations
    of the first pool chunk. Then the reduced-depth checks. Returns the
    variant-c launches and the run's numbers."""
    t0 = time.perf_counter()
    model, ys_true = blind_model(device)
    with tempfile.TemporaryDirectory() as tmp, keep_first_chunk() as first, \
            spy_kernels() as shapes:
        _reset_counts()
        info, (smin, smean), split, paths = drive_blind(model, ys_true, tmp)
        total, counts = _counts()
        written = [p for p in paths if os.path.getsize(p) > 44]
    widths = [sh[1] for sh in shapes]
    hist = info["history"]
    runs = hist[0]["pool"]
    chunks = -(-runs // POOL_CHUNK)
    reseeds = len(hist) - 1
    want = NITER_CONV * (chunks + reseeds)
    em_seeds = 2
    want_widths = ([POOL_CHUNK] * (NITER_CONV * chunks)
                   + [em_seeds] * (NITER_CONV * reseeds))
    prof = profile_gem(first["params"], first["X"], first["cfg"])
    del first
    log(f"phase 16 configs[2] blind (learned=True, select=learned, "
        f"{NITER_CONV} iters, em_seeds {em_seeds}, reseed_rounds 2): J="
        f"{model.params.n_spat} rank {model.params.spat[0].rank} F={model.F} "
        f"N={model.N}, pool {runs} runs in {chunks} chunks of {POOL_CHUNK}, "
        f"stages {[h['picked'] for h in hist]}, launches {total} {counts} "
        f"(expected {want}), widths {sorted(set(widths))}, min SDR "
        f"{smin:.2f} dB (mean {smean:.2f}; the port's CPU run from the "
        f"pool pick {CPU_SDR_BLIND} dB, cpu_reference_blind_pick; the JAX "
        f"package's TPU row {JAX_BLIND_MIN_SDR} dB), wavs {len(written)} | "
        f"{card}")
    log("phase 16 stage split (wall s): host votes and candidates "
        f"{split['votes']:.2f}, learned votes {split['learned']:.2f}, pool "
        f"GEM {split['pool']:.2f}, reseeds {split['reseeds']:.2f}, "
        f"separation {split['separation']:.2f}; total {split['total']:.2f}"
        f" -> xRT {DUR_CONV / split['total']:.3f} over the {DUR_CONV:.0f} s"
        f" clip | {card}")
    log(_profile_line(f"phase 16 profile pool chunk B={POOL_CHUNK} (of "
                      f"{NITER_CONV})", prof, card))
    embed_s = embed_device_check(device)
    ladder = ladder_checks(device, card)
    bad = []
    if total != want or counts["c"] != want or widths != want_widths:
        bad.append(f"launches {total} {counts}, widths "
                   f"{sorted(set(widths))} (expected {want} of variant c: "
                   f"{chunks} chunks {POOL_CHUNK} wide, {reseeds} reseed "
                   f"stages {em_seeds} wide, {NITER_CONV} each)")
    if not smin >= SDR_FLOOR["reverb"]:
        bad.append(f"min SDR {smin:.2f} dB < {SDR_FLOOR['reverb']} dB")
    if not abs(smin - CPU_SDR_BLIND) <= SDR_SLACK:
        bad.append(f"min SDR {smin:.2f} dB not within {SDR_SLACK} dB of "
                   f"the CPU run ({CPU_SDR_BLIND} dB)")
    if len(written) != model.params.n_spat:
        bad.append(f"expected {model.params.n_spat} WAVs, found {paths}")
    log(f"phase 16 done | {time.perf_counter() - t0:.2f}s")
    if bad:
        raise RuntimeError("phase 16: " + "; ".join(bad))
    return counts["c"], {"split": split, "profile": prof, "embed": embed_s,
                         "min_sdr": smin, "picked": info["picked"],
                         "ladder": ladder}


# -- phase 17: the CLI ---------------------------------------------------------

def speech_sources(rng, n, fs, n_spk=3):
    """tools/validate_hw.py::_speech_sources, copied (that module imports
    JAX): speech-like stems (glottal-sawtooth-excited formant
    resonators with syllabic gating, unvoiced fricatives and pauses),
    one per speaker."""
    from scipy.signal import lfilter

    vowels = [(730, 1090, 2440), (270, 2290, 3010), (300, 870, 2240),
              (660, 1720, 2410), (530, 1840, 2480)]   # a i u ae eh
    pitches = [115.0, 205.0, 150.0, 180.0]

    def resonator(x, fc, bw):
        r = np.exp(-np.pi * bw / fs)
        th = 2 * np.pi * fc / fs
        return lfilter([1.0 - r], [1.0, -2 * r * np.cos(th), r * r], x)

    out = []
    for spk in range(n_spk):
        f0 = pitches[spk % len(pitches)] * (1 + 0.06 * rng.uniform(-1, 1))
        s = np.zeros(n)
        i = int(rng.uniform(0, 0.25) * fs)            # desynchronized start
        while i < n:
            kind = rng.choice(["v", "v", "v", "f", "p"])
            dur = rng.uniform(0.12, 0.35) if kind == "v" \
                else rng.uniform(0.06, 0.2)
            L = min(int(dur * fs), n - i)
            tt = np.arange(L) / fs
            env = np.minimum(1.0, tt / 0.03) \
                * np.minimum(1.0, (L / fs - tt) / 0.05)
            if kind == "v":
                f0i = f0 * (1 + 0.12 * np.sin(
                    2 * np.pi * rng.uniform(1.5, 3.5) * tt
                    + rng.uniform(0, 6)))
                ph = 2 * np.pi * np.cumsum(f0i) / fs
                nh = max(2, int(fs / 2 / (f0 * 1.2)))
                exc = sum(np.sin(h * ph) / h for h in range(1, nh + 1))
                fset = vowels[rng.integers(0, len(vowels))]
                seg = sum(resonator(exc, fc * (1 + 0.04 * rng.uniform(-1, 1)),
                                    80 + 30 * k)
                          for k, fc in enumerate(fset))
                s[i:i + L] = seg * env
            elif kind == "f":
                w = rng.standard_normal(L)
                hp = w - np.convolve(w, np.ones(5) / 5, "same")
                s[i:i + L] = 0.35 * hp * env
            i += L
        out.append(s / (np.std(s) + 1e-9))
    return out


def music_sources(rng, n, fs):
    """tools/validate_hw.py::_music_sources, copied (that module imports
    JAX): bass line, chord pad, lead melody and drum kit stems of n
    samples at fs."""
    t = np.arange(n) / fs

    def note_seq(freq_of_i, dur, wave, attack, decay):
        seg = int(dur * fs)
        out = np.zeros(n)
        for k, i in enumerate(range(0, n, seg)):
            L = min(seg, n - i)
            tt = np.arange(L) / fs
            env = np.minimum(1.0, tt / attack) * np.exp(-tt / decay)
            out[i:i + L] = wave(freq_of_i(k), tt) * env
        return out

    def saw(f, tt):
        return sum(np.sin(2 * np.pi * f * h * tt) / h for h in range(1, 9))

    def organ(f, tt):
        return sum(np.sin(2 * np.pi * f * h * tt) / h ** 0.5
                   for h in (1, 2, 3, 4))

    roots = [55.0, 41.2, 43.65, 49.0]                 # A1 E1 F1 G1
    bass = note_seq(lambda k: roots[k % 4], 0.5, saw, 0.01, 0.4)
    chords = [(220.0, 277.2, 329.6), (164.8, 207.7, 246.9),
              (174.6, 220.0, 261.6), (196.0, 246.9, 293.7)]
    pad = note_seq(lambda k: 0.0, 2.0,
                   lambda f, tt: 0.0 * tt, 0.3, 4.0)  # filled below
    seg = int(2.0 * fs)
    for k, i in enumerate(range(0, n, seg)):
        L = min(seg, n - i)
        tt = np.arange(L) / fs
        env = np.minimum(1.0, tt / 0.3) * np.exp(-tt / 4.0)
        pad[i:i + L] = sum(organ(f, tt) for f in chords[k % 4]) * env
    pent = [440.0, 493.9, 554.4, 659.3, 740.0]
    mel = rng.integers(0, len(pent), size=n // int(0.25 * fs) + 1)

    def lead_wave(f, tt):
        vib = 1.0 + 0.012 * np.sin(2 * np.pi * 5.5 * tt)
        return (np.sin(2 * np.pi * f * vib * tt)
                + 0.4 * np.sin(2 * np.pi * 2 * f * vib * tt))

    lead = note_seq(lambda k: pent[mel[k]], 0.25, lead_wave, 0.01, 0.25)
    drums = np.zeros(n)
    beat = int(0.5 * fs)
    for i in range(0, n, beat):                       # kick
        L = min(int(0.12 * fs), n - i)
        tt = np.arange(L) / fs
        drums[i:i + L] += np.sin(
            2 * np.pi * (55 + 60 * np.exp(-tt / 0.02)) * tt) \
            * np.exp(-tt / 0.06) * 2.0
    for i in range(beat // 2, n, beat):               # snare (offbeat)
        L = min(int(0.1 * fs), n - i)
        tt = np.arange(L) / fs
        drums[i:i + L] += rng.standard_normal(L) * np.exp(-tt / 0.04)
    w = rng.standard_normal(n)
    hat_env = np.zeros(n)
    for i in range(0, n, beat // 2):                  # hats (8ths)
        L = min(int(0.04 * fs), n - i)
        hat_env[i:i + L] = np.exp(-np.arange(L) / (0.01 * fs))
    drums += (w - np.convolve(w, np.ones(5) / 5, "same")) * hat_env * 0.7
    levels = {"bass": 1.0, "pad": 0.8, "lead": 0.9, "drums": 1.1}
    out = []
    for name, s in (("bass", bass), ("pad", pad), ("lead", lead),
                    ("drums", drums)):
        out.append(levels[name] * s / (np.std(s) + 1e-9))
    return out


def music_mix(rng, srcs, n, fs, t60, pans):
    """tools/validate_hw.py::_music_mix, copied: each source through a
    random exponential room response per channel (T60 t60), panned by
    an ITD and a level. Returns the true images (J, n, 2)."""
    from scipy.signal import fftconvolve

    taps = int(fs * t60)
    ys_true = []
    for j, s in enumerate(srcs):
        az, g = pans[j]
        itd = int(round(az * 8))                     # +-8-sample ITD max
        chs = []
        for ch in range(2):
            h = rng.standard_normal(taps) * np.exp(
                -3.0 * np.log(10) * np.arange(taps) / taps) * 0.08
            d = max(0, itd if ch == 0 else -itd)
            h[d] += g * (1.2 - 0.4 * np.sign(az) * (1 if ch else -1))
            chs.append(fftconvolve(s, h)[:n])
        ys_true.append(np.stack(chs, 1))
    return np.stack(ys_true)


def speech_fixture(n_spk=3, t60=0.25, seed=120, fs=16000, dur=10.0):
    """tools/speech_lab.py::_fixture(n_spk, t60, seed) at `dur` seconds:
    (mixture (n, 2), true images (n_spk, n, 2))."""
    rng = np.random.default_rng(seed)
    n = int(fs * dur)
    srcs = speech_sources(rng, n, fs, n_spk)
    pans = [(0.9, 1.0), (-0.9, 1.0), (0.0, 1.0), (0.45, 1.0)][:n_spk]
    ys_true = music_mix(rng, srcs, n, fs, t60, pans)
    return ys_true.sum(0), ys_true


def music_fixture(seed=105, kinds=(0, 2, 3), t60=0.12, fs=44100, dur=20.0,
                  pans=((0.9, 1.0), (-0.9, 1.0), (0.0, 1.0))):
    """The first row of tools/validate_hw.py::scenario_music (its
    _music_run on a fresh default_rng(seed)) with the generator run for
    `dur` seconds: (mixture (n, 2), true images (len(kinds), n, 2))."""
    rng = np.random.default_rng(seed)
    n = int(fs * dur)
    srcs = music_sources(rng, n, fs)
    srcs = [srcs[k] for k in kinds]
    ys_true = music_mix(rng, srcs, n, fs, t60, list(pans))
    return ys_true.sum(0), ys_true


def write_mixture(path, mix, fs, ys_true=None):
    """Write `mix` as a float32 WAV, scaled so that it and every true image
    peak at 0.5 at most (the CLI writes its images as PCM16 clipped to
    [-1, 1]). Returns the true images at the WAV's scale."""
    from pyfasst_tpu_torch.audio import wav_write
    peak = np.max(np.abs(mix))
    if ys_true is not None:
        peak = max(peak, np.max(np.abs(ys_true)))
    g = 0.5 / peak
    wav_write(path, mix * g, fs, bits=32)
    return None if ys_true is None else ys_true * g


def run_cli(argv):
    """pyfasst_tpu_torch.__main__.main(argv) in this process, its standard
    output captured: the JSON report on its last line. Raises on a
    non-zero exit code or a report that is not JSON."""
    import contextlib
    import io
    from pyfasst_tpu_torch.__main__ import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise RuntimeError(f"phase 17: `{' '.join(argv)}` exited with {rc}")
    return json.loads(lines[-1])


def cli_shapes():
    """The E-step calls phase 17 makes, by label: (kernel, B, J, F, N,
    ranks, real_cov, ns_inj), kernel "general" (csrc/estep_general.cuh) or
    "r1" (csrc/estep.cu). Phase 2 checks and times each; phase 17 fails
    if its runs call a kernel at a shape not in this table."""
    from pyfasst_tpu_torch.tf.stft import _frame_geometry
    n_s = int(SPEECH["fs"] * SPEECH["dur"])
    n_m = int(MUSIC["fs"] * MUSIC["dur"])
    Ns = _frame_geometry(n_s, 2048, 1024)[2]
    Nf = _frame_geometry(n_m, 2048, 1024)[2]
    Nc = _frame_geometry(n_m, 8192, 4096)[2]
    r3 = (2, 2, 2)
    n_bands = -(-1025 // 32)              # band_em=32 over F = 1025
    return {
        "speech_pool": ("general", POOL_CHUNK, 3, 1025, Ns, r3, False,
                        False),
        "speech_band_probes": ("general", 2 * n_bands, 3, 32, Ns, r3, False,
                               False),
        "music_fine_pool": ("general", POOL_CHUNK, 3, 1025, Nf, r3, False,
                            False),
        "music_fine_reseed": ("general", 2, 3, 1025, Nf, r3, False, False),
        "music_coarse_pool": ("general", 6, 3, 4097, Nc, r3, False, False),
        "music_coarse_reseed": ("general", 2, 3, 4097, Nc, r3, False,
                                False),
        "inst": ("r1", 1, 2, WLEN // 2 + 1, _frame_geometry(
            int(FS * DUR), WLEN, HOP)[2], (1, 1), True, False),
        "batch": ("r1", len(CLI_BATCH_DURS), 2, WLEN // 2 + 1, GRANULARITY,
                  (1, 1), True, False),
        "stream": ("general", 1, 2, WLEN // 2 + 1, NB_STREAM, (1, 1), False,
                   False),
    }


def phase_cli_shapes(device):
    """Phase 2's part for phase 17: each kernel at each shape of
    cli_shapes() against its plain version (variant a's xi bit for bit;
    the rank-2 xi bar 3e-4), timed in turns with its bound. Returns the
    numbers by label."""
    import torch
    from pyfasst_tpu_torch.ops import cuda_estep
    t0 = time.perf_counter()
    out = {}
    for label, (kind, B, J_, F, N, ranks, real, ns) in cli_shapes().items():
        if kind == "r1":
            inp = _estep_inputs(B, F, N, seed=F * N, device=device, J_=J_)

            def kernel():
                return cuda_estep.estep_r1_real(**inp)

            def plain():
                return cuda_estep.estep_r1_real_ref(**inp)

            ops = count_ops(cuda_estep.estep_r1_real_ref, **inp)
            tensors = list(inp.values())
        else:
            inp = _general_inputs(B, J_, F, N, ranks, real, seed=F * N + J_,
                                  device=device)
            kw = dict(ns_inj=ns, real_cov=real)

            def kernel():
                return cuda_estep.estep_general(*inp, ranks, **kw)

            def plain():
                return cuda_estep.estep_ref(*inp, ranks, **kw)

            ops = general_ops(inp, ranks, **kw)
            tensors = list(inp)
        got, want, again = kernel(), plain(), kernel()
        torch.cuda.synchronize()
        errs, abs_err = _estep_errors(got, want)
        tol = dict(TOL, xi=3e-4 if max(ranks) == 2 else TOL["xi"])
        bad = [n for n, e in errs.items() if not e <= tol[n]]
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            bad.append("two runs differ")
        if kind == "r1" and not torch.equal(got[0], want[0]):
            bad.append("xi differs from the plain version's bits")
        kern, ref = _turns(kernel, plain)
        b_ms, b_by, nbytes = bound(tensors + list(got), ops)
        out[label] = {"shape": [B, J_, F, N], "ranks": list(ranks),
                      "max_abs_err": abs_err, "ms": statistics.median(kern),
                      "plain_ms": statistics.median(ref), "bound_ms": b_ms,
                      "bound_by": b_by,
                      "nofma_floor_ms": ops / FP32_NOFMA_OPS_PER_S * 1e3}
        log(f"phase 2 cli {label} ({'estep_r1_real' if kind == 'r1' else 'estep_general'}) "
            f"B,J,F,N={B},{J_},{F},{N} ranks {ranks}: "
            + " ".join(f"{n} {e:.2e}<={tol[n]:.0e}" for n, e in errs.items())
            + f" | max_abs_err {abs_err:.3e} | kernel {out[label]['ms']:.4f}"
            f" ms (min {min(kern):.4f}), plain {out[label]['plain_ms']:.3f} "
            f"ms, medians in turns | bound {b_ms:.4f} ms by {b_by} "
            f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} Gop; without FMA "
            f"{out[label]['nofma_floor_ms']:.4f} ms)")
        if bad:
            raise RuntimeError(f"phase 2 cli {label}: the kernel disagrees "
                               f"with its plain version: {bad}")
        del inp, got, want, again
    log(f"phase 2 cli shapes done | {time.perf_counter() - t0:.2f}s")
    return out


def blind_launches(histories, band_em):
    """E-step launches of a blind CLI run: NITER_CONV per pool chunk and
    per reseed stage of every _pool_and_reseed call, and the band probes'
    BAND_PROBE_ITERS when band_em is set."""
    return sum(NITER_CONV * (-(-h[0]["pool"] // POOL_CHUNK) + len(h) - 1)
               for h in histories) + (BAND_PROBE_ITERS if band_em else 0)


def blind_cli(tmp, preset, mix, ys_true, fs, profile=False, name=None):
    """`separate <wav> --preset <preset> --sources J` on the card through
    the CLI, the fixture written as a float32 WAV; the WAVs it writes read
    back and scored against the true images at the WAV's scale. Returns
    the run's numbers; with profile, also a profile of GEM iterations 60-80
    of the first pool chunk."""
    import torch
    from pyfasst_tpu_torch.audio import wavread
    name = name or preset
    wav = os.path.join(tmp, f"{name}.wav")
    ys_true = write_mixture(wav, mix, fs, ys_true)
    argv = ["separate", wav, "--preset", preset, "--sources",
            str(len(ys_true)), "-o", os.path.join(tmp, name), "-q"]
    _reset_counts()
    with keep_blind_run() as held, spy_kernels() as shapes, \
            keep_first_chunk() as first:
        t0 = time.perf_counter()
        rep = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, counts = _counts()
    ys = np.stack([wavread(p)[0] for p in rep["files"]])
    perm, sdrs = best_perm(ys, ys_true)
    model = held["model"]
    out = {"report": rep, "wall": wall, "launches": total, "counts": counts,
           "shapes": shapes, "histories": held["histories"], "perm": perm,
           "sdrs": sdrs, "min_sdr": float(min(sdrs)),
           "mean_sdr": float(np.mean(sdrs)), "ys_true": ys_true,
           "wav": wav, "stage_seconds": held["stage_seconds"],
           "finite": bool(np.all(np.isfinite(model.separated_images()))),
           "grid": (model.F, model.N), "duration": model.audio.duration}
    if profile:
        out["profile"] = profile_gem(first["params"], first["X"],
                                     first["cfg"])
    out["held"] = held
    return out


def cpu_reference_speech():
    """Phase 17's speech run on the card, then the port's CPU run from the
    card's pool pick onward (cpu_from_pick: the picked candidate's EM seeds
    under the learned judge): the figure CPU_SDR_SPEECH holds. One card run
    and a few minutes of an H100 machine's host cores."""
    import torch
    device = torch.device("cuda", 0)
    mix, ys_true = speech_fixture(**SPEECH)
    with tempfile.TemporaryDirectory() as tmp:
        r = blind_cli(tmp, "speech", mix, ys_true, SPEECH["fs"])
    held = r["held"]
    held["picked"] = held["histories"][0][0]["picked"]
    info_c, (cmin, cmean), cpu_s = cpu_from_pick(held["model"],
                                                 r["ys_true"], held)
    print(json.dumps({"card_min_sdr": r["min_sdr"],
                      "card_picked": r["report"]["picked"],
                      "cpu_min_sdr": cmin, "cpu_mean_sdr": cmean,
                      "cpu_history": [h["picked"]
                                      for h in info_c["history"]],
                      "cpu_seconds": cpu_s,
                      "threads": torch.get_num_threads()}), flush=True)


def cli_commands(tmp, speech):
    """Phase 17 (c): the other commands once each at reduced depth, on the
    card by the CLI's default. Returns ([problems], the E-step calls'
    shapes)."""
    from pyfasst_tpu_torch.audio import wav_info, wav_write, wavread
    from pyfasst_tpu_torch.tf.stft import _frame_geometry
    bad = []

    def counted(label, argv, want, kind):
        _reset_counts()
        with spy_kernels() as shapes:
            t0 = time.perf_counter()
            rep = run_cli(argv)
            secs = time.perf_counter() - t0
        total, counts = _counts()
        kinds = {s[0] for s in shapes}
        log(f"phase 17 {label}: `{' '.join(os.path.basename(a) for a in argv)}` -> "
            f"{json.dumps({k: v for k, v in rep.items() if k != 'results'})[:300]}"
            f" | launches {total} {counts} (expected {want}), {secs:.2f}s")
        if total != want or (want and kinds != {kind}) \
                or len(shapes) != want:
            bad.append(f"{label}: launches {total} {counts}, kernels "
                       f"{sorted(kinds)} (expected {want} of {kind})")
        return rep, shapes

    # separate (inst) with a checkpoint, then its resume: zero iterations
    mix, _, _ = make_mixture(dur=DUR)
    bench = os.path.join(tmp, "bench.wav")
    wav_write(bench, mix, FS, bits=32)
    ck = os.path.join(tmp, "ck.npz")
    base = ["separate", bench, "--iters", str(NITER_CLI), "-q"]
    rep, shapes = counted("separate inst", base + [
        "-o", os.path.join(tmp, "inst"), "--checkpoint", ck], NITER_CLI, "r1")
    rep2, _ = counted("separate --resume", base + [
        "-o", os.path.join(tmp, "resumed"), "--resume", ck], 0, None)
    same = all(np.array_equal(wavread(a)[0], wavread(b)[0])
               for a, b in zip(rep["files"], rep2["files"]))
    if not (np.isfinite(rep["final_loglik"]) and rep2["final_loglik"] is None
            and same):
        bad.append(f"resume: final_loglik {rep['final_loglik']} -> "
                   f"{rep2['final_loglik']}, WAVs equal {same}")
    seen = list(shapes)
    # --streaming on the first DUR_CLI_STREAM s of the bench clip
    n = mix[:int(FS * DUR_CLI_STREAM)].shape[0]
    stream = os.path.join(tmp, "stream.wav")
    wav_write(stream, mix[:n], FS, bits=32)
    frames = _frame_geometry(n, WLEN, HOP)[2]
    # pass 1 learns from the full blocks, pass 2 separates every block
    blocks = frames // NB_STREAM + -(-frames // NB_STREAM)
    rep, shapes = counted("separate --streaming", [
        "separate", stream, "--streaming", "-o", os.path.join(tmp, "s"),
        "-q"], (INNER_STREAM + 1) * blocks, "general")
    seen += shapes
    # --batch over a directory of clips: one bucket, one launch per
    # iteration, len(CLI_BATCH_DURS) clips wide
    clips = os.path.join(tmp, "clips")
    os.makedirs(clips)
    for i, d in enumerate(CLI_BATCH_DURS):
        wav_write(os.path.join(clips, f"c{i}.wav"),
                  make_mixture(dur=d, seed=i)[0], FS, bits=32)
    rep, shapes = counted("separate --batch", [
        "separate", clips, "--batch", "--iters", str(NITER_CLI), "-o",
        os.path.join(tmp, "b"), "-q"], NITER_CLI, "r1")
    seen += shapes
    if rep["clips"] != len(CLI_BATCH_DURS) or not all(
            np.isfinite(r["final_loglik"]) for r in rep["results"].values()):
        bad.append(f"batch: {rep['clips']} clips, logliks "
                   f"{[r['final_loglik'] for r in rep['results'].values()]}")
    # lead and demix on phase 14's vibrato mixture
    vib = os.path.join(tmp, "vibrato.wav")
    wav_write(vib, vibrato_mixture()[0], FS_CONV, bits=32)
    rep, _ = counted("lead", ["lead", vib, "-o", os.path.join(tmp, "lead"),
                              "--iters", str(NITER_CLI_LEAD)], 0, None)
    if len(rep["files"]) != 2 or not rep["melody_frames"]:
        bad.append(f"lead: {rep}")
    rep, _ = counted("demix", ["demix", vib, "--sources", "2"], 0, None)
    if rep["sources"] != 2:
        bad.append(f"demix: {rep}")
    # eval on (a)'s WAVs against its true images, written as WAVs
    refs = []
    for j, y in enumerate(speech["ys_true"]):
        refs.append(os.path.join(tmp, f"ref{j}.wav"))
        wav_write(refs[-1], y, SPEECH["fs"], bits=16)
    rep, _ = counted("eval", ["eval", "-e"] + speech["report"]["files"]
                     + ["-r"] + refs, 0, None)
    log(f"phase 17 eval against the true images: permutation "
        f"{rep['permutation']} (phase 17 (a)'s best {list(speech['perm'])});"
        f" BSS-Eval (512 taps, mono downmix) SDR {rep['sdr_db']} dB beside "
        f"(a)'s image SDR {[round(float(x), 2) for x in speech['sdrs']]} dB (other "
        f"measures, not compared)")
    if rep["permutation"] != list(speech["perm"]):
        bad.append(f"eval: permutation {rep['permutation']} != "
                   f"{list(speech['perm'])}")
    # info, in this process and as the module's entry point
    rep, _ = counted("info", ["info", speech["wav"]], 0, None)
    proc = subprocess.run([sys.executable, "-m", "pyfasst_tpu_torch", "info",
                           speech["wav"]], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(
                              os.path.abspath(__file__)))
    sub = (json.loads(proc.stdout.strip().splitlines()[-1])
           if proc.returncode == 0 and proc.stdout.strip() else None)
    log(f"phase 17 `python -m pyfasst_tpu_torch info`: rc {proc.returncode},"
        f" {sub}")
    if not rep == sub == wav_info(speech["wav"]):
        bad.append(f"info: {rep} / subprocess rc {proc.returncode} {sub} / "
                   f"{proc.stderr[-300:]}")
    return bad, seen


def phase_cli(card, shape_nums):
    """Phase 17: the CLI through pyfasst_tpu_torch.__main__.main in this
    process. (a) --preset speech at full width and depth: every E-step
    launch variant c, NITER_CONV per pool chunk and BAND_PROBE_ITERS of
    the band probes; min SDR of the written WAVs within SDR_SLACK of
    CPU_SDR_SPEECH and at least SPEECH_FLOOR; a profile of the first pool
    chunk; then the same on the fixture's other draws (SPEECH_SEEDS),
    whose median min SDR must reach SPEECH_FLOOR. (b) --preset music cut
    in depth: finite images, launches of variant c on the fine and the
    coarse grid as the stages' pools and reseeds ask, SDR printed. (c)
    the other commands (cli_commands). Every kernel call of the phase at
    a shape phase 2 checked (cli_shapes); their launches go into
    shape_nums by label."""
    t0 = time.perf_counter()
    bad = []
    checked = {v: k for k, v in cli_shapes().items()}
    with tempfile.TemporaryDirectory() as tmp:
        mix, ys_true = speech_fixture(**SPEECH)
        speech = blind_cli(tmp, "speech", mix, ys_true, SPEECH["fs"],
                           profile=True)
        rep = speech["report"]
        want = blind_launches(speech["histories"], band_em=True)
        log(f"phase 17 (a) separate --preset speech --sources 3 "
            f"(speech_lab._fixture(3, 0.25, 120): {SPEECH['dur']:.0f} s, "
            f"{SPEECH['fs']} Hz, F,N={speech['grid']}): picked "
            f"{rep['picked']}, stages {rep['stages']}, pool "
            f"{[h[0]['pool'] for h in speech['histories']]} runs, launches "
            f"{speech['launches']} {speech['counts']} (expected {want}), "
            f"min SDR {speech['min_sdr']:.2f} dB (mean "
            f"{speech['mean_sdr']:.2f}; the port's CPU run from the pool "
            f"pick {CPU_SDR_SPEECH} dB; the JAX package's TPU row "
            f"{JAX_SPEECH_MIN_SDR} dB), wall {speech['wall']:.2f}s -> xRT "
            f"{speech['duration'] / speech['wall']:.3f} (CLI report "
            f"{rep['wall_seconds']}s, xRT {rep['xrt']}) | {card}")
        log("phase 17 (a) stage split (wall s): " + ", ".join(
            f"{k} {v:.2f}" for k, v in speech["stage_seconds"].items())
            + f"; CLI total {speech['wall']:.2f} (STFT, separation and "
            f"WAVs the rest) | {card}")
        log(_profile_line(f"phase 17 profile speech pool chunk "
                          f"B={POOL_CHUNK} (of {NITER_CONV})",
                          speech["profile"], card))
        if speech["launches"] != want or speech["counts"]["c"] != want:
            bad.append(f"speech: launches {speech['launches']} "
                       f"{speech['counts']} (expected {want} of variant c)")
        if not abs(speech["min_sdr"] - CPU_SDR_SPEECH) <= SDR_SLACK:
            bad.append(f"speech: min SDR {speech['min_sdr']:.2f} dB not "
                       f"within {SDR_SLACK} dB of the CPU run "
                       f"({CPU_SDR_SPEECH} dB)")
        speech.pop("held")
        # the fixture's other draws, the same recipe and checks
        draws = [speech["min_sdr"]]
        shapes = list(speech["shapes"])
        for seed, jax_sdr in zip(SPEECH_SEEDS[1:],
                                 JAX_SPEECH_SEEDS_MIN_SDR[1:]):
            mix, ys_true = speech_fixture(**dict(SPEECH, seed=seed))
            r = blind_cli(tmp, "speech", mix, ys_true, SPEECH["fs"],
                          name=f"speech{seed}")
            r.pop("held")
            want = blind_launches(r["histories"], band_em=True)
            draws.append(r["min_sdr"])
            shapes += r["shapes"]
            log(f"phase 17 (a) --preset speech, fixture seed {seed}: picked "
                f"{r['report']['picked']}, launches {r['launches']} "
                f"(expected {want}), min SDR {r['min_sdr']:.2f} dB (mean "
                f"{r['mean_sdr']:.2f}; the JAX package's draw {jax_sdr} dB)"
                f", wall {r['wall']:.2f}s")
            if r["launches"] != want or r["counts"]["c"] != want:
                bad.append(f"speech seed {seed}: launches {r['launches']} "
                           f"{r['counts']} (expected {want} of variant c)")
        med = statistics.median(draws)
        log(f"phase 17 (a) --preset speech over fixture seeds {SPEECH_SEEDS}:"
            f" min SDR {[round(x, 2) for x in draws]} dB, worst "
            f"{min(draws):.2f} / median {med:.2f} / best {max(draws):.2f} "
            f"(the JAX package's draws on a TPU: "
            f"{list(JAX_SPEECH_SEEDS_MIN_SDR)}, median "
            f"{statistics.median(JAX_SPEECH_SEEDS_MIN_SDR)}) | {card}")
        if not med >= SPEECH_FLOOR:
            bad.append(f"speech: median min SDR over seeds {SPEECH_SEEDS} "
                       f"{med:.2f} dB < {SPEECH_FLOOR} dB")
        if not draws[0] >= SPEECH_FLOOR:
            bad.append(f"speech: seed {SPEECH_SEEDS[0]} min SDR "
                       f"{draws[0]:.2f} dB < {SPEECH_FLOOR} dB")

        mix, ys_true = music_fixture(**MUSIC)
        music = blind_cli(tmp, "music", mix, ys_true, MUSIC["fs"])
        music.pop("held")
        rep = music["report"]
        want = blind_launches(music["histories"], band_em=False)
        grids = {}
        for sh in music["shapes"]:
            grids[sh[3]] = grids.get(sh[3], 0) + 1
        log(f"phase 17 (b) separate --preset music --sources 3 (the 3-stem "
            f"row, cut from 20 s to {MUSIC['dur']:.0f} s): picked "
            f"{rep['picked']}, stages {rep['stages']}, pools "
            f"{[h[0]['pool'] for h in music['histories']]} runs, launches "
            f"{music['launches']} {music['counts']} (expected {want}) by F "
            f"{grids}, finite images {music['finite']}, min SDR "
            f"{music['min_sdr']:.2f} dB (mean {music['mean_sdr']:.2f}; not "
            f"gated; the JAX package's TPU row at 20 s {JAX_MUSIC_MIN_SDR} "
            f"dB), wall {music['wall']:.2f}s -> xRT "
            f"{music['duration'] / music['wall']:.3f} | {card}")
        if music["launches"] != want or music["counts"]["c"] != want \
                or set(grids) != {1025, 4097} or not music["finite"]:
            bad.append(f"music: launches {music['launches']} "
                       f"{music['counts']} by F {grids} (expected {want} "
                       f"of variant c on F = 1025 and 4097), finite "
                       f"{music['finite']}")

        problems, seen = cli_commands(tmp, speech)
        bad += problems
    by_label = {}
    for sh in shapes + music["shapes"] + seen:
        label = checked.get(sh)
        if label is None:
            bad.append(f"a kernel call at {sh}, a shape phase 2 did not "
                       f"check")
        else:
            by_label[label] = by_label.get(label, 0) + 1
    log(f"phase 17 E-step calls by phase-2 shape: {by_label}")
    for label, n in by_label.items():
        shape_nums[label]["launches"] = n
    log(f"phase 17 done | {time.perf_counter() - t0:.2f}s")
    if bad:
        raise RuntimeError("phase 17: " + "; ".join(bad))


# -- phase 18: the sharded path --------------------------------------------

# -- phase 19: five sources at full width ---------------------------------

def five_mixture(seed=SEED_FIVE):
    """Phase 19 (a)'s mix: FIVE_KINDS' sources (band_sources at 44.1 kHz,
    DUR seconds) panned apart at FIVE_PANS degrees, (cos, sin) gains
    (instantaneous, rank 1), the mix scaled to peak 1, as make_mixture.
    Returns (mix (T, 2) float32, true images (5, T, 2))."""
    rng = np.random.default_rng(seed)
    srcs = band_sources(rng, int(FS * DUR), FIVE_KINDS, fs=FS)
    ys = np.stack([np.outer(s, (np.cos(np.deg2rad(a)), np.sin(np.deg2rad(a))))
                   for s, a in zip(srcs, FIVE_PANS)])
    scale = np.max(np.abs(ys.sum(0)))
    return (ys.sum(0) / scale).astype(np.float32), ys / scale


def five_runs(device, tmp):
    """Phase 19's runs on `device` ("cuda" or "cpu"): (a) `separate
    --sources 5 --iters NITER` through the CLI on five_mixture's WAV, the
    WAVs it writes scored against the true images; (b) the five-source
    configs[2] model through the host API. Each with its min SDR, E-step
    launches by variant, the E-step shapes it called and its seconds."""
    import torch
    from pyfasst_tpu_torch.audio import wavread
    dev = "cuda" if str(device).startswith("cuda") else "cpu"
    out = {}
    mix, ys_true = five_mixture()
    wav = os.path.join(tmp, "five.wav")
    ys_true = write_mixture(wav, mix, FS, ys_true)
    argv = ["separate", wav, "--sources", str(len(FIVE_KINDS)), "--iters",
            str(NITER), "-o", os.path.join(tmp, "five"), "-q", "--device",
            dev]
    _reset_counts()
    with spy_kernels() as shapes:
        t0 = time.perf_counter()
        rep = run_cli(argv)
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    ys = np.stack([wavread(p)[0] for p in rep["files"]])
    sdrs = best_perm(ys, ys_true)[1]
    out["inst"] = {"min_sdr": float(min(sdrs)), "sdrs": sdrs,
                   "counts": _counts(), "shapes": set(shapes),
                   "seconds": seconds, "report": rep,
                   "finite": bool(np.all(np.isfinite(ys)))}
    model, truth = conv_model("reverb5", device)
    _reset_counts()
    with spy_kernels() as shapes:
        ll, sdr, seconds, _ = drive_conv(model, truth,
                                         os.path.join(tmp, "reverb5"))
    out["reverb5"] = {"min_sdr": sdr[0], "mean_sdr": sdr[1], "loglik": ll,
                      "counts": _counts(), "shapes": set(shapes),
                      "seconds": seconds, "grid": (model.F, model.N)}
    return out


def cpu_reference_five():
    """Phase 19's two runs on the CPU: the figures CPU_SDR_FIVE holds."""
    import torch
    print(f"threads {torch.get_num_threads()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = five_runs("cpu", tmp)
    print(json.dumps({k: {"min_sdr": v["min_sdr"], "seconds": v["seconds"]}
                      for k, v in out.items()}), flush=True)


def phase_five(device, card):
    """Phase 19: five sources at full width on the card (five_runs): (a)
    `separate --sources 5` makes NITER launches of the general kernel at
    J = 5 (real rank 1: variant a's model) at phase 2's path shape and no
    other; (b) the five-source configs[2] model makes NITER_CONV launches
    of variant c at J = 5, rank 2, at its path shape; each min SDR within
    SDR_SLACK of CPU_SDR_FIVE, the port's CPU run of the same recipe.
    Returns the launches of each run."""
    t0 = time.perf_counter()
    paths = wide_path_shapes()
    with tempfile.TemporaryDirectory() as tmp:
        out = five_runs(device, tmp)
    want = {"inst": (NITER, "a", ("general",) + (1, 5) + paths["inst"][1:]
                     + ((1,) * 5, True, False)),
            "reverb5": (NITER_CONV, "c", ("general",) + (1, 5)
                        + paths["reverb5"][1:] + ((2,) * 5, False, False))}
    bad = []
    for name, r in out.items():
        total, counts = r["counts"]
        n, key, shape = want[name]
        cpu = CPU_SDR_FIVE[name]
        per = (" per source " + " ".join(f"{x:.2f}" for x in r["sdrs"])
               if "sdrs" in r else f" mean {r['mean_sdr']:.2f}")
        log(f"phase 19 {name}: J=5, {n} iters, min SDR {r['min_sdr']:.2f} "
            f"dB (CPU run {cpu} dB;{per} dB), launches {total} {counts}, "
            f"shapes {sorted(r['shapes'])}, "
            f"{r['seconds']:.2f}s -> xRT "
            f"{(DUR if name == 'inst' else DUR_CONV) / r['seconds']:.2f} | "
            f"{card}")
        if total != n or counts[key] != n or r["shapes"] != {shape}:
            bad.append(f"{name}: launches {total} {counts} at shapes "
                       f"{r['shapes']} (expected {n} of variant {key} at "
                       f"{shape})")
        if cpu is None or abs(r["min_sdr"] - cpu) > SDR_SLACK:
            bad.append(f"{name}: min SDR {r['min_sdr']:.2f} dB not within "
                       f"{SDR_SLACK} dB of the CPU run ({cpu})")
    if not (out["inst"]["finite"]
            and np.all(np.isfinite(out["reverb5"]["loglik"]))):
        bad.append("non-finite images or loglik")
    log(f"phase 19 done | {time.perf_counter() - t0:.2f}s")
    if bad:
        raise RuntimeError("phase 19: " + "; ".join(bad))
    return {name: r["counts"][1] for name, r in out.items()}


def mesh_pool(device, mesh):
    """One chunk of phase 16's pool at its shapes: POOL_CHUNK runs (the
    candidates of phase 16's mixture, repeated to fill the chunk, with EM
    seeds 0 and 1) at J = 4, F = 513, N = 189, NITER_LADDER iterations,
    through reverb._run_candidates on `mesh`. Returns the records and the
    best run."""
    import torch
    from pyfasst_tpu_torch.models import reverb, spatial_init as si
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints
    from pyfasst_tpu_torch.tf.stft import STFT
    from pyfasst_tpu_torch.utils.config import GEMConfig
    mix, _ = reverb_mixture(102)
    X = STFT(wlen=WLEN_CONV, fs=FS_CONV, device=device).computeTransform(
        mix).cpu().numpy()
    _, _, pw, xx = si.tf_covariance_features(X)
    cands = si.candidate_votes(si.consensus_votes(X, 4, device=device), pw)
    cands = [(f"{name}#{i}", v) for i, (name, v) in
             enumerate((cands * POOL_CHUNK)[:POOL_CHUNK // 2])]
    X_d = torch.as_tensor(X, device=device)[None] / float(
        np.sqrt(np.mean(np.abs(X) ** 2)))
    cfg = GEMConfig(niter=NITER_LADDER, spatial_hold_frac=0.3)
    return reverb._run_candidates(
        X_d, cands, pw, xx, cfg, annealing_endpoints(X_d, cfg), mesh,
        em_seeds=2, nmf_comps=6, rank=2, chunk=POOL_CHUNK)


# phase 18 (c): the state and source-filter models of phase 14 on the mesh,
# at reduced depth (a check of the path): the 6-state HMM of configs[3],
# its Viterbi row and the source-filter model, each at fp = 2 and sp = 2,
# held as the NMF legs are: MESH_EARLY_RTOL over the first
# MESH_STATE_EARLY iterations, MESH_DRIFT_RTOL over the run. The soft HMM
# carries float32 rounding through its log-space recursion faster than
# NMF: on two CPU ranks (gloo) its fp leg reads 2.7e-5, 1.1e-4, 4.0e-4 and
# 8.7e-4 through iterations 2, 5, 10 and 50, and the witness (the
# unsharded run at B = 2) 3.7e-5, 1.6e-4, 1.6e-4 and 8.6e-4; the sp leg
# 7.7e-5, the Viterbi row 4.6e-5 and the source-filter model 1.4e-4 over
# the 50 (cpu_mesh_states(), on a CPU of 8 cores). A sum left unrouted is
# off by a share of its terms
# from the first M-step on, orders of magnitude past either bar
NITER_MESH_STATE, MESH_STATE_EARLY = 50, 3


def mesh_state_models():
    """Phase 18 (c)'s models, built on the CPU from phase 14's recipes
    (hmm_mixtures, vibrato_mixture) with NITER_MESH_STATE iterations: by
    name, (params, X (1, F, N, 2), cfg), CPU tensors, the inits the
    models draw (the JAX package's numbers)."""
    from pyfasst_tpu_torch import MultiChanHMM, multiChanSourceF0Filter
    (mix, _), (mix2, _) = hmm_mixtures()
    vmix = vibrato_mixture()[0]
    n = NITER_MESH_STATE
    models = {
        "hmm": MultiChanHMM(mix, fs=FS_CONV, nbComps=2, nbStates=6,
                            wlen=WLEN_CONV, iter_num=n, sparsity="HMM",
                            device="cpu"),
        "hmm_hard": MultiChanHMM(mix2, nbStates=2, sparsity="HMM",
                                 self_trans=0.97, decode="viterbi",
                                 fs=FS_CONV, wlen=512, iter_num=n,
                                 nbComps=2, seed=0, device="cpu"),
        "simm": multiChanSourceF0Filter(
            vmix, fs=FS_CONV, nbComps=2, nbNMFComps=4, wlen=WLEN_CONV,
            n_f0=60, f0_min=100, f0_max=500, iter_num=n, device="cpu")}
    return {k: (m.params, m.Xs, m.cfg) for k, m in models.items()}


def mesh_state_cases(states, sigs, device):
    """parallel/dryrun.run_cases' cases of phase 18 (c): each model of
    mesh_state_models at fp and sp on `device`, from endpoints `sigs`."""
    return [(f"{name} {leg}", "run_sharded", dict(
        params_b=p_s, X_b=X_s, cfg=cfg_s, device=device, separate=None,
        shard_frames=leg == "sp",
        sigma_endpoints_b=tuple(x.cpu() for x in sigs[name])))
        for name, (p_s, X_s, cfg_s) in states.items() for leg in ("fp", "sp")]


def mesh_state_check(ranks, states, sigs, device):
    """Phase 18 (c)'s comparison: each model's unsharded run on `device`
    against the ranks' fp and sp legs (MESH_EARLY_RTOL over the first
    MESH_STATE_EARLY iterations, MESH_DRIFT_RTOL over the run, one E-step
    launch per iteration per rank on the card), and the witness of
    float32 drift, the unsharded run of a batch of two copies of the clip
    (a change of batch width alone). Returns (a line per model, what
    failed, the launches per rank by leg)."""
    import torch
    from pyfasst_tpu_torch.ops.gem import run_gem
    from pyfasst_tpu_torch.parallel.sharding import batch_params
    lines, bad, launches = [], [], {}
    k = MESH_STATE_EARLY
    for name, (p_s, X_s, cfg_s) in states.items():
        X_d = X_s.to(device)
        sig_s = tuple(x.to(device) for x in sigs[name])
        _, ref = run_gem(batch_params([p_s], device=device), X_d, cfg_s,
                         sigma_endpoints=sig_s)
        _, two = run_gem(batch_params([p_s, p_s], device=device),
                         torch.cat([X_d, X_d]), cfg_s,
                         sigma_endpoints=tuple(torch.cat([x, x])
                                               for x in sig_s))
        ref, two = ref.cpu().numpy(), two.cpu().numpy()[:1]
        depths = (k, 5, 10, 20, cfg_s.niter)
        parts = []
        for leg in ("fp", "sp"):
            label = f"{name} {leg}"
            ll = [np.stack(r[label]["logliks"]) for r in ranks]
            rel = {n: max(loglik_rel(x[:, :n], ref[:, :n]) for x in ll)
                   for n in depths}
            per_rank = [{kk: v for kk, v in r[label]["launches"].items()
                         if v} for r in ranks]
            launches[label] = per_rank
            parts.append(f"{leg} mesh {ranks[0][label]['mesh']}: logliks rel"
                         " through iteration " + ", ".join(
                             f"{n} {e:.2e}" for n, e in rel.items())
                         + f" (<= {MESH_EARLY_RTOL:.0e} through {k}, <= "
                         f"{MESH_DRIFT_RTOL:.0e} over the run), launches "
                         f"per rank {per_rank}")
            if not (rel[k] <= MESH_EARLY_RTOL
                    and rel[cfg_s.niter] <= MESH_DRIFT_RTOL
                    and all(np.all(np.isfinite(x)) for x in ll)):
                bad.append(f"{label}: logliks rel {rel[k]:.2e} over the first"
                           f" {k} iterations, {rel[cfg_s.niter]:.2e} over "
                           "the run")
            if str(device).startswith("cuda") and any(
                    p != {"estep": cfg_s.niter} for p in per_rank):
                bad.append(f"{label}: launches per rank {per_rank} (expected"
                           f" {cfg_s.niter} E-steps)")
        lines.append(
            f"{name} (F={X_s.shape[1]} N={X_s.shape[2]}, {cfg_s.niter} iters)"
            ": " + "; ".join(parts) + "; the witness, the unsharded run at "
            "B = 2, through iteration " + ", ".join(
                f"{n} {loglik_rel(two[:, :n], ref[:, :n]):.2e}"
                for n in depths))
    return lines, bad, launches


def cpu_mesh_states():
    """Phase 18 (c) on two gloo ranks on the CPU, with its comparison: the
    drift figures of MESH_STATE_EARLY's note (a few minutes of CPU)."""
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints
    from pyfasst_tpu_torch.parallel import dryrun
    states = mesh_state_models()
    sigs = {name: annealing_endpoints(X_s, cfg_s)
            for name, (_, X_s, cfg_s) in states.items()}
    ranks = dryrun.spawn(dryrun.run_cases, 2,
                         mesh_state_cases(states, sigs, "cpu"))
    lines, bad, _ = mesh_state_check(ranks, states, sigs, "cpu")
    for line in lines:
        print(line, flush=True)
    print("failed: " + "; ".join(bad) if bad else "within the bars",
          flush=True)


# phase 18's loglik bars against the unsharded runs, relative per element
# (loglik_rel). tests/test_sharding.py's rtol 2e-4 holds over the first 50
# iterations: 9.1e-7 (fp) and 3.1e-7 (fp fused) there, 3.4e-4 and 8.0e-4
# by iteration 100. Over the whole run float32 EM carries any change in
# the order of a sum through its trajectory: the fp legs read 3.3e-4 and
# 1.35e-3 (their endpoints from the CPU) and 3.9e-4 and 8.0e-4 (from the
# card, as now), and the witness, the same unsharded runs in two halves of
# four clips, 1.25e-3 and 1.35e-3 (chip runs of this phase; NVIDIA H100
# 80GB HBM3, 700 W). MESH_DRIFT_RTOL is 1.5 times the largest of those.
# The separation gates (SDR_GATE; phase 9's SDR_SLACK) hold the result
MESH_EARLY_ITERS, MESH_EARLY_RTOL, MESH_DRIFT_RTOL = 50, 2e-4, 2e-3


def loglik_rel(got, ref):
    """The largest |got - ref| / |ref| over clips and iterations (the
    relative difference that numpy's assert_allclose(rtol=) bounds)."""
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)
                        / np.abs(ref)))


def phase_mesh(device, card, unfused, fused, bucket):
    """Phase 18: parallel/sharding.py on the card. (a) A process group of
    one rank on NCCL in this process: phase 9's bucket through
    batch_separate(mesh=make_mesh(1)) and one chunk of phase 16's pool
    (mesh_pool) equal the unsharded runs bit for bit (phase 9's own; the
    pool's made here before the group). A mesh of one rank takes the
    single-device path: no NCCL collective runs. (b) Two gloo ranks
    spawned by parallel/dryrun.py, both on cuda:0: the bench path's B = 8
    and 500 iterations at fp = 2 (F cut into 257 and 256 rows), unfused
    and fused, from the card's annealing endpoints, logliks against phases
    4 and 8 at MESH_EARLY_RTOL over the first MESH_EARLY_ITERS iterations
    and MESH_DRIFT_RTOL over the run (loglik_rel), rank 0's images over
    SDR_GATE; and phase 9's bucket at dp = 2 (four clips a rank): logliks
    at the same bars against phase 9's, logliks and images equal to the
    unsharded run of its two halves bit for bit, every clip's min SDR
    within SDR_SLACK of phase 9's. The witness of
    float32 drift: the same unsharded runs in two halves of the clips
    against the whole batch, printed beside each leg. Each rank's launches
    are counted in the rank and printed. Returns the launches by kernel
    and the drifts."""
    import torch
    import torch.distributed as dist
    from pyfasst_tpu_torch import batch_separate, convert
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints, run_gem
    from pyfasst_tpu_torch.parallel import dryrun
    from pyfasst_tpu_torch.parallel.sharding import make_mesh
    from pyfasst_tpu_torch.tf.stft import _istft_core, _stft_core
    from pyfasst_tpu_torch.utils.config import GEMConfig
    t0 = time.perf_counter()
    bad = []
    Xs, trees, cfg_c = bucket["Xs"], bucket["trees"], bucket["cfg"]

    def make_params(F, n_pad, i):
        return convert.params_from_numpy(trees[i], device=device)

    def same_pool(a, b):
        (ra, ba), (rb, bb) = a, b
        return (ra == rb and torch.equal(ba[0]["Y"], bb[0]["Y"])
                and all(np.array_equal(x, y) for x, y in zip(
                    dryrun._host(ba[0]["params"]).values(),
                    dryrun._host(bb[0]["params"]).values())))

    pool_ref = mesh_pool(device, make_mesh(1, device=device))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(1, device=device)
            _reset_counts()
            imgs, lls = batch_separate(Xs, make_params, cfg_c, mesh=mesh)
            total, counts = _counts()
            pool = mesh_pool(device, mesh)
            pool_total, _ = _counts()
        finally:
            dist.destroy_process_group()
    bucket_same = all(np.array_equal(a, b) for a, b in zip(
        imgs + lls, bucket["images"] + bucket["logliks"]))
    pool_same = same_pool(pool, pool_ref)
    ws1 = {"bucket": total, "pool": pool_total - total}
    log(f"phase 18 (a) NCCL world size 1: phase 9's bucket through "
        f"batch_separate(mesh=make_mesh(1)): launches {total} {counts}, "
        f"logliks and images bit for bit {bucket_same}; phase 16's pool "
        f"chunk ({POOL_CHUNK} runs, {NITER_LADDER} iters): launches "
        f"{ws1['pool']}, records, best images and params bit for bit "
        f"{pool_same} | {time.perf_counter() - t0:.2f}s")
    if not (bucket_same and pool_same):
        bad.append(f"world size 1 differs from the unsharded runs (bucket "
                   f"{bucket_same}, pool {pool_same})")
    if total != NITER_CONV or ws1["pool"] != NITER_LADDER:
        bad.append(f"world size 1 launches {ws1} (expected {NITER_CONV} "
                   f"and {NITER_LADDER})")

    mix, y_true, window, nsamples, F, N, _ = bench_setup(device, DUR, BATCH)
    X_d = _stft_core(mix, window, WLEN, HOP, "fft")
    # phases 4 and 8 compute the endpoints on the card: the ranks get those
    sig_d = annealing_endpoints(X_d, GEMConfig(niter=NITER))
    X, sig = X_d.cpu(), tuple(s.cpu() for s in sig_d)
    params = convert.params_from_numpy(
        [bench_tree(F, N, seed=b) for b in range(BATCH)], device="cpu")
    dev0 = "cuda:0"
    cfgs = {"fp": GEMConfig(niter=NITER),
            "fp fused": GEMConfig(niter=NITER, fuse_spectral=True)}
    cases = [(label, "run_sharded", dict(
        params_b=params, X_b=X, cfg=cfg, device=dev0, separate="rank0",
        sigma_endpoints_b=sig)) for label, cfg in cfgs.items()]
    cases.append(("dp", "bucket_case", dict(
        Xs=[x.cpu() for x in Xs],
        params_list=[convert.params_from_numpy(t, device="cpu")
                     for t in trees], cfg=cfg_c, device=dev0)))
    # (c) the routed state and source-filter models at fp = 2 and sp = 2,
    # from the card's annealing endpoints
    states = mesh_state_models()
    state_sig = {name: annealing_endpoints(X_s.to(device), cfg_s)
                 for name, (_, X_s, cfg_s) in states.items()}
    cases += mesh_state_cases(states, state_sig, dev0)
    t1 = time.perf_counter()
    ranks = dryrun.spawn(dryrun.run_cases, 2, cases)
    spawn_s = time.perf_counter() - t1

    # the witnesses: the same unsharded runs in two halves of the clips, in
    # this process (a change of batch width alone, no cross-rank sum)
    half = BATCH // 2
    t1 = time.perf_counter()
    halves = {}
    for label, cfg in cfgs.items():
        lls = []
        for lo in (0, half):
            p = convert.params_from_numpy(
                [bench_tree(F, N, seed=b) for b in range(lo, lo + half)],
                device=device)
            _, ll = run_gem(p, X_d[lo:lo + half].contiguous(), cfg,
                            sigma_endpoints=tuple(
                                s[lo:lo + half].contiguous() for s in sig_d))
            lls.append(ll.cpu().numpy())
        halves[label] = np.concatenate(lls)
    nc = len(Xs) // 2
    dp_halves = [batch_separate(Xs[lo:lo + nc], lambda F_, n, i, lo=lo:
                                make_params(F_, n, lo + i), cfg_c,
                                device=device) for lo in (0, nc)]
    halves["dp"] = np.stack(dp_halves[0][1] + dp_halves[1][1])
    dp_half_imgs = dp_halves[0][0] + dp_halves[1][0]
    halves_s = time.perf_counter() - t1

    launches, drift = {}, {}
    for label, ref, want in (
            ("fp", unfused["logliks"], {"estep": NITER}),
            ("fp fused", fused["logliks"],
             {"estep": NITER, "fb_stats": NITER, "tw_stats": NITER}),
            ("dp", np.stack(bucket["logliks"]), {"estep": NITER_CONV})):
        ll = [np.stack(r[label]["logliks"]) for r in ranks]
        k = MESH_EARLY_ITERS
        early = max(loglik_rel(x[:, :k], ref[:, :k]) for x in ll)
        run = max(loglik_rel(x, ref) for x in ll)
        wit = loglik_rel(halves[label], ref)
        drift[label] = {"sharded": run, "halves": wit}
        by_depth = {n: max(loglik_rel(x[:, :n], ref[:, :n]) for x in ll)
                    for n in (5, k, 100, 250, 400, ref.shape[1])
                    if n <= ref.shape[1]}
        same = all(np.array_equal(x, ref) for x in ll)
        per_rank = [{k: v for k, v in r[label]["launches"].items() if v}
                    for r in ranks]
        launches[label] = per_rank
        if label != "dp":
            Y = torch.as_tensor(ranks[0][label]["Y"], device=device)
            sdrs = min_sdr(_istft_core(Y, window, WLEN, HOP, nsamples),
                           y_true)
            sdr = (" | rank 0's images: per-clip min SDR "
                   + " ".join(f"{x:.2f}" for x in sdrs))
            if not np.all(sdrs > SDR_GATE):
                bad.append(f"{label}: separation below {SDR_GATE} dB: "
                           f"{sdrs}")
        else:
            imgs = ranks[0][label]["images"]
            as_halves = all(np.array_equal(x, y) for x, y in zip(
                [np.stack(r[label]["logliks"]) for r in ranks]
                + imgs, [halves["dp"]] * len(ranks) + dp_half_imgs))
            peak = max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                       for a, b in zip(imgs, bucket["images"]))
            sdrs = bucket["sdrs"](imgs)
            sdr = (f" | equal to the unsharded run of its two halves "
                   f"(logliks, images) bit for bit {as_halves} | rank 0's "
                   f"images {peak:.2e} of peak from phase 9's, per-clip min "
                   "SDR " + " ".join(f"{x:.2f}" for x in sdrs)
                   + " (phase 9: " + " ".join(f"{x:.2f}" for x in
                                               bucket["sdr"]) + ")")
            if not as_halves:
                bad.append("dp: not the unsharded run of its two halves")
            if any(abs(a - b) > SDR_SLACK
                   for a, b in zip(sdrs, bucket["sdr"])):
                bad.append(f"dp: per-clip min SDR {sdrs} not within "
                           f"{SDR_SLACK} dB of phase 9's {bucket['sdr']}")
        log(f"phase 18 (b) gloo 2 ranks on {dev0}, {label} mesh "
            f"{ranks[0][label]['mesh']}: logliks rel from the unsharded B = "
            f"{ref.shape[0]} run: first {k} iterations {early:.2e} (<= "
            f"{MESH_EARLY_RTOL:.0e}), the run {run:.2e} (<= "
            f"{MESH_DRIFT_RTOL:.0e}; through iteration "
            + ", ".join(f"{n} {e:.2e}" for n, e in by_depth.items())
            + f"; bit for bit {same}); the witness, unsharded in two halves "
            f"of {ref.shape[0] // 2} clips: {wit:.2e}; launches per rank "
            f"{per_rank}{sdr}")
        if not (early <= MESH_EARLY_RTOL and run <= MESH_DRIFT_RTOL):
            bad.append(f"{label}: logliks rel {early:.2e} over the first "
                       f"{k} iterations, {run:.2e} over the run")
        if any(p != want for p in per_rank):
            bad.append(f"{label}: launches per rank {per_rank} (expected "
                       f"{want})")
    t1 = time.perf_counter()
    lines, bad_c, launches_c = mesh_state_check(ranks, states, state_sig,
                                                device)
    for line in lines:
        log(f"phase 18 (c) gloo 2 ranks on {dev0}, {line}")
    bad += bad_c
    launches.update(launches_c)
    states_s = time.perf_counter() - t1
    log(f"phase 18 done: the two ranks' spawn and runs {spawn_s:.2f}s, the "
        f"witnesses {halves_s:.2f}s, (c)'s unsharded runs {states_s:.2f}s | "
        f"{card} | {time.perf_counter() - t0:.2f}s")
    if bad:
        raise RuntimeError("phase 18: " + "; ".join(bad))
    return {"ws1": ws1, "ranks": launches, "drift": drift}


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
    main_abs, erb_kernel = phase_kernel_vs_plain(device)
    general = phase_general_vs_plain(device)
    wide = phase_wide_vs_plain(device)
    ef, f_launches = phase_variants_ef(device)
    spectral = phase_spectral_vs_plain(device)
    stream_kernel = stream_kernel_check(device)
    cli_nums = phase_cli_shapes(device)
    _reset_counts()
    launches = phase_host_api(device, DUR, NITER)
    timing = phase_batch(device, DUR, NITER, BATCH, card)
    path_launches = {"a": launches,
                     "b": phase_conv(device, "anechoic", card)["b"],
                     "c": phase_conv(device, "reverb", card)["c"],
                     "d": phase_ns_inj(device)["d"]}
    fused = phase_fused(device, DUR, NITER, BATCH, card, timing)
    path_launches["e"] = fused["fused+fast_recip"]["counts"]["e"]
    batch_c, batch_run = phase_conv_batch(device, "reverb", card)
    batch_launches = {"c": batch_c,
                      "b": phase_conv_batch(device, "anechoic", card)[0]}
    phase_general(device, card)
    k_big = phase_k_big(device, card)
    erb_launches, _ = phase_erblet(device, card)
    hmm_launches, _ = phase_hmm(device, card)
    stream_launches, _ = phase_stream(device, card)
    blind_launches, _ = phase_blind(device, card)
    phase_cli(card, cli_nums)
    mesh = phase_mesh(device, card, timing, fused["fused"],
                      batch_run.pop("bucket"))
    five = phase_five(device, card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}s")
    log(card)

    def entry(name, source, replaces, launches, nums):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
                "plain_ms": nums["plain_ms"], "bound_ms": nums["bound_ms"],
                "bound_by": nums["bound_by"], "library_ms": None}

    def cli_paths(*labels):
        """Phase 17's shapes of one kernel variant: phase 2's numbers and
        the launches phase 17 made at each, keys cli_<label>_<key>."""
        return {f"cli_{label}_{key}": cli_nums[label].get(key, 0)
                for label in labels for key in (
                    "shape", "ranks", "ms", "plain_ms", "bound_ms",
                    "bound_by", "max_abs_err", "launches")}

    kernels = [dict(
        entry("estep_r1_real (variant a: real rank-1 mixing)",
              KERNEL_SOURCE, f"{REPLACES} (variant a)",
              path_launches["a"], dict(timing, max_abs_err=main_abs,
                                       ms=timing["kernel_ms"])),
        erblet48_shape=erb_kernel["shape"], erblet48_ms=erb_kernel["ms"],
        erblet48_plain_ms=erb_kernel["plain_ms"],
        erblet48_bound_ms=erb_kernel["bound_ms"],
        erblet48_bound_by=erb_kernel["bound_by"],
        erblet48_nofma_floor_ms=erb_kernel["nofma_floor_ms"],
        erblet48_max_abs_err=erb_kernel["max_abs_err"],
        erblet48_launches=erb_launches, configs3_launches=hmm_launches,
        mesh_fp_launches_per_rank=[r["estep"] for r in mesh["ranks"]["fp"]],
        mesh_fp_fused_launches_per_rank=[
            r["estep"] for r in mesh["ranks"]["fp fused"]],
        **cli_paths("inst", "batch"))]
    for key, label in GENERAL_HEADLINE.items():
        path = general[label]["path"]
        extra = {}
        if key in batch_launches:
            bp = general[label]["batch_path"]
            extra = dict(batch_path_shape=bp["shape"], batch_path_ms=bp["ms"],
                         batch_path_plain_ms=bp["plain_ms"],
                         batch_path_bound_ms=bp["bound_ms"],
                         batch_path_launches=batch_launches[key])
        if key == "c":
            pp = general[label]["pool_path"]
            extra.update(mesh_ws1_launches=mesh["ws1"],
                         mesh_dp_launches_per_rank=[
                             r["estep"] for r in mesh["ranks"]["dp"]],
                         pool_path_shape=pp["shape"], pool_path_ms=pp["ms"],
                         pool_path_plain_ms=pp["plain_ms"],
                         pool_path_bound_ms=pp["bound_ms"],
                         pool_path_bound_by=pp["bound_by"],
                         pool_path_max_abs_err=pp["max_abs_err"],
                         pool_path_launches=blind_launches,
                         **cli_paths("speech_pool", "speech_band_probes",
                                     "music_fine_pool", "music_fine_reseed",
                                     "music_coarse_pool",
                                     "music_coarse_reseed"))
        if key == "b":
            extra.update(
                stream_shape=stream_kernel["shape"],
                stream_ms=stream_kernel["ms"],
                stream_plain_ms=stream_kernel["plain_ms"],
                stream_bound_ms=stream_kernel["bound_ms"],
                stream_bound_by=stream_kernel["bound_by"],
                stream_max_abs_err=stream_kernel["max_abs_err"],
                stream_launches=stream_launches,
                **cli_paths("stream"))
        kernels.append(dict(
            entry(f"estep_general (variant {key}: {label})", GENERAL_SOURCE,
                  GENERAL_REPLACES[key], path_launches[key], general[label]),
            path_shape=path["shape"], path_ms=path["ms"],
            path_plain_ms=path["plain_ms"], path_bound_ms=path["bound_ms"],
            **extra))
    kernels.append(entry("estep_r1_real with fast_recip (variant e)",
                         KERNEL_SOURCE, GENERAL_REPLACES["e"],
                         path_launches["e"], ef["e"]))
    kernels.append(dict(
        entry("estep_r1_real with no_ll (variant f)", KERNEL_SOURCE,
              GENERAL_REPLACES["f"], f_launches, ef["f"]),
        launches_from="phase 2: its checks against the plain version and "
                      "the timing's warm-up calls (calls under graph "
                      "capture and replays do not count); no path sets "
                      "no_ll (pallas_estep.py:446 is its only use in the "
                      "JAX package)"))
    for name in ("fb_stats", "tw_stats"):
        kernels.append(dict(
            entry(name, SPECTRAL_SOURCE, SPECTRAL_REPLACES[name],
                  fused["fused"]["spectral"][name], spectral[name]),
            mesh_fp_fused_launches_per_rank=[
                r[name] for r in mesh["ranks"]["fp fused"]]))
    # the tiled form (K past 32: V once per tile over all K), phase 12's
    # path at each K of K_BIG, and the host API's B = 1 shape (the split
    # contracted axis); the first K's bench numbers stand for it
    for name in ("fb_stats", "tw_stats"):
        nums = [spectral[f"{name} K={k}"] for k in K_BIG]
        b1 = [spectral[f"{name} K={k} B=1"] for k in K_BIG]
        fields = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                  "max_abs_err", "nofma_floor_ms")
        kernels.append(dict(
            entry(f"{name} (tiled: K > 32, V once per tile over all K)",
                  SPECTRAL_SOURCE, SPECTRAL_REPLACES[name],
                  sum(k_big[k][name] for k in K_BIG), nums[0]),
            shape=nums[0]["shape"],
            nofma_floor_ms=nums[0]["nofma_floor_ms"],
            launches_by_k={str(k): k_big[k][name] for k in K_BIG},
            **{f"k{k}_{f}": n[f] for k, n in zip(K_BIG, nums)
               for f in fields},
            **{f"k{k}_b1_{f}": n[f] for k, n in zip(K_BIG, b1)
               for f in fields}))
    # the general kernel at J = 5 to 8: phase 19's paths take the first two
    # cases; the others run in phase 2 only
    path_of = {"inst": ("a", five["inst"]["a"]),
               "reverb5": ("c", five["reverb5"]["c"])}
    for key, label, J_, ranks, real, ns, path in WIDE_CASES:
        nums = wide[label]
        extra = {"shape": [BATCH, J_, 513, 863], "ranks": list(ranks),
                 "nofma_floor_ms": nums["nofma_floor_ms"]}
        if path:
            launches = path_of[path][1]
            pn = nums["path"]
            extra.update(path_shape=pn["shape"], path_ms=pn["ms"],
                         path_plain_ms=pn["plain_ms"],
                         path_bound_ms=pn["bound_ms"],
                         path_bound_by=pn["bound_by"],
                         launches_from=f"phase 19 ({path})")
        else:
            launches = nums["phase2_launches"]
            extra["launches_from"] = (
                "phase 2: its checks against the plain version and the "
                "timing's warm-up and eager calls (replays do not count); "
                "no path runs this instantiation")
        kernels.append(dict(
            entry(f"estep_general J={J_} (variant {key}: {label})",
                  f"pyfasst_tpu_torch/csrc/estep_j{J_}.cu ({GENERAL_SOURCE})",
                  f"{REPLACES} (J = {J_}, ranks {ranks}, "
                  f"real_cov={real}, ns_inj={ns})", launches, nums),
            **extra))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
