#!/usr/bin/env python3
"""Time the port's CUDA kernels in several trees on one card, in turns.

    python3 kernel_compare.py --tree parent=chip_checkout/parent \\
        --variant fb_rows16 spectral.cu "kFbRows = 8;" "kFbRows = 16;"

A side is a directory that holds a `pyfasst_tpu_torch` package:
  - "this": this checkout;
  - --tree NAME=DIR: another checkout, for example a parent commit
    unpacked with `git archive` into chip_checkout/ (gitignored);
  - --variant NAME FILE OLD NEW: a copy of this checkout's package under
    chip_checkout/variants/NAME/, with the one occurrence of OLD in
    csrc/FILE replaced by NEW (a tuning experiment); several --variant
    with one NAME make one side with all their replacements.
Each side runs in a process of its own, which builds its package's kernels
(_build.build, into that package's _build/), checks each kernel against its
plain version at chip_smoke.py's bars and times it with chip_smoke.py's
_graph_ms (CUDA-graph replay: device time), the same ruler for every side:
estep_r1_real (variant a, and with fast_recip and no_ll) at B = 8,
F = 513, N = 863, and variant a at the host API's B = 1, at the erblet48
plane (1, 2, 48, 98304; it splits its frames) and at configs[3]'s Viterbi
row (1, 2, 257, 376; too few frames a row to split); the general
kernel's GENERAL_CASES at the bench shape and at the conv paths' own
(B = 1, F = 513, N = 189), 1c at the configs[2] bucket and blind pool, 1c'
at the speech pool and the music coarse stage, and its WIDE_CASES (J = 5
to 16; a side whose wrapper refuses a J skips it) at the bench shape and
at phase 19's path shapes, every J of 9 to 16 at real rank 1, complex
rank 1, complex rank 2 and real rank 2 and with ns_inj at complex rank 1
and 2 at the bench shape ("1g''"), and csrc/estep_many.cu (J at run time) at
(8, J, 513, 863) for each J of chip_smoke.MANY_TABLE_J, real rank 1 and
complex rank 2, at chip_smoke.MANY_PATH and at (1, 61, 513, 863) real
rank 1 (its chunked route); fb_stats and tw_stats at the
bench shape (B = 8,
J = 2, F = 513, N = 863, K = 8) and at B = 1, and the same at each K of
chip_smoke.K_BIG (40 and 64: the tiled kernel past 32). The sides run in
turns, forward and then backward (this, parent, parent, this), --rounds
times; a kernel's figure is the median of its side's samples. Each side
also hashes the bits of each kernel's outputs on its (seeded) inputs, and
the table says whether every other side's bits equal this checkout's, and
for the E-step whether xi's do (the frame sums may differ in their last
bits when a side changes their order).
--only TEXT keeps the cases whose name holds TEXT. Prints the card
(nvidia-smi name and power limit), one line per side and run, and a table
of medians; writes every sample to chiprun_out/kernel_compare.json.
Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "pyfasst_tpu_torch"


def _smoke():
    """This checkout's chip_smoke.py, for its inputs, bars and timers; its
    functions import the package of whichever side is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "kernel_compare_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _within(smoke, got, want, tol):
    """The largest error over outputs as a share of its bar (<= 1 passes):
    the E-step's five frame outputs and its loglik, or the spectral
    kernels' relative error."""
    if tol is None:
        return max(float(((g - w).abs() / w.abs()).max()) / smoke.SPECTRAL_RTOL
                   for g, w in zip(got, want))
    worst = max(smoke._rel_err(g, w) / tol[n] for n, g, w in
                zip(("xi", "txs", "tss", "t4", "t7"), got, want))
    ll_g, ll_w = -got[5].sum(-1), -want[5].sum(-1)
    return max(worst, float(((ll_g - ll_w).abs() / ll_w.abs()).max())
               / tol["loglik"])


def cases(smoke, device):
    """(name, kernel call, plain call, bars) of every timed kernel."""
    from pyfasst_tpu_torch.ops import cuda_estep, cuda_spectral
    out = []
    bench = (smoke.BATCH, 513, 863)
    inp = smoke._estep_inputs(*bench, seed=1, device=device)
    one = smoke._estep_inputs(1, 513, 863, seed=1, device=device)
    erb = smoke._estep_inputs(1, smoke.ERB_SHAPE[2], smoke.ERB_SHAPE[3],
                              seed=1, device=device)
    vit = smoke._estep_inputs(1, 257, 376, seed=1, device=device)
    for name, flags, i in (("1a", {}, inp), ("1e", {"fast_recip": True}, inp),
                           ("1f", {"no_ll": True}, inp),
                           ("1a 1x513x863", {}, one),
                           ("1a' erblet48 1x48x98304", {}, erb),
                           ("1a 1x257x376", {}, vit)):
        no_ll = {"no_ll": True} if "no_ll" in flags else {}
        out.append((name,
                    lambda f=flags, i=i: cuda_estep.estep_r1_real(**i, **f),
                    lambda f=no_ll, i=i: cuda_estep.estep_r1_real_ref(**i,
                                                                      **f),
                    smoke.TOL))
    for key, label, J_, ranks, real, ns in smoke.GENERAL_CASES:
        tol = dict(smoke.TOL, xi=3e-4 if max(ranks) == 2 else smoke.TOL["xi"])
        for shape in (bench, (1, 513, smoke.conv_frames())):
            g_inp = smoke._general_inputs(*shape[:1], J_, *shape[1:], ranks,
                                          real, seed=2, device=device)
            kw = dict(ns_inj=ns, real_cov=real)
            out.append((f"1{key} {label} {'x'.join(map(str, shape))}",
                        lambda a=g_inp, r=ranks, k=kw:
                        cuda_estep.estep_general(*a, r, **k),
                        lambda a=g_inp, r=ranks, k=kw:
                        cuda_estep.estep_ref(*a, r, **k), tol))
    # 1c at phase 9's bucket and phase 16's pool, and 1c' (J = 3, ranks
    # (2, 2, 2)) at the speech preset's pool and the music preset's coarse
    # stage and its reseeds (phase 17)
    c_tol = dict(smoke.TOL, xi=3e-4)
    for name, ranks, shape in (
            ("1c complex J=4 rank 2", (2,) * 4,
             (len(smoke.CONV_BATCH_SEEDS["reverb"]), 513,
              smoke.padded_frames(smoke.conv_frames()))),
            ("1c complex J=4 rank 2", (2,) * 4,
             (smoke.POOL_CHUNK, 513, smoke.conv_frames())),
            ("1c' complex J=3 rank 2", (2,) * 3,
             (smoke.POOL_CHUNK, 1025, 158)),
            ("1c' complex J=3 rank 2", (2,) * 3, (6, 4097, 66)),
            ("1c' complex J=3 rank 2", (2,) * 3, (2, 4097, 66))):
        g_inp = smoke._general_inputs(shape[0], len(ranks), *shape[1:],
                                      ranks, False, seed=2, device=device)
        out.append((f"{name} {'x'.join(map(str, shape))}",
                    lambda a=g_inp, r=ranks: cuda_estep.estep_general(*a, r),
                    lambda a=g_inp, r=ranks: cuda_estep.estep_ref(*a, r),
                    c_tol))
    # the general kernel at J = 5 to 8 (WIDE_CASES): the bench shape, and
    # phase 19's path shape where a case has one
    paths = smoke.wide_path_shapes()
    for key, label, J_, ranks, real, ns, path in smoke.WIDE_CASES:
        tol = dict(smoke.TOL, xi=3e-4 if max(ranks) == 2 else smoke.TOL["xi"])
        for shape in (bench,) + ((paths[path],) if path else ()):
            g_inp = smoke._general_inputs(*shape[:1], J_, *shape[1:], ranks,
                                          real, seed=2, device=device)
            kw = dict(ns_inj=ns, real_cov=real)
            out.append((f"1g {label} {'x'.join(map(str, shape))}",
                        lambda a=g_inp, r=ranks, k=kw:
                        cuda_estep.estep_general(*a, r, **k),
                        lambda a=g_inp, r=ranks, k=kw:
                        cuda_estep.estep_ref(*a, r, **k), tol))
    # row 1g'': the general kernel at every J of 9 to 16, real rank 1,
    # complex rank 1, complex rank 2 and real rank 2, and ns_inj at
    # complex rank 1 and 2, at the bench shape (those that WIDE_CASES does
    # not time already)
    timed = {(J_, ranks, real, ns) for _, _, J_, ranks, real, ns, _ in
             smoke.WIDE_CASES}
    for J_ in range(9, 17):
        for R, real, ns in ((1, True, False), (1, False, False),
                            (2, False, False), (2, True, False),
                            (1, False, True), (2, False, True)):
            ranks = (R,) * J_
            if (J_, ranks, real, ns) in timed:
                continue
            tol = dict(smoke.TOL, xi=3e-4 if R == 2 else smoke.TOL["xi"])
            g_inp = smoke._general_inputs(bench[0], J_, *bench[1:], ranks,
                                          real, seed=2, device=device)
            kw = dict(ns_inj=ns, real_cov=real)
            out.append((f"1g'' {'ns_inj ' if ns else ''}"
                        f"{'real' if real else 'complex'} J={J_} rank "
                        f"{R} {'x'.join(map(str, bench))}",
                        lambda a=g_inp, r=ranks, k=kw:
                        cuda_estep.estep_general(*a, r, **k),
                        lambda a=g_inp, r=ranks, k=kw:
                        cuda_estep.estep_ref(*a, r, **k), tol))
    # csrc/estep_many.cu (J at run time): row 1g'''s bench shapes, real
    # rank 1 and complex rank 2 at each J of MANY_TABLE_J, and phase 19
    # (d)'s path (a tree from before it refuses these: skipped)
    many = [(bench, J_, (R,) * J_, R == 1) for J_ in smoke.MANY_TABLE_J
            for R in (1, 2)]
    many.append((smoke.MANY_PATH[:1] + smoke.MANY_PATH[2:],
                 smoke.MANY_PATH[1], (1,) * smoke.MANY_PATH[1], True))
    # and its chunked route at real mixing: J = 61 real rank 1 at B = 1,
    # past the fused route's last J at any rank and mixing
    many.append(((1, 513, 863), 61, (1,) * 61, True))
    for shape, J_, ranks, real in many:
        tol = dict(smoke.TOL, xi=3e-4 if max(ranks) == 2 else smoke.TOL["xi"])
        g_inp = smoke._general_inputs(shape[0], J_, *shape[1:], ranks, real,
                                      seed=2, device=device)
        out.append((f"1g''' J={J_} rank {max(ranks)} "
                    f"{'real' if real else 'complex'} "
                    f"{'x'.join(map(str, shape))}",
                    lambda a=g_inp, r=ranks, re=real:
                    cuda_estep.estep_general(*a, r, real_cov=re),
                    lambda a=g_inp, r=ranks, re=real:
                    cuda_estep.estep_ref(*a, r, real_cov=re), tol))
    for K_ in (smoke.K,) + smoke.K_BIG:
        for B, tag in ((smoke.BATCH, ""), (1, " 1x2x513x863")):
            s_inp = smoke._spectral_inputs(B, smoke.J, 513, 863, K_,
                                           seed=3, device=device)
            for name in ("fb_stats", "tw_stats"):
                label = name + ("" if K_ == smoke.K else f" K={K_}") + tag
                out.append((label,
                            lambda n=name, a=s_inp:
                            getattr(cuda_spectral, n)(*a),
                            lambda n=name, a=s_inp:
                            getattr(cuda_spectral, f"{n}_ref")(*a), None))
    return out


def _bits(outputs):
    """A hash of the bits of a kernel's outputs."""
    import hashlib
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def run_side(name, directory, reps, only=()):
    """One side, in this process: build, check, time; prints one JSON
    line of {"side", "build_s", "ms": {case: samples}, "err": {case:
    error over bar}, "bits": {case: hash of the outputs}, "info": {kernel:
    _build.kernel_info or None}}. A case the side's wrapper refuses
    (NotImplementedError: a J it has no kernel for) is left out."""
    sys.path.insert(0, str(Path(directory).resolve()))
    import torch
    from pyfasst_tpu_torch.ops import _build
    smoke = _smoke()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    info = _build.build()
    result = {"side": name, "dir": str(directory),
              "build_s": info["seconds"], "ms": {}, "err": {}, "bits": {},
              "xi_bits": {}, "info": {}}
    for label, kernel, args in (
            ("estep_r1_real", "estep_r1_real", (smoke.J,)),
            ("tw_stats", "tw_stats", (smoke.K, 513))) + tuple(
                (f"{n} K={k}", n, (k,) if n == "fb_stats" else (k, 513))
                for k in smoke.K_BIG for n in ("fb_stats", "tw_stats")):
        try:        # a tree from before these entry points has none
            result["info"][label] = _build.kernel_info(kernel, *args)
        except AttributeError:
            result["info"][label] = None
    for case, kernel, plain, tol in cases(smoke, device):
        if only and not any(t in case for t in only):
            continue
        try:
            got = kernel()
        except NotImplementedError:
            continue
        err = _within(smoke, got, plain(), tol)
        result["bits"][case] = _bits(got)
        if tol is not None:     # the E-step: xi has no sum in it
            result["xi_bits"][case] = _bits(got[:1])
        if not err <= 1.0:
            raise RuntimeError(f"{name}: {case} disagrees with its plain "
                               f"version ({err:.2f} of its bar)")
        result["err"][case] = err
        result["ms"][case] = smoke._graph_ms(kernel, reps, 10)
    print(json.dumps(result), flush=True)


def make_copy(dest, edits=(), tree=ROOT):
    """The package under `tree` copied into `dest` (without its builds),
    with, for each (FILE, OLD, NEW) of `edits`, the one occurrence of OLD
    in csrc/FILE replaced by NEW; returns `dest`."""
    dest = Path(dest)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(Path(tree) / PKG, dest / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for file, old, new in edits:
        src = dest / PKG / "csrc" / file
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{dest.name}: {old!r} occurs "
                             f"{text.count(old)} times in {file}, not once")
        src.write_text(text.replace(old, new))
    return dest


def make_variant(name, edits):
    """make_copy of this checkout's package under
    chip_checkout/variants/NAME/."""
    return make_copy(ROOT / "chip_checkout" / "variants" / name, edits)


def build_copies(dirs, names):
    """Builds the libraries `names` of the package in each directory of
    `dirs` ({side: directory}), one process a copy, all started together;
    {side: {name: path of its library}}. Load one with _build.load(name,
    path)."""
    cmd = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
           "from pyfasst_tpu_torch.ops import _build; "
           "i = _build.build(names=sys.argv[2:]); "
           "print(json.dumps([i['seconds'], i['paths']]))")
    procs = {side: subprocess.Popen(
        [sys.executable, "-c", cmd, str(d), *names], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for side, d in dirs.items()}
    paths = {}
    for side, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(out[-3000:])
        secs, paths[side] = json.loads(out.strip().splitlines()[-1])
        print(f"built {side}: {', '.join(names)} in {secs:.1f} s",
              flush=True)
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--variant", action="append", default=[], nargs=4,
                    metavar=("NAME", "FILE", "OLD", "NEW"))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("--only", action="append", default=[], metavar="TEXT",
                    help="time only the cases whose name contains TEXT "
                    "(repeatable)")
    ap.add_argument("--side", nargs=2, metavar=("NAME", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        run_side(*args.side, args.reps, args.only)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    print(smoke.smi(), flush=True)
    sides = [("this", ROOT)]
    sides += [tuple(t.split("=", 1)) for t in args.tree]
    edits = {}
    for name, *edit in args.variant:
        edits.setdefault(name, []).append(edit)
    sides += [(name, make_variant(name, e)) for name, e in edits.items()]
    order = (sides + sides[::-1]) * args.rounds
    runs = []
    for name, directory in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--side", name,
             str(directory), "--reps", str(args.reps)]
            + [a for t in args.only for a in ("--only", t)],
            capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(f"side {name} failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(res)
        print(f"{name}: build {res['build_s']:.1f}s | " + ", ".join(
            f"{k} {i['warps_per_sm']}w/{i['registers']}r/{i['local_bytes']}B"
            for k, i in res["info"].items() if i) + " | "
              + ", ".join(f"{c} {statistics.median(m):.4f}"
                          for c, m in res["ms"].items()), flush=True)
    names = [n for n, _ in sides]
    table = {n: {} for n in names}
    bits = {n: {} for n in names}
    xi_bits = {n: {} for n in names}
    for res in runs:
        for c, m in res["ms"].items():
            table[res["side"]].setdefault(c, []).extend(m)
            bits[res["side"]].setdefault(c, set()).add(res["bits"][c])
            if c in res.get("xi_bits", {}):
                xi_bits[res["side"]].setdefault(c, set()).add(
                    res["xi_bits"][c])

    def equal(kind, n, c):
        return ("-" if c not in kind[n] or c not in kind["this"] else
                str(kind[n][c] == kind["this"][c] and len(kind[n][c]) == 1))

    def ratio(n, c):
        if c not in table[n]:
            return "-"
        r = statistics.median(table["this"][c]) / statistics.median(
            table[n][c])
        return f"{r:.3f}"

    print("median ms by CUDA-graph replay | " + " | ".join(names)
          + " | bits equal this side's (" + ", ".join(names[1:])
          + ") | xi's bits equal (E-step) | this side's time over ("
          + ", ".join(names[1:]) + ")")
    for c in table["this"]:
        print(f"{c} | " + " | ".join(
            f"{statistics.median(table[n][c]):.4f}" if c in table[n]
            else "-" for n in names) + " | "
            + ", ".join(equal(bits, n, c) for n in names[1:]) + " | "
            + ", ".join(equal(xi_bits, n, c) for n in names[1:]) + " | "
            + ", ".join(ratio(n, c) for n in names[1:]))
    out = ROOT / "chiprun_out" / "kernel_compare.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"card": smoke.smi(), "order": [
        r["side"] for r in runs], "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
