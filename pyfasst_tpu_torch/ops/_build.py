"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Compiles the ``csrc/*.cu`` of the package to objects, one nvcc process per
source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -c -o _build/<name>.o csrc/<name>.cu

and links them into shared libraries with a plain C interface
(``nvcc -shared``) in ``pyfasst_tpu_torch/_build/``. There are three:
"core" (csrc/estep.cu, csrc/spectral.cu and the general E-step at J = 2 to
8, csrc/estep_j{2..8}.cu), "wide" (the general E-step at J = 9 to 16,
csrc/estep_j{9..16}.cu, the longest units to compile) and "many" (the
E-step at any other J, J an argument of the launch, csrc/estep_many.cu).
Each is built and loaded the first time one of its kernels is asked for,
so a caller at J <= 8 waits for neither of the others. A stamp beside
each library holds a hash of its sources, the shared headers and the
flags, so an unchanged tree is not rebuilt. Only the sources in the
package and the CUDA toolkit's headers go into the build. A failed build
raises with nvcc's output; nothing falls back to the plain PyTorch
versions. Each compile-time J of the general E-step kernel is its own
source, so its instantiations compile in parallel. No --use_fast_math: the kernels rely on exact IEEE divides and
logf (the E-step's fast_recip flag asks for its approximate reciprocal
explicitly, csrc/recip.cuh); and --fmad=false keeps every product rounded
as the plain versions round it (see csrc/estep.cu).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAMES = {"core": "libpyfasst_kernels.so",
             "wide": "libpyfasst_estep_wide.so",
             "many": "libpyfasst_estep_many.so"}
# the general E-step's compile-time J in the core and the wide library;
# every other J is the many library's
CORE_J = range(2, 9)
WIDE_J = range(9, 17)
MANY_SOURCE = "estep_many.cu"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


class NvccError(RuntimeError):
    """nvcc failed or was not found."""


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, the PATH, or /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise NvccError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_of(J: int) -> str:
    """The library that holds the general E-step kernel at J sources."""
    return "core" if J in CORE_J else "wide" if J in WIDE_J else "many"


def sources(name: str):
    """(.cu sources of library `name`, every shared header)."""
    own = {"wide": {f"estep_j{J}.cu" for J in WIDE_J},
           "many": {MANY_SOURCE}}
    own["core"] = {p.name for p in SRC_DIR.glob("*.cu")} - own["wide"] \
        - own["many"]
    cu = [p for p in sorted(SRC_DIR.glob("*.cu")) if p.name in own[name]]
    return cu, sorted(SRC_DIR.glob("*.cuh"))


def source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + FLAGS).encode())
    cu, cuh = sources(name)
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False,
          names: Sequence[str] = tuple(LIB_NAMES)) -> dict:
    """Compile the libraries `names` whose sources changed since their last
    build, every nvcc of them started together.

    Returns {"paths": {name: path}, "built", "seconds", "log"}: built is
    False when every stamped library was reused; log holds nvcc's output
    (with -Xptxas -v's register and spill report when verbose).
    """
    import time

    paths = {n: BUILD_DIR / LIB_NAMES[n] for n in names}
    keys = {n: source_hash(n) for n in names}
    stale = [n for n in names
             if not (paths[n].is_file() and _stamp(n).is_file()
                     and _stamp(n).read_text() == keys[n])]
    out = {"paths": {n: str(p) for n, p in paths.items()}, "built": False,
           "seconds": 0.0, "log": ""}
    if not stale:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for n in stale:
        cu, _ = sources(n)
        if not cu:
            raise NvccError(f"no CUDA sources for {n} in {SRC_DIR}")
        for src in cu:
            obj = BUILD_DIR / f".{src.stem}.{tag}.o"
            logf = BUILD_DIR / f".{src.stem}.{tag}.log"
            cmd = ([nvcc] + ARCH_FLAGS + FLAGS
                   + (["-Xptxas", "-v"] if verbose else [])
                   + ["-I", str(SRC_DIR), "-c", "-o", str(obj), str(src)])
            with open(logf, "w") as log:
                proc = subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT)
            jobs.append((n, cmd, obj, logf, proc))
    logs, failed = [], []
    for _, cmd, obj, logf, proc in jobs:
        rc = proc.wait()
        text = logf.read_text().strip()
        logf.unlink(missing_ok=True)
        logs.append(text)
        if rc != 0:
            failed.append(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    tmps = {n: BUILD_DIR / f".{LIB_NAMES[n]}.{tag}" for n in stale}
    for n in stale if not failed else ():
        cmd = ([nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmps[n])]
               + [str(obj) for m, _, obj, _, _ in jobs if m == n])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for _, _, obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        for t in tmps.values():
            t.unlink(missing_ok=True)
        raise NvccError("\n".join(failed))
    for n in stale:
        os.replace(tmps[n], paths[n])
        _stamp(n).write_text(keys[n])
    out.update(built=True, seconds=time.perf_counter() - t0,
               log="\n".join(t for t in logs if t))
    return out


def _stamp(name: str) -> Path:
    return BUILD_DIR / (LIB_NAMES[name] + ".sha256")


def load(name: str = "core", path: Optional[str] = None) -> ctypes.CDLL:
    """Library `name` ("core", "wide" or "many"), built on first use, with
    its C signatures set; with `path`, that build of it (an edited copy's,
    say), which then serves the calls that follow."""
    if name in _libs and path is None:
        return _libs[name]
    from pyfasst_tpu_torch.ops.cuda_estep import GENERAL_J
    lib = ctypes.CDLL(path or build(names=(name,))["paths"][name])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "many":
        fn = lib.pyfasst_estep_many
        # x4 v A4 sigma, xi txs tss t4 t7 ll ws; B J F N; ranks (host);
        # rmax real_cov ns_inj; eps; fast_recip no_ll; stream
        fn.argtypes = ([p] * 11 + [i] * 4 + [ctypes.POINTER(i)] + [i] * 3
                       + [f] + [i] * 2 + [p])
        fn.restype = i
        # B J F N rmax real_cov
        lib.pyfasst_estep_many_workspace.argtypes = [i] * 6
        lib.pyfasst_estep_many_workspace.restype = ctypes.c_longlong
        # B J F N rmax real_cov; out (6 long longs)
        lib.pyfasst_estep_many_plan.argtypes = [i] * 6 + [p]
        lib.pyfasst_estep_many_plan.restype = i
        # which (0 frames, 1 sums, 2 fused, 3 segments) J rmax real_cov
        # ns_inj; out
        lib.pyfasst_estep_many_info.argtypes = [i] * 5 + [p]
        lib.pyfasst_estep_many_info.restype = i
        _libs[name] = lib
        return lib
    for J in GENERAL_J:
        if library_of(J) != name:
            continue
        fn = getattr(lib, f"pyfasst_estep_j{J}")
        # x4 v A4 sigma, xi txs tss t4 t7 ll; B F N rank_mask rmax
        # real_cov ns_inj; eps; fast_recip no_ll; stream
        fn.argtypes = [p] * 10 + [i] * 7 + [f] + [i] * 2 + [p]
        fn.restype = i
        fn = getattr(lib, f"pyfasst_estep_j{J}_info")
        fn.argtypes = [i] * 3 + [p]             # rmax real_cov ns_inj; out
        fn.restype = i
    if name == "wide":
        _libs[name] = lib
        return lib
    fn = lib.pyfasst_estep_r1_real
    # x4 v A sigma, xi txs tss t4 t7 ll ws; B J F N; eps; fast_recip no_ll;
    # stream
    fn.argtypes = [p] * 11 + [i] * 4 + [f] + [i] * 2 + [p]
    fn.restype = i
    lib.pyfasst_estep_r1_real_workspace.argtypes = [i] * 4     # B J F N
    lib.pyfasst_estep_r1_real_workspace.restype = ctypes.c_longlong
    lib.pyfasst_estep_r1_real_segments.argtypes = [i] * 4      # B J F N
    lib.pyfasst_estep_r1_real_segments.restype = i
    for sym in ("pyfasst_fb_stats", "pyfasst_tw_stats"):
        fn = getattr(lib, sym)
        # xi FB TW vfloor, num den ws; B J F N K; stream
        fn.argtypes = [p] * 7 + [i] * 5 + [p]
        fn.restype = i
        fn = getattr(lib, f"{sym}_workspace")
        fn.argtypes = [i] * 5                   # B J F N K
        fn.restype = ctypes.c_longlong
    for sym, args in (("estep_r1_real", [i]),     # J; out
                        ("fb_stats", [i]),          # K; out
                        ("tw_stats", [i, i])):      # K F; out
        fn = getattr(lib, f"pyfasst_{sym}_info")
        fn.argtypes = args + [p]
        fn.restype = i
    _libs[name] = lib
    return lib


def kernel_info(name: str, *args: int) -> dict:
    """What the runtime reports of one kernel instantiation: resident warps
    per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and
    local (spill) bytes per thread, shared bytes per block (static, and
    the launch's dynamic bytes for the general E-step and tw_stats).

    name is "estep_j{J}" (J in cuda_estep.GENERAL_J) with args (rmax,
    real_cov, ns_inj), "estep_many" with args (which, J, rmax, real_cov,
    ns_inj), which 0 and 1 its chunked route's frames and sums kernels, 2
    its fused kernel (with its dynamic shared bytes at J sources), 3 the
    fused route's second pass over segments,
    "estep_r1_real" with args (J,), "fb_stats" with args (K,), or
    "tw_stats" with args (K, F). Needs a CUDA device.
    """
    out = (ctypes.c_int * 4)()
    lib = load(library_of(int(name[7:])) if name.startswith("estep_j")
               else "many" if name == "estep_many" else "core")
    err = getattr(lib, f"pyfasst_{name}_info")(*args, out)
    if err != 0:
        raise RuntimeError(f"{name}{args} info failed: cudaError_t {err}")
    return dict(zip(("warps_per_sm", "registers", "local_bytes",
                     "shared_bytes"), out))
