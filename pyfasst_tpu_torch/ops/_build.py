"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Compiles every ``csrc/*.cu`` of the package to an object, one nvcc
process per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -c -o _build/<name>.o csrc/<name>.cu

and links the objects into one shared library with a plain C interface
(``nvcc -shared``), on first CUDA use, into ``pyfasst_tpu_torch/_build/``.
A stamp beside the library holds a hash of the sources and flags, so an
unchanged tree is not rebuilt. Only the sources in the package and the CUDA
toolkit's headers go into the build. A failed build raises with nvcc's
output; nothing falls back to the plain PyTorch versions. Each J of the
general E-step kernel is its own source (csrc/estep_j{2..8}.cu), so its
instantiations compile in parallel, beside csrc/estep.cu and
csrc/spectral.cu. No --use_fast_math: the kernels rely on exact IEEE
divides and logf (the E-step's fast_recip flag asks for its approximate
reciprocal explicitly, csrc/recip.cuh); and --fmad=false keeps every
product rounded as the plain versions round it (see csrc/estep.cu).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libpyfasst_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


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


def sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + FLAGS).encode())
    cu, cuh = sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build(verbose: bool = False) -> dict:
    """Compile the kernels if the sources changed since the last build.

    Returns {"path", "built", "seconds", "log"}: built is False when the
    stamped library was reused; log holds nvcc's output (with
    -Xptxas -v's register and spill report when verbose).
    """
    import time

    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    key = source_hash()
    if lib.is_file() and stamp.is_file() and stamp.read_text() == key:
        return {"path": str(lib), "built": False, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = sources()
    if not cu:
        raise NvccError(f"no CUDA sources in {SRC_DIR}")
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in cu:
        obj = BUILD_DIR / f".{src.stem}.{tag}.o"
        logf = BUILD_DIR / f".{src.stem}.{tag}.log"
        cmd = ([nvcc] + ARCH_FLAGS + FLAGS
               + (["-Xptxas", "-v"] if verbose else [])
               + ["-I", str(SRC_DIR), "-c", "-o", str(obj), str(src)])
        with open(logf, "w") as out:
            proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
        jobs.append((cmd, obj, logf, proc))
    logs, failed = [], []
    for cmd, obj, logf, proc in jobs:
        rc = proc.wait()
        text = logf.read_text().strip()
        logf.unlink(missing_ok=True)
        logs.append(text)
        if rc != 0:
            failed.append(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    objs = [obj for _, obj, _, _ in jobs]
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    if not failed:
        cmd = ([nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)]
               + [str(o) for o in objs])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise NvccError("\n".join(failed))
    os.replace(tmp, lib)
    stamp.write_text(key)
    return {"path": str(lib), "built": True, "seconds": seconds,
            "log": "\n".join(t for t in logs if t)}


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    from pyfasst_tpu_torch.ops.cuda_estep import GENERAL_J
    info = build()
    lib = ctypes.CDLL(info["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.pyfasst_estep_r1_real
    # x4 v A sigma, xi txs tss t4 t7 ll; B J F N; eps; fast_recip no_ll;
    # stream
    fn.argtypes = [p] * 10 + [i] * 4 + [f] + [i] * 2 + [p]
    fn.restype = i
    for J in GENERAL_J:
        fn = getattr(lib, f"pyfasst_estep_j{J}")
        # x4 v A4 sigma, xi txs tss t4 t7 ll; B F N rank_mask rmax
        # real_cov ns_inj; eps; fast_recip no_ll; stream
        fn.argtypes = [p] * 10 + [i] * 7 + [f] + [i] * 2 + [p]
        fn.restype = i
    for name in ("pyfasst_fb_stats", "pyfasst_tw_stats"):
        fn = getattr(lib, name)
        # xi FB TW vfloor, num den ws; B J F N K; stream
        fn.argtypes = [p] * 7 + [i] * 5 + [p]
        fn.restype = i
        fn = getattr(lib, f"{name}_workspace")
        fn.argtypes = [i] * 5                   # B J F N K
        fn.restype = ctypes.c_longlong
    for J in GENERAL_J:
        fn = getattr(lib, f"pyfasst_estep_j{J}_info")
        fn.argtypes = [i] * 3 + [p]             # rmax real_cov ns_inj; out
        fn.restype = i
    for name, args in (("estep_r1_real", [i]),      # J; out
                       ("fb_stats", [i]),           # K; out
                       ("tw_stats", [i, i])):       # K F; out
        fn = getattr(lib, f"pyfasst_{name}_info")
        fn.argtypes = args + [p]
        fn.restype = i
    _lib = lib
    return lib


def kernel_info(name: str, *args: int) -> dict:
    """What the runtime reports of one kernel instantiation: resident warps
    per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and
    local (spill) bytes per thread, shared bytes per block (static, and
    the launch's dynamic bytes for the general E-step and tw_stats).

    name is "estep_j{J}" (J in cuda_estep.GENERAL_J) with args (rmax,
    real_cov, ns_inj), "estep_r1_real" with args (J,), "fb_stats" with
    args (K,), or "tw_stats" with args (K, F). Needs a CUDA device.
    """
    out = (ctypes.c_int * 4)()
    err = getattr(load(), f"pyfasst_{name}_info")(*args, out)
    if err != 0:
        raise RuntimeError(f"{name}{args} info failed: cudaError_t {err}")
    return dict(zip(("warps_per_sm", "registers", "local_bytes",
                     "shared_bytes"), out))
