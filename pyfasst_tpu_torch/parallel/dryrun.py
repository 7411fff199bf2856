"""A dry run of the sharded path on n ranks of one machine.

The port's counterpart of the JAX package's ``dryrun_multichip``: it
spawns n processes (torch.multiprocessing, start method "spawn"), joins
them in a gloo process group through a ``file://`` rendezvous under a
temporary directory, and runs a worker function of this module on every
rank. Each rank runs on one thread (``torch.set_num_threads(1)``). The
workers take their inputs as arguments (CPU tensors or numpy arrays) and
put every rank's tensors on `device`: "cpu" in the tests, "cuda:0" to put
every rank on one card. Gloo carries CUDA tensors through the host.

    python -m pyfasst_tpu_torch.parallel.dryrun [n]

runs the dp, fp and sp cases of ``sharding_cases`` at n ranks (default 2)
on the CPU and checks each against the single-device run at rtol 2e-4.
"""
from __future__ import annotations

import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RTOL = 2e-4
"""The sharded path against the single-device one: the bar of the JAX
package's tests/test_sharding.py (reductions in another order)."""


def _rank_entry(rank: int, n: int, init_file: str, out_dir: str,
                fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=n)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, tmpdir: Optional[str] = None
          ) -> List:
    """Run fn(*args) on n gloo ranks; return each rank's result, in rank
    order. fn must be a module-level function (the ranks import it)."""
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        mp.spawn(_rank_entry, args=(n, init_file, tmp, fn, args),
                 nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


# -- the tiny model -----------------------------------------------------------

def tiny_problem(B: int = 4, F: int = 33, N: int = 16, J: int = 2,
                 K: int = 3, seed: int = 0, I: int = 2
                 ) -> Dict[str, np.ndarray]:
    """A batch of I-channel clips and NMF inits made from `seed` with
    numpy (tests/test_sharding.py's _batch): X (B, F, N, I) complex64, FB
    (B, J, F, K) and TW (B, J, K, N) float32 (clip b's from
    default_rng(b)); the mixing is init_inst_mixing(None, I, 1, J)."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((B, F, N, I))
         + 1j * rng.standard_normal((B, F, N, I))).astype(np.complex64)
    FB = np.empty((B, J, F, K), np.float32)
    TW = np.empty((B, J, K, N), np.float32)
    for b in range(B):
        r = np.random.default_rng(b)
        for j in range(J):
            FB[b, j] = 0.5 + r.random((F, K))
            TW[b, j] = 0.5 + r.random((K, N))
    return {"X": X, "FB": FB, "TW": TW}


def tiny_params(prob: Dict[str, np.ndarray], device="cpu"):
    """The port's FasstParams of tiny_problem's inits."""
    from pyfasst_tpu_torch.models.components import (
        FasstParams, SpatialComp, SpectralComp, init_inst_mixing,
    )
    B, J = prob["FB"].shape[:2]
    I = prob["X"].shape[-1]
    spat = tuple(SpatialComp(A=a[None].expand(B, -1, -1).contiguous())
                 for a in init_inst_mixing(None, I, 1, J, device=device))
    spec = tuple(SpectralComp(
        FB=torch.as_tensor(prob["FB"][:, j], device=device),
        TW=torch.as_tensor(prob["TW"][:, j], device=device), spat_ind=j)
        for j in range(J))
    return FasstParams(spat=spat, spec=spec)


STATE_KINDS = ("hmm", "viterbi", "gmm", "simm")
"""The spectral models of tiny_state_params: a soft-decoded HMM, a
Viterbi-decoded HMM, a GMM and a source-filter (FB2/TW2) component."""


def tiny_state_params(prob: Dict[str, np.ndarray], kind: str,
                      device="cpu"):
    """tiny_params' model with its spectral components made `kind` (one of
    STATE_KINDS): the K columns of FB are the states of an HMM (transition
    0.8 to stay, the rest spread) or a GMM (prior rising with the state),
    or the component gains a second chain FB2 @ TW2 of rank 2, both
    factors free, drawn from default_rng(7). Returns port FasstParams."""
    from pyfasst_tpu_torch.models.components import GMM, HMM
    params = tiny_params(prob, device=device)
    B, Q = params.batch, prob["FB"].shape[-1]
    kw = dict(dtype=torch.float32, device=device)
    if kind in ("hmm", "viterbi"):
        trans = np.tile(np.where(np.eye(Q) > 0, 0.8, 0.2 / (Q - 1)),
                        (B, 1, 1))
        extra = dict(constraint=HMM, trans=torch.as_tensor(trans, **kw),
                     decode="viterbi" if kind == "viterbi" else "soft")
        return params.replace(spec=tuple(c.replace(**extra)
                                         for c in params.spec))
    if kind == "gmm":
        prior = np.tile(np.arange(1, Q + 1) / (Q * (Q + 1) / 2), (B, 1))
        return params.replace(spec=tuple(c.replace(
            constraint=GMM, trans=torch.as_tensor(prior, **kw))
            for c in params.spec))
    if kind != "simm":
        raise ValueError(f"kind must be one of {STATE_KINDS}, got {kind!r}")
    r = np.random.default_rng(7)
    F, N = prob["X"].shape[1:3]
    return params.replace(spec=tuple(c.replace(
        FB2=torch.as_tensor(0.5 + r.random((B, F, 2)), **kw),
        TW2=torch.as_tensor(0.5 + r.random((B, 2, N)), **kw),
        free2=(True, True)) for c in params.spec))


def _host(params) -> Dict[str, np.ndarray]:
    """Every array of the parameters on the host, keyed by name and index
    (A0, FB0, TW0, ..., FB21 for component 1's FB2)."""
    out = {}
    for j, c in enumerate(params.spat):
        out[f"A{j}"] = c.A.detach().cpu().numpy()
    for j, c in enumerate(params.spec):
        for name in ("FB", "TW", "FW", "TB", "trans", "FB2", "TW2"):
            t = getattr(c, name)
            if t is not None:
                out[f"{name}{j}"] = t.detach().cpu().numpy()
    return out


# -- workers (run on every rank) ----------------------------------------------

def _launches() -> Dict[str, int]:
    """The kernel launches the host made (ops/cuda_estep, ops/cuda_spectral)
    and the GEM iterations run_gem replayed as CUDA graphs, which launch
    their kernels without the host (ops/gem.py GRAPH_STEPS)."""
    from pyfasst_tpu_torch.ops import cuda_estep, cuda_spectral, gem
    return {"estep": cuda_estep.LAUNCHES, **cuda_spectral.LAUNCHES,
            "replayed": gem.GRAPH_STEPS["replayed"]}


def run_sharded(params_b, X_b, cfg, dp: Optional[int] = None,
                shard_frames: bool = False, device="cpu",
                separate: Optional[str] = "all", sigma_endpoints_b=None
                ) -> Dict[str, object]:
    """batched_run_gem (and sharded_batch_separate) of one batch on the
    mesh of every rank (make_mesh(dp=dp)). Returns the rank's view of the
    full result on the host, the mesh's shape and this rank's kernel
    launches (ops/cuda_estep, ops/cuda_spectral; zero on the CPU). The
    images (B, J, F, N, I) are separated unless `separate` is None and
    returned by every rank ("all") or by rank 0 ("rank0")."""
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints
    from pyfasst_tpu_torch.parallel.sharding import (
        batched_run_gem, make_mesh, sharded_batch_separate,
    )

    mesh = make_mesh(dp=dp, device=device)
    X_b = torch.as_tensor(X_b)
    sig = (annealing_endpoints(X_b, cfg) if sigma_endpoints_b is None
           else sigma_endpoints_b)
    before = _launches()
    params, lls = batched_run_gem(params_b, X_b, cfg, mesh,
                                  sigma_endpoints_b=sig,
                                  shard_frames=shard_frames)
    out = {"mesh": mesh.shape, "logliks": lls.cpu().numpy(),
           "params": _host(params)}
    out["launches"] = {k: v - before[k] for k, v in _launches().items()}
    if separate is not None:
        Y = sharded_batch_separate(params, X_b, sig[1], mesh)
        ships = separate == "all" or dist.get_rank() == 0
        out["Y"] = Y.cpu().numpy() if ships else None
    return out


def bucket_case(Xs, params_list, cfg, device="cpu") -> Dict[str, object]:
    """batch_separate of clips `Xs` from the initial params `params_list`
    (B = 1 each, clip i's for clip i) with every rank a slice of the clips
    (make_mesh(dp=world size)). Returns the logliks per clip, the images
    (rank 0 only) and this rank's kernel launches."""
    from pyfasst_tpu_torch.parallel.batch import batch_separate
    from pyfasst_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(dp=dist.get_world_size(), device=device)
    before = _launches()
    imgs, lls = batch_separate(Xs, lambda F, N, i: params_list[i], cfg,
                               mesh=mesh)
    return {"mesh": mesh.shape, "logliks": lls,
            "images": imgs if dist.get_rank() == 0 else None,
            "launches": {k: v - before[k] for k, v in _launches().items()}}


def sharding_cases(prob: Dict[str, np.ndarray], niter: int = 5,
                   device="cpu") -> Dict[str, Dict]:
    """The dp, fp and sp legs of tiny_problem `prob` on this rank's mesh:
    "fp" the default factoring, "dp" every rank a clip slice, "sp" the
    default factoring with the frames sharded (B must divide by the
    world size)."""
    from pyfasst_tpu_torch.utils.config import GEMConfig

    n = dist.get_world_size()
    cfg = GEMConfig(niter=niter)
    params = tiny_params(prob)
    return {
        "fp": run_sharded(params, prob["X"], cfg, device=device),
        "dp": run_sharded(params, prob["X"], cfg, dp=n, device=device),
        "sp": run_sharded(params, prob["X"], cfg, shard_frames=True,
                          device=device, separate=None),
    }


def tiny_make_params(F: int, Npad: int, i: int):
    """batch_separate's make_params for tiny clips: clip i's inits from
    default_rng(i) (tests/test_sharding.py's), B = 1."""
    from pyfasst_tpu_torch.models.components import (
        FasstParams, SpatialComp, SpectralComp,
    )
    r = np.random.default_rng(i)
    spat = tuple(SpatialComp(A=torch.as_tensor(
        np.abs(r.standard_normal((1, 2, 1))) + 0.4, dtype=torch.float32))
        for _ in range(2))
    spec = tuple(SpectralComp(
        FB=torch.as_tensor(0.5 + r.random((1, F, 3)), dtype=torch.float32),
        TW=torch.as_tensor(0.5 + r.random((1, 3, Npad)),
                           dtype=torch.float32), spat_ind=j)
        for j in range(2))
    return FasstParams(spat=spat, spec=spec)


class Killed(RuntimeError):
    """The stand-in for a preemption in batch_case's checkpoint leg."""


def batch_case(Xs, niter: int, granularity: int, device="cpu",
               checkpoint_dir: Optional[str] = None, every: int = 2
               ) -> Dict[str, object]:
    """batch_separate of clips `Xs` (tiny_make_params' inits) on every
    rank's default mesh. With checkpoint_dir, the run is cut after its
    first checkpoint (every `every` iterations), the files left are
    listed, and the same call resumes it. Returns images and logliks per
    clip (and "files_after_kill", "files_after_resume")."""
    from pyfasst_tpu_torch.parallel.batch import batch_separate
    from pyfasst_tpu_torch.parallel.sharding import barrier, make_mesh
    from pyfasst_tpu_torch.utils.config import GEMConfig

    mesh = make_mesh(device=device)
    cfg = GEMConfig(niter=niter)
    out: Dict[str, object] = {"mesh": mesh.shape}
    kw = dict(mesh=mesh, granularity=granularity)
    if checkpoint_dir is not None:
        def kill(Npad, it):
            raise Killed(f"cut at bucket {Npad} iteration {it}")
        try:
            batch_separate(Xs, tiny_make_params, cfg, checkpoint_dir=
                           checkpoint_dir, checkpoint_every=every,
                           on_checkpoint=kill, **kw)
        except Killed:
            pass
        out["files_after_kill"] = sorted(os.listdir(checkpoint_dir))
        barrier()
        kw.update(checkpoint_dir=checkpoint_dir, checkpoint_every=every)
    imgs, lls = batch_separate(Xs, tiny_make_params, cfg, **kw)
    if checkpoint_dir is not None:
        out["files_after_resume"] = sorted(os.listdir(checkpoint_dir))
    out["images"], out["logliks"] = imgs, lls
    return out


def pool_case(X, J: int, votes, iters: int = 20, band_width: int = 16,
              device="cpu") -> Dict[int, Dict[str, np.ndarray]]:
    """One blind pool (spatial_init's band-local EM probes) at
    n_devices = 1 and at the world size: per run final logliks, each
    band's picked run and the converged dominance labels."""
    from pyfasst_tpu_torch.models import spatial_init

    out = {}
    for nd in (1, dist.get_world_size()):
        p = spatial_init._band_em_probes(
            X, J, band_width=band_width, iters=iters, nmf_comps=3,
            votes_init=votes, n_devices=nd, device=device)
        out[nd] = {"ll": p.ll, "pick": p.pick, "lab": p.lab}
    return out


def cli_case(argv: List[str]) -> Dict[str, object]:
    """`python -m pyfasst_tpu_torch` in this rank: its exit code, what it
    printed and how many checkpoints this rank saved (FASST's
    save_checkpoint calls)."""
    import contextlib
    import io

    from pyfasst_tpu_torch.__main__ import main
    from pyfasst_tpu_torch.models.fasst import FASST

    saves = 0
    save = FASST.save_checkpoint

    def counted(self, *a, **kw):
        nonlocal saves
        saves += 1
        return save(self, *a, **kw)

    buf = io.StringIO()
    FASST.save_checkpoint = counted
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        FASST.save_checkpoint = save
    return {"rc": rc, "stdout": buf.getvalue(), "saves": saves}


def state_cases(prob: Dict[str, np.ndarray], niter: int = 5,
                device="cpu", kinds=STATE_KINDS) -> Dict[str, Dict]:
    """Each of `kinds` (STATE_KINDS by default) on this rank's mesh with
    every rank on the second axis (dp = 1): "fp" the frequencies sharded,
    "sp" the frames. No separation (sharded_batch_separate is per bin and
    model-blind)."""
    from pyfasst_tpu_torch.utils.config import GEMConfig
    cfg = GEMConfig(niter=niter)
    return {kind: {leg: run_sharded(tiny_state_params(prob, kind),
                                    prob["X"], cfg, dp=1,
                                    shard_frames=leg == "sp", device=device,
                                    separate=None)
                   for leg in ("fp", "sp")}
            for kind in kinds}


def single_case(prob: Dict[str, np.ndarray], niter: int = 5,
                device="cpu") -> Dict[str, object]:
    """batched_run_gem on make_mesh(1) in a process group of one rank."""
    from pyfasst_tpu_torch.utils.config import GEMConfig
    return run_sharded(tiny_params(prob), prob["X"], GEMConfig(niter=niter),
                       device=device)


def run_cases(cases) -> Dict[str, object]:
    """Run several workers of this module on this rank, in order (one
    spawn, many cases): cases is a sequence of (name, worker name,
    keyword arguments)."""
    mod = sys.modules[__name__]
    return {name: getattr(mod, fn)(**kw) for name, fn, kw in cases}


def dryrun_multichip(n: int = 2, niter: int = 5) -> Dict[str, float]:
    """Spawn n CPU ranks, run sharding_cases and hold every rank's
    log-likelihoods, params and images against the single-device run at
    RTOL. Returns the largest relative difference of each case."""
    from pyfasst_tpu_torch.ops.gem import annealing_endpoints, run_gem
    from pyfasst_tpu_torch.ops.wiener import separate_sources
    from pyfasst_tpu_torch.utils.config import GEMConfig

    prob = tiny_problem(B=2 * n)
    cfg = GEMConfig(niter=niter)
    X = torch.as_tensor(prob["X"])
    sig = annealing_endpoints(X, cfg)
    ref, ll = run_gem(tiny_params(prob), X, cfg, sigma_endpoints=sig)
    want = {"logliks": ll.numpy(), **_host(ref),
            "Y": separate_sources(ref, X, sig[1]).numpy()}
    worst: Dict[str, float] = {}
    for rank, cases in enumerate(spawn(sharding_cases, n, prob, niter)):
        for case, got in cases.items():
            flat = {"logliks": got["logliks"], **got["params"]}
            if "Y" in got:
                flat["Y"] = got["Y"]
            for k, v in flat.items():
                np.testing.assert_allclose(
                    v, want[k], rtol=RTOL, atol=RTOL * np.abs(want[k]).max(),
                    err_msg=f"rank {rank} case {case} {k}")
                err = float(np.max(np.abs(v - want[k]))
                            / max(np.abs(want[k]).max(), 1e-30))
                worst[case] = max(worst.get(case, 0.0), err)
    return worst


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2))
