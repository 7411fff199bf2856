"""The port's multi-device path (parallel/sharding.py) on gloo ranks.

The JAX package proves its sharding on 8 virtual CPU devices
(tests/test_sharding.py); the port's mesh is a torch.distributed process
group, so these tests spawn 1, 2 and 4 CPU ranks through
parallel/dryrun.py (gloo, a file:// rendezvous under a temporary
directory, one thread per rank). Each world size is spawned once per
module, runs every case in its ranks, and the tests below assert on what
the ranks returned.

Bars: the sharded runs against the port's single-device runs at rtol 2e-4
(tests/test_sharding.py:54-55: the cross-shard sums add in another order);
against the JAX package's batched_run_gem on its 8-device mesh at the same
rtol 2e-4 (measured: ~1e-6 relative in loglik after 5 iterations); a mesh
of one rank, and the dp leg, bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from pyfasst_tpu_torch.ops.gem import (
    annealing_endpoints, endpoints_from_power, run_gem,
)
from pyfasst_tpu_torch.ops.wiener import separate_sources
from pyfasst_tpu_torch.parallel import dryrun, sharding
from pyfasst_tpu_torch.utils.config import GEMConfig

torch.set_num_threads(1)

RTOL = dryrun.RTOL
NITER = 5
PROB = dryrun.tiny_problem(B=4, F=33, N=16)
PROB3 = dryrun.tiny_problem(B=2, F=17, N=12, I=3, J=3, seed=1)  # general-I
PROB_S = dryrun.tiny_problem(B=2, F=33, N=16, seed=2)     # state models
LENGTHS = (40, 44, 150)          # two buckets at granularity 64
FS = 16000


def _clips(seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((33, n, 2))
             + 1j * rng.standard_normal((33, n, 2))).astype(np.complex64)
            for n in LENGTHS]


def _pool_input(F=32, N=64, J=2, seed=4):
    """Two sources with per-frequency complex directions, and the true
    dominance votes (F, N, J)."""
    rng = np.random.default_rng(seed)
    S = (rng.standard_normal((J, F, N)) + 1j * rng.standard_normal((J, F, N))
         ) * rng.random((J, 1, N)) ** 2
    A = np.exp(1j * rng.uniform(-1, 1, (J, F, 2))) * np.array(
        [[0.9, 0.3], [0.3, 0.9]])[:, None, :]
    imgs = A[:, :, None, :] * S[..., None]                  # (J, F, N, 2)
    X = imgs.sum(0) + 1e-3 * rng.standard_normal((F, N, 2))
    votes = np.eye(J)[np.argmax((np.abs(imgs) ** 2).sum(-1), axis=0)]
    return X.astype(np.complex64), votes


def _cli_wav(path):
    rng = np.random.default_rng(2)
    t = np.arange(FS) / FS
    s1 = 0.4 * np.sin(2 * np.pi * 300 * t)
    s2 = 0.3 * rng.standard_normal(t.size) * (np.sin(2 * np.pi * 2 * t) > 0)
    mix = np.outer(s1, [0.95, 0.31]) + np.outer(s2, [0.31, 0.95])
    scipy.io.wavfile.write(path, FS, np.round(0.9 * mix / np.abs(mix).max()
                                              * 32767).astype(np.int16))
    return path


def _cases(n, tmp):
    cases = [("sharding", "sharding_cases", dict(prob=PROB, niter=NITER)),
             ("padding", "batch_case",
              dict(Xs=_clips()[:1], niter=4, granularity=128)),
             ("state", "state_cases", dict(prob=PROB_S, niter=NITER))]
    if n == 2:
        X, votes = _pool_input()
        wav = _cli_wav(str(tmp / "mix.wav"))
        cases += [
            ("i3", "sharding_cases", dict(prob=PROB3, niter=NITER)),
            ("state_b1", "state_cases", dict(
                prob={k: v[:1] for k, v in PROB_S.items()}, niter=NITER,
                kinds=("hmm",))),
            ("batch", "batch_case",
             dict(Xs=_clips(), niter=6, granularity=64)),
            ("resume", "batch_case",
             dict(Xs=_clips(), niter=6, granularity=64,
                  checkpoint_dir=str(tmp / "ckpts"))),
            ("pool", "pool_case", dict(X=X, J=2, votes=votes)),
            ("cli", "cli_case", dict(argv=[
                "separate", wav, "-o", str(tmp / "cli"), "--model",
                "fullrank", "--spatial-init", "--n-devices", "2", "--iters",
                "3", "--wlen", "256", "--nmf-comps", "2", "-q", "--device",
                "cpu"])),
            ("cli_ckpt", "cli_case", dict(argv=[
                "separate", wav, "-o", str(tmp / "cli_ckpt"), "--model",
                "fullrank", "--spatial-init", "--n-devices", "2", "--iters",
                "3", "--wlen", "256", "--nmf-comps", "2", "-q", "--device",
                "cpu", "--checkpoint", str(tmp / "ck.npz"),
                "--checkpoint-every", "1"]))]
    return cases


_RUNS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(n): every rank's results of _cases(n), spawned once."""
    def get(n):
        if n not in _RUNS:
            tmp = tmp_path_factory.mktemp(f"ranks{n}")
            _RUNS[n] = dryrun.spawn(dryrun.run_cases, n, _cases(n, tmp),
                                    tmpdir=str(tmp))
        return _RUNS[n]
    return get


@pytest.fixture(scope="module")
def single():
    """The port's single-device run of PROB: run_gem over the batch, each
    clip alone, and the separation."""
    cfg = GEMConfig(niter=NITER)
    X = torch.as_tensor(PROB["X"])
    sig = annealing_endpoints(X, cfg)
    params, ll = run_gem(dryrun.tiny_params(PROB), X, cfg,
                         sigma_endpoints=sig)
    per_clip = np.stack([
        run_gem(dryrun.tiny_params({k: v[b:b + 1] for k, v in PROB.items()}),
                X[b:b + 1], cfg)[1][0].numpy() for b in range(X.shape[0])])
    return {"logliks": ll.numpy(), "per_clip": per_clip,
            "params": dryrun._host(params),
            "Y": separate_sources(params, X, sig[1]).numpy()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("n", (1, 2, 4, 8))
def test_mesh_factoring_matches_jax(n):
    """make_mesh's default (dp, fp) is the JAX package's for n devices."""
    from pyfasst_tpu.parallel import make_mesh
    dp = sharding._default_dp(n)
    assert {"dp": dp, "fp": n // dp} == dict(make_mesh(n).shape)


@pytest.mark.parametrize("n", (2, 4))
def test_mesh_shapes_on_ranks(ranks, n):
    dp = sharding._default_dp(n)
    for rank in ranks(n):
        cases = rank["sharding"]
        assert cases["fp"]["mesh"] == {"dp": dp, "fp": n // dp}
        assert cases["dp"]["mesh"] == {"dp": n, "fp": 1}


@pytest.mark.parametrize("leg", ("fp", "dp", "sp"))
@pytest.mark.parametrize("n", (2, 4))
def test_batched_gem_matches_single_clip(ranks, single, n, leg):
    """Every rank returns the full batch; its logliks match each clip's
    single-device run_gem at rtol 2e-4, its params and images the batch's
    (the dp leg, which reduces nothing, bit for bit)."""
    for r, rank in enumerate(ranks(n)):
        got = rank["sharding"][leg]
        assert got["logliks"].shape == (PROB["X"].shape[0], NITER)
        _close(got["logliks"], single["per_clip"], f"rank {r} logliks")
        for k, v in got["params"].items():
            if leg == "dp":
                np.testing.assert_array_equal(v, single["params"][k])
            else:
                _close(v, single["params"][k], f"rank {r} {k}")


def test_general_i_engine_on_two_ranks(ranks):
    """A 3-channel batch (ops/engine_general.py, which batch_separate_files
    takes for I != 2) through the fp, dp and sp legs against run_gem and
    separate_sources on one device (J = 3: with fewer sources than
    channels the annealed noise floor alone explains a direction, and
    float32 rounding then grows to ~1e-3 in A within 5 iterations on one
    device)."""
    cfg = GEMConfig(niter=NITER)
    X = torch.as_tensor(PROB3["X"])
    sig = annealing_endpoints(X, cfg)
    params, ll = run_gem(dryrun.tiny_params(PROB3), X, cfg,
                         sigma_endpoints=sig)
    want = dryrun._host(params)
    Y = separate_sources(params, X, sig[1]).numpy()
    for rank in ranks(2):
        for leg, got in rank["i3"].items():
            _close(got["logliks"], ll.numpy(), f"I=3 {leg} logliks")
            for k, v in got["params"].items():
                _close(v, want[k], f"I=3 {leg} {k}")
            if "Y" in got:
                assert got["Y"].shape == (2, 3, 17, 12, 3)
                _close(got["Y"], Y, f"I=3 {leg} images")


@pytest.fixture(scope="module")
def single_state():
    """The port's single-device run_gem of each state model on PROB_S."""
    cfg = GEMConfig(niter=NITER)
    X = torch.as_tensor(PROB_S["X"])
    out = {}
    for kind in dryrun.STATE_KINDS:
        params, ll = run_gem(dryrun.tiny_state_params(PROB_S, kind), X, cfg,
                             sigma_endpoints=annealing_endpoints(X, cfg))
        out[kind] = {"logliks": ll.numpy(), "params": dryrun._host(params)}
    return out


@pytest.mark.parametrize("n,leg", ((2, "fp"), (2, "sp"), (4, "fp"),
                                   (4, "sp")))
@pytest.mark.parametrize("kind", dryrun.STATE_KINDS)
def test_state_models_match_single_device(ranks, single_state, kind, n,
                                          leg):
    """The HMM (soft and Viterbi), GMM and source-filter models with their
    frequencies (fp = n) or frames (sp = n) cut over every rank: logliks
    and every parameter (FB2 and TW2 included, trans unchanged) at rtol
    2e-4 of the single-device run, on every rank."""
    want = single_state[kind]
    for r, rank in enumerate(ranks(n)):
        got = rank["state"][kind][leg]
        assert got["mesh"] == {"dp": 1, "fp": n}
        assert set(got["params"]) == set(want["params"])
        _close(got["logliks"], want["logliks"], f"rank {r} logliks")
        for k, v in got["params"].items():
            _close(v, want["params"][k], f"rank {r} {k}")
        for j in range(2):
            k = f"trans{j}"
            if k in want["params"]:
                np.testing.assert_array_equal(
                    got["params"][k],
                    dryrun._host(dryrun.tiny_state_params(PROB_S, kind))[k])


def _jax_state_params(kind):
    """tiny_state_params(PROB_S, kind) as the JAX package's batched
    parameters (its own components, the same numbers)."""
    from pyfasst_tpu.models.components import (
        FasstParams, SpatialComp, SpectralComp, init_inst_mixing,
    )
    from pyfasst_tpu.parallel import batch_params
    port = dryrun.tiny_state_params(PROB_S, kind)
    spat = tuple(SpatialComp(A=a) for a in init_inst_mixing(None, 2, 1, 2))
    clips = []
    for b in range(port.batch):
        spec = []
        for c in port.spec:
            arrays = {n: jnp.asarray(getattr(c, n)[b].numpy())
                      for n in ("FB", "TW", "trans", "FB2", "TW2")
                      if getattr(c, n) is not None}
            spec.append(SpectralComp(spat_ind=c.spat_ind, free=c.free,
                                     free2=c.free2, constraint=c.constraint,
                                     decode=c.decode, **arrays))
        clips.append(FasstParams(spat=spat, spec=tuple(spec)))
    return batch_params(clips)


@pytest.mark.parametrize("kind", dryrun.STATE_KINDS)
def test_state_models_against_jax_batched_gem(ranks, kind):
    """The same state model through the JAX package's batched_run_gem on
    its 8-device mesh (dp 2, fp 4), against the port's fp = 2, sp = 2 and
    fp = 4 legs at rtol 2e-4."""
    from pyfasst_tpu.parallel import batched_run_gem, make_mesh
    from pyfasst_tpu.utils.config import GEMConfig as JConfig
    out, ll = batched_run_gem(_jax_state_params(kind),
                              jnp.asarray(PROB_S["X"]), JConfig(niter=NITER),
                              make_mesh(8))
    ll = np.asarray(jax.block_until_ready(ll))
    for n, leg in ((2, "fp"), (2, "sp"), (4, "fp")):
        got = ranks(n)[0]["state"][kind][leg]
        _close(got["logliks"], ll, f"{kind} {leg}={n} logliks")
        for j, c in enumerate(out.spec):
            for name in ("FB", "TW", "FB2", "TW2"):
                if getattr(c, name) is not None:
                    _close(got["params"][f"{name}{j}"],
                           np.asarray(getattr(c, name)),
                           f"{kind} {leg}={n} {name}{j}")


def test_one_clip_on_a_mesh(ranks):
    """A batch of one clip (an odd number of loglik words beside the
    complex frame sums in reduce_stats' buffer) through the fp and sp legs
    of the soft HMM against its single-device run."""
    prob = {k: v[:1] for k, v in PROB_S.items()}
    cfg = GEMConfig(niter=NITER)
    X = torch.as_tensor(prob["X"])
    params, ll = run_gem(dryrun.tiny_state_params(prob, "hmm"), X, cfg,
                         sigma_endpoints=annealing_endpoints(X, cfg))
    want = dryrun._host(params)
    for rank in ranks(2):
        for leg in ("fp", "sp"):
            got = rank["state_b1"]["hmm"][leg]
            _close(got["logliks"], ll.numpy(), f"{leg} logliks")
            for k, v in got["params"].items():
                _close(v, want[k], f"{leg} {k}")


def test_collectives_are_plain_torch_without_a_shard():
    """With no shard active the routed helpers are the plain calls they
    replace, so the single-device path keeps its bits: the state gains and
    log-likelihoods equal the unrouted formula bit for bit."""
    from pyfasst_tpu_torch.ops import collectives as co, hmm
    rng = np.random.default_rng(3)
    P = torch.as_tensor(rng.random((2, 9, 7)) + 0.1, dtype=torch.float32)
    W = torch.as_tensor(rng.random((2, 9, 3)) + 0.1, dtype=torch.float32)
    assert co.active_axis() is None and co.axis_length("F", 9) == 9
    t = P.sum(-1)
    assert co.contract(t, "FN") is t
    full, lo = co.gather_frames(P)
    assert full is P and lo == 0
    assert torch.equal(co.mean_over(P, (-2, -1), "FN"),
                       torch.mean(P, dim=(-2, -1)))
    g, L = hmm._state_gains_and_loglik(P, W, 1e-30)
    Winv = 1.0 / torch.clamp(W, min=1e-30)
    g0 = torch.clamp((Winv.mT @ P) / 9, min=1e-30)
    logw = torch.sum(torch.log(torch.clamp(W, min=1e-30)), dim=-2)
    assert torch.equal(g, g0)
    assert torch.equal(L, -(9 * torch.log(g0) + logw[..., None] + 9))


def test_state_models_world_size_one_bit_for_bit(single_state, tmp_path):
    """A process group of one rank runs every state model on the
    single-device path: the same bits as run_gem with no group."""
    got = dryrun.spawn(dryrun.state_cases, 1, PROB_S, NITER,
                       tmpdir=str(tmp_path))[0]
    for kind in dryrun.STATE_KINDS:
        for leg in ("fp", "sp"):
            g = got[kind][leg]
            assert g["mesh"] == {"dp": 1, "fp": 1}
            np.testing.assert_array_equal(g["logliks"],
                                          single_state[kind]["logliks"])
            for k, v in g["params"].items():
                np.testing.assert_array_equal(
                    v, single_state[kind]["params"][k])


@pytest.mark.parametrize("n", (2, 4))
def test_sharded_separation(ranks, single, n):
    for rank in ranks(n):
        for leg in ("fp", "dp"):
            Y = rank["sharding"][leg]["Y"]
            assert Y.shape == (4, 2, 33, 16, 2) and np.all(np.isfinite(Y))
            _close(Y, single["Y"], leg)


@pytest.mark.parametrize("n", (2, 4))
def test_against_jax_batched_gem(ranks, n):
    """The same inputs through the JAX package's batched_run_gem on its
    8-device mesh (dp 2, fp 4)."""
    from pyfasst_tpu.models.components import (
        FasstParams, SpatialComp, SpectralComp, init_inst_mixing,
    )
    from pyfasst_tpu.parallel import batch_params, batched_run_gem, make_mesh
    from pyfasst_tpu.utils.config import GEMConfig as JConfig

    B, J = PROB["FB"].shape[:2]
    spat = tuple(SpatialComp(A=a) for a in init_inst_mixing(None, 2, 1, J))
    params_b = batch_params([FasstParams(spat=spat, spec=tuple(SpectralComp(
        FB=jnp.asarray(PROB["FB"][b, j]), TW=jnp.asarray(PROB["TW"][b, j]),
        spat_ind=j) for j in range(J))) for b in range(B)])
    out, ll = batched_run_gem(params_b, jnp.asarray(PROB["X"]),
                              JConfig(niter=NITER), make_mesh(8))
    ll = np.asarray(jax.block_until_ready(ll))
    for rank in ranks(n):
        for leg in ("fp", "dp", "sp"):
            got = rank["sharding"][leg]
            _close(got["logliks"], ll, f"{leg} logliks")
            for j in range(J):
                _close(got["params"][f"FB{j}"],
                       np.asarray(out.spec[j].FB), f"{leg} FB{j}")
                _close(got["params"][f"TW{j}"],
                       np.asarray(out.spec[j].TW), f"{leg} TW{j}")


@pytest.mark.parametrize("n", (2, 4))
def test_padding_preserves_annealing_endpoints(ranks, n):
    """A heavily padded clip on a mesh (at 4 ranks its bucket is also
    padded to the dp axis of 2) keeps the endpoints of its own frames."""
    X = _clips()[0]
    Xp = torch.as_tensor(np.pad(X, ((0, 0), (0, 128 - X.shape[1]), (0, 0))))
    cfg = GEMConfig(niter=4)
    se = endpoints_from_power(
        torch.as_tensor(np.mean(np.abs(X) ** 2, axis=(1, 2)))[None], cfg)
    _, ll_ref = run_gem(dryrun.tiny_make_params(33, 128, 0), Xp[None], cfg,
                        sigma_endpoints=se)
    _, ll_diluted = run_gem(dryrun.tiny_make_params(33, 128, 0), Xp[None],
                            cfg)
    for rank in ranks(n):
        lls = rank["padding"]["logliks"]
        _close(lls[0], ll_ref[0].numpy(), "padded clip")
        assert not np.allclose(lls[0], ll_diluted[0].numpy(), rtol=1e-5)


def test_batch_separate_on_a_mesh(ranks):
    """Variable-length clips through batch_separate on 2 ranks against the
    same call on one device."""
    from pyfasst_tpu_torch.parallel.batch import batch_separate
    imgs, lls = batch_separate(_clips(), dryrun.tiny_make_params,
                               GEMConfig(niter=6), device="cpu",
                               granularity=64)
    for rank in ranks(2):
        got = rank["batch"]
        for i, n in enumerate(LENGTHS):
            assert got["images"][i].shape == (2, 33, n, 2)
            _close(got["logliks"][i], lls[i], f"clip {i} logliks")
            _close(got["images"][i], imgs[i], f"clip {i} images")


def test_checkpoint_resume_under_a_mesh(ranks):
    """A bucket cut after its first checkpoint and resumed on the same
    mesh lands on the uninterrupted run bit for bit; rank 0 wrote the
    one checkpoint and removed it at the end."""
    for rank in ranks(2):
        got, ref = rank["resume"], rank["batch"]
        assert len(got["files_after_kill"]) == 1
        assert got["files_after_kill"][0].startswith("bucket_")
        assert got["files_after_resume"] == []
        for i in range(len(LENGTHS)):
            np.testing.assert_array_equal(got["logliks"][i],
                                          ref["logliks"][i])
            np.testing.assert_array_equal(got["images"][i],
                                          ref["images"][i])


def test_frame_sharding_sp(ranks, single):
    """The SP row (tests/test_sharding.py:252-277): frames over the mesh's
    second axis against the unsharded batch."""
    for n in (2, 4):
        for rank in ranks(n):
            got = rank["sharding"]["sp"]
            assert np.all(np.isfinite(got["logliks"]))
            _close(got["logliks"], single["logliks"], "sp logliks")


def test_spatial_init_pool_on_two_ranks(ranks):
    """spatial_init's band-EM probe pool at n_devices = 2 (a (1, 2) mesh:
    frequencies split) against n_devices = 1 in the same rank: the same
    final logliks at rtol 2e-4, the same pick per band, the same
    converged labels on >= 99% of the bins."""
    for rank in ranks(2):
        one, two = rank["pool"][1], rank["pool"][2]
        _close(two["ll"], one["ll"], "pool logliks")
        np.testing.assert_array_equal(two["pick"], one["pick"])
        assert np.mean(two["lab"] == one["lab"]) >= 0.99


def test_cli_n_devices_on_two_ranks(ranks, tmp_path):
    """`separate --spatial-init --n-devices 2` inside a process group of
    two: both ranks exit 0, rank 0 alone prints the report, and the WAVs
    it names exist."""
    r0, r1 = (rank["cli"] for rank in ranks(2))
    assert r0["rc"] == 0 and r1["rc"] == 0
    assert r1["stdout"] == ""
    rep = json.loads(r0["stdout"].strip().splitlines()[-1])
    assert len(rep["files"]) == 2
    assert all(os.path.exists(f) for f in rep["files"])
    assert np.isfinite(rep["final_loglik"])


def test_cli_checkpoint_on_two_ranks(ranks):
    """`--checkpoint` with `--n-devices 2`: both ranks run the fit, rank 0
    alone saves the checkpoints (once per chunk of one iteration), and the
    file it leaves loads at the last iteration."""
    from pyfasst_tpu_torch.utils.checkpoint import load_params
    r0, r1 = (rank["cli_ckpt"] for rank in ranks(2))
    assert r0["rc"] == 0 and r1["rc"] == 0
    assert r0["saves"] == 3 and r1["saves"] == 0
    rep = json.loads(r0["stdout"].strip().splitlines()[-1])
    path = os.path.join(os.path.dirname(os.path.dirname(rep["files"][0])),
                        "ck.npz")
    params, it, _ = load_params(path, device="cpu")
    assert it == 3 and len(params.spec) == 2


def test_world_size_one_is_bit_for_bit(single, tmp_path):
    """A process group of one rank runs the single-device path: the same
    bits as run_gem and separate_sources with no group."""
    got = dryrun.spawn(dryrun.single_case, 1, PROB, NITER,
                       tmpdir=str(tmp_path))[0]
    assert got["mesh"] == {"dp": 1, "fp": 1}
    np.testing.assert_array_equal(got["logliks"], single["logliks"])
    np.testing.assert_array_equal(got["Y"], single["Y"])
    for k, v in got["params"].items():
        np.testing.assert_array_equal(v, single["params"][k])


def test_make_mesh_without_a_group_raises():
    assert sharding.make_mesh(1, device="cpu").size == 1
    assert sharding.make_mesh(device="cpu").shape == {"dp": 1, "fp": 1}
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        sharding.make_mesh(4, device="cpu")
