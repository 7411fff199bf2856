"""GEM loop of the port against the JAX package: 10 iterations from the
same parameters.

float32: loglik rtol 1e-5 and parameters rtol 1e-4 (floor 1e-6 of the
largest entry): ten iterations of float32 rounding-order differences,
each ~1e-6, compound through the multiplicative updates.
float64 (JAX under enable_x64): the bars of tests/test_parity.py, loglik
rtol 1e-6 and parameters rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from pyfasst_tpu.ops import gem as jgem
from pyfasst_tpu.utils.config import GEMConfig as JConfig
from pyfasst_tpu_torch.ops import gem
from pyfasst_tpu_torch.utils.config import GEMConfig
from tests.torch_parity import batched, jax_problem, to_torch_params

torch.set_num_threads(1)


def _compare(got_params, got_ll, want_params, want_ll, b, ll_rtol, rtol,
             floor):
    np.testing.assert_allclose(got_ll[b].numpy(), np.asarray(want_ll),
                               rtol=ll_rtol)
    for tc, jc in zip(got_params.spat, want_params.spat):
        w = np.asarray(jc.A)
        np.testing.assert_allclose(tc.A[b].numpy(), w, rtol=rtol,
                                   atol=floor * np.max(np.abs(w)))
    for tc, jc in zip(got_params.spec, want_params.spec):
        for name in ("FB", "TW"):
            w = np.asarray(getattr(jc, name))
            np.testing.assert_allclose(getattr(tc, name)[b].numpy(), w,
                                       rtol=rtol,
                                       atol=floor * np.max(np.abs(w)))


@pytest.mark.parametrize("annealing", ["ann", "no_ann"])
def test_run_gem_float32_matches_jax(annealing):
    rng = np.random.default_rng(0)
    X, jp, _ = jax_problem(rng, F=33, N=40)
    want_p, want_ll = jgem.run_gem(jp, jnp.asarray(X),
                                   JConfig(niter=10, annealing=annealing))
    got_p, got_ll = gem.run_gem(to_torch_params(jp), batched(X),
                                GEMConfig(niter=10, annealing=annealing))
    assert got_ll.shape == (1, 10) and got_ll.dtype == torch.float32
    _compare(got_p, got_ll, want_p, want_ll, 0, 1e-5, 1e-4, 1e-6)


@pytest.mark.parametrize("mix,annealing", [("inst", "ann"),
                                           ("inst", "no_ann"),
                                           ("inst", "ann_ns_inj"),
                                           ("conv", "ann")])
def test_run_gem_float64_matches_jax(mix, annealing):
    with enable_x64():
        rng = np.random.default_rng(1)
        X, jp, _ = jax_problem(rng, F=33, N=40, mix_type=mix,
                               dtype=np.float64)
        cfg = JConfig(niter=10, annealing=annealing)
        want_p, want_ll = jgem.run_gem(jp, jnp.asarray(X), cfg)
        got_p, got_ll = gem.run_gem(to_torch_params(jp, torch.float64),
                                    batched(X),
                                    GEMConfig(niter=10, annealing=annealing))
        _compare(got_p, got_ll, want_p, want_ll, 0, 1e-6, 1e-5, 1e-9)


def test_run_gem_two_clips_match_two_jax_runs():
    rng = np.random.default_rng(2)
    probs = [jax_problem(rng, F=33, N=40) for _ in range(2)]
    cfg = GEMConfig(niter=10)
    tps = [to_torch_params(p[1]) for p in probs]
    tp = tps[0].replace(
        spat=tuple(a.replace(A=torch.cat([a.A, b.A]))
                   for a, b in zip(tps[0].spat, tps[1].spat)),
        spec=tuple(a.replace(FB=torch.cat([a.FB, b.FB]),
                             TW=torch.cat([a.TW, b.TW]))
                   for a, b in zip(tps[0].spec, tps[1].spec)))
    X = torch.cat([batched(p[0]) for p in probs])
    got_p, got_ll = gem.run_gem(tp, X, cfg)
    assert got_ll.shape == (2, 10)
    for b, (Xb, jp, _) in enumerate(probs):
        want_p, want_ll = jgem.run_gem(jp, jnp.asarray(Xb), JConfig(niter=10))
        _compare(got_p, got_ll, want_p, want_ll, b, 1e-5, 1e-4, 1e-6)


def test_chunked_run_is_the_uninterrupted_run():
    """Chunks [0, 4) + [4, 10) reproduce the single run bit for bit (the
    schedule is a function of the iteration index and the full niter)."""
    rng = np.random.default_rng(3)
    X, jp, _ = jax_problem(rng, F=17, N=30)
    cfg = GEMConfig(niter=10)
    tX = batched(X)
    whole_p, whole_ll = gem.run_gem(to_torch_params(jp), tX, cfg)
    p, ll = gem.run_gem(to_torch_params(jp), tX, cfg, end_iter=4)
    assert float(ll[0, 4:].abs().max()) == 0.0
    p, ll = gem.run_gem(p, tX, cfg, start_iter=4, logliks=ll)
    assert torch.equal(ll, whole_ll)
    for a, b in zip(p.spat, whole_p.spat):
        assert torch.equal(a.A, b.A)
    for a, b in zip(p.spec, whole_p.spec):
        assert torch.equal(a.FB, b.FB) and torch.equal(a.TW, b.TW)


@pytest.mark.parametrize("annealing", ["ann", "no_ann"])
def test_annealing_schedule_matches_jax(annealing):
    rng = np.random.default_rng(4)
    X, _, _ = jax_problem(rng, F=17, N=30)
    X[3] = 0.0                                   # a silent bin is floored
    jcfg, cfg = JConfig(niter=7), GEMConfig(niter=7)
    js0, js1 = jgem.annealing_endpoints(jnp.asarray(X), jcfg)
    ts0, ts1 = gem.annealing_endpoints(batched(X), cfg)
    np.testing.assert_allclose(ts0[0].numpy(), np.asarray(js0), rtol=1e-6)
    np.testing.assert_allclose(ts1[0].numpy(), np.asarray(js1), rtol=1e-6)
    mode = jcfg.annealing.__class__(annealing)
    for it in range(7):
        want = jgem.noise_psd(jnp.int32(it), 7, js0, js1, mode)
        got = gem.noise_psd(it, 7, ts0, ts1, cfg.annealing.__class__(
            annealing))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=1e-6)
