"""The GEM loop as CUDA graphs (ops/gem.py::run_gem, graph_rule).

On the CPU: the annealing table the graph gathers its noise PSD from,
against noise_psd bit for bit; which calls the graph takes and which stay
eager (graph_rule on CPU and meta inputs, the segments of a call); the
graph path with a stand-in graph that runs its capture once (the captured
step against the eager one, GRAPH_STEPS of a call). On the card (marker
`cuda`, skipped without one; `python -m pytest
tests/test_torch_gem_graph.py -m cuda --noconftest`): the graphed loop
against the eager loop (gem._eager_loop), bit for bit, over the logliks
and the final A, FB and TW, and each kernel once an iteration in the
device's trace. The file imports nothing of the JAX package.
"""
import pytest
import torch

from pyfasst_tpu_torch.models.components import (
    FasstParams, SpatialComp, SpectralComp,
)
from pyfasst_tpu_torch.ops import collectives, cuda_estep, cuda_spectral, gem
from pyfasst_tpu_torch.utils.config import AnnealingMode, GEMConfig

torch.set_num_threads(1)


def _params(B, F, N, K, device, ranks=(1, 1), mix="inst", seed=0,
            dtype=torch.float32, constraint="NMF", source_filter=False):
    g = torch.Generator().manual_seed(seed)
    spat, spec = [], []
    for j, R in enumerate(ranks):
        if mix == "inst":
            A = torch.rand(B, 2, R, generator=g, dtype=dtype) + 0.3
        else:
            A = 0.5 * torch.complex(
                torch.randn(B, F, 2, R, generator=g, dtype=dtype),
                torch.randn(B, F, 2, R, generator=g, dtype=dtype))
        spat.append(SpatialComp(A=A.to(device), mix_type=mix))
        extra = {}
        if source_filter:
            extra = {"FB2": torch.rand(B, F, 2, dtype=dtype).to(device),
                     "TW2": torch.rand(B, 2, N, dtype=dtype).to(device)}
        spec.append(SpectralComp(
            FB=(0.5 + torch.rand(B, F, K, generator=g, dtype=dtype)).to(
                device),
            TW=(0.5 + torch.rand(B, K, N, generator=g, dtype=dtype)).to(
                device),
            spat_ind=j, constraint=constraint, **extra))
    return FasstParams(spat=tuple(spat), spec=tuple(spec))


def _X(B, F, N, I, device, seed=0, dtype=torch.complex64):
    g = torch.Generator().manual_seed(seed + 1)
    return torch.complex(torch.randn(B, F, N, I, generator=g),
                         torch.randn(B, F, N, I, generator=g)).to(
        device=device, dtype=dtype)


def _reset_counters():
    cuda_estep.LAUNCHES = 0
    for d in (cuda_estep.VARIANT_LAUNCHES, cuda_spectral.LAUNCHES,
              gem.GRAPH_STEPS):
        for k in d:
            d[k] = 0


# -- the CPU: the annealing table, the rule, the counts -------------------------

@pytest.mark.parametrize("niter", [1, 2, 500])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", list(AnnealingMode))
def test_annealing_weights_give_noise_psd_bit_for_bit(mode, dtype, niter):
    """The graph's noise PSD, gathered from the table by a device counter,
    is noise_psd's at every iteration, to the bit."""
    g = torch.Generator().manual_seed(niter)
    s0 = 10 * torch.rand(3, 17, generator=g, dtype=dtype) + 1e-3
    s1 = 1e-3 * torch.rand(3, 17, generator=g, dtype=dtype) + 1e-9
    table = torch.from_numpy(gem.annealing_weights(niter, dtype, mode))
    assert table.dtype == dtype and table.shape == (niter, 2)
    for it in range(niter):
        got = gem.noise_psd_from(table.index_select(0, torch.tensor([it])),
                                 s0, s1)
        want = gem.noise_psd(it, niter, s0, s1, mode)
        assert got.dtype == want.dtype and torch.equal(got, want), it


def _rule_case(name):
    """(params, X, cfg, shard) of a call graph_rule sends to the eager
    loop, and a word of the reason it gives."""
    cfg = GEMConfig(niter=10)
    meta = torch.device("meta")
    p, X = _params(2, 9, 12, 3, meta), _X(2, 9, 12, 2, meta)
    if name == "cpu":
        return (_params(2, 9, 12, 3, "cpu"), _X(2, 9, 12, 2, "cpu"), cfg,
                False, "cpu tensor")
    if name == "meta":
        return p, X, cfg, False, "meta tensor"
    if name in ("mono", "three"):
        I = 1 if name == "mono" else 3
        return p, _X(2, 9, 12, I, meta), cfg, False, f"I = {I}"
    if name == "sharded":
        return p, X, cfg, True, "sharded"
    if name == "float64":
        return (_params(2, 9, 12, 3, meta, dtype=torch.float64),
                _X(2, 9, 12, 2, meta, dtype=torch.complex128), cfg, False,
                "float64")
    if name == "rank3":
        return (_params(2, 9, 12, 3, meta, ranks=(1, 3), mix="conv"), X, cfg,
                False, "ranks")
    if name == "hmm":
        return (_params(2, 9, 12, 3, meta, constraint="HMM"), X, cfg, False,
                "GMM/HMM")
    if name == "source_filter":
        return (_params(2, 9, 12, 3, meta, source_filter=True), X, cfg,
                False, "source-filter")
    raise KeyError(name)


@pytest.mark.parametrize("name", ["cpu", "meta", "mono", "three", "sharded",
                                  "float64", "rank3", "hmm",
                                  "source_filter"])
def test_graph_rule_sends_these_calls_to_the_eager_loop(name):
    params, X, cfg, shard, word = _rule_case(name)
    if shard:
        with collectives.sharded("F", None, X.shape[1]):
            why = gem.graph_rule(params, X, cfg)
    else:
        why = gem.graph_rule(params, X, cfg)
    assert word in why


def test_graph_rule_takes_kernel_models_but_for_the_device():
    """Every model with a kernel E-step passes all but the device check:
    real and complex mixing, rank 2, ns_inj, fast_recip, fused spectra."""
    meta = torch.device("meta")
    X = _X(2, 9, 12, 2, meta)
    for params, cfg in [
            (_params(2, 9, 12, 3, meta), GEMConfig()),
            (_params(2, 9, 12, 3, meta, ranks=(1, 1, 1), mix="conv"),
             GEMConfig(fast_recip=True)),
            (_params(2, 9, 12, 3, meta, ranks=(1, 2, 2, 1), mix="conv"),
             GEMConfig(annealing="ann_ns_inj", fuse_spectral=True))]:
        assert gem.graph_rule(params, X, cfg) == \
            "a meta tensor (graphs are CUDA's)"


@pytest.mark.parametrize("start,stop,hold,segments", [
    (0, 500, 50, [(0, 50), (50, 500)]),      # a whole call: two graphs
    (60, 80, 50, [(60, 80)]),                # the profiled chunk: one
    (45, 55, 50, [(45, 50), (50, 55)]),      # a chunk across the hold
    (49, 51, 50, [(49, 50), (50, 51)]),      # single iterations: eager
    (0, 10, 0, [(0, 10)]),                   # no hold
    (7, 7, 50, []),                          # nothing to run
])
def test_segments_cut_at_the_hold(start, stop, hold, segments):
    assert gem._segments(start, stop, hold) == segments


def test_cpu_run_counts_eager_iterations_only():
    _reset_counters()
    cfg = GEMConfig(niter=6, spatial_hold_frac=0.5)
    params, X = _params(1, 9, 12, 3, "cpu"), _X(1, 9, 12, 2, "cpu")
    gem.run_gem(params, X, cfg, end_iter=4)
    assert gem.GRAPH_STEPS == {"captures": 0, "replayed": 0, "eager": 4}


class _RunOnceGraph:
    """torch.cuda.CUDAGraph's stand-in on the CPU: a "capture" runs the
    step once as it is issued, a replay does nothing."""

    def capture_begin(self, pool=None, capture_error_mode=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def cpu_graphs(monkeypatch):
    """run_gem's graph path on the CPU, with _RunOnceGraph for graphs."""
    import contextlib
    nothing = contextlib.nullcontext
    for name, value in [("CUDAGraph", _RunOnceGraph),
                        ("Stream", lambda *a: _Stream()),
                        ("current_stream", lambda *a: _Stream()),
                        ("graph_pool_handle", lambda: (0, 1)),
                        ("stream", lambda s: nothing()),
                        ("device", lambda d: nothing())]:
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(torch._C, "_cuda_clearCublasWorkspaces",
                        lambda: None, raising=False)
    monkeypatch.setattr(gem, "_CAPTURE", {})
    monkeypatch.setattr(gem, "graph_rule", lambda *a: "")
    monkeypatch.setattr(gem, "_device_weights", lambda cfg, dtype, dev: (
        torch.from_numpy(gem.annealing_weights(cfg.niter, dtype,
                                               cfg.annealing))))


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("hold_frac,stop,segments", [(0.0, 2, 1),
                                                     (0.5, 4, 2)])
def test_captured_step_is_the_eager_step(cpu_graphs, hold_frac, stop,
                                         segments, fuse):
    """Segments of two iterations, spatial updates on (hold 0) and off then
    on (hold 2): the eager first step, then the captured one (run at its
    capture here, at its one replay on the card) with its noise PSD and log-likelihood column picked by the device
    counter and its state written back in place, give the eager loop's
    bits."""
    cfg = GEMConfig(niter=4, spatial_hold_frac=hold_frac, fuse_spectral=fuse)
    params, X = _params(2, 9, 12, 3, "cpu"), _X(2, 9, 12, 2, "cpu")
    logliks = torch.zeros(2, 4)
    want = gem._eager_loop(params, X, cfg, 0, stop,
                           gem.annealing_endpoints(X, cfg), logliks, None,
                           False)
    _reset_counters()
    got, ll = gem.run_gem(params, X, cfg, end_iter=stop)
    assert gem.GRAPH_STEPS == {"captures": segments, "replayed": segments,
                               "eager": segments}
    assert torch.equal(ll, logliks)
    for a, b in zip(gem._leaves(got), gem._leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("start,stop,niter,counts", [
    (0, 500, 500, (2, 498, 2)),     # a whole call: two segments
    (60, 80, 500, (1, 19, 1)),      # the profiled chunk
    (45, 55, 100, (2, 8, 2)),       # a chunk across the hold
    (49, 51, 100, (0, 0, 2)),       # single iterations stay eager
    (7, 7, 100, (0, 0, 0)),         # nothing to run
])
def test_graph_steps_count_a_call(cpu_graphs, start, stop, niter, counts):
    """GRAPH_STEPS of one call: in each segment of two or more
    iterations the first eager and the others replays of one capture."""
    cfg = GEMConfig(niter=niter, spatial_hold_frac=0.5 if niter == 100
                    else 0.1)
    params, X = _params(1, 5, 6, 2, "cpu"), _X(1, 5, 6, 2, "cpu")
    _reset_counters()
    gem.run_gem(params, X, cfg, start_iter=start, end_iter=stop)
    assert gem.GRAPH_STEPS == dict(zip(("captures", "replayed", "eager"),
                                       counts))


# -- the card: graph against eager, bit for bit ---------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _eager(params, X, cfg, start=0, stop=None, logliks=None):
    """gem._eager_loop as run_gem would call it."""
    if logliks is None:
        logliks = torch.zeros((X.shape[0], cfg.niter), dtype=torch.float32,
                              device=X.device)
    stop = cfg.niter if stop is None else stop
    return gem._eager_loop(params, X, cfg, start, stop,
                           gem.annealing_endpoints(X, cfg), logliks,
                           cuda_estep.pack_x4(X), False), logliks


def _assert_same(got, want):
    (pg, lg), (pw, lw) = got, want
    assert torch.equal(lg, lw), float((lg - lw).abs().max())
    for a, b in zip(gem._leaves(pg), gem._leaves(pw)):
        assert a.shape == b.shape
        assert torch.equal(a, b), float((a - b).abs().max())


def _cell_cfg(fuse, niter=500):
    return GEMConfig(niter=niter, sigma_end_frac=1e-3, fuse_spectral=fuse)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_graph_equals_eager_over_500_iterations(dev, fuse):
    """Both cells' configurations (bench.py's model, unfused and fused) at
    a small shape: the graphed loop is the eager loop's bits, the
    caller's parameters are untouched, and no returned tensor is one of
    them."""
    params, X = _params(2, 65, 100, 8, dev), _X(2, 65, 100, 2, dev)
    before = [t.clone() for t in gem._leaves(params)]
    cfg = _cell_cfg(fuse)
    want = _eager(params, X, cfg)
    _reset_counters()
    got = gem.run_gem(params, X, cfg)
    _assert_same(got, want)
    assert gem.GRAPH_STEPS["replayed"] >= cfg.niter - 2
    for t, b in zip(gem._leaves(params), before):
        assert torch.equal(t, b)
    mine = {id(t) for t in gem._leaves(params)}
    assert not any(id(t) in mine for t in gem._leaves(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["configs1", "configs2"])
def test_graph_equals_eager_general_kernel(dev, model):
    """configs[1]'s model (complex mixing, J = 3: the general kernel) and
    configs[2]'s (ranks 1, 2, 2, 1), across the spatial hold."""
    ranks = (1, 1, 1) if model == "configs1" else (1, 2, 2, 1)
    params = _params(2, 33, 70, 6, dev, ranks=ranks, mix="conv", seed=3)
    X = _X(2, 33, 70, 2, dev, seed=3)
    cfg = GEMConfig(niter=60, spatial_hold_frac=0.3, sigma_end_frac=1e-3)
    _assert_same(gem.run_gem(params, X, cfg), _eager(params, X, cfg))


@pytest.mark.cuda
def test_graph_chunks_and_resume_equal_the_eager_run(dev, tmp_path):
    """Chunks that cut the hold (..45, 45..55, 55..) and a resume from a
    checkpoint written at 55 repeat the uninterrupted eager run."""
    from pyfasst_tpu_torch.utils.checkpoint import load_params, save_params
    params, X = _params(2, 65, 100, 8, dev), _X(2, 65, 100, 2, dev)
    cfg = _cell_cfg(False)
    want = _eager(params, X, cfg)
    p, ll = gem.run_gem(params, X, cfg, end_iter=45)
    p, ll = gem.run_gem(p, X, cfg, start_iter=45, end_iter=55, logliks=ll)
    path = save_params(str(tmp_path / "ck.npz"), p, iteration=55,
                       stacked=True)
    _assert_same(gem.run_gem(p, X, cfg, start_iter=55, logliks=ll.clone()),
                 want)
    q, it, _ = load_params(path, device=dev)
    assert it == 55
    _assert_same(gem.run_gem(q, X, cfg, start_iter=55, logliks=ll), want)


def _kernel_events(fn) -> dict:
    """{kernel: events} in the device's trace of fn(), by the kernel's name
    without its template arguments."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+)(<[^()]*>)?\(", e.name)
            key = m.group(1) if m else e.name
            out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_graph_runs_each_kernel_once_an_iteration(dev, fuse):
    """The host counts the launches of the eager iterations alone
    (cuda_estep.LAUNCHES, cuda_spectral.LAUNCHES: one each); the device's
    trace of the whole run shows the E-step kernel, and the fused spectral
    kernels, once an iteration."""
    params, X = _params(2, 65, 100, 8, dev), _X(2, 65, 100, 2, dev)
    cfg = _cell_cfg(fuse, niter=40)
    gem.run_gem(params, X, cfg)
    _reset_counters()
    seen = _kernel_events(lambda: gem.run_gem(params, X, cfg))
    assert gem.GRAPH_STEPS == {"captures": 2, "replayed": 38, "eager": 2}
    assert cuda_estep.LAUNCHES == cuda_estep.VARIANT_LAUNCHES["a"] == 2
    spectral = ("fb_stats_kernel", "tw_stats_kernel")
    assert cuda_spectral.LAUNCHES == dict.fromkeys(
        ("fb_stats", "tw_stats"), 2 if fuse else 0)
    assert seen.get("estep_r1_real_kernel") == cfg.niter, seen
    assert [seen.get(k, 0) for k in spectral] == [cfg.niter * fuse] * 2


@pytest.mark.cuda
def test_graph_calls_in_turns_equal_eager(dev):
    """Calls of two signatures in turns (unfused at one shape, fused at
    another), each capturing into the pool the other's graph used, with
    matrix products on the caller's stream between them (cuBLAS's
    workspaces dropped and made again around every capture): every call
    gives the eager loop's bits."""
    cases = [(_params(2, 65, 100, 8, dev), _X(2, 65, 100, 2, dev),
              _cell_cfg(False, niter=30)),
             (_params(1, 33, 70, 4, dev, seed=5), _X(1, 33, 70, 2, dev,
                                                    seed=5),
              _cell_cfg(True, niter=30))]
    wants = [_eager(p, X, cfg) for p, X, cfg in cases]
    g = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        for (p, X, cfg), want in zip(cases, wants):
            got = gem.run_gem(p, X, cfg)
            a, b = (torch.randn(256, 256, device=dev, generator=g)
                    for _ in range(2))
            (a @ b).sum().item()
            _assert_same(got, want)


@pytest.mark.cuda
def test_graph_takes_a_layout_of_its_own(dev):
    """Parameters laid out otherwise than the step lays its outputs (TW a
    transposed view) still give the eager loop's bits."""
    params, X = _params(2, 65, 100, 8, dev), _X(2, 65, 100, 2, dev)
    params = params.replace(spec=tuple(
        c.replace(TW=c.TW.mT.contiguous().mT) for c in params.spec))
    cfg = _cell_cfg(False, niter=30)
    _assert_same(gem.run_gem(params, X, cfg), _eager(params, X, cfg))


@pytest.mark.cuda
def test_sharded_and_cpu_runs_stay_eager(dev):
    """A CPU call and a sharded call on the card (a one-rank gloo group,
    its sums finished by all_reduce) run no graph."""
    import socket

    import torch.distributed as dist
    cfg = _cell_cfg(False, niter=8)
    _reset_counters()
    gem.run_gem(_params(1, 9, 12, 3, "cpu"), _X(1, 9, 12, 2, "cpu"), cfg)
    assert gem.GRAPH_STEPS == {"captures": 0, "replayed": 0, "eager": 8}
    params, X = _params(2, 65, 100, 8, dev), _X(2, 65, 100, 2, dev)
    ends = gem.annealing_endpoints(X, cfg)
    made = not dist.is_initialized()
    if made:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    try:
        _reset_counters()
        with collectives.sharded("F", dist.group.WORLD, X.shape[1]):
            gem.run_gem(params, X, cfg, sigma_endpoints=ends)
        assert gem.GRAPH_STEPS == {"captures": 0, "replayed": 0,
                                   "eager": 8}
    finally:
        if made:
            dist.destroy_process_group()
