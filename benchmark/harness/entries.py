"""The two entries into the program a traffic file can drive, chosen by
its "entry":

    batch      the bench pipeline on B clips at a time, as bench.py and
               chip_smoke.pipeline run it: tf.stft._stft_core ->
               ops.gem.run_gem -> ops.wiener.separate_sources ->
               tf.stft._istft_core, on clips held on the device
    host_api   one clip at a time from a WAV file to WAV files through
               MultiChanNMFInst_FASST(...), estim_param_a_posteriori()
               and separate_spat_comps(out_dir)

An entry makes its pool from the seed and warms the cell's shapes in
setup(); unit(i, spans) runs the i-th unit of the window and returns what
the check needs of it; gem_inputs(kept) gives the kept unit's initial
parameters, plane and configuration, from which with_steps() runs its GEM
again to record the program's own steps past the hold; reference(kept)
runs the plain reference on the same inputs and from those states;
profile_step() gives the GEM chunk the traced run profiles. The program is
called through its modules' attributes, so a test can break it
underneath.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from harness import prng, reference, traffic, wav

PROFILE_ITERS = (60, 80)


def _mod(name):
    return importlib.import_module(f"pyfasst_tpu_torch.{name}")


def gem_config(model: dict):
    g = model["gem"]
    return _mod("utils.config").GEMConfig(
        niter=g["niter"], annealing=g["annealing"],
        sigma_start_frac=g["sigma_start_frac"],
        sigma_end_frac=g["sigma_end_frac"], eps=g["eps"],
        power_floor_frac=g["power_floor_frac"],
        spatial_hold_frac=g["spatial_hold_frac"],
        fuse_spectral=model["fuse_spectral"])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Events:
    """CUDA events around a stage (elapsed ms read after the window), or
    the host clock with synchronisation on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pairs = []

    def stage(self, fn):
        if self.cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = fn()
            b.record()
            self.pairs.append((a, b))
            return out
        t0 = time.perf_counter()
        out = fn()
        self.pairs.append(time.perf_counter() - t0)
        return out

    def seconds(self):
        return sum(a.elapsed_time(b) / 1e3 for a, b in self.pairs) \
            if self.cuda else sum(self.pairs)


def step_iters(cfg) -> list:
    """The iterations the check follows one by one from the program's own
    state: the first spatial update (the hold's end), the middle and the
    last of the fit."""
    hold = int(cfg.spatial_hold_frac * cfg.niter)
    return sorted({hold, cfg.niter // 2, cfg.niter - 1})


def _state(params) -> dict:
    return {"A": torch.stack([c.A[..., 0] for c in params.spat], 1),
            "FB": torch.stack([c.FB for c in params.spec], 1),
            "TW": torch.stack([c.TW for c in params.spec], 1)}


def with_steps(entry, kept: dict) -> dict:
    """kept with "steps": the kept unit's GEM run again by ops.gem.run_gem,
    in chunks that stop before each of step_iters, and for each such
    iteration the state before it ("A0", "FB0", "TW0"), its log-likelihood
    and the state after it; and "rerun", the final state of that run."""
    gem_m = _mod("ops.gem")
    params, X, cfg = entry.gem_inputs(kept)
    logliks = torch.zeros((X.shape[0], cfg.niter), dtype=torch.float32,
                          device=X.device)
    steps, at = [], 0
    for it in step_iters(cfg):
        params, _ = gem_m.run_gem(params, X, cfg, start_iter=at,
                                  end_iter=it, logliks=logliks)
        before = {k + "0": v for k, v in _state(params).items()}
        params, _ = gem_m.run_gem(params, X, cfg, start_iter=it,
                                  end_iter=it + 1, logliks=logliks)
        steps.append({"it": it, "loglik": logliks[:, it].clone(), **before,
                      **_state(params)})
        at = it + 1
    params, _ = gem_m.run_gem(params, X, cfg, start_iter=at,
                              logliks=logliks)
    return {**kept, "steps": steps, "rerun": _state(params)}


def _starts(kept: dict, dtype, device) -> list:
    """The reference's inputs for the program's steps."""
    return [{"it": st["it"], **{n: st[n + "0"].to(device=device,
                                                  dtype=dtype)
                                for n in ("A", "FB", "TW")}}
            for st in kept.get("steps", ())]


@dataclasses.dataclass
class Cell:
    name: str
    model: dict
    traffic: dict
    seed: int
    device: str


class Batch:
    """B clips a call from a pool held on the device, the calls rotating
    through the pool's groups of B."""

    def __init__(self, cell: Cell):
        self.cell = cell
        m, tr = cell.model, cell.traffic
        self.B, self.J, self.K = tr["batch"], m["sources"], m["nmf_rank"]
        self.T, self.F, self.N = traffic.clip_shape(tr["clips"], m)
        self.audio_s = self.B * tr["clips"]["seconds"]
        self.groups = tr["pool"] // self.B

    def setup(self):
        c, m = self.cell, self.cell.model
        comps = _mod("models.components")
        self.cfg = gem_config(m)
        self.window = torch.as_tensor(
            _mod("tf.stft").sine_window(m["wlen"]), dtype=torch.float32,
            device=c.device)
        P = self.groups * self.B
        self.mix = traffic.make_clips(c.seed, c.traffic["clips"], P,
                                      c.device)
        self.A, self.FB, self.TW = traffic.make_params(
            c.seed, c.traffic["init"], P, self.J, self.F, self.N, self.K,
            c.device)
        self.params = []
        for g in range(self.groups):
            sl = slice(g * self.B, (g + 1) * self.B)
            self.params.append(comps.FasstParams(
                spat=tuple(comps.SpatialComp(
                    A=self.A[sl, j, :, None].contiguous())
                    for j in range(self.J)),
                spec=tuple(comps.SpectralComp(
                    FB=self.FB[sl, j].contiguous(),
                    TW=self.TW[sl, j].contiguous(), spat_ind=j)
                    for j in range(self.J))))
        self.unit(0)                                    # warm the shapes
        _sync(c.device)

    def unit(self, i: int, spans: dict = None) -> dict:
        g = i % self.groups
        sl = slice(g * self.B, (g + 1) * self.B)
        stft_m, gem_m, wiener_m = (_mod("tf.stft"), _mod("ops.gem"),
                                   _mod("ops.wiener"))
        m, cfg, win = self.cell.model, self.cfg, self.window
        ev = _Events(self.cell.device) if spans is not None else None

        def stage(fn):
            return ev.stage(fn) if ev else fn()
        X = stage(lambda: stft_m._stft_core(self.mix[sl], win, m["wlen"],
                                            m["hop"], "fft"))
        if spans is not None:
            _sync(self.cell.device)
            t0 = time.perf_counter()
        params, logliks = gem_m.run_gem(self.params[g], X, cfg)
        if spans is not None:
            t1 = time.perf_counter()
            _sync(self.cell.device)
            t2 = time.perf_counter()
            spans["gem_s"].append(t2 - t0)
            spans["enqueue_s"].append(t1 - t0)

        def wiener():
            return wiener_m.separate_sources(
                params, X, gem_m.annealing_endpoints(X, cfg)[1])
        Y = stage(wiener)
        ys = stage(lambda: stft_m._istft_core(Y, win, m["wlen"], m["hop"],
                                              self.T))
        _sync(self.cell.device)
        if ev:
            spans["events"].append(ev)
        return {"group": g, "logliks": logliks, "ys": ys, **_state(params)}

    def health(self, out: dict):
        return out["logliks"]

    def bad(self, logliks) -> bool:
        return not bool(torch.isfinite(logliks).all())

    def keep(self, out: dict) -> dict:
        return out

    def read_back(self, kept: dict) -> dict:
        return kept

    def gem_inputs(self, kept: dict):
        g, m = kept["group"], self.cell.model
        X = _mod("tf.stft")._stft_core(
            self.mix[g * self.B:(g + 1) * self.B], self.window, m["wlen"],
            m["hop"], "fft")
        return self.params[g], X, self.cfg

    def release(self):
        """Drop the program's initial parameters before the reference."""
        self.params = None

    def reference(self, kept: dict, dtype=torch.float64, tf32=False,
                  low=None) -> dict:
        """The reference's whole fit of the kept unit's clips and its steps
        from the program's states, in `dtype` (TF32 products with tf32,
        the state held in `low`, if given), and its images from the
        program's final state (the Wiener filter in `low`)."""
        sl = slice(kept["group"] * self.B, (kept["group"] + 1) * self.B)
        mix, A, FB, TW = (t[sl].to(dtype)
                          for t in (self.mix, self.A, self.FB, self.TW))
        out = reference.fit(mix, A, FB, TW, self.cell.model,
                            _starts(kept, dtype, mix.device), tf32, low)
        out["ys"] = reference.separate(
            mix, *(kept[n].to(dtype) for n in ("A", "FB", "TW")),
            self.cell.model, low)
        return out

    def profile_step(self):
        """GEM iterations PROFILE_ITERS of the first group, as one call."""
        gem_m, stft_m, m = _mod("ops.gem"), _mod("tf.stft"), self.cell.model
        X = stft_m._stft_core(self.mix[:self.B], self.window, m["wlen"],
                              m["hop"], "fft")
        sig = gem_m.annealing_endpoints(X, self.cfg)
        a, b = PROFILE_ITERS

        def step():
            gem_m.run_gem(self.params[0], X, self.cfg, start_iter=a,
                          end_iter=b, sigma_endpoints=sig)
        return step, b - a

    def close(self):
        pass


class HostAPI:
    """One clip a call, WAV in and WAV out, through the host API."""

    def __init__(self, cell: Cell):
        self.cell = cell
        m, tr = cell.model, cell.traffic
        self.J, self.K = m["sources"], m["nmf_rank"]
        self.T, self.F, self.N = traffic.clip_shape(tr["clips"], m)
        self.audio_s = tr["clips"]["seconds"]
        self.pool = tr["pool"]

    def setup(self):
        c = self.cell
        self.tmp = tempfile.mkdtemp(prefix="fasst-bench-")
        self.out_dir = os.path.join(self.tmp, "out")
        self.keep_dir = os.path.join(self.tmp, "keep")
        os.makedirs(self.keep_dir)
        mix = traffic.make_clips(c.seed, c.traffic["clips"], self.pool,
                                 c.device).cpu().numpy()
        self.paths = []
        for i in range(self.pool):
            path = os.path.join(self.tmp, f"clip{i}.wav")
            wav.write_float32(path, mix[i], c.traffic["clips"]["fs"])
            self.paths.append(path)
        self.seeds = traffic.host_seeds(c.seed, self.pool)
        self.unit(0)                                    # warm the shapes
        _sync(c.device)

    def model(self, i: int):
        m = self.cell.model
        g = m["gem"]
        model = _mod("models.variants").MultiChanNMFInst_FASST(
            self.paths[i % self.pool], nbComps=self.J,
            nbNMFComps=self.K, wlen=m["wlen"], hop=m["hop"],
            iter_num=g["niter"], annealing=g["annealing"],
            sigma_start_frac=g["sigma_start_frac"],
            sigma_end_frac=g["sigma_end_frac"],
            spatial_hold_frac=g["spatial_hold_frac"],
            seed=self.seeds[i % self.pool], device=self.cell.device)
        if m["fuse_spectral"]:
            model.cfg = dataclasses.replace(model.cfg, fuse_spectral=True)
        return model

    def unit(self, i: int, spans: dict = None) -> dict:
        dev = self.cell.device
        if spans is not None:
            _sync(dev)
            t0 = time.perf_counter()
        model = self.model(i)
        if spans is not None:
            _sync(dev)
            t1 = time.perf_counter()
        logliks = model.estim_param_a_posteriori()
        if spans is not None:
            t2 = time.perf_counter()
        paths = model.separate_spat_comps(self.out_dir)
        if spans is not None:
            t3 = time.perf_counter()
            spans["init_s"].append(t1 - t0)
            spans["gem_s"].append(t2 - t1)
            spans["separate_s"].append(t3 - t2)
        return {"clip": i % self.pool, "paths": paths,
                "logliks": np.asarray(logliks)[None], **_state(model.params)}

    def health(self, out: dict):
        return out["logliks"], len(out["paths"])

    def bad(self, h) -> bool:
        return not np.all(np.isfinite(h[0])) or h[1] != self.J

    def gem_inputs(self, kept: dict):
        model = self.model(kept["clip"])
        return model.params, model.Xs, model.cfg

    def release(self):
        pass

    def keep(self, out: dict) -> dict:
        """Move a unit's WAVs out of the reused directory, for the check
        after the window."""
        kept = []
        for p in out["paths"]:
            q = os.path.join(self.keep_dir, os.path.basename(p))
            os.replace(p, q)
            kept.append(q)
        return {**out, "paths": kept}

    def read_back(self, kept: dict) -> dict:
        words = [wav.read(p)[0] for p in kept["paths"]]
        return {**kept, "pcm": np.stack(words).astype(np.float64)}

    def reference(self, kept: dict, dtype=torch.float64, tf32=False,
                  low=None) -> dict:
        """As Batch.reference, on the kept clip's WAV and the host API's
        initial draw worked out again; the PCM16 words from the model's
        final state."""
        data, _ = wav.read(self.paths[kept["clip"]])
        A, FB, TW = prng.host_init(self.seeds[kept["clip"]], self.F,
                                   self.N, self.J, self.K)
        data, A, FB, TW = reference.as_tensors((data, A, FB, TW), dtype,
                                               self.cell.device)
        out = reference.host_fit(data, A, FB, TW, self.cell.model,
                                 _starts(kept, dtype, data.device), tf32,
                                 low)
        out["pcm"] = reference.host_separate(
            data, *(kept[n].to(dtype) for n in ("A", "FB", "TW")),
            self.cell.model, low)
        return out

    def profile_step(self):
        """GEM iterations PROFILE_ITERS of clip 0's model, as the host API
        runs a chunk of them (run_gem on its parameters and plane)."""
        gem_m = _mod("ops.gem")
        model = self.model(0)
        a, b = PROFILE_ITERS
        logliks = torch.zeros((1, model.cfg.niter), dtype=torch.float32,
                              device=self.cell.device)

        def step():
            gem_m.run_gem(model.params, model.Xs, model.cfg, start_iter=a,
                          end_iter=b, logliks=logliks)
        return step, b - a

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


ENTRIES = {"batch": Batch, "host_api": HostAPI}
