"""A run with the timed path broken underneath comes out as not correct,
once for each fault a cell can have: a GEM step that returns its state
unchanged, from the start or from the first spatial update on; half of
the batch left out, the rest's mean put in its place; an answer altered
where it is produced. (No cell spans chips, so none has an exchange to
leave out.) Each run skips the harness's look for a card and drives the
rest of a run on the CPU at a small size, against the cell's own limits;
the same run unbroken comes out correct."""
from __future__ import annotations

import importlib

import pytest
import torch

from conftest import CELLS, HOST, ROOT, host_checkout, tiny
from run import run

gem_m = importlib.import_module("pyfasst_tpu_torch.ops.gem")
wiener_m = importlib.import_module("pyfasst_tpu_torch.ops.wiener")
audio_m = importlib.import_module("pyfasst_tpu_torch.audio")
comps = importlib.import_module("pyfasst_tpu_torch.models.components")


def _run(cell, tmp_path, seed=11):
    root = host_checkout(tmp_path) if cell == HOST else ROOT
    model, mix = tiny(cell, root)
    return run(cell, seed, 0.5, False, device="cpu", root=root, model=model,
               traffic_mix=mix)


def _state_unchanged(monkeypatch):
    step = gem_m.gem_step

    def unchanged(params, *a, **kw):
        return params, step(params, *a, **kw)[1]
    monkeypatch.setattr(gem_m, "gem_step", unchanged)


def _state_unchanged_past_hold(monkeypatch):
    """From the first spatial update on (the spatial hold's end), a GEM
    step returns its state."""
    step = gem_m.gem_step

    def unchanged(params, *a, spatial_enabled=True, **kw):
        new, ll = step(params, *a, spatial_enabled=spatial_enabled, **kw)
        return (params if spatial_enabled else new), ll
    monkeypatch.setattr(gem_m, "gem_step", unchanged)


def _half_batch(monkeypatch):
    """run_gem fits the first half of the clips; the others get that
    half's mean parameters and log-likelihoods."""
    fit = gem_m.run_gem

    def half(params, X, cfg, *a, **kw):
        h = max(1, X.shape[0] // 2)

        def cut(t):
            return t[:h]

        def fill(t):
            return torch.cat([t, t.mean(0, keepdim=True).expand(
                (X.shape[0] - h,) + t.shape[1:])])
        sub = comps.FasstParams(
            spat=tuple(c.replace(A=cut(c.A)) for c in params.spat),
            spec=tuple(c.replace(FB=cut(c.FB), TW=cut(c.TW))
                       for c in params.spec))
        p, ll = fit(sub, X[:h], cfg, *a, **kw)
        return comps.FasstParams(
            spat=tuple(c.replace(A=fill(c.A)) for c in p.spat),
            spec=tuple(c.replace(FB=fill(c.FB), TW=fill(c.TW))
                       for c in p.spec)), fill(ll)
    monkeypatch.setattr(gem_m, "run_gem", half)


def _image_altered(monkeypatch):
    """One source image of the first clip 1% louder, where the Wiener
    filter makes it."""
    sep = wiener_m.separate_sources

    def altered(*a, **kw):
        Y = sep(*a, **kw).clone()
        Y[0, 0] *= 1.01
        return Y
    monkeypatch.setattr(wiener_m, "separate_sources", altered)


def _wav_altered(monkeypatch):
    """The host API's WAV words 1% louder, where the file is written."""
    write = audio_m.wav_write

    def altered(path, data, *a, **kw):
        return write(path, data * 0.99, *a, **kw)
    monkeypatch.setattr(audio_m, "wav_write", altered)


FAULTS = [(cell, fault) for cell in CELLS + (HOST,)
          for fault in ((_state_unchanged, _state_unchanged_past_hold,
                         _image_altered, _half_batch)
                        if cell != HOST else (_state_unchanged,
                                              _state_unchanged_past_hold,
                                              _wav_altered))]


@pytest.mark.parametrize("cell", CELLS + (HOST,))
def test_sound_run_is_correct(cell, tmp_path):
    res = _run(cell, tmp_path)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    res = _run(cell, tmp_path)
    assert not res["correct"], res["checks"]
