"""The comparison that decides `correct`: what the timed path produced for
one unit drawn from the seed, against the plain reference
(harness/reference.py) in float64 on the same inputs, number by number.
The numbers that benchmark/limits/<cell>.json gives a limit decide; the
others are read for PERF.md.

    loglik_hold  the GEM's log-likelihood trajectory over the spatial
                 hold (its first iterations, the mixing held): the largest
                 gap over the reference's largest |loglik|, the worst clip
    loglik       the same over the whole fit
    psd          the final source powers FB TW against the reference's,
                 which follows the whole fit from the same inputs:
                 ||v - v_ref|| / ||v_ref||, the worst source and clip
    mixing       the same for the final mixing A
    step_loglik  the iterations of entries.step_iters (the first spatial
    step_mixing  update, the middle and the last), each from the program's
    step_psd     own state before it: its log-likelihood (the gap over the
                 reference's largest |loglik|, as loglik), mixing and
                 source powers after it, against one reference iteration
                 from that state; the worst step, source and clip
    images       the batch path's output, each source image in the time
                 domain: ||y - y_ref|| / ||y_ref||, the worst source and
                 clip, y_ref the reference's Wiener images and inverse STFT
                 from the program's own final parameters
    wav          the host API's WAV files as written, read back: the rms
                 gap in PCM16 steps to the words the reference makes from
                 the model's own final parameters, the worst source
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


NUMBERS = ("loglik_hold", "loglik", "psd", "mixing", "step_loglik",
           "step_mixing", "step_psd", "images", "wav")


def _rel(a, b, dims):
    return torch.linalg.vector_norm(a - b, dim=dims) \
        / torch.linalg.vector_norm(b, dim=dims)


def _as(prog, name, like):
    return torch.as_tensor(prog[name]).to(device=like.device,
                                           dtype=like.dtype)


def _loglik_gap(prog, ref):
    ll_ref = ref["logliks"]
    n = ll_ref.shape[-1]
    ll = _as(prog, "logliks", ll_ref)[..., :n]
    return (ll - ll_ref).abs() / ll_ref.abs().amax(-1, keepdim=True)


def _psd(state, like):
    return _as(state, "FB", like) @ _as(state, "TW", like)


def numbers(prog: dict, ref: dict, hold: int) -> dict:
    """The numbers of one unit. prog holds the program's "logliks" (B,
    niter), its final "A", "FB", "TW", its "steps" (entries.with_steps) and
    "ys" (B, J, T, 2) or "pcm" (J, T, 2); ref the reference's, as
    reference.fit returns them, with its "ys" or "pcm" from the program's
    final state."""
    gap = _loglik_gap(prog, ref)
    v_ref = ref["FB"] @ ref["TW"]
    out = {"loglik_hold": float(gap[:, :hold].max()),
           "loglik": float(gap.max()),
           "psd": float(_rel(_psd(prog, v_ref), v_ref, (-2, -1)).max()),
           "mixing": float(_rel(_as(prog, "A", ref["A"]), ref["A"],
                                -1).max())}
    if ref["steps"]:
        worst = {"step_loglik": 0.0, "step_mixing": 0.0, "step_psd": 0.0}
        scale = ref["logliks"].abs().amax(-1)
        for p, r in zip(prog["steps"], ref["steps"]):
            v = r["FB"] @ r["TW"]
            for name, val in (
                    ("step_loglik", (_as(p, "loglik", r["loglik"])
                                     - r["loglik"]).abs() / scale),
                    ("step_mixing", _rel(_as(p, "A", r["A"]), r["A"], -1)),
                    ("step_psd", _rel(_psd(p, v), v, (-2, -1)))):
                worst[name] = max(worst[name], float(val.max()))
        out.update(worst)
    if "ys" in prog:
        ys = ref["ys"]
        out["images"] = float(_rel(_as(prog, "ys", ys), ys, (-2, -1)).max())
    if "pcm" in prog:
        d = _as(prog, "pcm", ref["pcm"]) - ref["pcm"]
        out["wav"] = float(torch.sqrt(torch.mean(d * d, dim=(-2, -1)))
                           .max())
    return {k: v if np.isfinite(v) else float("inf") for k, v in out.items()}


def rerun_gap(kept: dict) -> float:
    """The largest gap, over the largest magnitude, between the kept unit's
    final state and that of its GEM run again for the steps (0 where the
    program repeats itself bit for bit)."""
    return max(float((kept["rerun"][n].double() - kept[n].double()).abs()
                     .max() / kept[n].double().abs().max())
               for n in ("A", "FB", "TW"))


def spans(prog: dict, ref: dict, ends=(50, 100, 200, 300, 400, 450, 490)
          ) -> dict:
    """The loglik gap over the first n iterations, for each n in ends the
    fit reaches: where along the fit a trajectory leaves the reference."""
    gap = _loglik_gap(prog, ref)
    return {f"loglik_{n}": float(gap[:, :n].max()) for n in ends
            if n < gap.shape[-1]}


def load_limits(root: Path, cell: str) -> dict:
    """benchmark/limits/<cell>.json: {"limits": {number: limit}, ...}"""
    with open(root / "benchmark" / "limits" / f"{cell}.json") as fh:
        return json.load(fh)


def judge(found: dict, limits: dict) -> tuple:
    """(every number at or under its limit, {name: {"value", "limit"}}),
    over the limits' names; a number the run did not produce fails."""
    table = {name: {"value": found.get(name, float("inf")), "limit": lim}
             for name, lim in limits.items()}
    ok = all(r["value"] <= r["limit"] for r in table.values())
    return ok, table
