"""Carry FASST parameters across as numpy arrays.

A parameter tree is a plain nested dict of one clip's parameters, without
the clip axis, in the JAX package's shapes:

    {"spat": [{"A": ndarray, "mix_type": "inst", "free": True}, ...],
     "spec": [{"FB": ndarray, "TW": ndarray, "FW": None, "TB": None,
               "trans": None, "FB2": None, "TW2": None,
               "spat_ind": 0, "free": (True, False, True, False),
               "free2": (False, True), "constraint": "NMF",
               "decode": "soft"}, ...]}

Missing entries take the SpectralComp defaults.

Any object with the same attributes (for instance a JAX FasstParams after
``jax.tree.map(np.asarray, params)``) is read the same way, so the tests can
hand both packages the same numbers. A list of trees with the same structure
is stacked on the clip axis B.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from pyfasst_tpu_torch.models.components import (
    FasstParams, SpatialComp, SpectralComp, complex_dtype,
)

_SPAT_ARRAYS = ("A",)
_SPAT_STATIC = ("mix_type", "free")
_SPEC_ARRAYS = ("FB", "TW", "FW", "TB", "trans", "FB2", "TW2")
_SPEC_STATIC = ("spat_ind", "free", "free2", "constraint", "decode")


def _get(obj, name, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def as_tree(params) -> dict:
    """One clip's parameters (a dict or an object with the same attributes)
    as a plain nested dict of numpy arrays and static fields."""
    def comp(c, arrays, static):
        out = {}
        for n in arrays:
            a = _get(c, n)
            out[n] = None if a is None else np.asarray(a)
        for n in static:
            val = _get(c, n)
            if val is not None:
                out[n] = tuple(val) if isinstance(val, (list, tuple)) else val
        return out
    return {"spat": [comp(c, _SPAT_ARRAYS, _SPAT_STATIC)
                     for c in _get(params, "spat")],
            "spec": [comp(c, _SPEC_ARRAYS, _SPEC_STATIC)
                     for c in _get(params, "spec")]}


def _stack(arrays, device, dtype):
    if arrays[0] is None:
        if any(a is not None for a in arrays):
            raise ValueError("clips disagree on which factors are present")
        return None
    a = np.stack(arrays)
    dt = complex_dtype(dtype) if np.iscomplexobj(a) else dtype
    return torch.as_tensor(a, dtype=dt, device=device)


def params_from_numpy(tree: Union[dict, object, Sequence], device="cpu",
                      dtype=torch.float32) -> FasstParams:
    """FasstParams from one tree (B = 1) or a list of trees (stacked on B).

    Real arrays become `dtype`, complex ones the complex dtype of the same
    precision. The static fields come from the first tree.
    """
    trees = ([as_tree(t) for t in tree] if isinstance(tree, (list, tuple))
             else [as_tree(tree)])
    first = trees[0]
    spat = []
    for i, c in enumerate(first["spat"]):
        arrays = {n: _stack([t["spat"][i][n] for t in trees], device, dtype)
                  for n in _SPAT_ARRAYS}
        static = {n: c[n] for n in _SPAT_STATIC if n in c}
        spat.append(SpatialComp(**arrays, **static))
    spec = []
    for i, c in enumerate(first["spec"]):
        arrays = {n: _stack([t["spec"][i][n] for t in trees], device, dtype)
                  for n in _SPEC_ARRAYS}
        static = {n: c[n] for n in _SPEC_STATIC if n in c}
        spec.append(SpectralComp(**arrays, **static))
    return FasstParams(spat=tuple(spat), spec=tuple(spec))


def params_to_numpy(params: FasstParams) -> List[dict]:
    """The inverse of params_from_numpy: one tree per clip."""
    def arr(t, b):
        return None if t is None else t[b].detach().cpu().numpy()

    out = []
    for b in range(params.batch):
        spat = [{"A": arr(c.A, b), "mix_type": c.mix_type, "free": c.free}
                for c in params.spat]
        spec = [{**{n: arr(getattr(c, n), b) for n in _SPEC_ARRAYS},
                 **{n: getattr(c, n) for n in _SPEC_STATIC}}
                for c in params.spec]
        out.append({"spat": spat, "spec": spec})
    return out
