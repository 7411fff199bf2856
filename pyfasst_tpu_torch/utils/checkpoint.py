"""Checkpoint / resume for GEM runs.

Port of pyfasst_tpu/utils/checkpoint.py, in the same .npz layout, so a
checkpoint written by either package loads in the other: one array per
leaf (``spat_{j}_A``, ``spec_{k}_{FACTOR}``, ``xtr_{name}`` for extra
arrays) and the JSON ``__meta__`` (iteration, structure, extra metadata).
EM restarts exactly: resume = load the parameters and continue the loop
from the saved iteration (the annealing schedule is a pure function of the
iteration index).

A single-clip checkpoint holds each leaf without the clip axis, as the
JAX host API writes it; a stacked one (``stacked=True``, a batch bucket)
keeps the leading clip axis, as the JAX batch path writes it.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from pyfasst_tpu_torch.models.components import (
    INST, FasstParams, SpatialComp, SpectralComp, complex_dtype,
)
from pyfasst_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_FACTORS = ("FB", "FW", "TW", "TB", "trans", "FB2", "TW2")


def save_params(path: str, params: FasstParams, iteration: int = 0,
                extra: Optional[dict] = None,
                extra_arrays: Optional[dict] = None,
                stacked: bool = False) -> str:
    """Serialize params (and their structure) to one .npz, atomically (a
    temporary file, then os.replace).

    stacked=False writes one clip (params.batch must be 1) without the clip
    axis; stacked=True keeps it. extra: JSON-serializable metadata.
    extra_arrays: named arrays stored alongside (e.g. logliks); load_params
    returns them merged into the extra dict.
    """
    if not stacked and params.batch != 1:
        raise ValueError(f"a single-clip checkpoint needs B = 1, got "
                         f"B = {params.batch} (pass stacked=True)")

    def host(t):
        a = t.detach().cpu().numpy()
        return a if stacked else a[0]

    arrays = {f"xtr_{k}": np.asarray(v)
              for k, v in (extra_arrays or {}).items()}
    meta = {"iteration": int(iteration), "n_spat": params.n_spat,
            "n_spec": len(params.spec), "spat": [], "spec": [],
            "extra": extra or {},
            "extra_array_names": sorted((extra_arrays or {}).keys())}
    for j, c in enumerate(params.spat):
        arrays[f"spat_{j}_A"] = host(c.A)
        meta["spat"].append({"mix_type": c.mix_type, "free": bool(c.free)})
    for k, c in enumerate(params.spec):
        present = []
        for name in _FACTORS:
            val = getattr(c, name, None)
            if val is not None:
                arrays[f"spec_{k}_{name}"] = host(val)
                present.append(name)
        meta["spec"].append({
            "spat_ind": c.spat_ind, "free": list(c.free),
            "free2": list(c.free2), "constraint": c.constraint,
            "decode": c.decode, "present": present,
        })
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    return path


def load_params(path: str, device=DEFAULT_DEVICE,
                dtype: Optional[torch.dtype] = None
                ) -> Tuple[FasstParams, int, dict]:
    """(params, iteration, extra) from a checkpoint of either package.

    The leaves go to `device` (the card unless the caller asks for "cpu";
    "cuda" without a card raises), with a clip axis: B = 1 for a single-clip
    checkpoint (told apart from a stacked one by the rank of the mixing
    arrays), the stacked B otherwise. dtype None keeps each leaf's dtype
    (real stays real, complex stays complex); a real dtype converts real
    leaves to it and complex ones to the complex dtype of that precision.
    """
    device = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {k: np.array(data[k]) for k in data.files
                  if k != "__meta__"}
    first = meta["spat"][0]
    single = arrays["spat_0_A"].ndim == (2 if first["mix_type"] == INST
                                         else 3)

    def up(a):
        t = torch.as_tensor(a[None] if single else a)
        if dtype is not None:
            t = t.to(complex_dtype(dtype) if t.is_complex() else dtype)
        return t.to(device)

    spat = tuple(SpatialComp(A=up(arrays[f"spat_{j}_A"]),
                             mix_type=m["mix_type"], free=m["free"])
                 for j, m in enumerate(meta["spat"]))
    spec = []
    for k, m in enumerate(meta["spec"]):
        kw = {name: up(arrays[f"spec_{k}_{name}"]) for name in m["present"]}
        spec.append(SpectralComp(spat_ind=m["spat_ind"],
                                 free=tuple(m["free"]),
                                 free2=tuple(m.get("free2", (False, True))),
                                 constraint=m["constraint"],
                                 decode=m.get("decode", "soft"), **kw))
    extra = meta.get("extra", {})
    for name in meta.get("extra_array_names", []):
        extra[name] = arrays[f"xtr_{name}"]
    return (FasstParams(spat=spat, spec=tuple(spec)), meta["iteration"],
            extra)
