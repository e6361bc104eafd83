"""Checkpoint / resume for TCI optimization state.

Counterpart of ``tci_tpu/utils/checkpoint.py``, in its file format exactly:
a TCI2's index sets, site tensors and error bookkeeping go to one ``.npz``
written with ``np.savez_compressed`` under the same keys and numpy dtypes
(``localdims`` int64; ``bonderrors``, ``pivoterrors`` and
``maxsamplevalue`` float64; ``dtype`` numpy's dtype name; ``meta`` the JSON
of ``{"Iset": ..., "Jset": ...}``; ``sitetensor_<b>``), and read with
``allow_pickle=False``. A file written by either package loads in the
other. ``optimize`` on a restored object resumes sweeping on any tier (the
reference supports re-optimizing an existing TCI: test/test_conversion.jl:67,
the constructor from Iset/Jset src/tensorci2.jl:123-137).

The site tensors come to the host in one fetch for all of them
(``FETCHES["checkpoint"]``); a load puts them on its `device`.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..models.tensorci2 import TensorCI2
from ..models.tensortrain import TensorTrain
from .device import fetch, numpy_dtype, resolve_device, to_device


def _host_tensors(tensors) -> list:
    """Each tensor as a numpy array, in one device-to-host fetch for all of
    them (tensors on several devices or on the CPU take one each)."""
    tensors = list(tensors)
    if not tensors:
        return []
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type == "cpu" or any(t.device != dev or t.dtype != dtype
                                for t in tensors):
        return [t.detach().cpu().numpy() for t in tensors]
    flat = fetch(torch.cat([t.detach().reshape(-1) for t in tensors]),
                 "checkpoint")
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(tuple(t.shape)).copy())
        at += n
    return out


def _json_sets(sets) -> list:
    """Index sets as lists of lists of Python ints (a numpy integer that a
    fetch left in a tuple is not JSON)."""
    return [[[int(v) for v in i] for i in s] for s in sets]


def save_tci2(path: str, tci: TensorCI2) -> None:
    """Serialize a TensorCI2 to `path` (.npz) in ``tci_tpu``'s format.

    The Iset/Jset histories (non-strict nesting) are not saved, as
    ``tci_tpu`` does not save them: a restored TCI starts with none, so its
    first sweep nests against its own sets only."""
    payload = {
        "localdims": np.asarray(tci.localdims, dtype=np.int64),
        "bonderrors": np.asarray(tci.bonderrors, dtype=np.float64),
        "pivoterrors": np.asarray(tci.pivoterrors, dtype=np.float64),
        # the resolved value: the largest sample may still lie on the device
        "maxsamplevalue": np.float64(tci.maxsamplevalue),
        "dtype": np.str_(numpy_dtype(tci.dtype).name),
        "meta": np.str_(json.dumps({"Iset": _json_sets(tci.Iset),
                                    "Jset": _json_sets(tci.Jset)})),
    }
    for b, t in enumerate(_host_tensors(tci.sitetensors())):
        payload[f"sitetensor_{b}"] = t
    np.savez_compressed(path, **payload)


def load_tci2(path: str, device=None) -> TensorCI2:
    """Restore a TensorCI2 saved with save_tci2 (by either package) on
    `device`: the current CUDA device by default; without one it raises
    unless ``device="cpu"`` is given."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        localdims = [int(d) for d in data["localdims"]]
        dtype = np.dtype(str(data["dtype"]))
        tci = TensorCI2(localdims, dtype=dtype, device=device)
        meta = json.loads(str(data["meta"]))
        tci.Iset = [[tuple(i) for i in s] for s in meta["Iset"]]
        tci.Jset = [[tuple(j) for j in s] for s in meta["Jset"]]
        tci.bonderrors = np.asarray(data["bonderrors"])
        tci.pivoterrors = [float(e) for e in data["pivoterrors"]]
        tci.maxsamplevalue = float(data["maxsamplevalue"])
        for b in range(len(localdims)):
            tci._sitetensors[b] = to_device(
                np.asarray(data[f"sitetensor_{b}"]), tci.device)
    return tci


def save_tensortrain(path: str, tt: TensorTrain) -> None:
    """Serialize a tensor train's cores to `path` (.npz) as ``core_<i>``."""
    np.savez_compressed(path, **{
        f"core_{i}": t for i, t in enumerate(_host_tensors(tt.sitetensors()))})


def load_tensortrain(path: str, device=None) -> TensorTrain:
    """Restore a tensor train saved with save_tensortrain on `device` (the
    device rule of ``load_tci2``)."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        n = len(data.files)
        return TensorTrain([np.asarray(data[f"core_{i}"]) for i in range(n)],
                           device=device)
