"""State converter: numpy dictionaries <-> the port's rig and state.

ESVO has no learned weights; its "parameters" are the calibrated stereo
rig and the mapping state. These converters move both in and out as
plain numpy arrays, so the port can start from a rig or a state built
anywhere else (the tests build them with the JAX package and hand them
over with ``np.asarray``).

Rig dictionary::

    {"left":  {"K", "D", "R", "P", "lut", "inv_map", "mask"},
     "right": {... the same ...},
     "T_right_left": (4, 4), "baseline": scalar,
     "width": int, "height": int, "model": str}

State dictionary (every key optional)::

    {"ts_left" / "ts_right": {"last_t_pos", "last_t_neg"},
     "history": {DepthEstimates field: array},
     "grid":    {DepthGrid field: array}}
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from esvo_tpu_torch._device import resolve_device
from esvo_tpu_torch.geometry.camera import Camera, PinholeParams, StereoRig
from esvo_tpu_torch.mapping.depth_refinement import DepthEstimates
from esvo_tpu_torch.mapping.fusion import DepthGrid
from esvo_tpu_torch.surface.time_surface import TimeSurfaceState

_INT_FIELDS = ("age",)
_BOOL_FIELDS = ("valid", "mask")


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(name: str, a, dtype, dev) -> torch.Tensor:
    a = np.asarray(a)
    if name in _BOOL_FIELDS:
        return torch.as_tensor(a.astype(bool), device=dev)
    if name in _INT_FIELDS:
        return torch.as_tensor(a.astype(np.int32), device=dev)
    return torch.tensor(a, device=dev).to(dtype)


def rig_to_numpy(rig) -> dict:
    """Rig dictionary from any rig object with the esvo field names (a
    rig of this package or of the JAX package)."""
    def cam(c):
        d = {k: _numpy(getattr(c.params, k)) for k in ("K", "D", "R", "P")}
        d.update({k: _numpy(getattr(c, k))
                  for k in ("lut", "inv_map", "mask")})
        return d

    p = rig.left.params
    return {"left": cam(rig.left), "right": cam(rig.right),
            "T_right_left": _numpy(rig.T_right_left),
            "baseline": _numpy(rig.baseline), "width": int(p.width),
            "height": int(p.height), "model": str(p.model)}


def rig_from_numpy(d: dict, dtype=torch.float32, device=None) -> StereoRig:
    """StereoRig from a rig dictionary."""
    dev = resolve_device(device)

    def cam(c) -> Camera:
        params = PinholeParams(
            **{k: _tensor(k, c[k], dtype, dev) for k in ("K", "D", "R", "P")},
            width=int(d["width"]), height=int(d["height"]),
            model=str(d["model"]))
        return Camera(params=params,
                      **{k: _tensor(k, c[k], dtype, dev)
                         for k in ("lut", "inv_map", "mask")})

    return StereoRig(left=cam(d["left"]), right=cam(d["right"]),
                     T_right_left=_tensor("T", d["T_right_left"], dtype, dev),
                     baseline=_tensor("b", d["baseline"], dtype, dev))


def fields_to_numpy(obj) -> dict:
    """{field: array} of a dataclass of arrays (TimeSurfaceState,
    DepthEstimates, DepthGrid of either package)."""
    return {f.name: _numpy(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def state_from_numpy(d: dict, dtype=torch.float32, device=None) -> dict:
    """The port's state objects from a state dictionary: returns a dict
    with the same keys holding TimeSurfaceState / DepthEstimates /
    DepthGrid."""
    dev = resolve_device(device)
    kinds = {"ts_left": TimeSurfaceState, "ts_right": TimeSurfaceState,
             "history": DepthEstimates, "grid": DepthGrid}
    out = {}
    for key, fields in d.items():
        cls = kinds[key]
        names = [f.name for f in dataclasses.fields(cls)]
        missing = set(names) - set(fields)
        if missing:
            raise KeyError(f"{key}: missing fields {sorted(missing)}")
        out[key] = cls(**{n: _tensor(n, fields[n], dtype, dev)
                          for n in names})
    return out
