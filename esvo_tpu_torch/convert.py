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

An ``EsvoSystem``'s whole state moves as the checkpoint's two parts
(``system_state_to_numpy`` / ``system_state_from_numpy``): flat arrays
("ts_l/<field>", "ts_r/<field>", "grid/<field>", "hist/<field>",
"pose/times", "pose/list", "traj/times", "traj/poses", "T_world_frame",
"T_world_cur", "gmap/keys", "gmap/pts", "torch_rng_state") and a JSON
meta dict (status, hist_slot, frames_filled, last_tick_time,
last_mapping_time, events_since_last_obs, stats, and an MVStereoSystem's
mapping method as "mvstereo_mode"). The JAX package's checkpoint has the
same layout, with its ``jax.random`` key under "rng_key" in place of
"torch_rng_state" and no "mvstereo_mode".
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


_STATE_GROUPS = (("ts_l", "ts_left"), ("ts_r", "ts_right"),
                 ("grid", "grid"), ("hist", "history"))


def system_state_to_numpy(system) -> tuple[dict, dict]:
    """(arrays, meta) of an EsvoSystem's state (module docstring)."""
    objs = {"ts_left": system.ts_state_left, "ts_right": system.ts_state_right,
            "grid": system.grid, "history": system.history}
    arrays = {f"{prefix}/{name}": a
              for prefix, key in _STATE_GROUPS
              for name, a in fields_to_numpy(objs[key]).items()}
    arrays.update({
        "pose/times": np.asarray(system.pose_times),
        "pose/list": np.asarray(system.pose_list),
        "traj/times": np.asarray(system.traj_times),
        "traj/poses": (np.asarray(system.traj_poses) if system.traj_poses
                       else np.zeros((0, 4, 4))),
        "T_world_frame": np.asarray(system.T_world_frame),
        "T_world_cur": np.asarray(system.T_world_cur),
        "gmap/keys": np.fromiter(system._global_voxels.keys(), np.int64),
        "gmap/pts": (np.stack(list(system._global_voxels.values()))
                     if system._global_voxels else np.zeros((0, 3))),
        "torch_rng_state": system._gen.get_state().numpy()})
    meta = {"status": system.status.value,
            "hist_slot": system.cycle.hist_slot,
            "frames_filled": system._frames_filled,
            "last_tick_time": system.last_tick_time,
            "last_mapping_time": system.last_mapping_time,
            "events_since_last_obs": system.events_since_last_obs,
            "stats": system.stats}
    if hasattr(system, "mode"):           # an MVStereoSystem's method
        meta["mvstereo_mode"] = int(system.mode)
    return arrays, meta


def system_state_from_numpy(system, arrays, meta: dict):
    """Restore an EsvoSystem's state in place from (arrays, meta), as
    written by this package's or the JAX package's checkpoint (the JAX
    "rng_key" is ignored: the tracker's generator keeps its own state
    unless "torch_rng_state" is given). A WORKING system then rebuilds
    its depth frame and the tracker's map from the restored window.
    Returns the system."""
    from esvo_tpu_torch.runtime.system import SystemStatus

    groups = {key: {name.split("/", 1)[1]: arrays[name] for name in arrays
                    if name.startswith(prefix + "/")}
              for prefix, key in _STATE_GROUPS}
    state = state_from_numpy(groups, system.dtype, system.device)
    system.ts_state_left, system.ts_state_right = (state["ts_left"],
                                                   state["ts_right"])
    system.grid, system.history = state["grid"], state["history"]
    system.pose_times = list(np.asarray(arrays["pose/times"]))
    system.pose_list = list(np.asarray(arrays["pose/list"]))
    system.traj_times = list(np.asarray(arrays["traj/times"]))
    system.traj_poses = list(np.asarray(arrays["traj/poses"]))
    system.T_world_frame = np.asarray(arrays["T_world_frame"])
    system.T_world_cur = np.asarray(arrays["T_world_cur"])
    system.status = SystemStatus(meta["status"])
    system.cycle.hist_slot = int(meta["hist_slot"])
    system._frames_filled = int(meta["frames_filled"])
    system.last_tick_time = meta["last_tick_time"]
    system.last_mapping_time = meta.get("last_mapping_time")
    system.events_since_last_obs = int(meta.get("events_since_last_obs", 0))
    system.stats = dict(meta["stats"])
    if "mvstereo_mode" in meta and hasattr(system, "mode"):
        system.mode = type(system.mode)(meta["mvstereo_mode"])
    if "gmap/keys" in arrays:
        system._global_voxels = dict(zip(
            np.asarray(arrays["gmap/keys"]).tolist(),
            np.asarray(arrays["gmap/pts"])))
    if "torch_rng_state" in arrays:
        system._gen.set_state(torch.from_numpy(
            np.asarray(arrays["torch_rng_state"], np.uint8).copy()))
    system._pending_mapping = None
    system._ref_maps = []
    if system.status == SystemStatus.WORKING:
        system.grid, system._map_pts, system._map_ok, _, _ = \
            system.cycle.rebuild_frame(
                system.history,
                torch.as_tensor(system.T_world_frame, dtype=system.dtype,
                                device=system.device))
        system._push_ref_map(system._map_pts, system._map_ok,
                             int(torch.sum(system._map_ok)))
    return system
