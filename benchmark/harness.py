"""What every drive path shares: the manifest and the data files a cell
names, the program's public entry points, the traffic, timing on the
card and the result line.

A cell (an entry of BENCHMARK.json's ``workloads``) names a
configuration and a traffic mix. The harness finds everything by name:

- ``configs[].file``: the configuration (preset values, rig, scene);
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, among them
  ``driver``, the drive path;
- ``benchmark/workloads/<cell>.json``: the cell's check (samples and the
  limit of every number it compares);
- ``benchmark/drivers/<driver>.py``: the drive path, a ``run(ctx)``;
- ``benchmark/metrics/<metric>.py``: one reader per per-layer metric, a
  ``read(trace)`` that returns a number or None.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# the benchmark's own modules first, then the checkout (the program)
sys.path[:0] = [p for p in (str(ROOT), str(REPO)) if p not in sys.path]

import scene as scene_mod  # noqa: E402

# top-level module names that no run may load (compared whole: the
# port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "esvo_tpu")


def process_start() -> float:
    """perf_counter() at this process's start (Linux: /proc), so set-up
    counts the interpreter's start and the imports too."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = float(stat[stat.rindex(")") + 2:].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_manifest(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    workload: dict
    chips: int
    per_layer: list        # the manifest's per_layer entries of this cell
    end_to_end: list       # the manifest's end_to_end entries of this cell


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None,
              repo: Path = REPO) -> Cell:
    """A cell and its files, found by the names in the manifest (of the
    checkout at `repo`)."""
    man = manifest or load_manifest(repo / "BENCHMARK.json")
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    root = repo / ROOT.name
    with open(repo / conf["file"]) as f:
        config = json.load(f)
    with open(root / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(root / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name=name, config=config, traffic=traffic, workload=workload,
                chips=entry["chips"], per_layer=layer, end_to_end=e2e)


def readers(cell: Cell) -> dict:
    """name -> read(trace) of each per-layer metric of the cell."""
    return {m["name"]: load_module(ROOT / "metrics" / f"{m['name']}.py",
                                   f"metric_{m['name'].replace('.', '_')}"
                                   ).read
            for m in cell.per_layer}


def program():
    """The program's public entry points (imported on first use)."""
    from esvo_tpu_torch.geometry import camera
    from esvo_tpu_torch.runtime.config import SystemConfig
    from esvo_tpu_torch.runtime.resident import ResidentLoop
    from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
    return SimpleNamespace(camera=camera, SystemConfig=SystemConfig,
                           EsvoSystem=EsvoSystem, ResidentLoop=ResidentLoop,
                           WORKING=SystemStatus.WORKING)


# What the drivers read or wrap of the program beyond its public entry
# points (PERF.md lists them, with what each feeds): a later change to one
# changes the yardstick, so a run whose program lacks one stops, naming
# it, before its window.
SYSTEM_INTERNALS = (
    "cfg.mapping.mapping_rate_hz", "status", "process_ticks",
    "draw_ref_scores", "select_ref_points",
    "ts_state_left", "ts_state_right", "history", "grid", "cycle.hist_slot",
    "cycle.render_pair", "T_world_frame", "T_world_cur", "pose_times",
    "pose_list", "pose_table_size", "_consec_rejects", "last_mapping_time")
LOOP_INTERNALS = (
    "R", "state.ts_left", "state.ts_right", "state.history",
    "state.hist_slot", "state.grid", "state.ref_ok", "state.map",
    "inputs.scores", "inputs.t_syncs", "stage", "step")


def _has(obj, dotted: str) -> bool:
    for name in dotted.split("."):
        if not hasattr(obj, name):
            return False
        obj = getattr(obj, name)
    return True


def require_internals(system, loop=None) -> None:
    """Raise, naming them, when the program lacks internals the drivers
    read (after set-up, when each exists)."""
    missing = [f"EsvoSystem.{n}" for n in SYSTEM_INTERNALS
               if not _has(system, n)]
    if loop is not None:
        missing += [f"ResidentLoop.{n}" for n in LOOP_INTERNALS
                    if not _has(loop, n)]
    if missing:
        raise AttributeError(
            f"the program has no {', '.join(missing)}, which the "
            "benchmark's drivers read (PERF.md, section 3): the yardstick "
            "has to change with it")


def reference():
    """The plain reference (frozen copies under benchmark/plainref)."""
    from plainref.geometry import camera
    from plainref.runtime import step
    from plainref.runtime.config import SystemConfig
    return SimpleNamespace(camera=camera, step=step,
                           SystemConfig=SystemConfig)


def reference_cycle(params: dict, cell: Cell, dev):
    """The reference and its step functions on the cell's rig (its own
    maps, in float32 on `dev`, as the program builds them)."""
    ref = reference()
    rig = scene_mod.build_rig(params, ref.camera, torch.float32, dev)
    return ref, ref.step.Cycle(rig, ref.SystemConfig.from_dict(
        cell.config["system"]))


def make_stream(cell: Cell, seed: int):
    """The cell's traffic from the seed: the rig's inverse maps from the
    reference's camera model in float64 on the host, then one period of
    framed events (scene.make_stream)."""
    params = scene_mod.rig_params(cell.config["rig"])
    ref = reference()
    rig = scene_mod.build_rig(params, ref.camera, torch.float64, "cpu")
    inv = [c.inv_map.numpy() for c in (rig.left, rig.right)]
    masks = [c.mask.numpy() for c in (rig.left, rig.right)]
    stream = scene_mod.make_stream(cell.config, cell.traffic, seed, inv,
                                   masks)
    return params, stream


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float
    log: list = dataclasses.field(default_factory=list)
    trace_data: dict | None = None     # what a traced run measured

    def note(self, **kw) -> None:
        """A line for standard error before the result (counts, event
        rates, set-up parts)."""
        self.log.append(kw)


def settle() -> None:
    """Before the window: collect, and move what set-up allocated out of
    the collector's reach, so a collection inside the window walks only
    what the window allocates."""
    gc.collect()
    gc.freeze()


def sync(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def sample_times(seed: int, n: int, seconds: float) -> np.ndarray:
    """n moments of the window, drawn from the seed: the first step that
    starts after each is checked."""
    rng = np.random.default_rng([seed, 7])
    return np.sort(rng.uniform(0.05, 0.95, n)) * seconds


def nvidia_power_limit() -> str | None:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return dict(platform="cpu", kind="cpu", count=chips,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
