"""Frozen copy of esvo_tpu_torch/runtime/config.py for the benchmark's plain
reference: the kernel dispatch is taken out, so every call runs the
plain twin; no precision guard inside (the caller sets the matmul
precision around a whole step). The original's text follows.

System configuration (port of esvo_tpu/runtime/config.py): one
dataclass tree with the JAX package's section names, field names,
defaults and loaders.

One rule keeps the LSnorm and the regularizer coherent with the depth
section (``_derive``): the constructor and ``with_overrides`` always
apply it, ``from_dict`` only to what the dict leaves out, and
``from_yaml`` after reading the reference-format files. PyYAML is
imported inside the loaders only.
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field

from plainref.mapping.block_matching import BlockMatchConfig
from plainref.mapping.depth_refinement import DepthProblemConfig
from plainref.mapping.fusion import FusionConfig
from plainref.mapping.initialization import SGMConfig
from plainref.mapping.regularization import RegularizationConfig
from plainref.surface.time_surface import TimeSurfaceConfig
from plainref.tracking.registration import RegProblemConfig


@dataclass(frozen=True)
class MappingConfig:
    """Node-level mapping knobs (cfg/mapping/mapping_rpg.yaml values)."""
    inv_depth_min_range: float = 0.2
    inv_depth_max_range: float = 2.0
    residual_vis_threshold: float = 20.0
    std_var_vis_threshold: float = 0.015
    age_max_range: int = 10
    age_vis_threshold: int = 1
    fusion_strategy: str = "CONST_POINTS"   # or "CONST_FRAMES"
    max_fusion_frames: int = 40
    max_fusion_points: int = 5000
    denoising: bool = True
    regularization: bool = True
    process_event_num: int = 1000
    init_sgm_num_threshold: int = 500
    mapping_rate_hz: float = 20.0
    bm_half_slice_thickness: float = 0.001


@dataclass(frozen=True)
class TrackingNodeConfig:
    """Node-level tracking knobs: the sync-tick rate, the REF_HISTORY
    length, and the velocity guard on accepted tracker poses (a solve
    implying faster motion is rejected; after max_consecutive_rejects
    rejections in a row the guard re-anchors to the incoming pose).
    constant_velocity_prior is read by the device-resident loop
    (runtime/resident.py) only: its tracker starts each tick from the
    last accepted step extrapolated once."""
    tracking_rate_hz: float = 100.0
    ref_history_length: int = 10
    max_speed_mps: float = 30.0
    max_ang_speed_rps: float = 10.0
    max_consecutive_rejects: int = 20
    constant_velocity_prior: bool = False


_SECTIONS = {
    "surface": TimeSurfaceConfig, "bm": BlockMatchConfig,
    "depth": DepthProblemConfig, "fusion": FusionConfig,
    "regularizer": RegularizationConfig, "sgm": SGMConfig,
    "tracker": RegProblemConfig, "mapping": MappingConfig,
    "tracking": TrackingNodeConfig,
}
# regularizer field <- depth field
_REG_FROM_DEPTH = {
    "ls_norm": "ls_norm", "radius": "regularization_radius",
    "min_neighbours": "regularization_min_neighbours",
    "min_close_neighbours": "regularization_min_close_neighbours",
}


def _derive(cfg: "SystemConfig", fusion_norm: bool = True,
            reg_keys=tuple(_REG_FROM_DEPTH)) -> None:
    """The one derivation rule: fusion.ls_norm (if fusion_norm) and the
    listed regularizer keys take their values from the depth section."""
    d = cfg.depth
    if fusion_norm:
        cfg.fusion = dataclasses.replace(cfg.fusion, ls_norm=d.ls_norm)
    cfg.regularizer = dataclasses.replace(
        cfg.regularizer,
        **{k: getattr(d, _REG_FROM_DEPTH[k]) for k in reg_keys})


@dataclass
class SystemConfig:
    surface: TimeSurfaceConfig = field(default_factory=TimeSurfaceConfig)
    bm: BlockMatchConfig = field(default_factory=BlockMatchConfig)
    depth: DepthProblemConfig = field(default_factory=DepthProblemConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    regularizer: RegularizationConfig = field(
        default_factory=RegularizationConfig)
    sgm: SGMConfig = field(default_factory=SGMConfig)
    tracker: RegProblemConfig = field(default_factory=RegProblemConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    tracking: TrackingNodeConfig = field(default_factory=TrackingNodeConfig)

    def __post_init__(self):
        _derive(self)

    @property
    def cost_vis_threshold(self) -> float:
        """pow(residual_vis_threshold, 2) * patch_area."""
        return self.mapping.residual_vis_threshold ** 2 \
            * self.depth.patch_area

    @property
    def history_frames(self) -> int:
        """Frames in the fusion window: ~1.5x maxNumFusionPoints for
        CONST_POINTS (at least 2), maxNumFusionFrames for CONST_FRAMES."""
        m = self.mapping
        if m.fusion_strategy == "CONST_POINTS":
            return max(int(math.ceil(1.5 * m.max_fusion_points
                                     / m.process_event_num)), 2)
        return m.max_fusion_frames

    @staticmethod
    def from_dict(d: dict) -> "SystemConfig":
        """Build from a nested dict in the configs/*.yaml schema (a
        "dataset" section is ignored). Derives only the sections and
        keys the dict leaves out: an explicit regularizer keeps its
        radius and neighbour counts, an explicit ls_norm is kept."""
        cfg = SystemConfig()
        for section, values in d.items():
            if section not in _SECTIONS:
                if section == "dataset":
                    continue
                raise KeyError(f"unknown config section {section!r}; "
                               f"expected one of {sorted(_SECTIONS)}")
            cls = _SECTIONS[section]
            bad = set(values) - {f.name for f in dataclasses.fields(cls)}
            if bad:
                raise KeyError(f"unknown keys {sorted(bad)} in config "
                               f"section {section!r}")
            setattr(cfg, section, cls(**values))
        reg = d.get("regularizer")
        _derive(cfg,
                fusion_norm="ls_norm" not in d.get("fusion", {}),
                reg_keys=(tuple(_REG_FROM_DEPTH) if reg is None
                          else () if "ls_norm" in reg else ("ls_norm",)))
        return cfg

    @staticmethod
    def from_preset(name_or_path: str) -> "SystemConfig":
        """Load a shipped preset ("rpg", "upenn", "hkust", "dsec",
        "simulation" under configs/) or any YAML file in the same nested
        schema. Needs PyYAML."""
        import yaml

        path = name_or_path
        if not os.path.exists(path):
            root = os.path.join(os.path.dirname(__file__), "..", "..",
                                "configs")
            path = os.path.join(root, f"{name_or_path}.yaml")
            if not os.path.exists(path):
                avail = sorted(p[:-5] for p in os.listdir(root)
                               if p.endswith(".yaml"))
                raise FileNotFoundError(
                    f"no preset {name_or_path!r}; available: {avail}")
        with open(path) as f:
            return SystemConfig.from_dict(yaml.safe_load(f))

    @staticmethod
    def from_yaml(mapping_yaml: str | None = None,
                  tracking_yaml: str | None = None,
                  time_surface_yaml: str | None = None) -> "SystemConfig":
        """Build from reference-format YAML files (parameter names as in
        cfg/mapping/*.yaml, cfg/tracking/*.yaml, ts_parameters.yaml).
        Needs PyYAML only when a file is given: with none it returns the
        defaults."""
        cfg = SystemConfig()
        if mapping_yaml:
            m = _load_yaml(mapping_yaml)
            # rpg/hkust name the key "Lnorm", upenn/dsec "LSnorm"
            lnorm = str(m.get("Lnorm", m.get("LSnorm", "Tdist")))
            cfg.depth = DepthProblemConfig(
                patch_size_x=int(m.get("patch_size_X", 15)),
                patch_size_y=int(m.get("patch_size_Y", 7)),
                ls_norm=lnorm,
                td_nu=float(m.get("Tdist_nu", 2.1897)),
                td_scale=float(m.get("Tdist_scale", 16.6397)),
                max_iteration=int(m.get("ITERATION_OPTIMIZATION", 10)),
                regularization_radius=int(m.get("RegularizationRadius", 5)),
                regularization_min_neighbours=int(
                    m.get("RegularizationMinNeighbours", 8)),
                regularization_min_close_neighbours=int(
                    m.get("RegularizationMinCloseNeighbours", 8)))
            cfg.bm = BlockMatchConfig(
                patch_size_x=int(m.get("patch_size_X", 15)),
                patch_size_y=int(m.get("patch_size_Y", 7)),
                min_disparity=int(m.get("BM_min_disparity", 1)),
                max_disparity=int(m.get("BM_max_disparity", 40)),
                step=int(m.get("BM_step", 1)),
                zncc_threshold=float(m.get("BM_ZNCC_Threshold", 0.1)),
                up_down=bool(m.get("BM_bUpDownConfiguration", False)),
                smooth_time_surface=bool(m.get("SmoothTimeSurface", False)))
            cfg.fusion = FusionConfig(
                ls_norm=lnorm, fusion_radius=int(m.get("fusion_radius", 0)))
            cfg.mapping = MappingConfig(
                inv_depth_min_range=float(m.get("invDepth_min_range", 0.2)),
                inv_depth_max_range=float(m.get("invDepth_max_range", 2.0)),
                residual_vis_threshold=float(
                    m.get("residual_vis_threshold", 20)),
                std_var_vis_threshold=float(
                    m.get("stdVar_vis_threshold", 0.015)),
                age_max_range=int(m.get("age_max_range", 10)),
                age_vis_threshold=int(m.get("age_vis_threshold", 1)),
                fusion_strategy=str(m.get("FUSION_STRATEGY",
                                          "CONST_POINTS")),
                max_fusion_frames=int(m.get("maxNumFusionFrames", 40)),
                max_fusion_points=int(m.get("maxNumFusionPoints", 5000)),
                denoising=bool(m.get("Denoising", True)),
                regularization=bool(m.get("Regularization", True)),
                process_event_num=int(m.get("PROCESS_EVENT_NUM", 1000)),
                init_sgm_num_threshold=int(
                    m.get("INIT_SGM_DP_NUM_THRESHOLD", 500)),
                mapping_rate_hz=float(m.get("mapping_rate_hz", 20)),
                bm_half_slice_thickness=float(
                    m.get("BM_half_slice_thickness", 0.001)))
        if tracking_yaml:
            t = _load_yaml(tracking_yaml)
            cfg.tracker = RegProblemConfig(
                patch_size_x=int(t.get("patch_size_X", 1)),
                patch_size_y=int(t.get("patch_size_Y", 1)),
                kernel_size=int(t.get("kernelSize", 5)),
                huber_threshold=float(t.get("huber_threshold", 50)),
                max_registration_points=int(
                    t.get("MAX_REGISTRATION_POINTS", 2000)),
                batch_size=int(t.get("BATCH_SIZE", 300)),
                max_iteration=int(t.get("MAX_ITERATION", 10)),
                ls_norm=str(t.get("LSnorm", "Huber")),
                min_num_events=int(t.get("MIN_NUM_EVENTS", 1000)),
                # RegProblemType: 0 numerical, 1 analytical
                use_numerical_diff=int(t.get("RegProblemType", 1)) == 0)
            cfg.tracking = TrackingNodeConfig(
                tracking_rate_hz=float(t.get("tracking_rate_hz", 100)),
                ref_history_length=int(t.get("REF_HISTORY_LENGTH", 10)))
        if time_surface_yaml:
            s = _load_yaml(time_surface_yaml)
            cfg.surface = TimeSurfaceConfig(
                decay_sec=float(s.get("decay_ms", 30)) / 1000.0,
                ignore_polarity=bool(s.get("ignore_polarity", True)),
                median_blur_kernel_size=int(
                    s.get("median_blur_kernel_size", 1)),
                mode=("backward" if int(s.get("time_surface_mode", 0)) == 0
                      else "forward"))
        _derive(cfg)
        return cfg


def _load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def with_overrides(cfg: SystemConfig, overrides) -> SystemConfig:
    """Apply ``section.field=value`` override strings on top of a config
    (values parse as YAML scalars; needs PyYAML). Unknown sections or
    fields raise with the valid choices."""
    import yaml

    groups: dict = {}
    sections = {f.name for f in dataclasses.fields(cfg)}
    for ov in overrides or []:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"--set wants section.field=value, got {ov!r}")
        sec, sep2, name = key.partition(".")
        if not sep2 or sec not in sections:
            raise ValueError(
                f"unknown config section in {ov!r}; sections: "
                f"{sorted(sections)}")
        names = {f.name for f in dataclasses.fields(getattr(cfg, sec))}
        if name not in names:
            raise ValueError(
                f"unknown field {name!r} in section {sec!r}; fields: "
                f"{sorted(names)}")
        groups.setdefault(sec, {})[name] = yaml.safe_load(val)
    # dataclasses.replace runs __post_init__, i.e. the derivation
    return dataclasses.replace(cfg, **{
        sec: dataclasses.replace(getattr(cfg, sec), **kv)
        for sec, kv in groups.items()})
