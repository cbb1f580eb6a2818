"""Configuration of the mapping cycle (the part of
esvo_tpu/runtime/config.py this port has so far).

``MappingConfig`` keeps the JAX package's field names and defaults;
``MappingCycleConfig`` bundles the sub-configs the WORKING mapping cycle
reads and derives the same coherent settings as ``SystemConfig`` does
(one LSnorm across depth, fusion and regularization; the regularizer's
radius and neighbour counts from the depth section).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

from esvo_tpu_torch.mapping.block_matching import BlockMatchConfig
from esvo_tpu_torch.mapping.depth_refinement import DepthProblemConfig
from esvo_tpu_torch.mapping.fusion import FusionConfig
from esvo_tpu_torch.mapping.regularization import RegularizationConfig
from esvo_tpu_torch.surface.time_surface import TimeSurfaceConfig


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


_SECTIONS = {
    "surface": TimeSurfaceConfig, "bm": BlockMatchConfig,
    "depth": DepthProblemConfig, "fusion": FusionConfig,
    "regularizer": RegularizationConfig, "mapping": MappingConfig,
}


@dataclass(frozen=True)
class MappingCycleConfig:
    surface: TimeSurfaceConfig = field(default_factory=TimeSurfaceConfig)
    bm: BlockMatchConfig = field(default_factory=BlockMatchConfig)
    depth: DepthProblemConfig = field(default_factory=DepthProblemConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    regularizer: RegularizationConfig = field(
        default_factory=RegularizationConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)

    def __post_init__(self):
        d = self.depth
        object.__setattr__(self, "fusion", dataclasses.replace(
            self.fusion, ls_norm=d.ls_norm))
        object.__setattr__(self, "regularizer", dataclasses.replace(
            self.regularizer, ls_norm=d.ls_norm,
            radius=d.regularization_radius,
            min_neighbours=d.regularization_min_neighbours,
            min_close_neighbours=d.regularization_min_close_neighbours))

    @property
    def cost_vis_threshold(self) -> float:
        """pow(residual_vis_threshold, 2) * patch_area."""
        return self.mapping.residual_vis_threshold ** 2 \
            * self.depth.patch_area

    @property
    def history_frames(self) -> int:
        """Frames in the fusion window: ~1.5x maxNumFusionPoints for
        CONST_POINTS, maxNumFusionFrames for CONST_FRAMES."""
        m = self.mapping
        if m.fusion_strategy == "CONST_POINTS":
            return max(int(math.ceil(1.5 * m.max_fusion_points
                                     / m.process_event_num)), 2)
        return m.max_fusion_frames

    @staticmethod
    def from_dict(d: dict) -> "MappingCycleConfig":
        """Build from a nested dict in the configs/*.yaml schema (sections
        the cycle does not read, such as tracker, are ignored)."""
        kw = {}
        for section, cls in _SECTIONS.items():
            values = d.get(section, {})
            names = {f.name for f in dataclasses.fields(cls)}
            bad = set(values) - names
            if bad:
                raise KeyError(f"unknown keys {sorted(bad)} in config "
                               f"section {section!r}")
            kw[section] = cls(**values)
        return MappingCycleConfig(**kw)
