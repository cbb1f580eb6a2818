"""The backend (port of esvo_tpu/backend): sliding-window bundle
adjustment, keyframe association, SE(3) pose graphs and loop closure."""
from esvo_tpu_torch.backend.bundle_adjustment import (
    BAProblem,
    BAConfig,
    bundle_adjust,
    reprojection_residuals,
)
from esvo_tpu_torch.backend.keyframes import KeyframeGraph, build_ba_problem
from esvo_tpu_torch.backend.pose_graph import (
    PoseGraph,
    PoseGraphConfig,
    optimize_pose_graph,
    odometry_graph,
    add_edge,
)
from esvo_tpu_torch.backend.loop_closure import (
    LoopClosureConfig,
    LoopClosureDetector,
    ts_descriptor,
    verify_loop,
    verify_loop_icp,
    icp_align,
)

__all__ = ["BAProblem", "BAConfig", "bundle_adjust",
           "reprojection_residuals", "KeyframeGraph", "build_ba_problem",
           "PoseGraph", "PoseGraphConfig", "optimize_pose_graph",
           "odometry_graph", "add_edge", "LoopClosureConfig",
           "LoopClosureDetector", "ts_descriptor", "verify_loop",
           "verify_loop_icp", "icp_align"]
