"""Event-axis sharding over a torch.distributed process group (port of
esvo_tpu/parallel): one process a rank, a 1-D device mesh named "ev"."""
from esvo_tpu_torch.parallel.sharding import (
    EVENT_AXIS,
    make_mesh,
    run_ranks,
    sharded_ba_normal_equations,
    sharded_bundle_adjust,
    sharded_map_estimate,
    sharded_pose_graph,
    sharded_surface_update,
    sharded_tracking_step,
    spawn_ranks,
)

__all__ = ["EVENT_AXIS", "make_mesh", "run_ranks", "spawn_ranks",
           "sharded_surface_update", "sharded_map_estimate",
           "sharded_tracking_step", "sharded_ba_normal_equations",
           "sharded_bundle_adjust", "sharded_pose_graph"]
