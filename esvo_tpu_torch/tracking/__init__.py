"""6-DoF tracking: 3D-2D edge registration on negative time surfaces."""
