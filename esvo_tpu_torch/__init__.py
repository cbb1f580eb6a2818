"""esvo_tpu_torch — the PyTorch/CUDA port of esvo_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``esvo_tpu``), with the same
module layout so each function has an obvious counterpart:

- ``geometry``  — SE(3)/SO(3) helpers, camera models, rectification maps;
- ``ops``       — patch/window gathers, the small SPD solve, and the three
  hand-written CUDA kernels (``remap``, ``patches``, ``lm``) with their
  plain twins;
- ``surface``   — the time-surface engine;
- ``mapping``   — block matching, the depth LM, fusion, regularization,
  denoising and the SGM bootstrap;
- ``tracking``  — the 6-DoF registration tracker;
- ``runtime``   — ``SystemConfig``, ``MappingCycle``, ``EsvoSystem`` (the
  closed loop), the resident loop, the mapper benchmark, the BA and
  pose-graph layers over the loop, and checkpoints;
- ``backend``   — bundle adjustment, keyframe association, SE(3) pose
  graphs and loop closure;
- ``eval``      — ATE / RPE and TUM trajectories;
- ``io``        — event framing, the synthetic stereo scene, the event
  simulator, the dataset loaders and live streams;
- ``utils``     — the debug maps, the precision guard, timing and the
  live dashboard.

The package imports torch and numpy only (never jax or esvo_tpu). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch twin.
"""

__version__ = "0.1.0"
