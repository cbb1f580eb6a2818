"""esvo_tpu_torch — the PyTorch/CUDA port of esvo_tpu for NVIDIA Hopper.

A second package beside the JAX reference (``esvo_tpu``), with the same
module layout so each function has an obvious counterpart:

- ``geometry``  — SE(3)/SO(3) helpers, camera models, rectification maps;
- ``ops``       — patch/window gathers, and the three hand-written CUDA
  kernels (``remap``, ``patches``, ``lm``) with their plain twins;
- ``surface``   — the time-surface engine;
- ``mapping``   — block matching, the depth LM, fusion, regularization,
  denoising;
- ``runtime``   — the mapping-cycle configuration and ``MappingCycle``;
- ``io``        — event framing and the synthetic stereo scene.

The package imports torch and numpy only (never jax or esvo_tpu). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch twin.
"""

__version__ = "0.1.0"
