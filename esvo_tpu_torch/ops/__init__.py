"""Patch/window gathers, and the hand-written CUDA kernels with their
plain twins."""
