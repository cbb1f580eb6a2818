"""Checkpoint / resume of the full EsvoSystem state (port of
esvo_tpu/runtime/checkpoint.py), in the same format: ``state.npz`` (flat
arrays) beside ``meta.json`` (host scalars and counters); the layout is
``convert.system_state_to_numpy``'s.

A checkpoint written by the JAX package loads here: its "rng_key" is a
``jax.random`` key, which this package ignores (the tracker's
``torch.Generator`` keeps its state). This package writes its generator
state under "torch_rng_state" instead, which the JAX package ignores.
"""
from __future__ import annotations

import json
import os

import numpy as np

from esvo_tpu_torch import convert


def save_checkpoint(system, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    arrays, meta = convert.system_state_to_numpy(system)
    np.savez_compressed(os.path.join(path, "state.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(system, path: str):
    """Restore state in place (the system must be built with the same rig
    and config shapes); a WORKING system rebuilds its tracker map from
    the restored window. Returns the system."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "state.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return convert.system_state_from_numpy(system, arrays, meta)
