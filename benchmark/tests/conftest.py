"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of the checkout (the card's tests: add `-m cuda` on a machine with
one). They import the benchmark's modules from benchmark/ and no JAX."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@pytest.fixture
def few_threads():
    """The port on the CPU with two threads, put back afterwards."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")
