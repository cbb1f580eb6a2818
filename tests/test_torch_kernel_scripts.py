"""The kernel measurement scripts on a machine without a card.

- ``scripts/torch_k4_stamps.py`` instruments a copy of
  ``esvo_tpu_torch/csrc/track.cu`` by anchor lines: every anchor is in
  the source once, and the copy carries a stamp at each phase boundary
  of a round, inside the serial algebra, and at the prologue.
- The scripts need a card: without one they exit non-zero before
  building or importing anything of the port's kernels.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import torch_k4_stamps  # noqa: E402
import torch_kernel_ab  # noqa: E402


def test_k4_stamps_anchor_every_phase():
    src = torch_k4_stamps.stamped_source()
    # two prologue stamps, ten a round, three inside the algebra
    assert src.count("STAMP(") == 2 + 10 + 3 + 1   # + the macro itself
    for k in range(10):
        assert f"STAMP(RB + {k})" in src
    assert "esvo_track_stamps_clear" in src
    assert len(torch_k4_stamps.PHASES) == 9
    assert len(torch_k4_stamps.ALGEBRA) == 4


@pytest.mark.parametrize("script, argv", [
    (torch_k4_stamps, ["--rig", "rpg"]),
    (torch_kernel_ab, ["--skip-loops"]),
], ids=["k4_stamps", "kernel_ab"])
def test_scripts_need_a_card(script, argv, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert script.main(argv) == 2
