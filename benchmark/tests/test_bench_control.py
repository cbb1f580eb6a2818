"""The control on the card: the plain reference in TF32 (the nearest
precision below the configuration's float32 with TF32 off) put in the
program's place fails the check, while the program passes it, at each
cell's own size. Run on a machine with a card:

    python -m pytest -m cuda benchmark/tests/test_bench_control.py
"""
from __future__ import annotations

import pytest

import calibrate
import harness as H

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  H.load_manifest()["workloads"]])
def test_control_fails_and_program_passes(cell, card):
    r = calibrate.reading(cell, seed=2 ** 31 + 17, seconds=4.0, control=True,
                          device=card)
    assert r["failed"] == 0
    assert r["program_correct"], r["program"]
    assert not r["control_correct"], r["control"]
