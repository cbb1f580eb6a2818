"""What runs may load: no JAX, no JAX package (top-level names compared
whole: esvo_tpu_torch begins with esvo_tpu), a reference that imports
nothing of the program, and no result without a card."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

import harness as H

SETUP = r"""
import json, sys
sys.path.insert(0, "benchmark")
import torch
torch.set_num_threads(2)
import harness as H
cell = H.load_cell("rpg.resident")
P = H.program()
params, stream = H.make_stream(cell, 5)
rig = H.scene_mod.build_rig(params, P.camera, torch.float32, "cpu")
system = P.EsvoSystem(rig, P.SystemConfig.from_dict(cell.config["system"]),
                      device="cpu", seed=5)
system.process_ticks(*stream.ticks_at(0, 5))
ref = H.reference()
H.load_module(H.ROOT / "drivers" / "resident.py", "d1")
H.load_module(H.ROOT / "drivers" / "tick.py", "d2")
H.readers(cell)
print(json.dumps(dict(status=system.status.value,
                      found=H.forbidden_modules(),
                      loaded=sorted({m.split(".")[0] for m in sys.modules}))))
"""


def _py(code: str, **kw):
    return subprocess.run([sys.executable, "-c", code], cwd=H.REPO,
                          capture_output=True, text=True, timeout=600, **kw)


def test_set_up_loads_no_jax_nor_the_jax_package(few_threads):
    out = _py(SETUP)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["found"] == []
    assert "esvo_tpu_torch" in res["loaded"] and "plainref" in res["loaded"]
    assert res["status"] == "WORKING"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "esvo_tpu_torch_x", sys)
    assert "esvo_tpu_torch_x" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "esvo_tpu.fake", sys)
    assert H.forbidden_modules() == ["esvo_tpu.fake"]


def test_reference_imports_nothing_of_the_program():
    root = H.ROOT / "plainref"
    for path in root.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                top = s.split()[1].split(".")[0]
                assert top not in ("esvo_tpu_torch", "esvo_tpu", "jax"), \
                    f"{path}: {s}"
    out = _py("import sys; sys.path.insert(0, 'benchmark'); "
              "import plainref.runtime.step; "
              "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "esvo_tpu_torch" not in out.stdout and "jax" not in out.stdout


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "rpg.resident", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=H.REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ gives no
    result."""
    import shutil
    shutil.copy(H.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(H.ROOT, tmp_path / H.ROOT.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "rpg.resident", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_paths_hold_only_the_benchmark():
    man = H.load_manifest()
    assert all(not p.startswith("/") and ".." not in p
               for p in man["paths"] + man["command"][1:])
    assert Path(man["command"][1]).parts[0] in man["paths"]
