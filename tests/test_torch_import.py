"""The port stands alone: importing esvo_tpu_torch loads neither JAX nor
the JAX package, and no file of the port (nor chip_smoke.py, nor the
port's scripts/torch_*.py) imports them."""
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "esvo_tpu_torch").rglob("*.py"))
              + sorted((ROOT / "scripts").glob("torch_*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py"))
              + [ROOT / "chip_smoke.py"])
# "esvo_tpu." never matches the port's own prefix "esvo_tpu_torch"
FORBIDDEN = re.compile(r"\b(import|from)\s+(jax|flax)\b|\besvo_tpu\."
                       r"|\b(import|from)\s+esvo_tpu\b")


def test_import_loads_no_jax():
    code = ("import sys, esvo_tpu_torch\n"
            "import esvo_tpu_torch.runtime.system, esvo_tpu_torch.convert\n"
            "import esvo_tpu_torch.tracking.registration\n"
            "import esvo_tpu_torch.runtime.checkpoint\n"
            "import esvo_tpu_torch.eval.trajectory\n"
            "import esvo_tpu_torch.mapping.initialization\n"
            "import esvo_tpu_torch.utils.visualization\n"
            "import esvo_tpu_torch.ops.linalg\n"
            "import esvo_tpu_torch.runtime.resident\n"
            "import esvo_tpu_torch.io.stream\n"
            "import esvo_tpu_torch.mapping.event_matcher\n"
            "import esvo_tpu_torch.runtime.mvstereo\n"
            "import esvo_tpu_torch.io.datasets, esvo_tpu_torch.io.rosbag\n"
            "import esvo_tpu_torch.io.native, esvo_tpu_torch.io.live\n"
            "import esvo_tpu_torch.utils.precision\n"
            "import esvo_tpu_torch.io.esim, esvo_tpu_torch.backend\n"
            "import esvo_tpu_torch.backend.bundle_adjustment\n"
            "import esvo_tpu_torch.backend.keyframes\n"
            "import esvo_tpu_torch.backend.pose_graph\n"
            "import esvo_tpu_torch.backend.loop_closure\n"
            "import esvo_tpu_torch.runtime.backend_loop\n"
            "import esvo_tpu_torch.runtime.pose_graph_loop\n"
            "import esvo_tpu_torch.utils.profiling\n"
            "import esvo_tpu_torch.utils.live_view\n"
            "import esvo_tpu_torch.parallel.sharding\n"
            "sys.path.insert(0, 'scripts')\n"
            "import torch_run_dataset, torch_run_live, torch_repack_bag\n"
            "import torch_sim_campaign\n"
            "import torch_bench, torch_bench_solve, torch_bench_ticks\n"
            "import torch_profile_system, torch_measure_em_overflow\n"
            "import torch_bench_scaling\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'flax')) or m == 'esvo_tpu' "
            "or m.startswith('esvo_tpu.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports_in_source(path):
    assert path.exists(), path
    hits = [m.group(0) for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.name}: {hits}"
