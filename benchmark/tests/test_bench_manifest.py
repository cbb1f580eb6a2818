"""BENCHMARK.json against the benchmark's contract: every entry resolves
to its files by name, every name and unit uses the allowed characters,
and a new cell is found from data files alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest

import check as C
import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = H.load_manifest()


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cmd = MANIFEST["command"]
    assert len(cmd) <= 32 and (H.REPO / cmd[1]).is_file()
    assert len((H.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and \
                        not (group == "per_layer" and key == "source"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves_by_name(cell):
    c = H.load_cell(cell)
    assert c.chips == 1
    assert (H.ROOT / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    readers = H.readers(c)
    assert set(readers) == {m["name"] for m in c.per_layer}
    assert {"surface_levels", "map_share"} <= set(c.workload["limits"]) \
        <= set(C.NUMBERS)
    for m in c.per_layer:
        assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_every_config_is_used_and_states_its_cut():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        data = json.loads((H.REPO / c["file"]).read_text())
        assert data["source"] == c["source"] and data["assumed"]
        assert c["reduced"] == []


def test_a_new_cell_is_found_from_data_files_alone(tmp_path):
    """A later cell adds a traffic and a workload file and a manifest
    entry; no existing file changes."""
    shutil.copytree(H.ROOT, tmp_path / H.ROOT.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / H.ROOT.name).rglob("*") if p.is_file()}
    man = json.loads(json.dumps(MANIFEST))
    man["workloads"].append(dict(
        name="rpg.paced", config="rpg", traffic="paced_ticks", chips=1,
        why="a paced open loop"))
    root = tmp_path / H.ROOT.name
    traffic = json.loads(
        (root / "traffic" / "live_ticks.json").read_text())
    (root / "traffic" / "paced_ticks.json").write_text(
        json.dumps(dict(traffic, rate_hz=100.0)))
    shutil.copy(root / "workloads" / "rpg.tick.json",
                root / "workloads" / "rpg.paced.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = H.load_cell("rpg.paced", repo=tmp_path)
    assert cell.traffic["rate_hz"] == 100.0
    assert cell.config["rig"]["width"] == 240
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    after = {p: (tmp_path / p).read_bytes() for p in before}
    assert after == before
