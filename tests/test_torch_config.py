"""The port's SystemConfig against the JAX package's, field by field and
exactly: every shipped preset (from_preset), the dicts that set the
regularizer and fusion sections (from_dict derives only what they leave
out), the reference-format YAMLs (from_yaml), with_overrides, and the
sections chip_smoke.py's RPG and DSEC dicts carry against the presets
they copy."""
import dataclasses
import pathlib

import pytest
import yaml

from esvo_tpu.runtime import config as jconf
from esvo_tpu_torch.runtime import config as tconf

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRESETS = sorted(p.stem for p in (ROOT / "configs").glob("*.yaml"))


def _fields(cfg) -> dict:
    return {sec.name: dataclasses.asdict(getattr(cfg, sec.name))
            for sec in dataclasses.fields(cfg)}


def _assert_same(t, j):
    assert _fields(t) == _fields(j)
    assert t.cost_vis_threshold == j.cost_vis_threshold


@pytest.mark.parametrize("name", PRESETS)
def test_presets(name):
    _assert_same(tconf.SystemConfig.from_preset(name),
                 jconf.SystemConfig.from_preset(name))


SECTION_DICTS = {
    # the dict of the config fault: explicit sections are kept
    "explicit": {"depth": {"regularization_radius": 5},
                 "regularizer": {"radius": 3, "ls_norm": "l2"},
                 "fusion": {"ls_norm": "l2"}},
    "reg-without-norm": {"depth": {"ls_norm": "l2",
                                   "regularization_radius": 7},
                         "regularizer": {"radius": 2}},
    "fusion-without-norm": {"depth": {"ls_norm": "l2"},
                            "fusion": {"fusion_radius": 1}},
    "derived": {"depth": {"ls_norm": "l2", "regularization_radius": 9,
                          "regularization_min_neighbours": 3}},
    "empty": {},
    "dataset": {"dataset": {"name": "x"}, "tracker": {"batch_size": 200}},
}


@pytest.mark.parametrize("key", sorted(SECTION_DICTS))
def test_from_dict_derives_only_what_is_left_out(key):
    d = SECTION_DICTS[key]
    t, j = tconf.SystemConfig.from_dict(d), jconf.SystemConfig.from_dict(d)
    _assert_same(t, j)
    if key == "explicit":
        assert (t.regularizer.radius, t.regularizer.ls_norm,
                t.fusion.ls_norm) == (3, "l2", "l2")


def test_constructor_always_derives():
    from esvo_tpu.mapping.depth_refinement import DepthProblemConfig as JD
    from esvo_tpu.mapping.regularization import RegularizationConfig as JR
    from esvo_tpu_torch.mapping.depth_refinement import DepthProblemConfig
    from esvo_tpu_torch.mapping.regularization import RegularizationConfig
    kw = dict(ls_norm="l2", regularization_radius=4)
    t = tconf.SystemConfig(depth=DepthProblemConfig(**kw),
                           regularizer=RegularizationConfig(radius=1))
    j = jconf.SystemConfig(depth=JD(**kw), regularizer=JR(radius=1))
    _assert_same(t, j)
    assert t.regularizer.radius == 4 and t.fusion.ls_norm == "l2"


def test_unknown_keys_raise():
    for d in ({"nope": {}}, {"depth": {"nope": 1}}):
        with pytest.raises(KeyError):
            tconf.SystemConfig.from_dict(d)
    with pytest.raises(FileNotFoundError):
        tconf.SystemConfig.from_preset("no-such-preset")


OVERRIDES = [
    ["depth.ls_norm=l2", "tracker.batch_size=150"],
    ["mapping.process_event_num=640", "tracking.max_speed_mps=1.5",
     "sgm.num_disparities=32", "surface.mode=forward"],
    ["regularizer.radius=2"],           # re-derived from depth, as in JAX
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_with_overrides(overrides):
    base_t = tconf.SystemConfig.from_preset("rpg")
    base_j = jconf.SystemConfig.from_preset("rpg")
    _assert_same(tconf.with_overrides(base_t, overrides),
                 jconf.with_overrides(base_j, overrides))
    with pytest.raises(ValueError):
        tconf.with_overrides(base_t, ["depth.nope=1"])


def test_from_yaml(tmp_path):
    mapping = {"patch_size_X": 11, "patch_size_Y": 5, "LSnorm": "l2",
               "Tdist_nu": 2.5, "BM_max_disparity": 60, "fusion_radius": 1,
               "invDepth_min_range": 0.1, "FUSION_STRATEGY": "CONST_FRAMES",
               "maxNumFusionFrames": 6, "Denoising": False,
               "PROCESS_EVENT_NUM": 700, "RegularizationRadius": 3}
    tracking = {"kernelSize": 3, "BATCH_SIZE": 250, "MAX_ITERATION": 8,
                "RegProblemType": 0, "REF_HISTORY_LENGTH": 5}
    surface = {"decay_ms": 20, "median_blur_kernel_size": 2,
               "time_surface_mode": 1}
    paths = []
    for name, d in (("m", mapping), ("t", tracking), ("s", surface)):
        p = tmp_path / f"{name}.yaml"
        p.write_text(yaml.safe_dump(d))
        paths.append(str(p))
    for args in (paths, (paths[0], None, None), (None, paths[1], paths[2])):
        _assert_same(tconf.SystemConfig.from_yaml(*args),
                     jconf.SystemConfig.from_yaml(*args))


@pytest.mark.parametrize("name", ["rpg", "dsec"])
def test_chip_smoke_dicts_match_their_presets(name):
    import chip_smoke
    d = getattr(chip_smoke, name.upper())
    got = _fields(tconf.SystemConfig.from_dict(d))
    want = _fields(tconf.SystemConfig.from_preset(name))
    for section in d:
        assert got[section] == want[section], section
