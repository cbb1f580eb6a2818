"""scripts/torch_bench.py against the JAX package's bench.py composition,
on the CPU at a tiny size (48x64, N = 64 events, disparities 6..10
around the texture's shift of 8, whose inverse depth 0.4 lies inside
the culling range 0.2..2).

bench.py is not imported (its import sets a process-wide JAX compilation
cache); the JAX side is written here from esvo_tpu's functions, composed
as bench.py:113-147 composes them, in float32. Each stage gets the same
numpy inputs on both sides (the JAX stage's outputs feed the next stage
of both), then the whole cycle runs on each side from the world alone.

Tolerances:
- ts: the surfaces (the render blended half-and-half with the texture)
  within half an 8-bit level everywhere and within 1e-4 on >= 99.9% of
  the pixels (tests/test_torch_time_surface.py's, halved by the blend);
  the timestamp grids equal;
- bm: validity on >= 99% of the events, disparity equal on >= 99% of
  those matched on both sides (tests/test_torch_block_matching.py's);
- solve: validity on >= 98% of the events, inverse depth within the LM
  tolerance (rtol 2e-4, atol 2e-5) on >= 98% of the events the block
  matching matched, those the LM refined (tests/test_torch_lm.py's;
  bench.py's world sits on integer pixels of an ideal rig, where K2's
  twin and the JAX kernel may race into other minima). The JAX side runs the Pallas LM in interpret mode
  (lm_kernel="pallas"), the path the port's kernel and twin follow;
- fuse: nfused equal, the fused inverse depth at
  tests/test_torch_fusion.py's rtol 1e-5 / atol 1e-7;
- the whole cycle: the fused grid's occupancy on >= 98% of the pixels,
  its inverse depth at the LM tolerance on >= 98% of the pixels occupied
  on both sides, nfused within 2%, and the solve's tolerance on the
  estimates in the history.

bench.py's world culls every estimate on both sides (see
test_stage_fuse), so the cycle's grid is empty and nfused 0 in both
packages; the fuse stage is held on the estimates before culling.
"""
import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esvo_tpu.geometry.camera import make_ideal_rig as jmake_ideal_rig
from esvo_tpu.geometry.se3 import interpolate_pose_table as jinterp
from esvo_tpu.mapping import block_matching as jbm
from esvo_tpu.mapping import depth_refinement as jdr
from esvo_tpu.mapping import fusion as jfu
from esvo_tpu.surface import time_surface as jtsf
from esvo_tpu_torch.mapping import block_matching as tbm
from esvo_tpu_torch.mapping import depth_refinement as tdr
from esvo_tpu_torch.mapping import fusion as tfu
from esvo_tpu_torch.surface import time_surface as ttsf

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import torch_bench as tb  # noqa: E402

W, H, N, DISP, F = 64, 48, 64, 8, 4
MAX_ITER = 10
F32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: these are thousands of small ops, and
    several test workers each running a full pool slow them tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bm_cfgs():
    return (jbm.BlockMatchConfig(min_disparity=6, max_disparity=10),
            tbm.BlockMatchConfig(min_disparity=6, max_disparity=10))


def _dp_cfgs():
    return (jdr.DepthProblemConfig(max_iteration=MAX_ITER,
                                   lm_kernel="pallas"),
            tdr.DepthProblemConfig(max_iteration=MAX_ITER))


def jax_cycle(rig, bm_cfg, dp_cfg, fu_cfg, surf_cfg, ts_tex_l, ts_tex_r):
    """bench.py's build_cycle on esvo_tpu's functions, in float32."""
    pose_t = jnp.asarray(np.linspace(-0.05, 0.05, 32), F32)
    pose_T = jnp.broadcast_to(jnp.eye(4, dtype=F32), (32, 4, 4))

    def stage_ts(ts_state, ev_x, ev_y, ev_t, ev_p, ev_valid):
        batch = jtsf.EventBatch(x=ev_x, y=ev_y, t=ev_t, p=ev_p,
                                valid=ev_valid)
        ts_state = jtsf.insert_events(ts_state, batch)
        surf = jtsf.render_backward(ts_state, ev_t[-1], rig.left, surf_cfg)
        return ts_state, 0.5 * (surf + ts_tex_l)

    def stage_bm(ts_l, ev_x, ev_y, ev_t, ev_valid):
        x_rect = rig.left.lut[ev_y, ev_x]
        return jbm.match_events(ts_l, ts_tex_r, x_rect, x_rect, ev_t,
                                ev_valid, rig.left.mask, rig, bm_cfg)

    def stage_solve(ts_l, matches, ev_t):
        T_wv = jinterp(pose_t, pose_T, ev_t)
        est = jdr.solve(matches.x_left, T_wv, T_wv, matches.inv_depth,
                        matches.valid, ev_t, ts_l, ts_tex_r, rig, dp_cfg)
        return jdr.point_culling(est, 0.03, 20.0 ** 2 * dp_cfg.patch_area,
                                 0.2, 2.0)

    def stage_fuse(history, slot, est):
        history = jax.tree.map(lambda h, e: h.at[slot].set(e), history, est)
        flat = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]),
                            history)
        grid = jfu.empty_grid(H, W, F32)
        cand = jfu.propagate_points(flat, jnp.eye(4, dtype=F32), rig.left,
                                    fu_cfg)
        grid, nfused, _ = jfu.fuse_frame(grid, cand, rig.left, fu_cfg)
        return history, grid.inv_depth, nfused

    def cycle(ts_state, history, slot, ev_x, ev_y, ev_t, ev_p, ev_valid):
        ts_state, ts_l = stage_ts(ts_state, ev_x, ev_y, ev_t, ev_p, ev_valid)
        matches = stage_bm(ts_l, ev_x, ev_y, ev_t, ev_valid)
        est = stage_solve(ts_l, matches, ev_t)
        history, inv_d, nfused = stage_fuse(history, slot, est)
        return ts_state, history, inv_d, nfused

    return (jax.jit(cycle), jax.jit(stage_ts), jax.jit(stage_bm),
            jax.jit(stage_solve), jax.jit(stage_fuse))


def jax_empty_history():
    z = jnp.zeros
    return jdr.DepthEstimates(
        x=z((F, N, 2), F32), inv_depth=-jnp.ones((F, N), F32),
        variance=z((F, N), F32), scale2=z((F, N), F32), nu=z((F, N), F32),
        residual=z((F, N), F32), age=z((F, N), jnp.int32),
        p_cam=z((F, N, 3), F32),
        T_world_cam=jnp.broadcast_to(jnp.eye(4, dtype=F32), (F, N, 4, 4)),
        valid=z((F, N), bool))


def to_port(cls, obj):
    """A JAX struct's arrays as the port's dataclass `cls` on the CPU."""
    return cls(**{f.name: torch.from_numpy(np.array(getattr(obj, f.name)))
                  for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def world():
    """Both sides' cycles and stages on bench.py's world at the tiny size
    (the port's make_world; the JAX side gets the same numbers)."""
    rig_t, tex_l, tex_r, ev_x, ev_y, ev_t, ev_p = tb.make_world(
        W, H, N, DISP, np.random.default_rng(0), "cpu")
    rig_j = jmake_ideal_rig(W, H, 200.0, 200.0, W / 2 - 0.5, H / 2 - 0.5,
                            0.1, dtype=F32)
    np.testing.assert_array_equal(rig_t.left.lut.numpy(),
                                  np.asarray(rig_j.left.lut))
    events = [a.numpy() for a in (ev_x, ev_y, ev_t, ev_p)]
    events.append(np.ones(N, bool))
    (jbm_cfg, tbm_cfg), (jdp_cfg, tdp_cfg) = _bm_cfgs(), _dp_cfgs()
    jax_side = jax_cycle(rig_j, jbm_cfg, jdp_cfg, jfu.FusionConfig(),
                         jtsf.TimeSurfaceConfig(), jnp.asarray(tex_l.numpy()),
                         jnp.asarray(tex_r.numpy()))
    port_side = tb.build_cycle(rig_t, W, H, N, F, tbm_cfg, tdp_cfg,
                               tfu.FusionConfig(), ttsf.TimeSurfaceConfig(),
                               tex_l, tex_r)
    return events, jax_side, port_side


def _port_events(events):
    return [torch.from_numpy(a) for a in events]


def test_stage_ts(world):
    events, (_, j_ts, *_), (_, t_ts, *_) = world
    st_j, ts_j = j_ts(jtsf.init_state(H, W), *map(jnp.asarray, events))
    st_t, ts_t = t_ts(ttsf.init_state(H, W, "cpu"), *_port_events(events))
    np.testing.assert_array_equal(st_t.last_t_pos.numpy(),
                                  np.asarray(st_j.last_t_pos))
    np.testing.assert_array_equal(st_t.last_t_neg.numpy(),
                                  np.asarray(st_j.last_t_neg))
    diff = np.abs(ts_t.numpy() - np.asarray(ts_j))
    assert diff.max() <= 0.5 + 1e-4
    assert (diff <= 1e-4).mean() >= 0.999


def _surface(world):
    events, (_, j_ts, *_), _ = world
    return np.array(j_ts(jtsf.init_state(H, W),
                         *map(jnp.asarray, events))[1])


def _jax_matches(world, ts_l):
    events, (_, _, j_bm, *_), _ = world
    x, y, t, _, v = events
    return j_bm(jnp.asarray(ts_l), *map(jnp.asarray, (x, y, t, v)))


def test_stage_bm(world):
    events, _, (_, _, t_bm, *_) = world
    ts_l = _surface(world)
    mj = _jax_matches(world, ts_l)
    x, y, t, _, v = _port_events(events)
    mt = t_bm(torch.from_numpy(ts_l), x, y, t, v)
    vj, vt = np.asarray(mj.valid), mt.valid.numpy()
    assert (vj == vt).mean() >= 0.99
    both = vj & vt
    assert both.sum() >= 10
    assert (np.asarray(mj.disparity)[both]
            == mt.disparity.numpy()[both]).mean() >= 0.99


def _assert_estimates(est_t, est_j, matched):
    """Validity on >= 98% of the events; the inverse depth within the LM
    tolerance on >= 98% of the `matched` events (those the LM refined
    from a block-matching start)."""
    vj, vt = np.asarray(est_j.valid), est_t.valid.numpy()
    assert (vj == vt).mean() >= 0.98
    assert matched.sum() >= 10
    close = np.isclose(est_t.inv_depth.numpy()[matched],
                       np.asarray(est_j.inv_depth)[matched], rtol=2e-4,
                       atol=2e-5)
    assert close.mean() >= 0.98, f"{(~close).sum()} of {close.size} apart"


def _jax_solve(world, ts_l, mj):
    events, (_, _, _, j_solve, _), _ = world
    return j_solve(jnp.asarray(ts_l), mj, jnp.asarray(events[2]))


def test_stage_solve(world):
    events, _, (_, _, _, t_solve, *_) = world
    ts_l = _surface(world)
    mj = _jax_matches(world, ts_l)
    est_j = _jax_solve(world, ts_l, mj)
    est_t = t_solve(torch.from_numpy(ts_l), to_port(tbm.EventMatches, mj),
                    torch.from_numpy(events[2]))
    _assert_estimates(est_t, est_j, np.asarray(mj.valid))


def test_stage_fuse(world):
    """The fuse stage on the solve's estimates with the culling undone:
    bench.py's world culls every estimate (its left surface is the render
    blended with the texture, the right one the texture alone, so every
    residual lies above the culling bound of 20^2 x the patch area), and
    fusing nothing would test nothing."""
    _, (*_, j_fuse), (*_, t_fuse, _) = world
    ts_l = _surface(world)
    mj = _jax_matches(world, ts_l)
    est_j = _jax_solve(world, ts_l, mj)
    est_j = est_j.replace(valid=mj.valid & (est_j.inv_depth > 1e-3))
    hist_j = jax.tree.map(
        lambda h, e: jnp.broadcast_to(e[None], h.shape).astype(h.dtype),
        jax_empty_history(), est_j)
    _, inv_j, nf_j = j_fuse(hist_j, 0, est_j)
    est_t = to_port(tdr.DepthEstimates, est_j)
    hist_t = est_t.map(lambda e: e[None].expand((F,) + e.shape).clone())
    _, inv_t, nf_t = t_fuse(hist_t, 0, est_t)
    assert int(nf_t) == int(nf_j) > 0
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-5,
                               atol=1e-7)


def test_cycle(world):
    events, (j_cycle, *_), (t_cycle, *_, empty) = world
    out_j = j_cycle(jtsf.init_state(H, W), jax_empty_history(), 0,
                    *map(jnp.asarray, events))
    out_t = t_cycle(ttsf.init_state(H, W, "cpu"), empty(), 0,
                    *_port_events(events))
    inv_j, inv_t = np.asarray(out_j[2]), out_t[2].numpy()
    occ_j, occ_t = inv_j > 0, inv_t > 0
    assert (occ_j == occ_t).mean() >= 0.98
    both = occ_j & occ_t
    if both.any():
        assert np.isclose(inv_t[both], inv_j[both], rtol=2e-4,
                          atol=2e-5).mean() >= 0.98
    nf_j, nf_t = int(out_j[3]), int(out_t[3])
    assert abs(nf_t - nf_j) <= 0.02 * nf_j
    # the history slot holds the cycle's estimates on both sides (the
    # block-matching start of the cycle's surface decides which the LM
    # refined)
    matched = np.asarray(_jax_matches(world, _surface(world)).valid)
    _assert_estimates(out_t[1].map(lambda a: a[0]),
                      jax.tree.map(lambda a: a[0], out_j[1]), matched)


# ---------------------------------------------------------------------------
# the JSON line, the roofline and the closed loop
# ---------------------------------------------------------------------------

def _dict_keys(fn_node, pick) -> set:
    """Keys of the dict literal in `fn_node` that `pick` selects."""
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Dict) and pick(node):
            return {k.value for k in node.keys}
    raise AssertionError("no such dict literal")


def bench_py_keys() -> dict:
    """bench.py's JSON keys, read from its source (not imported)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    has = lambda key: lambda d: any(
        isinstance(k, ast.Constant) and k.value == key for k in d.keys)
    return dict(
        top=_dict_keys(fns["main"], has("metric")),
        stage=_dict_keys(fns["bench_pipeline"], has("cycle_ms")),
        roofline=_dict_keys(fns["bench_pipeline"], has("membw_frac")),
        system=_dict_keys(fns["bench_closed_loop"], has("ticks_per_sec")))


@pytest.fixture(scope="module")
def tiny_pipeline():
    bm_cfg = _bm_cfgs()[1]
    dp_cfg = tdr.DepthProblemConfig(max_iteration=MAX_ITER)
    return tb.bench_pipeline(W, H, N, DISP, bm_cfg, dp_cfg, reps=1,
                             rng=np.random.default_rng(0), device="cpu")


@pytest.fixture(scope="module")
def tiny_loop():
    return tb.bench_closed_loop(dispatch_ticks=(5, 10), duration=0.4,
                                device="cpu")


def test_json_line_keys(tiny_pipeline, tiny_loop, monkeypatch, capsys):
    calls = []

    def pipeline(*args, **kw):
        calls.append((args, kw))
        return tiny_pipeline

    monkeypatch.setattr(tb, "bench_pipeline", pipeline)
    monkeypatch.setattr(tb, "bench_closed_loop", lambda **kw: tiny_loop)
    out = tb.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(
        json.dumps(out))
    want = bench_py_keys()
    assert set(out) == want["top"] | {"device"}
    assert out["device"]["platform"] == "cpu"
    for stage in out["stages"].values():
        assert set(stage) == want["stage"]
        for rec in stage["roofline"].values():
            assert set(rec) == want["roofline"] - {"xla_gb"} | {"flops_frac"}
    assert set(out["system"]) == want["system"]
    assert out["value"] == 4096 / (tiny_pipeline["cycle_ms"] * 1e-3)
    # bench.py's widths: rpg, then DSEC
    (rpg, rpg_kw), (dsec, dsec_kw) = calls
    assert rpg[:4] == (240, 180, 4096, 8) and rpg_kw["reps"] == 20
    assert dsec[:4] == (640, 480, 8192, 24) and dsec_kw["reps"] == 10
    assert (dsec[4].min_disparity, dsec[4].max_disparity) == (0, 150)
    assert rpg[4] == tbm.BlockMatchConfig()
    assert rpg[5].max_iteration == dsec[5].max_iteration == 10


def test_roofline_counts(tiny_pipeline):
    P_bm, D, P_lm, Wy, Wx = 15 * 7, 5, 15 * 7, 24, 32
    want = {
        "ts": ((8 * H * W + 4 * N) * 4, N + 25 * H * W),
        "bm": ((2 * H * W + 16 * N) * 4, N * (3 * P_bm + D * (5 * P_bm
                                                             + 12))),
        "solve": ((2 * N * Wy * Wx + 2 * H * W + 16 * N) * 4,
                  N * (P_lm * (11 * 54 + 4 * 10 + 2) + 85)),
        "fuse": ((30 * F * N + 9 * H * W) * 4, F * N * 70),
    }
    roof = tiny_pipeline["roofline"]
    assert set(roof) == set(want)
    for name, (nbytes, flops) in want.items():
        assert roof[name]["min_hbm_gb"] == nbytes / 1e9
        assert roof[name]["gflops"] == flops / 1e9
        # a CPU run states no share of the card's peaks
        assert roof[name]["flops_frac"] is None
        assert roof[name]["membw_frac"] is None


def test_roofline_share_above_one_raises():
    counts = {"solve": (4e9, 1e9)}          # 4 GB in 1 ms: 4 TB/s
    with pytest.raises(AssertionError, match="counting fault"):
        tb.roofline(counts, {"solve": 1e-3}, "cuda")
    shares = tb.roofline(counts, {"solve": 1e-2}, "cuda")["solve"]
    assert shares["membw_frac"] == 4e9 / 1e-2 / tb.PEAK_HBM_BYTES
    assert shares["flops_frac"] == 1e9 / 1e-2 / tb.PEAK_F32_FLOPS


def test_closed_loop_short(tiny_loop):
    assert set(tiny_loop["ate_by_dispatch"]) == {5, 10}
    assert all(np.isfinite(a) and a < 0.2
               for a in tiny_loop["ate_by_dispatch"].values())
    assert set(tiny_loop["by_dispatch_ticks"]) == {5, 10}
    assert tiny_loop["ticks_per_sec"] > 0
    assert tiny_loop["host_roll_ticks_per_sec"] > 0


def test_closed_loop_failure_raises():
    # 3 ticks: not one roll, so never WORKING
    with pytest.raises(RuntimeError, match="no WORKING status"):
        tb.bench_closed_loop(duration=0.04, device="cpu")


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main([])
    out = subprocess.run([sys.executable, "scripts/torch_bench.py"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
