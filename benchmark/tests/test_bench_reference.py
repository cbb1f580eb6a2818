"""The plain reference against the port on the CPU, through the drivers'
functions (a short window of each drive path at the rpg preset's real
size: on the CPU the port runs its plain twins, so every number reads
0), and with the timed path broken underneath, each fault the cells can
have turns `correct` false."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import check as C
import harness as H

SECONDS = 3.0
_MAKE = H.make_stream


@functools.lru_cache(maxsize=None)
def _stream(name: str, seed: int):
    return _MAKE(H.load_cell(name), seed)


def drive(name: str, monkeypatch, seed: int = 4
          ) -> tuple[bool, dict, dict]:
    """One run of the cell on the CPU; (correct, numbers, the drive
    path's result)."""
    monkeypatch.setattr(H, "make_stream",
                        lambda cell, s: _stream(cell.name, s))
    cell = H.load_cell(name)
    driver = H.load_module(H.ROOT / "drivers"
                           / f"{cell.traffic['driver']}.py", "driver")
    ctx = H.Context(cell=cell, seed=seed, seconds=SECONDS, trace=False,
                    device=torch.device("cpu"), t_process=0.0)
    res = driver.run(ctx)
    assert res["attempted"] > 0
    correct, _ = C.verdict(res["numbers"], cell.workload["limits"])
    return correct and res["failed"] == 0, res["numbers"], res


CELLS = ["rpg.resident", "rpg.tick"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name, few_threads, monkeypatch):
    correct, numbers, _ = drive(name, monkeypatch)
    assert set(C.NUMBERS) <= set(numbers)
    assert all(v == 0.0 for v in numbers.values()), numbers
    assert correct


def _state_unchanged(monkeypatch):
    """The step returns the state it was given."""
    from esvo_tpu_torch.runtime.resident import ResidentLoop
    from esvo_tpu_torch.runtime.system import MappingCycle
    roll = ResidentLoop.roll
    monkeypatch.setattr(ResidentLoop, "roll", lambda self, st, inp: (
        st.map(torch.clone), roll(self, st, inp)[1]))
    render = MappingCycle.render_tick

    def frozen(self, st_l, st_r, ev_l, ev_r, t):
        out = render(self, st_l, st_r, ev_l, ev_r, t)
        return (st_l, st_r) + out[2:]
    monkeypatch.setattr(MappingCycle, "render_tick", frozen)


def _half_the_events(monkeypatch):
    """Half of each tick's events left out of the surfaces."""
    from esvo_tpu_torch.surface import time_surface as tsf
    insert = tsf.insert_events

    def half(state, ev):
        keep = torch.arange(ev.valid.shape[-1]) < ev.valid.shape[-1] // 2
        return insert(state, tsf.EventBatch(x=ev.x, y=ev.y, t=ev.t, p=ev.p,
                                            valid=ev.valid & keep))
    monkeypatch.setattr(tsf, "insert_events", half)


def _pose_altered(monkeypatch):
    """Each tracked pose moved by 1 cm where the tracker produces it."""
    from esvo_tpu_torch.tracking import registration as reg
    solve = reg.solve

    def moved(prob, camera, cfg):
        p, T, rms = solve(prob, camera, cfg)
        T = T.clone()
        T[0, 3] += 1e-2
        return p, T, rms
    monkeypatch.setattr(reg, "solve", moved)


def _pose_altered_on_mapping_ticks(monkeypatch):
    """The pose moved by 1 cm on mapping ticks only (one tick in five):
    the resident roll's last tick, the live path's ticks with a cycle."""
    from esvo_tpu_torch.runtime.resident import ResidentLoop
    from esvo_tpu_torch.runtime.system import EsvoSystem
    roll = ResidentLoop.roll

    def moved_roll(self, st, inp):
        new, out = roll(self, st, inp)
        at = 16 * (self.K - 1) + 3          # the last tick's x translation
        out = out.clone()
        out[at] += 1e-2
        T = new.T_world_cur.clone()
        T[0, 3] += 1e-2
        return new.replace(T_world_cur=T), out
    monkeypatch.setattr(ResidentLoop, "roll", moved_roll)
    tick = EsvoSystem.process_tick

    def moved_tick(self, *a, **kw):
        out = tick(self, *a, **kw)
        if "map_estimates" in out and kw.get("gt_pose") is None:
            self.T_world_cur = self.T_world_cur.copy()
            self.T_world_cur[0, 3] += 1e-2
        return out
    monkeypatch.setattr(EsvoSystem, "process_tick", moved_tick)


def _disparity_off_by_one(monkeypatch):
    """Block matching's disparity scan picks the disparity one above its
    best, where the program produces it."""
    from esvo_tpu_torch.mapping import block_matching as bm
    best_disparity = bm.best_disparity

    def off(ts_left, ts_right, ui, vi, dmin, dmax, *rest, **kw):
        best, cost, dark = best_disparity(ts_left, ts_right, ui, vi, dmin,
                                          dmax, *rest, **kw)
        return torch.clamp(best + 1, max=dmax - dmin), cost, dark
    monkeypatch.setattr(bm, "best_disparity", off)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_the_events": _half_the_events,
          "pose_altered": _pose_altered,
          "pose_altered_on_mapping_ticks": _pose_altered_on_mapping_ticks,
          "disparity_off_by_one": _disparity_off_by_one}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, few_threads,
                                            monkeypatch):
    FAULTS[fault](monkeypatch)
    correct, numbers, _ = drive(name, monkeypatch)
    assert not correct, numbers
    assert max(v for v in numbers.values() if np.isfinite(v)) > 0
