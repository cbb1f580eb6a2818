"""Device-resident closed loop (port of esvo_tpu/runtime/resident.py).

The host-driven ``EsvoSystem.process_ticks`` roll issues every small op
of the tracker and the mapping cycle from Python, thousands a tick, and
syncs poses to the host each roll. This module keeps the WHOLE
WORKING-state loop on the device, one roll at a time:

    per roll of K ticks:
        per tick: insert events -> render the left surface (K3)
            -> tracking LM -> device-side pose guard
            -> pose-table shift-append
        on the roll's last tick: render both surfaces (one K3 pair)
            -> mapping estimate (K1 pair, K2) -> history write at a
            device slot -> window fusion rebuild -> guarded ref-map
            publish (kept on the device)

The state lives in static buffers that ``ResidentLoop`` allocates once,
and ``roll`` is a plain function of (state, one roll's inputs, its
point-selection scores). On CUDA tensors the roll is captured once, as
one CUDA graph that writes the new state back into the buffers, after a
warm-up on a copy of the state; every roll is then a replay, and the
host reads back only poses and small counters (one copy per dispatch, in
``sync``). A failed capture or replay raises: nothing falls back to the
eager roll. On CPU tensors the same roll function runs eagerly (the CPU
tests). ``start``, ``run``, ``step`` and ``roll`` run under
utils/precision.py's ``highest_precision``, so the capture freezes full
float32 matmul kernels into the graph whatever the caller set.

Semantics preserved against the host-driven roll path:
- one-roll publish latency: the ref map rebuilt by roll r is first used
  by roll r+1's tracking (the reference's mapper -> tracker latency);
- the pose guard (rigidity + velocity plausibility + re-anchor
  recovery) is EsvoSystem.record_pose's, on the device;
- a collapsed mapping cycle keeps the last good ref map (REF_HISTORY
  fallback); the host degrades to INITIALIZATION when
  ``rolls_since_good`` exceeds the ref-history length
  (esvo_Tracking.cpp:163-168);
- the point selection draws the host path's scores: one
  ``EsvoSystem.draw_ref_scores`` a roll, in the same order, outside the
  graph.

The INITIALIZATION/bootstrap phase stays on the host path
(EsvoSystem._sgm_bootstrap): enter the resident loop once WORKING.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from esvo_tpu_torch.geometry.se3 import se3_inverse
from esvo_tpu_torch.mapping import depth_refinement as dr
from esvo_tpu_torch.mapping import fusion as fu
from esvo_tpu_torch.runtime.system import EsvoSystem, SystemStatus
from esvo_tpu_torch.surface import time_surface as tsf
from esvo_tpu_torch.utils.precision import highest_precision
from esvo_tpu_torch.utils.profiling import count, device_span, span


class TimestampDiscontinuity(RuntimeError):
    """``ResidentLoop.run`` met a tick time that goes back or jumps by
    0.5 s or more: the caller finishes the loop and lets the host path
    reset (a RuntimeError, as in the JAX package; a subclass, so a
    caller can catch it without catching CUDA errors)."""


# block-matching counters of the packed output, in match_events_stats'
# order
BM_KEYS = ("input", "out_of_bounds", "info_noise_low", "coarse_fail",
           "fine_fail", "matched")


def _leaves(obj) -> list[torch.Tensor]:
    """The tensors of a (nested) dataclass, in field order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for f in dataclasses.fields(obj)
            for t in _leaves(getattr(obj, f.name))]


def _tree_map(fn, obj):
    """A (nested) dataclass of fn(tensor) for each of its tensors."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return type(obj)(**{f.name: _tree_map(fn, getattr(obj, f.name))
                        for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class ResidentState:
    """The complete device-side WORKING-loop state."""
    ts_left: tsf.TimeSurfaceState
    ts_right: tsf.TimeSurfaceState
    pose_times: torch.Tensor      # (S,) strictly increasing, newest last
    pose_tab: torch.Tensor        # (S, 4, 4)
    T_world_cur: torch.Tensor     # (4, 4)
    T_world_prev: torch.Tensor    # (4, 4) previous ACCEPTED pose (the
    #                               constant-velocity prior's anchor)
    T_world_frame: torch.Tensor   # (4, 4) frame of the current ref map
    history: dr.DepthEstimates    # (F, N, ...)
    hist_slot: torch.Tensor       # int64 scalar
    grid: fu.DepthGrid            # of the latest rebuilt frame
    ref_pts: torch.Tensor         # (H, W, 3) ref map in world coords
    ref_ok: torch.Tensor          # (H, W) bool
    rolls_since_good: torch.Tensor  # int32
    consec_rejects: torch.Tensor  # int32 (velocity-guard re-anchor counter)
    num_rejects: torch.Tensor     # int32 accumulated tracking rejections

    def replace(self, **kw) -> "ResidentState":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "ResidentState":
        return _tree_map(fn, self)

    def tensors(self) -> list[torch.Tensor]:
        return _leaves(self)

    def copy_(self, other: "ResidentState") -> "ResidentState":
        """Write other's values into this state's tensors in place."""
        for dst, src in zip(self.tensors(), other.tensors()):
            dst.copy_(src)
        return self


@dataclasses.dataclass
class RollInputs:
    """One roll's inputs: K ticks of (K, capacity) events per camera, the
    tick times and the point-selection scores."""
    ev_left: tsf.EventBatch
    ev_right: tsf.EventBatch
    t_syncs: torch.Tensor         # (K,) float32
    scores: torch.Tensor          # (H*W,)

    def tensors(self) -> list[torch.Tensor]:
        return _leaves(self)


def _det3(R):
    return (R[0, 0] * (R[1, 1] * R[2, 2] - R[1, 2] * R[2, 1])
            - R[0, 1] * (R[1, 0] * R[2, 2] - R[1, 2] * R[2, 0])
            + R[0, 2] * (R[1, 0] * R[2, 1] - R[1, 1] * R[2, 0]))


def _guard_append(T_est, T_cur, t_k, ptimes, ptab, consec, nrej, tr_cfg):
    """Device-side EsvoSystem.record_pose: rigidity + velocity
    plausibility with re-anchor recovery; on accept, shift-append into
    the fixed-size stamped-pose table. Returns
    (T_new, ptimes, ptab, consec, nrej, accepted)."""
    dt = T_est.dtype
    R = T_est[:3, :3]
    eye = torch.eye(3, dtype=dt, device=T_est.device)
    finite = torch.all(torch.isfinite(T_est))
    RRt = torch.matmul(R, R.T)
    rigid = (finite
             & (torch.abs(_det3(R) - 1.0) < 0.05)
             & (torch.sqrt(torch.sum((RRt - eye) ** 2)) < 0.05))
    dt_s = torch.clamp(t_k - ptimes[-1],
                       min=1.0 / tr_cfg.tracking_rate_hz).to(dt)
    dist = torch.linalg.vector_norm(T_est[:3, 3] - T_cur[:3, 3])
    dR = torch.matmul(T_cur[:3, :3].T, R)
    ang = torch.arccos(torch.clamp((torch.trace(dR) - 1.0) / 2.0, -1.0, 1.0))
    too_fast = ((dist > tr_cfg.max_speed_mps * dt_s + 0.01)
                | (ang > tr_cfg.max_ang_speed_rps * dt_s + 0.02))
    force = consec >= tr_cfg.max_consecutive_rejects
    accept = rigid & (~too_fast | force)
    consec = torch.where(accept, 0,
                         torch.where(rigid & too_fast, consec + 1, consec))
    nrej = nrej + (~accept).to(nrej.dtype)
    T_new = torch.where(accept, T_est, T_cur)
    ptimes = torch.where(
        accept, torch.cat([ptimes[1:], t_k[None].to(ptimes.dtype)]), ptimes)
    ptab = torch.where(
        accept, torch.cat([ptab[1:], T_new[None].to(ptab.dtype)]), ptab)
    return T_new, ptimes, ptab, consec, nrej, accept


def _tick(ev: tsf.EventBatch, k: int) -> tsf.EventBatch:
    return tsf.EventBatch(x=ev.x[k], y=ev.y[k], t=ev.t[k], p=ev.p[k],
                          valid=ev.valid[k])


def out_width(K: int) -> int:
    """Length of one roll's packed output (``ResidentLoop.roll``)."""
    return 16 * K + 2 * K + 4 + len(BM_KEYS)


def unpack(row: np.ndarray, K: int) -> dict:
    """One roll's packed output as a dict: K guarded poses, the last LM
    round's rms and the guard's accept flag of each tick, and the mapping
    cycle's counters."""
    row = np.asarray(row, np.float64)
    at = [0]

    def take(n):
        v = row[at[0]:at[0] + n]
        at[0] += n
        return v

    out = dict(poses=take(16 * K).reshape(K, 4, 4), rms=take(K),
               accepted=take(K) > 0.5)
    out.update(zip(("n_est", "map_points", "nf", "nd"),
                   take(4).astype(np.int64)))
    out["bm"] = dict(zip(BM_KEYS, take(len(BM_KEYS)).astype(np.int64)))
    return out


class ResidentLoop:
    """Owns the device-resident state while the system is WORKING.

    Usage:
        loop = ResidentLoop(system, ticks_per_roll=5, rolls_per_dispatch=2)
        loop.start()
        for batch in ...:
            out = loop.run(t_syncs, ev_left, ev_right)   # R rolls
            loop.sync()          # fold outputs into host mirrors
        loop.finish()            # hand state back to the EsvoSystem

    `run` does not synchronize (it returns device handles); `sync`
    converts pending outputs into the system's trajectory / stats and
    refreshes the host mirrors (grid, T_world_frame, T_world_cur). World
    corrections applied through `EsvoSystem.apply_world_correction` while
    the loop is live are mirrored into the device state (observer hook).
    """

    def __init__(self, system: EsvoSystem, ticks_per_roll: int,
                 rolls_per_dispatch: int, pose_table_size: int = 256):
        if getattr(system, "mesh", None) is not None:
            raise NotImplementedError(
                "resident loop currently targets a single chip; use the "
                "host roll path with mesh sharding")
        self.system = system
        self.K = int(ticks_per_roll)
        self.R = int(rolls_per_dispatch)
        self.S = int(pose_table_size)
        dev, dt = system.device, system.dtype
        H, W, S = system.H, system.W, self.S
        z = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype,
                                                 device=dev)
        self.state = ResidentState(
            ts_left=tsf.init_state(H, W, dev),
            ts_right=tsf.init_state(H, W, dev),
            pose_times=z(S), pose_tab=z(S, 4, 4), T_world_cur=z(4, 4),
            T_world_prev=z(4, 4), T_world_frame=z(4, 4),
            history=system.history.map(torch.zeros_like),
            hist_slot=z(dtype=torch.int64), grid=fu.empty_grid(H, W, dt, dev),
            ref_pts=z(H, W, 3), ref_ok=z(H, W, dtype=torch.bool),
            rolls_since_good=z(dtype=torch.int32),
            consec_rejects=z(dtype=torch.int32),
            num_rejects=z(dtype=torch.int32))
        # the roll's static inputs, allocated at the first stage() (their
        # event capacity comes with the data)
        self.inputs: RollInputs | None = None
        self._out = z(out_width(self.K), dtype=torch.float64)
        self._cuda = dev.type == "cuda"
        self._graph = None
        self._staging: list = []
        self._flip = 0
        self.warmup_ms: float | None = None
        self.capture_ms: float | None = None
        self._pending: list = []
        self._started = False

    # ------------------------------------------------------------------
    @highest_precision()
    def roll(self, st: ResidentState, inp: RollInputs):
        """One WORKING roll of K ticks as a plain function of the state
        and the roll's inputs (the JAX package's ``one_roll``). Returns
        (the new state, the packed (out_width(K),) float64 output); `st`
        is left as it was."""
        system = self.system
        cycle, cfg, dt = system.cycle, system.cfg, system.dtype
        tr_node = cfg.tracking
        # the map is fixed across the roll: select once, move the points
        # to the ref frame once
        pts, ok = system.select_from_scores(st.ref_pts, st.ref_ok,
                                            inp.scores)
        T_world_ref = st.T_world_frame
        p_ref = torch.einsum("ji,nj->ni", T_world_ref[:3, :3],
                             pts - T_world_ref[:3, 3])
        T_ref_world = se3_inverse(T_world_ref)
        ts_l, ts_r = st.ts_left, st.ts_right
        T_cur, T_prev = st.T_world_cur, st.T_world_prev
        ptimes, ptab = st.pose_times, st.pose_tab
        consec, nrej = st.consec_rejects, st.num_rejects
        poses, rms, accepted = [], [], []
        for k in range(self.K):
            t_k = inp.t_syncs[k]
            if tr_node.constant_velocity_prior:
                # initial guess = last ACCEPTED step extrapolated once
                # (left-delta); identity while frozen
                step = torch.matmul(T_cur, se3_inverse(T_prev))
                guess = torch.matmul(step, T_cur)
            else:
                guess = T_cur
            ts_l, ts_r, _, T_est, rms_k = system._track_tick_body(
                ts_l, ts_r, _tick(inp.ev_left, k), _tick(inp.ev_right, k),
                t_k, T_world_ref, T_ref_world, p_ref, ok, guess)
            T_new, ptimes, ptab, consec, nrej, acc = _guard_append(
                T_est.to(dt), T_cur, t_k, ptimes, ptab, consec, nrej,
                tr_node)
            T_prev = torch.where(acc, T_cur, T_prev)
            T_cur = T_new
            poses.append(T_new)
            rms.append(rms_k[-1])
            accepted.append(acc)

        # ---- the mapping cycle on the roll's final tick ----
        s_l, s_r = cycle.render_pair(ts_l, ts_r, inp.t_syncs[-1])
        last = _tick(inp.ev_left, self.K - 1)
        est, n_est, bm_stats = cycle.mapping_estimate(
            s_l.to(dt), s_r.to(dt), last.x, last.y, last.t.to(dt),
            last.valid, ptimes, ptab, T_cur)
        history = cycle.write_history(st.history, est, st.hist_slot)
        grid, pts_world, occ, nf, nd = cycle.rebuild_frame(history, T_cur)
        n_pts = torch.sum(occ)
        # ref-map publish: keep the last good map when this cycle
        # collapsed (REF_HISTORY fallback)
        good = n_pts >= cfg.tracker.batch_size
        rolls_since_good = torch.where(good, 0, st.rolls_since_good + 1)
        new = ResidentState(
            ts_left=ts_l, ts_right=ts_r, pose_times=ptimes, pose_tab=ptab,
            T_world_cur=T_cur, T_world_prev=T_prev,
            T_world_frame=torch.where(good, T_cur, st.T_world_frame),
            history=history, hist_slot=(st.hist_slot + 1) % system.F,
            grid=grid, ref_pts=torch.where(good, pts_world, st.ref_pts),
            ref_ok=torch.where(good, occ, st.ref_ok),
            rolls_since_good=rolls_since_good, consec_rejects=consec,
            num_rejects=nrej)
        counters = [n_est, n_pts, nf, nd] + [bm_stats[k] for k in BM_KEYS]
        f64 = torch.float64
        out = torch.cat([torch.stack(poses).reshape(-1).to(f64),
                         torch.stack(rms).to(f64),
                         torch.stack(accepted).to(f64),
                         torch.stack([c.to(f64) for c in counters])])
        return new, out

    def _roll_into_buffers(self) -> None:
        """The body a graph captures: roll, then write the new state and
        the packed output back into the static buffers."""
        new, out = self.roll(self.state, self.inputs)
        self.state.copy_(new)
        self._out.copy_(out)

    def _capture(self) -> None:
        """Warm up on a copy of the state (filling every lazy cache:
        kernel plans, cached constants, library handles), then capture one
        roll. Errors propagate; nothing runs eagerly in the graph's
        place."""
        with span("resident.capture"):
            t0 = time.perf_counter()
            side = torch.cuda.Stream(device=self.system.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.roll(self.state.map(torch.clone), self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._roll_into_buffers()
            torch.cuda.synchronize()
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3
        self._graph = graph
        count("graph.captures")

    @highest_precision()
    def step(self) -> torch.Tensor:
        """One roll on the staged inputs: a replay of the captured graph
        on the card (captured at the first step), the roll function
        eagerly on the CPU. Returns the packed output buffer (overwritten
        by the next step)."""
        with span("resident.step"):
            count("resident.ticks", self.K)
            if not self._cuda:
                self._roll_into_buffers()
                return self._out
            if self._graph is None:
                self._capture()
            with device_span("resident.replay"):
                self._graph.replay()
            count("resident.replays")
            return self._out

    # ------------------------------------------------------------------
    def _arrays(self, t_syncs, ev_left: dict, ev_right: dict) -> list:
        """One roll's inputs as numpy arrays in RollInputs' leaf order."""
        out = []
        for ev in (ev_left, ev_right):
            p = np.asarray(ev["p"], bool)
            out += [np.asarray(ev["x"], np.int32),
                    np.asarray(ev["y"], np.int32),
                    np.asarray(ev["t"], np.float32), p,
                    np.asarray(ev.get("valid", np.ones_like(p)), bool)]
        return out + [np.asarray(t_syncs, np.float32)]

    def stage(self, t_syncs, ev_left: dict, ev_right: dict,
              scores: torch.Tensor | None = None) -> None:
        """Put one roll's K ticks into the static inputs and draw its
        scores from the system's generator (or take `scores` (H*W,)). On
        the card the events go through pinned staging buffers by
        non-blocking copies; the two staging sets alternate, and a set is
        refilled only once its last copy has finished."""
        with span("resident.stage"):
            system = self.system
            with span("resident.stage.arrays"):
                arrays = self._arrays(t_syncs, ev_left, ev_right)
            if self.inputs is None:
                dev = system.device
                leaf = lambda a: torch.empty(
                    a.shape, dtype=torch.from_numpy(a).dtype, device=dev)
                self.inputs = RollInputs(
                    ev_left=tsf.EventBatch(*map(leaf, arrays[:5])),
                    ev_right=tsf.EventBatch(*map(leaf, arrays[5:10])),
                    t_syncs=leaf(arrays[10]),
                    scores=torch.empty(system.H * system.W, device=dev))
                if self._cuda:
                    self._staging = [
                        ([torch.empty(a.shape,
                                      dtype=torch.from_numpy(a).dtype,
                                      pin_memory=True) for a in arrays],
                         torch.cuda.Event()) for _ in range(2)]
            dst = self.inputs.tensors()[:-1]
            for d, a in zip(dst, arrays):
                if tuple(d.shape) != a.shape:
                    raise ValueError(f"roll input of shape {a.shape}, the "
                                     f"static buffer is {tuple(d.shape)}")
            if self._cuda:
                pinned, ready = self._staging[self._flip]
                self._flip ^= 1
                with span("resident.stage.wait"):
                    ready.synchronize()
                with span("resident.stage.copy"):
                    for d, p, a in zip(dst, pinned, arrays):
                        np.copyto(p.numpy(), a)
                        d.copy_(p, non_blocking=True)
                    ready.record()
            else:
                with span("resident.stage.copy"):
                    for d, a in zip(dst, arrays):
                        d.copy_(torch.from_numpy(a))
            with span("resident.stage.scores"):
                self.inputs.scores.copy_(system.draw_ref_scores()
                                         if scores is None else scores)

    # ------------------------------------------------------------------
    def _correct_body(self, state: ResidentState, corr) -> ResidentState:
        """Mirror EsvoSystem.apply_world_correction into the device
        state: left-multiply every world-frame quantity."""
        cj = torch.as_tensor(np.asarray(corr), dtype=self.system.dtype,
                             device=state.T_world_cur.device)

        def mul(T):
            return torch.matmul(cj, T)

        return state.replace(
            T_world_cur=mul(state.T_world_cur),
            T_world_prev=mul(state.T_world_prev),
            T_world_frame=mul(state.T_world_frame),
            pose_tab=torch.einsum("ij,sjk->sik", cj, state.pose_tab),
            ref_pts=torch.einsum("ij,hwj->hwi", cj[:3, :3], state.ref_pts)
            + cj[:3, 3],
            history=state.history.replace(T_world_cam=torch.einsum(
                "ij,fnjk->fnik", cj, state.history.T_world_cam)))

    @highest_precision()
    def start(self):
        """Copy the system's host state into the static buffers. The
        system must be WORKING with a usable ref map."""
        system = self.system
        system.flush()
        if system.status != SystemStatus.WORKING:
            raise RuntimeError("resident loop requires WORKING status "
                               "(bootstrap on the host path first)")
        ref = system._current_ref_map()
        if ref is None:
            raise RuntimeError("no reference map available")
        S = self.S
        times = np.asarray(system.pose_times[-S:], np.float64)
        poses = np.asarray(system.pose_list[-S:])
        n = len(times)
        if n < S:
            # pad at the FRONT with the oldest pose at strictly
            # decreasing earlier times (the table shift-appends at the
            # back; interpolation clamps below the oldest entry)
            pad_t = times[0] - 1e-4 * np.arange(S - n, 0, -1)
            times = np.concatenate([pad_t, times])
            poses = np.concatenate(
                [np.repeat(poses[:1], S - n, axis=0), poses])
        T_prev = (system.pose_list[-2] if len(system.pose_list) > 1
                  else system.T_world_cur)
        scalar = lambda v, dtype: torch.tensor(v, dtype=dtype)
        self.state.copy_(ResidentState(
            ts_left=system.ts_state_left, ts_right=system.ts_state_right,
            pose_times=system._tensor(times), pose_tab=system._tensor(poses),
            T_world_cur=system._tensor(system.T_world_cur),
            T_world_prev=system._tensor(T_prev),
            T_world_frame=system._tensor(system.T_world_frame),
            history=system.history,
            hist_slot=scalar(system.cycle.hist_slot, torch.int64),
            grid=system.grid,
            ref_pts=ref[0].reshape(system.H, system.W, 3),
            ref_ok=ref[1].reshape(system.H, system.W),
            rolls_since_good=scalar(0, torch.int32),
            consec_rejects=scalar(system._consec_rejects, torch.int32),
            num_rejects=scalar(0, torch.int32)))
        system._world_correction_observers.append(self._on_world_correction)
        self._started = True

    def _on_world_correction(self, corr):
        self.state.copy_(self._correct_body(self.state, corr))

    # ------------------------------------------------------------------
    @highest_precision()
    def run(self, t_syncs, ev_left: dict, ev_right: dict) -> dict:
        """Process R*K ticks: R rolls, each a graph replay on the card.

        t_syncs: (R*K,) tick times; ev_left / ev_right: dicts of framed
        event arrays with leading dim R*K (io.events.frame_events).
        Returns the dispatch's device outputs (also queued for `sync`):
        the (R, out_width(K)) packed output ring and the left surface at
        the last tick."""
        if not self._started:
            raise RuntimeError("call start() first")
        t_syncs = np.asarray(t_syncs, np.float64)
        K, RK = self.K, self.R * self.K
        if len(t_syncs) != RK:
            raise ValueError(f"expected {RK} ticks, got {len(t_syncs)}")
        # timestamp watchdog (esvo_Mapping.cpp:611-628): the resident
        # loop has no reset path — the caller must drop to the host loop
        # across stream discontinuities
        prev = self.system.last_tick_time
        dts = np.diff(np.concatenate(
            [[prev] if prev is not None else [], t_syncs]))
        if len(dts) and ((dts < 0).any() or (dts >= 0.5).any()):
            raise TimestampDiscontinuity(
                "timestamp discontinuity: exit the resident loop and reset "
                "on the host path")
        with span("resident.run"):
            ring = torch.empty((self.R, self._out.numel()),
                               dtype=torch.float64, device=self._out.device)
            for r in range(self.R):
                sl = slice(r * K, (r + 1) * K)
                pick = lambda ev: {k: np.asarray(v)[sl]
                                   for k, v in ev.items()}
                self.stage(t_syncs[sl], pick(ev_left), pick(ev_right))
                ring[r].copy_(self.step())
            system = self.system
            with span("resident.render"):
                s_l = system.cycle.render_left(self.state.ts_left,
                                               self.inputs.t_syncs[-1]).to(
                    system.dtype)
        system.last_tick_time = float(t_syncs[-1])
        out = {"t_syncs": t_syncs, "outs": ring, "ts_left": s_l}
        self._pending.append(out)
        return out

    def sync(self) -> dict:
        """Convert pending dispatch outputs into host state: trajectory,
        stats, and the host mirrors (grid / T_world_frame /
        T_world_cur). Returns a process_ticks-style summary dict for the
        LAST pending dispatch (empty if none)."""
        with span("resident.sync"):
            system = self.system
            summary: dict = {}
            for p in self._pending:
                with span("resident.sync.read"):
                    outs = p["outs"].cpu().numpy()
                # the ring, and rolls_since_good in the summary below
                count("host_reads", 2)
                rolls = [unpack(row, self.K) for row in outs]
                poses = np.concatenate([r["poses"] for r in rolls])
                for i, t in enumerate(p["t_syncs"]):
                    system.traj_times.append(float(t))
                    system.traj_poses.append(poses[i])
                last = rolls[-1]
                map_points = int(last["map_points"])
                system.stats["map_points"] = map_points
                bm_sum = {k: int(sum(r["bm"][k] for r in rolls))
                          for k in BM_KEYS}
                system.stats["bm"] = {
                    k: system.stats["bm"].get(k, 0) + v
                    for k, v in bm_sum.items()}
                system.stats["fusions"] += int(sum(r["nf"] for r in rolls))
                system.stats["dropped"] += int(sum(r["nd"] for r in rolls))
                summary = {
                    "t": float(p["t_syncs"][-1]),
                    "status": system.status.value,
                    "n_cycles": self.R,
                    "poses": poses,
                    "map_points": map_points,
                    "map_estimates": int(last["n_est"]),
                    "bm_stats": bm_sum,
                    "tracking_rms": np.concatenate([r["rms"]
                                                    for r in rolls]),
                    "accepted": np.concatenate([r["accepted"]
                                                for r in rolls]),
                    "rolls_since_good": int(self.state.rolls_since_good),
                    "ts_left": p["ts_left"],
                }
            self._pending = []
            if summary:
                # the host mirrors come from the live state, which a world
                # correction made after `run` has already moved
                st = self.state
                # num_rejects counts since the last sync's reset
                system.stats["tracking_rejects"] += int(st.num_rejects)
                st.num_rejects.zero_()
                host = lambda T: T.cpu().double().numpy()
                system.T_world_cur = host(st.T_world_cur)
                system.T_world_frame = host(st.T_world_frame)
                count("host_reads", 3)      # num_rejects, the two poses
                # a copy: the state's grid is overwritten by the next
                # roll, and host consumers (keyframe sampling, debug maps)
                # must stay readable after it
                system.grid = _tree_map(torch.clone, self.state.grid)
                # degrade check: every recent cycle collapsed -> the host
                # must re-bootstrap (esvo_Tracking.cpp:163-168)
                if summary["rolls_since_good"] > \
                        system.cfg.tracking.ref_history_length:
                    summary["degraded"] = True
            return summary

    def finish(self):
        """Drain outputs and hand copies of the state back to the
        EsvoSystem so the host path (bootstrap, checkpointing, exports) can
        resume."""
        summary = self.sync()
        system = self.system
        st = self.state.map(torch.clone)
        system.ts_state_left = st.ts_left
        system.ts_state_right = st.ts_right
        system.history = st.history
        system.cycle.hist_slot = int(st.hist_slot)
        system._frames_filled = system.F
        system.grid = st.grid
        system.T_world_cur = st.T_world_cur.cpu().double().numpy()
        system.T_world_frame = st.T_world_frame.cpu().double().numpy()
        system._consec_rejects = int(st.consec_rejects)
        # pose table: device ring back to host lists
        times = st.pose_times.cpu().double().numpy()
        poses = st.pose_tab.cpu().double().numpy()
        keep = times > (system.pose_times[-1] if system.pose_times
                        else -np.inf)
        system.pose_times.extend(times[keep].tolist())
        system.pose_list.extend(list(poses[keep]))
        # publish the final ref map into the host REF_HISTORY ring
        n_pts = int(torch.sum(st.ref_ok))
        system._map_pts = st.ref_pts
        system._map_ok = st.ref_ok
        system._push_ref_map(st.ref_pts, st.ref_ok, n_pts)
        system.stats["map_points"] = n_pts
        obs = system._world_correction_observers
        if self._on_world_correction in obs:
            obs.remove(self._on_world_correction)
        self._started = False
        return summary
