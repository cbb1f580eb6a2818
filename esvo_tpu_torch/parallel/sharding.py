"""Event-axis sharding over a torch.distributed process group (port of
esvo_tpu/parallel/sharding.py).

The JAX package runs one controller and splits global arrays over a
device mesh with ``shard_map``. The port runs SPMD: one process a rank
(``run_ranks`` starts them), each running the same program on the same
replicated inputs. A sharded function takes its rank's contiguous block
of the sharded axis (rank r of `world` gets ``[r*n/world,
(r+1)*n/world)``, the split ``P(EVENT_AXIS)`` makes) and returns
replicated results on every rank; a collective stands in for each
``pmax`` / ``psum`` / all-gather:

- time-surface update: each rank scatters its block of events into a
  local copy of the grids, and the grids merge with an elementwise MAX
  all-reduce (scatter-max is associative: the result equals the serial
  insert bit for bit);
- mapping (block matching + depth LM): each rank matches and refines its
  block of events (kernels K1 and K2 on the card), and the estimates are
  all-gathered;
- tracking Gauss-Newton: each rank's J^T J, J^T f and cost are
  SUM-all-reduced, and the damped 6x6 solve runs replicated;
- bundle adjustment and pose graph: the observation (edge) axis is
  sharded, every segment sum is SUM-all-reduced
  (``bundle_adjust(group=)``, ``optimize_pose_graph(group=)``).

Everything else stays replicated, and bit-identical across ranks: all
ranks compute it from the same inputs in the same order.

Backends: ``nccl`` for CUDA ranks (one card each), ``gloo`` for CPU
ranks, and ``gloo`` over CUDA tensors only when the caller names it (two
ranks may then share one card).

Every collective issued here or through ``ops/linalg.py::psum`` adds the
bytes of its result to ``COLLECTIVE_BYTES`` (by op, "all-gather" and
"all-reduce"): the sum of output shapes that the JAX package's
scripts/bench_scaling.py parses from its compiled HLO, counted where the
port sends it (scripts/torch_bench_scaling.py reads it).
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from esvo_tpu_torch.backend import bundle_adjustment as ba
from esvo_tpu_torch.backend import pose_graph as pg
from esvo_tpu_torch.geometry.camera import Camera, StereoRig
from esvo_tpu_torch.mapping import block_matching as bm
from esvo_tpu_torch.mapping import depth_refinement as dr
from esvo_tpu_torch.ops.linalg import psum, solve_spd
from esvo_tpu_torch.surface import time_surface as tsf
from esvo_tpu_torch.tracking import registration as reg
from esvo_tpu_torch.utils.precision import highest_precision

EVENT_AXIS = "ev"


# bytes of the results of this process's collectives, by op (each rank
# counts its own; a reader clears it)
COLLECTIVE_BYTES: dict[str, int] = {}


def _count(op: str, nbytes: int) -> None:
    COLLECTIVE_BYTES[op] = COLLECTIVE_BYTES.get(op, 0) + nbytes


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``dist.all_reduce`` of x in place over `group`, its bytes counted."""
    _count("all-reduce", x.numel() * x.element_size())
    dist.all_reduce(x, op=op, group=group)
    return x


# ---------------------------------------------------------------------------
# the mesh and its blocks
# ---------------------------------------------------------------------------

def make_mesh(n_devices: int | None = None) -> DeviceMesh:
    """The 1-D mesh named EVENT_AXIS over the process group that is
    already up (``run_ranks`` starts one). Raises where there is no
    group, or where its size differs from `n_devices`. The mesh's device
    type names the backend's home: cuda for NCCL, cpu for gloo (whose
    ranks may still pass CUDA tensors)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the "
                           "ranks with run_ranks (or init_process_group)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(EVENT_AXIS,))


def check_mesh(mesh) -> DeviceMesh:
    """`mesh` itself if it is a 1-D DeviceMesh, else TypeError."""
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(f"mesh must be a 1-D torch.distributed DeviceMesh "
                        f"(make_mesh), got {mesh!r}")
    return mesh


def _block(mesh: DeviceMesh, n: int) -> slice:
    """This rank's contiguous block of a sharded axis of length n."""
    world = mesh.size()
    if n % world:
        raise ValueError(f"the sharded axis ({n}) must be divisible by the "
                         f"mesh size {world} (pad it with invalid lanes)")
    size = n // world
    rank = mesh.get_local_rank()
    return slice(rank * size, (rank + 1) * size)


def _all_gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's block of x, concatenated in rank order (bool tensors
    travel as uint8)."""
    send = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size())]
    _count("all-gather", mesh.size() * send.numel() * send.element_size())
    dist.all_gather(parts, send, group=mesh.get_group())
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def pad_events(mesh: DeviceMesh, ev: tsf.EventBatch) -> tsf.EventBatch:
    """ev with valid=False lanes appended up to a multiple of the mesh
    size (an insert ignores them)."""
    pad = (-ev.x.shape[0]) % mesh.size()
    if not pad:
        return ev
    return tsf.EventBatch(**{
        k: torch.cat([a, a.new_zeros(pad)])
        for k, a in dataclasses.asdict(ev).items()})


# ---------------------------------------------------------------------------
# the sharded programs (JAX's signatures, mesh first)
# ---------------------------------------------------------------------------

def sharded_surface_update(mesh: DeviceMesh, state: tsf.TimeSurfaceState,
                           ev: tsf.EventBatch) -> tsf.TimeSurfaceState:
    """Scatter-max the event timestamps with the event axis sharded: a
    local insert of this rank's block, then a MAX all-reduce of both
    grids. Equals the serial insert_events bit for bit."""
    sl = _block(check_mesh(mesh), ev.x.shape[0])
    local = tsf.insert_events(state, tsf.EventBatch(
        x=ev.x[sl], y=ev.y[sl], t=ev.t[sl], p=ev.p[sl], valid=ev.valid[sl]))
    for grid in (local.last_t_pos, local.last_t_neg):
        all_reduce(grid, dist.ReduceOp.MAX, mesh.get_group())
    return local


def sharded_depth_solve(mesh: DeviceMesh, rig: StereoRig,
                        cfg: dr.DepthProblemConfig):
    """Returns fn(matches_x, T_wv, T_lv, d_init, valid, t, ts_l, ts_r) ->
    DepthEstimates (N,), replicated: dr.solve on this rank's block of
    events (kernels K1 and K2 on the card), all-gathered. The mapping
    cycle of EsvoSystem(mesh=...), whose block matching stays
    replicated."""
    check_mesh(mesh)

    def fn(matches_x, T_wv, T_lv, d_init, valid, t, ts_l, ts_r):
        sl = _block(mesh, matches_x.shape[0])
        est = dr.solve(matches_x[sl], T_wv[sl], T_lv[sl], d_init[sl],
                       valid[sl], t[sl], ts_l, ts_r, rig, cfg)
        return est.map(lambda a: _all_gather(a, mesh))

    return fn


def sharded_map_estimate(mesh: DeviceMesh, rig: StereoRig,
                         bm_cfg: bm.BlockMatchConfig,
                         dp_cfg: dr.DepthProblemConfig):
    """Returns fn(ts_l, ts_r, x_rect, t, valid, T_wv, T_lv) ->
    DepthEstimates (N,), replicated: block matching and the depth LM on
    this rank's block of events (kernels K1 and K2 on the card), then an
    all-gather of every estimate field."""
    check_mesh(mesh)

    def fn(ts_l, ts_r, x_rect, t, valid, T_wv, T_lv):
        sl = _block(mesh, x_rect.shape[0])
        x, tt, v = x_rect[sl], t[sl], valid[sl]
        matches = bm.match_events(ts_l, ts_r, x, x, tt, v, rig.left.mask,
                                  rig, bm_cfg)
        est = dr.solve(matches.x_left, T_wv[sl], T_lv[sl],
                       matches.inv_depth, matches.valid, tt, ts_l, ts_r,
                       rig, dp_cfg)
        return est.map(lambda a: _all_gather(a, mesh))

    return fn


def sharded_tracking_step(mesh: DeviceMesh, camera: Camera,
                          cfg: reg.RegProblemConfig):
    """Returns fn(R, t, T_world_ref, ts_neg, grad_u, grad_v, points,
    valid) -> (dx (6,), cost): this rank's block of points gives its
    J^T J, J^T f and cost, SUM-all-reduced; the damped 6x6 solve runs
    replicated, and a non-finite step becomes 0."""
    check_mesh(mesh)

    @highest_precision()
    def fn(R, t, T_world_ref, ts_neg, gu, gv, pts, ok):
        sl = _block(mesh, pts.shape[0])
        pts, ok = pts[sl], ok[sl]
        prob = reg.RegProblem(R=R, t=t, T_world_ref=T_world_ref,
                              points=pts, point_valid=ok, ts_negative=ts_neg,
                              grad_u=gu, grad_v=gv)
        zero = torch.zeros(6, dtype=R.dtype, device=R.device)
        fvec, _, _ = reg.residuals_and_weights(prob, zero, pts, ok, camera,
                                               cfg)
        # the serial solver's dispatch (registration.solve)
        if cfg.use_numerical_diff or cfg.patch_size_x * cfg.patch_size_y > 1:
            J = reg.numerical_jacobian(prob, pts, ok, camera, cfg)
        else:
            J = reg.analytic_jacobian(prob, pts, ok, camera, cfg)
        f = fvec.reshape(-1)
        group = mesh.get_group()
        H = psum(torch.matmul(J.T, J), group)
        g = psum(torch.matmul(J.T, f), group)
        cost = psum(torch.sum(f * f), group)
        damp = cfg.lm_damping * torch.diag(torch.diag(H)) \
            + 1e-12 * torch.eye(6, dtype=R.dtype, device=R.device)
        dx = -solve_spd(H + damp, g)
        return torch.where(torch.isfinite(dx), dx, 0.0), cost

    return fn


def pad_observations(mesh: DeviceMesh,
                     prob: ba.BAProblem) -> ba.BAProblem:
    """prob with obs_valid=False observations appended up to a multiple
    of the mesh size."""
    pad = (-prob.obs_kf.shape[0]) % mesh.size()
    if not pad:
        return prob
    grow = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    return prob.replace(obs_kf=grow(prob.obs_kf),
                        obs_point=grow(prob.obs_point),
                        obs_uv=grow(prob.obs_uv),
                        obs_valid=grow(prob.obs_valid))


def _obs_block(prob: ba.BAProblem, sl: slice) -> ba.BAProblem:
    return prob.replace(obs_kf=prob.obs_kf[sl], obs_point=prob.obs_point[sl],
                        obs_uv=prob.obs_uv[sl], obs_valid=prob.obs_valid[sl])


def sharded_bundle_adjust(mesh: DeviceMesh, cfg: ba.BAConfig):
    """Returns run(BAProblem) -> (problem, costs): the LM-damped Schur BA
    with the observation axis sharded (this rank's block of
    observations; every segment sum all-reduced). Poses and points stay
    replicated. The observation count must be a multiple of the mesh
    size: pad with obs_valid=False."""
    check_mesh(mesh)

    def run(prob: ba.BAProblem):
        local = _obs_block(prob, _block(mesh, prob.obs_kf.shape[0]))
        out, costs = ba.bundle_adjust(local, cfg, group=mesh.get_group())
        return prob.replace(T_world_kf=out.T_world_kf,
                            points=out.points), costs

    return run


def sharded_ba_normal_equations(mesh: DeviceMesh, cfg: ba.BAConfig):
    """Returns fn(T_kf, points, obs_kf, obs_point, obs_uv, obs_valid, fx,
    fy, cx, cy) -> (B, C, gc, gp): the BA normal-equation blocks of this
    rank's observations (ba.assemble_normal_equations), all-reduced."""
    check_mesh(mesh)

    def fn(T_kf, points, obs_kf, obs_point, obs_uv, obs_valid, fx, fy, cx,
           cy):
        prob = ba.BAProblem(T_world_kf=T_kf, points=points, obs_kf=obs_kf,
                            obs_point=obs_point, obs_uv=obs_uv,
                            obs_valid=obs_valid, fx=fx, fy=fy, cx=cx, cy=cy)
        local = _obs_block(prob, _block(mesh, obs_kf.shape[0]))
        B, C, gc, gp, _, _ = ba.assemble_normal_equations(
            local, cfg, group=mesh.get_group())
        return B, C, gc, gp

    return fn


def sharded_pose_graph(mesh: DeviceMesh, cfg: pg.PoseGraphConfig):
    """Returns run(PoseGraph) -> (graph, costs): LM pose-graph
    optimization with the edge axis sharded (this rank's block of edges;
    H, g and the costs all-reduced). The poses stay replicated. The edge
    count must be a multiple of the mesh size: pad with
    edge_valid=False."""
    check_mesh(mesh)

    def run(graph: pg.PoseGraph):
        sl = _block(mesh, graph.edge_i.shape[0])
        local = graph.replace(
            edge_i=graph.edge_i[sl], edge_j=graph.edge_j[sl],
            T_ij=graph.T_ij[sl], w_rot=graph.w_rot[sl],
            w_trans=graph.w_trans[sl], edge_valid=graph.edge_valid[sl])
        out, costs = pg.optimize_pose_graph(local, cfg,
                                            group=mesh.get_group())
        return graph.replace(T_world=out.T_world), costs

    return run


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world: int, fn, args, device_type: str,
               backend: str, init_file: str, results) -> None:
    try:
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            # one thread a rank: `world` ranks share the host's cores
            torch.set_num_threads(1)
            device = torch.device("cpu")
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank)
        try:
            out = fn(*args, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            # plain pickle bytes: a queued tensor would travel as a shared
            # memory handle that dies with this process
            results.put((rank, None, pickle.dumps(_to_host(out))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def spawn_ranks(fn, world: int, *args, device=None,
                backend: str | None = None) -> list:
    """Run ``fn(*args, device=<the rank's device>)`` in `world` spawned
    processes joined by one process group (a ``file://`` rendezvous in a
    temporary directory). Returns every rank's result, in rank order,
    with each tensor moved to the CPU (a rank reports its kernels'
    ``CudaKernel.launches`` in its result).

    device: "cuda" (the default) or "cpu". backend: "nccl" for CUDA (rank
    r on cuda:r; world must not exceed the visible cards), "gloo" for the
    CPU; "gloo" with device "cuda" puts rank r on cuda:(r % cards), so
    ranks may share one card. A rank's exception is raised here, with
    its traceback, after the other ranks are stopped; a rank that dies
    without one raises too. fn must be importable by name (a module-level
    function); it runs with one thread a rank on the CPU."""
    device_type = torch.device("cuda" if device is None else device).type
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("spawn_ranks(device='cuda'): no CUDA device")
        if backend == "nccl" and world > cards:
            raise ValueError(f"{world} NCCL ranks need {world} cards; "
                             f"{cards} visible")
    elif backend != "gloo":
        raise ValueError(f"CPU ranks need the gloo backend, not {backend}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="esvo_ranks_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, fn, args, device_type, backend,
                               os.path.join(tmp, "rendezvous"), results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        done: dict = {}
        while len(done) < world:
            try:
                rank, err, res = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and not p.is_alive()]
                if dead:
                    # a last message may still be in flight
                    try:
                        rank, err, res = results.get(timeout=5.0)
                    except queue_mod.Empty:
                        codes = {r: procs[r].exitcode for r in dead}
                        raise RuntimeError(f"rank(s) {dead} died without a "
                                           f"result (exit codes {codes})")
                else:
                    continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            done[rank] = pickle.loads(res)
        return [done[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            if p.pid is not None:
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def run_ranks(fn, world: int, *args, device=None,
              backend: str | None = None):
    """``spawn_ranks`` returning rank 0's result."""
    return spawn_ranks(fn, world, *args, device=device, backend=backend)[0]
