"""Frame-axis sharding of the stage-1 fit over `torch.distributed`.

Port of `mhmocap_tpu/parallel/spmd.py`. The time axis is cut into D
equal blocks of whole chunks, one per rank, the analog of context
parallelism for this workload:

  * the per-frame terms (SMPL, both raster kernels, the depth and
    silhouette losses) run on the rank that holds the frame: each rank
    runs the port's per-chunk loss and `.backward()` over its own chunks;
  * the temporal terms need the previous `cfg.halo` frames (1, or 2 with
    gap_aware_temporal, which also carries the stale mask across):
    each rank's first chunk reads its left neighbour's last frames
    through `HaloFromLeft`, whose backward routes the halo's gradient to
    the rank that owns those frames, once a cycle, after all chunks.
    Rank 0's halo wraps around from rank D-1 and is masked, as in JAX,
    by the `global_t > 0` pair gate and the `center_t >= 1` triple gate;
  * each chunk's loss, parts and gradients of the time-shared `betas`
    and `xscale` are gathered from every rank and added in the global
    chunk order (`_sum_in_chunk_order`), as the single process
    accumulates them, and the scale regularizer is added once, after the
    sum. So every rank holds the same bits, and they are the single
    process's on the same time layout: a sum in another order (a
    backend's all_reduce, or rank by rank) differs in the last bits, and
    RMSprop's normalized steps turn that into a full step on a
    near-zero gradient component within a few cycles;
  * RMSprop updates each rank's shard (elementwise, no communication);
    the replicated `betas` and `xscale` stay equal on every rank without
    a broadcast.

Every exchange is an all_gather, never send/recv, so that the same code
runs under NCCL and under gloo with CUDA tensors (several ranks on one
card, which NCCL refuses). `TimeMesh.collectives` counts them.

The fused cycle's refreshes give every rank the single-device values:
the scene median is taken over all T, so every rank keeps the full-T
depths, background masks and frame validity (`SceneData`) and gathers
the z bounds; the One-Euro refresh runs sequentially over T, so every
rank gathers the poses, filters all T and keeps its own frames.

`padded_frames` must divide into D ranks x `chunk`; the Predictor's
`tune_time_layout(T, D)` sees to it.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import require_device
from ..engine import optimizer as E

# the StageParams fields indexed by time; betas and xscale are replicated
TIME_SHARDED = ("poses_T", "poses_smpl", "zmin_lin", "zmax_lin")
# a halo frame per person: poses_T (3) and poses_smpl (72), then the
# frame_valid and stale_tn entries
POSE_WIDTH = 75


@dataclass
class TimeMesh:
    """One rank's view of the time mesh: its rank, the number of ranks,
    the process group (None: the default group) and the device of its
    tensors. `collectives` counts the exchanges made through it: calls,
    the bytes this rank sent into all_gathers, and barriers."""

    rank: int
    size: int
    group: Optional[object]
    device: torch.device
    collectives: Dict[str, int] = field(default_factory=lambda: {
        "all_gather": 0, "all_gather_bytes": 0, "barrier": 0})

    def reset_counts(self):
        for k in self.collectives:
            self.collectives[k] = 0

    def barrier(self):
        self.collectives["barrier"] += 1
        if dist.get_backend(self.group) == "nccl":
            dist.barrier(self.group, device_ids=[self.device.index])
        else:
            dist.barrier(self.group)


def world_size() -> int:
    """The size of the default process group; 1 without one."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def default_mesh(device) -> TimeMesh:
    """The time mesh over the initialised default process group, with
    this rank's tensors on `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return TimeMesh(rank=dist.get_rank(), size=dist.get_world_size(),
                    group=None, device=device)


def init_time_mesh(backend: Optional[str] = None, device=None,
                   init_method: str = "env://", rank: Optional[int] = None,
                   world_size: Optional[int] = None) -> TimeMesh:
    """Initialise the default process group and return its time mesh.

    The device defaults to cuda:LOCAL_RANK (the launcher's local rank);
    the backend to NCCL on a CUDA device and gloo on the CPU. A caller
    may pass backend="gloo" with a CUDA device: several ranks on one
    card. `init_method` defaults to the launcher's environment, which
    also gives the rank and world size unless they are passed. A backend
    that fails to initialise raises; nothing falls back."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = require_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {} if rank is None else {"rank": rank, "world_size": world_size}
    dist.init_process_group(backend, init_method=init_method, **kw)
    return default_mesh(device)


@contextlib.contextmanager
def launcher_mesh(device):
    """The time mesh of an entry point run under a launcher
    (`python -m torch.distributed.run --nproc_per_node D -m ...`, which
    sets WORLD_SIZE > 1), or None without one. With a CPU `device` the
    ranks run over gloo; with a CUDA one over NCCL, each on
    cuda:LOCAL_RANK. The process group is destroyed on exit."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        yield None
        return
    device = torch.device(device)
    mesh = init_time_mesh(device=None if device.type == "cuda" else device)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _all_gather(mesh: TimeMesh, x: torch.Tensor) -> List[torch.Tensor]:
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x, group=mesh.group)
    mesh.collectives["all_gather"] += 1
    mesh.collectives["all_gather_bytes"] += x.numel() * x.element_size()
    return out


def _sum_in_chunk_order(mesh: TimeMesh, rows: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's (local chunks, W) rows, added one row at a
    time in global chunk order (rank 0's chunks first), the same bits on
    every rank."""
    rows = torch.cat(_all_gather(mesh, rows), dim=0)
    total = rows[0]
    for row in rows[1:]:
        total = total + row
    return total


def _gather_time(mesh: TimeMesh,
                 tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Full-T copies of time-sharded tensors of one dtype, in one
    all_gather: each is flattened to (T_local, -1) and packed side by
    side."""
    n = tensors[0].shape[0]
    flat = [t.reshape(n, -1) for t in tensors]
    full = torch.cat(_all_gather(mesh, torch.cat(flat, dim=1)), dim=0)
    pieces = torch.split(full, [f.shape[1] for f in flat], dim=1)
    return [p.reshape((-1,) + tuple(t.shape[1:]))
            for p, t in zip(pieces, tensors)]


class HaloFromLeft(torch.autograd.Function):
    """The left neighbour's `tail` ((hl, ...) frames): rank r receives
    rank (r - 1) mod D's. Backward sends the halo's gradient back: rank
    r receives rank (r + 1) mod D's, the gradient of its own tail."""

    @staticmethod
    def forward(ctx, tail, mesh: TimeMesh):
        ctx.mesh = mesh
        return _all_gather(mesh, tail)[(mesh.rank - 1) % mesh.size]

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return _all_gather(mesh, grad)[(mesh.rank + 1) % mesh.size], None


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------

class SceneData(NamedTuple):
    """The inputs of the scene rebuild, over all T, on every rank."""

    depths: torch.Tensor       # (Tp, H, W)
    backmask: torch.Tensor     # (Tp, H, W) bool
    frame_valid: torch.Tensor  # (Tp,)
    cam_K: torch.Tensor        # (3, 3)


class ShardedSeqData(NamedTuple):
    local: E.SeqData           # this rank's frames; cam_K replicated
    scene: SceneData


def _local(mesh: TimeMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of x along the time axis, as a copy so that the
    full tensor can be freed."""
    n = x.shape[0] // mesh.size
    if n * mesh.size != x.shape[0]:
        raise ValueError(f"{x.shape[0]} frames do not split into "
                         f"{mesh.size} ranks")
    return x[mesh.rank * n:(mesh.rank + 1) * n].clone()


def shard_params(params: E.StageParams, mesh: TimeMesh) -> E.StageParams:
    return E.StageParams(*[
        _local(mesh, p) if k in TIME_SHARDED else p.clone()
        for k, p in zip(E.PARAM_NAMES, params)])


def gather_params(params: E.StageParams, mesh: TimeMesh) -> E.StageParams:
    """The full-T params on every rank (one all_gather)."""
    full = _gather_time(mesh, [getattr(params, k) for k in TIME_SHARDED])
    return params._replace(**dict(zip(TIME_SHARDED, full)))


def shard_opt_state(state: E.RMSpropState, mesh: TimeMesh):
    return E.RMSpropState(nu=shard_params(state.nu, mesh),
                          trace=shard_params(state.trace, mesh),
                          count=state.count)


def gather_opt_state(state: E.RMSpropState, mesh: TimeMesh):
    """The full-T RMSprop state on every rank (one all_gather)."""
    full = _gather_time(mesh, [getattr(tree, k) for tree in (state.nu,
                                                              state.trace)
                               for k in TIME_SHARDED])
    k = len(TIME_SHARDED)
    return E.RMSpropState(
        nu=state.nu._replace(**dict(zip(TIME_SHARDED, full[:k]))),
        trace=state.trace._replace(**dict(zip(TIME_SHARDED, full[k:]))),
        count=state.count)


def shard_data(data: E.SeqData, mesh: TimeMesh) -> ShardedSeqData:
    local = E.SeqData(*[x if k == "cam_K" else _local(mesh, x)
                        for k, x in zip(E.SeqData._fields, data)])
    return ShardedSeqData(local=local, scene=SceneData(
        data.depths, data.backmask, data.frame_valid, data.cam_K))


def shard_aux(aux: E.StageAux, mesh: TimeMesh) -> E.StageAux:
    return aux._replace(verts_filt_diff=_local(mesh, aux.verts_filt_diff))


# ---------------------------------------------------------------------------
# The sharded cycle
# ---------------------------------------------------------------------------

def _halo_tail(leaves: E.StageParams, data: E.SeqData, hl: int, N: int):
    """(hl, N, POSE_WIDTH + 2): the last hl local frames' poses_T,
    poses_smpl, frame_valid and stale mask, packed for one exchange."""
    return torch.cat([
        leaves.poses_T[-hl:].reshape(hl, N, 3),
        leaves.poses_smpl[-hl:],
        data.frame_valid[-hl:, None, None].expand(hl, N, 1),
        data.stale_tn[-hl:, :, None]], dim=-1)


def spmd_cycle_loss_and_grads(params: E.StageParams, model,
                              data: ShardedSeqData, aux: E.StageAux, coefs,
                              cfg: E.EngineConfig, mesh: TimeMesh):
    """The full-sequence loss, its parts and this rank's gradient, from
    this rank's shard: the counterpart of `spmd_cycle_loss` and of the
    port's `cycle_loss_and_grads`. Loss and parts are the full
    sequence's on every rank; the gradient is this rank's frames' for
    the time-sharded params and the full one for betas and xscale."""
    D, C, hl, N = mesh.size, cfg.chunk, cfg.halo, cfg.num_people
    if cfg.padded_frames % (D * C) != 0:
        raise ValueError(f"padded_frames {cfg.padded_frames} must divide "
                         f"into {D} devices x chunk {C}")
    local_chunks = cfg.padded_frames // (D * C)
    loc = data.local
    leaves = E.StageParams(*[p.detach().requires_grad_(True) for p in params])
    dev = leaves.poses_T.device

    halo = HaloFromLeft.apply(_halo_tail(leaves, loc, hl, N), mesh)
    # the chunks read a leaf copy of the halo's poses, so that their
    # gradient is sent back once, after the last chunk
    halo_pose = halo[..., :POSE_WIDTH].detach().requires_grad_(True)
    halo_h = {"poses_T": halo_pose[..., :3].reshape(hl, N, 1, 3),
              "poses_smpl": halo_pose[..., 3:],
              "frame_valid": halo[:, 0, POSE_WIDTH].detach(),
              "stale_tn": halo[..., POSE_WIDTH + 1].detach()}
    t_base = mesh.rank * local_chunks * C
    f32 = torch.float32

    def grad_of(p):
        return torch.zeros_like(p) if p.grad is None else p.grad

    # per chunk: its loss, parts and betas and xscale gradients
    rows = []
    for i in range(local_chunks):
        t0 = i * C
        c = slice(t0, t0 + C)

        def ext(name, x):
            """x's frames t0 - hl .. t0 + C - 1, the first chunk's from
            the halo."""
            if i == 0:
                return torch.cat([halo_h[name], x[:C]], dim=0)
            return x[t0 - hl:t0 + C]

        min_z, max_z = E.z_bounds_of(leaves, cfg)
        chunk = E.ChunkInputs(
            poses_T_h=ext("poses_T", leaves.poses_T),
            poses_smpl_h=ext("poses_smpl", leaves.poses_smpl),
            min_z_c=min_z[c], max_z_c=max_z[c],
            depths_c=loc.depths[c],
            seg_c=loc.seg_mask[c].to(f32),
            seg_er_c=loc.seg_eroded[c].to(f32),
            pose2d_c=loc.pose2d[c],
            ref_poses_c=loc.poses_smpl_ref[c],
            valid_smpl_c=loc.valid_smpl[c],
            frame_valid_h=ext("frame_valid", loc.frame_valid),
            global_t=t_base + t0 + torch.arange(C, device=dev),
            dvf_c=aux.verts_filt_diff[c],
            stale_h=(ext("stale_tn", loc.stale_tn)
                     if cfg.gap_aware_temporal else None),
        )
        loss, p = E._chunk_loss_core(chunk, model, leaves.betas,
                                     E.scale_factor_of(leaves), loc.cam_K,
                                     aux, coefs, cfg)
        leaves.betas.grad = leaves.xscale.grad = None
        loss.backward()
        rows.append(torch.cat([loss.detach().reshape(1), p.detach(),
                               grad_of(leaves.betas).reshape(-1),
                               grad_of(leaves.xscale).reshape(-1)]))

    g_halo = (halo_pose.grad if halo_pose.grad is not None
              else torch.zeros_like(halo_pose))
    halo.backward(torch.cat([g_halo, torch.zeros_like(halo[..., POSE_WIDTH:])],
                            dim=-1))

    K, nb = len(E.LOG_KEYS), leaves.betas.numel()
    shared = _sum_in_chunk_order(mesh, torch.stack(rows))
    total, parts = shared[0], shared[1:1 + K].clone()
    leaves.betas.grad = shared[1 + K:1 + K + nb].reshape(
        leaves.betas.shape).clone()
    leaves.xscale.grad = shared[1 + K + nb:].reshape(
        leaves.xscale.shape).clone()
    reg, logged = E._scale_reg(leaves, coefs, cfg)
    reg.backward()
    total = total + reg.detach()
    parts[4] = logged.detach()
    return total, parts, E.StageParams(*[grad_of(p) for p in leaves])


def spmd_grad_step(params, opt_state, model, data: ShardedSeqData, aux,
                   coefs, cfg: E.EngineConfig, mesh: TimeMesh,
                   optimize_scale: bool):
    loss, parts, grads = spmd_cycle_loss_and_grads(params, model, data, aux,
                                                   coefs, cfg, mesh)
    if not optimize_scale:
        grads = grads._replace(xscale=torch.zeros_like(grads.xscale))
    with torch.no_grad():
        params, opt_state = E.rmsprop_update(grads, opt_state, params)
    return params, opt_state, loss, parts


def spmd_fused_aux_refresh(params: E.StageParams, aux: E.StageAux,
                           cycle_idx: int, model, data: ShardedSeqData,
                           cfg: E.EngineConfig,
                           mesh: TimeMesh) -> E.StageAux:
    """`fused_aux_refresh` on the shards: the same scene on every rank,
    and this rank's frames of the filtered targets, each equal to the
    single-device value."""
    do_aux = cycle_idx >= cfg.warmup_cycles
    do_scene = do_aux and cycle_idx % cfg.scene_update_every == 0
    do_filt = do_aux and cycle_idx % cfg.update_filters_every == 0
    scene, dvf = aux.scene, aux.verts_filt_diff
    with torch.no_grad():
        if do_scene:
            zmin, zmax = _gather_time(mesh, [params.zmin_lin,
                                             params.zmax_lin])
            scene = E.update_scene(params._replace(zmin_lin=zmin,
                                                   zmax_lin=zmax),
                                   data.scene, cfg)
        if do_filt:
            poses_T, poses_smpl = _gather_time(mesh, [params.poses_T,
                                                      params.poses_smpl])
            dvf = _local(mesh, E.update_filtered_targets(
                params._replace(poses_T=poses_T, poses_smpl=poses_smpl),
                model, cfg))
    return aux._replace(scene=scene, have_scene=aux.have_scene or do_scene,
                        verts_filt_diff=dvf,
                        have_filters=aux.have_filters or do_filt)


def spmd_stage1_cycle(params, opt_state, model, data: ShardedSeqData, aux,
                      coefs, cfg: E.EngineConfig, mesh: TimeMesh,
                      optimize_scale: bool = True):
    """One sharded cycle without the aux refreshes. Returns (params,
    opt_state, loss, parts)."""
    return spmd_grad_step(params, opt_state, model, data, aux, coefs, cfg,
                          mesh, optimize_scale)


def spmd_stage1_cycle_fused(params, opt_state, aux, cycle_idx: int, model,
                            data: ShardedSeqData, coefs,
                            cfg: E.EngineConfig, mesh: TimeMesh,
                            optimize_scale: bool = True):
    """One sharded production cycle: the aux refreshes, then the
    gradient and one RMSprop update. Returns (params, opt_state, aux,
    loss, parts)."""
    aux = spmd_fused_aux_refresh(params, aux, cycle_idx, model, data, cfg,
                                 mesh)
    params, opt_state, loss, parts = spmd_grad_step(
        params, opt_state, model, data, aux, coefs, cfg, mesh,
        optimize_scale)
    return params, opt_state, aux, loss, parts


def spmd_stage1_cycles_fused(params, opt_state, aux, cycle_idx0: int, model,
                             data: ShardedSeqData, coefs,
                             cfg: E.EngineConfig, mesh: TimeMesh,
                             optimize_scale: bool = True, n_cycles: int = 1):
    """`n_cycles` consecutive `spmd_stage1_cycle_fused` calls. Returns
    (params, opt_state, aux, losses (n_cycles,), parts (n_cycles,
    len(LOG_KEYS)))."""
    losses, parts = [], []
    for k in range(n_cycles):
        params, opt_state, aux, loss, p = spmd_stage1_cycle_fused(
            params, opt_state, aux, cycle_idx0 + k, model, data, coefs, cfg,
            mesh, optimize_scale)
        losses.append(loss)
        parts.append(p)
    return params, opt_state, aux, torch.stack(losses), torch.stack(parts)


def cycle_collectives(cfg: E.EngineConfig, mesh: TimeMesh,
                      cycle_idx: int) -> Dict[str, int]:
    """The collective budget of one `spmd_stage1_cycle_fused` call: three
    all_gathers (the halo, its gradient, and each chunk's loss, parts
    and shared gradients), one more for the z bounds on a scene rebuild
    and one for the poses on a filter refresh; no barrier. The bytes are
    this rank's contributions, all float32."""
    hl, N = cfg.halo, cfg.num_people
    local = cfg.padded_frames // mesh.size
    local_chunks = local // cfg.chunk
    do_aux = cycle_idx >= cfg.warmup_cycles
    do_scene = do_aux and cycle_idx % cfg.scene_update_every == 0
    do_filt = do_aux and cycle_idx % cfg.update_filters_every == 0
    words = (2 * hl * N * (POSE_WIDTH + 2)
             + local_chunks * (1 + len(E.LOG_KEYS) + N * 10 + N)
             + do_scene * local * 2 + do_filt * local * N * POSE_WIDTH)
    return {"all_gather": 3 + int(do_scene) + int(do_filt),
            "all_gather_bytes": 4 * words, "barrier": 0}
