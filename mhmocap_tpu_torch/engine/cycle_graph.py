"""One device program per stage-1 cycle: CUDA graphs over static state.

Counterpart of the JAX package's execution contract
(`mhmocap_tpu/engine/optimizer.py`): `stage1_cycle_fused` is one jitted
program per production cycle, its params, optimizer state and aux
donated and resident on the device, with the aux refreshes under
`lax.cond` inside it; `stage1_cycles_fused` runs K cycles as one
program; the jitted `init_global_poses` runs its Adam steps as one
`lax.scan`. In PyTorch a jitted, donated, resident program is a CUDA
graph captured over static buffers:

  * `StaticState`: params, RMSprop nu/trace and its step count, the aux
    (scene point cloud, bf16 filtered targets, betas_ref), a device
    log of each cycle's loss and parts and, with phase marks on, the
    ring of each cycle's phase marks (`ops/phase_marks.py`), in
    persistent tensors that a cycle updates in place (the counterpart
    of donation);
  * `cycle_body`: one production cycle on a StaticState, with the
    arithmetic of `optimizer.stage1_cycle_eager` (the same functions,
    their results copied into the buffers), and with marks on a mark at
    each phase boundary;
  * `CycleGraph`: the fit's static state and one graph per cycle
    `Variant`, each captured into one shared memory pool on a snapshot
    of the state, which is then restored: ahead of the cycles by
    `prepare`, or at the variant's first `replay`. `replay(cycle)` runs
    a cycle as one graph replay with no host synchronization. The
    refresh cadence and the loss's branches on the scene and the
    filtered targets are host decisions, so they key the graphs, as the
    `lax.cond`s key the JAX program's branches;
  * `replay_cycles`: `optimizer.stage1_cycle{,s}_fused` on CUDA tensors;
  * `init_global_poses_fused`: `optimizer.init_global_poses` as one
    captured Adam step, replayed for every step with no host
    interaction.

On the CPU the same bodies run eagerly: the caller chose the CPU. On
CUDA a capture that fails raises; nothing runs eagerly in its place.
The sharded fit (`parallel/spmd.py`) stays eager: its gloo collectives
cannot be captured.

Set-up runs under spans (`spans.py`): "cycle_graph.init", and in
`prepare` "cycle_graph.prepare" > "cycle_graph.warmup" and
"cycle_graph.capture" of each variant, from which `capture_seconds` is
read; the init solve's graph "init_solve.warmup",
"init_solve.capture" and "init_solve.replays". `replay` opens none.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..ops.phase_marks import PhaseMarks, make_ring
from ..spans import Spans, span
from . import optimizer as E
from .scene import ScenePointCloud


class Variant(NamedTuple):
    """What a cycle's program does, from the host's view of the cycle:
    the refreshes it runs and whether the loss has a scene and filtered
    targets after them."""

    do_scene: bool
    do_filt: bool
    have_scene: bool
    have_filters: bool


def cycle_variant(cycle: int, have_scene: bool, have_filters: bool,
                  cfg: E.EngineConfig) -> Variant:
    do_scene, do_filt = E.refresh_flags(cycle, cfg)
    return Variant(do_scene, do_filt, have_scene or do_scene,
                   have_filters or do_filt)


def tree_map(fn, tree):
    """fn over the tensors of nested (named) tuples; other leaves kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple):
        items = [tree_map(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def tree_leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in tree_leaves(x)]
    return []


def _copy_into(dst, src):
    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            d.copy_(s)


class StaticState(NamedTuple):
    """The fit's state in persistent tensors, updated in place."""

    params: E.StageParams
    nu: E.StageParams
    trace: E.StageParams
    count: torch.Tensor             # () int64: RMSprop steps taken
    scene: ScenePointCloud
    verts_filt_diff: torch.Tensor   # (Tp, N, V, 3) bf16
    betas_ref: torch.Tensor         # (1, N, 10)
    losses: torch.Tensor            # (L,): cycle c's loss at row c
    parts: torch.Tensor             # (L, len(LOG_KEYS))
    cycle: torch.Tensor             # () int64: the next cycle's row
    steps: int                      # the steps count's schedule covers
    ring: Optional[torch.Tensor] = None   # (L, M) int64 phase marks

    @classmethod
    def create(cls, params: E.StageParams, opt_state: E.RMSpropState,
               aux: E.StageAux, log_len: int,
               num_chunks: Optional[int] = None) -> "StaticState":
        """The state of (params, opt_state, aux) with a log of
        `log_len` rows, and with `num_chunks` a ring of phase marks."""
        dev = params.poses_T.device
        own = lambda t: t.detach().clone()                    # noqa: E731
        count = int(opt_state.count)
        return cls(
            params=tree_map(own, params), nu=tree_map(own, opt_state.nu),
            trace=tree_map(own, opt_state.trace),
            count=torch.full((), count, dtype=torch.int64, device=dev),
            scene=tree_map(own, aux.scene),
            verts_filt_diff=own(aux.verts_filt_diff),
            betas_ref=own(aux.betas_ref),
            losses=torch.zeros((log_len,), device=dev),
            parts=torch.zeros((log_len, len(E.LOG_KEYS)), device=dev),
            cycle=torch.zeros((), dtype=torch.int64, device=dev),
            steps=E.schedule_len(count + log_len),
            ring=(None if num_chunks is None
                  else make_ring(log_len, num_chunks, dev)))

    def opt_state(self) -> E.RMSpropState:
        return E.RMSpropState(nu=self.nu, trace=self.trace, count=self.count)


def cycle_body(st: StaticState, v: Variant, model, data: E.SeqData, coefs,
               cfg: E.EngineConfig, optimize_scale: bool,
               marks: Optional[PhaseMarks] = None):
    """One production cycle of variant `v` on `st`, in place: the
    refreshes, the full-batch gradient and one RMSprop update, the loss
    and parts written to the log row `st.cycle`; with `marks`, a mark at
    each phase boundary into that row of the ring (the last one after
    the row's step, at offset -1). After its first call for a (variant,
    device) it builds no tensor from host data and does not
    synchronize, so it can be captured."""
    if marks:
        marks("start")
    if v.do_scene:
        _copy_into(st.scene, E.update_scene(st.params, data, cfg))
        if marks:
            marks("scene")
    if v.do_filt:
        _copy_into(st.verts_filt_diff,
                   E.update_filtered_targets(st.params, model, cfg))
        if marks:
            marks("filter")
    aux = E.StageAux(betas_ref=st.betas_ref, scene=st.scene,
                     have_scene=v.have_scene,
                     verts_filt_diff=st.verts_filt_diff,
                     have_filters=v.have_filters)
    params, opt_state, loss, parts = E.grad_step(
        st.params, st.opt_state(), model, data, aux, coefs, cfg,
        optimize_scale, steps=st.steps, mark=marks)
    _copy_into((st.params, st.nu, st.trace, st.count),
               (params, opt_state.nu, opt_state.trace, opt_state.count))
    with torch.no_grad():
        row = st.cycle.reshape(1)
        st.losses.index_copy_(0, row, loss.reshape(1))
        st.parts.index_copy_(0, row, parts[None])
        st.cycle.add_(1)
    if marks:
        marks("update", row_offset=-1)


def capture_graph(body: Callable[[], None], device, pool=None,
                  name: str = "cycle_graph"):
    """`body` run once eagerly on a side stream, as PyTorch's
    whole-network capture requires of a warm-up (its work is real:
    `init_global_poses_fused` counts it as the first step; `CycleGraph`
    runs it on a snapshot and discards it), under the span
    "<name>.warmup", then captured in a CUDA graph that shares memory
    pool `pool`, under "<name>.capture" (capture and instantiation). The
    capture runs nothing. Returns the graph."""
    device = torch.device(device)
    with span(f"{name}.warmup"):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with span(f"{name}.capture"):
        with torch.cuda.graph(graph, pool=pool):
            body()
    return graph


class CycleGraph:
    """The stage-1 fit as CUDA graphs over a StaticState.

    Built from (params, opt_state, aux) before the first cycle (or from
    a checkpoint's), for cycles [0, num_cycles). `replay(cycle)` runs
    one cycle: on CUDA one replay of its variant's graph, captured by
    `prepare` into one memory pool shared by all variants (by the
    replay itself if `prepare` has not covered the cycle); on the CPU
    `cycle_body`, eagerly. `spans` records the set-up spans of its
    captures; `capture_seconds` holds each variant's (warm-up, capture)
    seconds, read from them.

    With `phase_marks` the state holds a ring of phase marks
    (`ops/phase_marks.py`) and every body, eager or captured, marks its
    phases in row `cycle` (`phase_rows`); `mark_order` holds the slots
    each variant's marks stamp. Without, the body launches no mark and
    the graphs hold no mark node."""

    @span("cycle_graph.init")
    def __init__(self, params: E.StageParams, opt_state: E.RMSpropState,
                 aux: E.StageAux, model, data: E.SeqData, coefs,
                 cfg: E.EngineConfig, optimize_scale: bool = True,
                 num_cycles: int = 1, phase_marks: bool = False):
        self.model, self.data, self.coefs, self.cfg = model, data, coefs, cfg
        self.optimize_scale = optimize_scale
        self.num_cycles = num_cycles
        self.state = StaticState.create(
            params, opt_state, aux, num_cycles,
            cfg.num_chunks if phase_marks else None)
        self.marks = (PhaseMarks(self.state.ring, self.state.cycle,
                                 cfg.num_chunks) if phase_marks else None)
        self.mark_order: Dict[Variant, tuple] = {}
        self.device = self.state.count.device
        self.have_scene = bool(aux.have_scene)
        self.have_filters = bool(aux.have_filters)
        self._count = int(opt_state.count)
        self._next_row = 0
        self.graphs: Dict[Variant, torch.cuda.CUDAGraph] = {}
        self.spans = Spans()
        self.capture_seconds: Dict[Variant, tuple] = {}
        self._pool = None

    def phase_rows(self, first: int, last: int) -> torch.Tensor:
        """The ring rows of cycles [first, last), copied to the host in
        one copy (marks on only)."""
        if self.state.ring is None:
            raise ValueError("this CycleGraph was built without phase marks")
        return self.state.ring[first:last].cpu()

    def aux(self) -> E.StageAux:
        st = self.state
        return E.StageAux(betas_ref=st.betas_ref, scene=st.scene,
                          have_scene=self.have_scene,
                          verts_filt_diff=st.verts_filt_diff,
                          have_filters=self.have_filters)

    def holds(self, params, opt_state, aux) -> bool:
        """Whether (params, opt_state, aux) are this state's buffers."""
        st = self.state
        return (all(a is b for a, b in zip(tree_leaves(
            (params, opt_state.nu, opt_state.trace, aux.scene)), tree_leaves(
                (st.params, st.nu, st.trace, st.scene))))
            and opt_state.count is st.count
            and aux.verts_filt_diff is st.verts_filt_diff
            and aux.betas_ref is st.betas_ref)

    def load(self, params, opt_state, aux):
        """Copy (params, opt_state, aux) into the static buffers."""
        st = self.state
        _copy_into((st.params, st.nu, st.trace, st.scene,
                    st.verts_filt_diff, st.betas_ref),
                   (params, opt_state.nu, opt_state.trace, aux.scene,
                    aux.verts_filt_diff, aux.betas_ref))
        self._count = int(opt_state.count)
        st.count.fill_(self._count)
        self.have_scene = bool(aux.have_scene)
        self.have_filters = bool(aux.have_filters)

    def _cover(self, count: int):
        """Longer schedule tables once step `count` is past the state's
        (they then cover num_cycles more): the graphs captured with the
        shorter ones are dropped, and captured again before their
        variants' next cycles."""
        if count >= self.state.steps:
            self.state = self.state._replace(
                steps=E.schedule_len(count + self.num_cycles))
            self.graphs.clear()

    def _body(self, v: Variant):
        cycle_body(self.state, v, self.model, self.data, self.coefs,
                   self.cfg, self.optimize_scale, self.marks)
        if self.marks:
            self.mark_order[v] = tuple(self.marks.order)

    def variants(self, first: int, last: int):
        """The variants of cycles [first, last) in their order of first
        use, found as `replay` finds them: from the host's view of the
        cycles, with the refresh cadence."""
        found = []
        have_scene, have_filters = self.have_scene, self.have_filters
        for cycle in range(first, last):
            v = cycle_variant(cycle, have_scene, have_filters, self.cfg)
            have_scene, have_filters = v.have_scene, v.have_filters
            if v not in found:
                found.append(v)
        return found

    def on_snapshot(self, fn: Callable[[], object]):
        """fn(), after which every buffer of the state (params, RMSprop
        state and count, scene, filtered targets, betas_ref, the log and
        its row) is copied back from a snapshot taken before it."""
        leaves = tuple(tree_leaves(self.state))
        with torch.no_grad():
            saved = tuple(t.clone() for t in leaves)
        out = fn()
        _copy_into(leaves, saved)
        return out

    def prepare(self, first: int, last: int):
        """On CUDA, capture the graph of each variant of cycles
        [first, last) that has none yet, before they run: each is warmed
        up and captured `on_snapshot`, so the state and the host's view
        are left as they were, and `replay` over those cycles only
        replays. On the CPU there is nothing to capture."""
        if self.device.type != "cuda":
            return
        # the schedule tables must cover the last cycle's step first:
        # growing them later would drop the graphs captured here
        self._cover(self._count + max(last - first - 1, 0))
        with self.spans, span("cycle_graph.prepare"):
            for v in self.variants(first, last):
                if v in self.graphs:
                    continue
                n = len(self.spans.records)
                graph = self.on_snapshot(
                    lambda: capture_graph(lambda: self._body(v),
                                          self.device, self._pool))
                new = {r.name: r.seconds for r in self.spans.records[n:]}
                self.capture_seconds[v] = (new["cycle_graph.warmup"],
                                           new["cycle_graph.capture"])
                self._pool = graph.pool()
                self.graphs[v] = graph

    def replay(self, cycle: int) -> Variant:
        """Run stage-1 cycle `cycle` (its loss lands in
        `state.losses[cycle]`). Returns its variant."""
        if not 0 <= cycle < self.num_cycles:
            raise ValueError(f"cycle {cycle} is outside [0, "
                             f"{self.num_cycles})")
        self._cover(self._count)
        v = cycle_variant(cycle, self.have_scene, self.have_filters,
                          self.cfg)
        if cycle != self._next_row:
            self.state.cycle.fill_(cycle)
        if self.device.type != "cuda":
            self._body(v)
        else:
            if v not in self.graphs:
                self.prepare(cycle, cycle + 1)
            self.graphs[v].replay()
        self._next_row = cycle + 1
        self._count += 1
        self.have_scene, self.have_filters = v.have_scene, v.have_filters
        return v


# The graph of the functional API (`optimizer.stage1_cycle{,s}_fused` on
# CUDA tensors), like jit's cache of a compiled program: one entry, for
# the last (model, data, coefs, cfg, optimize_scale) it ran.
_FUNCTIONAL: Dict[str, object] = {}
FUNCTIONAL_LOG_LEN = 1024


def replay_cycles(params, opt_state, aux, cycle0: int, model, data, coefs,
                  cfg, optimize_scale: bool, n_cycles: int):
    """`n_cycles` replays from cycle `cycle0` with no host
    synchronization. The inputs are copied into the cached graph's
    static state unless they are its buffers (what the last call
    returned). Returns (params, opt_state, aux, losses (n_cycles,),
    parts (n_cycles, len(LOG_KEYS))), the first three the static
    buffers."""
    key = (id(model), id(data), cfg, tuple(sorted(coefs.items())),
           optimize_scale)
    cg = _FUNCTIONAL.get("graph")
    end = cycle0 + n_cycles
    if cg is None or _FUNCTIONAL["key"] != key or end > cg.num_cycles:
        cg = CycleGraph(params, opt_state, aux, model, data, coefs, cfg,
                        optimize_scale, max(FUNCTIONAL_LOG_LEN, end))
        _FUNCTIONAL.update(graph=cg, key=key)
    elif not cg.holds(params, opt_state, aux):
        cg.load(params, opt_state, aux)
    for c in range(cycle0, end):
        cg.replay(c)
    st = cg.state
    return (st.params, st.opt_state(), cg.aux(),
            st.losses[cycle0:end].clone(), st.parts[cycle0:end].clone())


def init_global_poses_fused(model, pose2d, poses_smpl, betas_smpl, cam_K,
                            xscale, dist_coef=None, proj2d_coef: float = 1.0,
                            reg_velocity_coef: float = 0.05,
                            num_iter: int = 100, joints_thr: float = 0.15,
                            pose_weights=None):
    """`optimizer.init_global_poses` (same arguments) over static
    buffers: one Adam step (`optimizer.init_step`, its index a device
    count) updates poses_T, its moments and the loss history in place.
    On CUDA tensors the first step runs eagerly as the warm-up, is
    captured as one graph, and the graph is replayed for the other
    steps with no host synchronization; on CPU tensors the step runs
    eagerly `num_iter` times. (One graph of all the steps, replayed
    once a video, takes longer to capture than the eager loop takes to
    run.) Returns (poses_T (T, N, 1, 3), loss_2d history (num_iter,))."""
    problem = E.InitProblem.create(
        model, pose2d, poses_smpl, betas_smpl, cam_K, xscale, dist_coef,
        proj2d_coef, reg_velocity_coef, joints_thr, pose_weights)
    poses_T = problem.start()
    mu, nu = torch.zeros_like(poses_T), torch.zeros_like(poses_T)
    hist = torch.zeros((num_iter,), device=poses_T.device)
    step = torch.zeros((), dtype=torch.int64, device=poses_T.device)

    def body():
        out = E.init_step(problem, poses_T, mu, nu, step, steps=num_iter)
        _copy_into((poses_T, mu, nu), out[:3])
        with torch.no_grad():
            hist.index_copy_(0, step.reshape(1), out[3].reshape(1))
            step.add_(1)

    if poses_T.is_cuda and num_iter > 1:
        graph = capture_graph(body, poses_T.device, name="init_solve")
        with span("init_solve.replays"):
            for _ in range(num_iter - 1):
                graph.replay()
    else:
        for _ in range(num_iter):
            body()
    return poses_T, hist
