"""Plan lowering of the stream engine: configs, routing plan, per-phase
row tables and multi-job arena packing.

Copied from the lowering half of ``src/repro/streams/engine.py`` (plain
numpy; the port imports nothing of the JAX package). The numpy
`StreamEngine` itself stays in the reference as the semantic oracle.

What differs from the original:

* `lower_tensor_plan` has one lowering, the compact row tables
  (`CompactPhase`), which the port's seed-batched tick runs through the
  `repro_torch.kernels.tick_phase` kernel. The dense lowering and the
  auto selector between the two are not carried over.
* `lower_upgrade` / `lower_autoscale` lower ``None`` to the inert leaves
  and raise `NotImplementedError` otherwise: their non-inert lowering
  needs the deploy-downtime and state-move cost models, which come with
  the drill and traffic drivers. The tick itself runs non-inert leaves
  (see `torch_engine.from_reference`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.chaos import failover_mode_codes
from repro_torch.streams.graph import (LogicalGraph, PhysicalGraph, Task,
                                       expand, namespaced)


@dataclasses.dataclass
class FailoverConfig:
    # "region" | "single_task" | "hot_standby" | "none"
    mode: str = "region"
    detect_s: float = 1.0
    region_restart_s: float = 45.0   # restore state + redeploy the region
    single_restart_s: float = 3.0    # redeploy one task, clean state
    # hybrid replication (paper §IV-A): hot_standby pays switch latency +
    # replay of standby staleness INSTEAD of a checkpoint restore
    standby_switch_s: float = 0.05
    standby_staleness_s: float = 0.5
    # passive-restore surcharge (added to region/single downtimes):
    # restore_base_s is scaled by the storage-brownout factor at kill
    # time (restore bandwidth degrades with the ramp), replay_rate is
    # seconds of replay per second of checkpoint age, and
    # lazyload_stagger_s staggers region ready-times — a task blocks
    # until its own region is materialized (State LazyLoad, §III-B)
    restore_base_s: float = 0.0
    replay_rate: float = 0.0
    lazyload_stagger_s: float = 0.0

    @classmethod
    def from_replication(cls, timing, *, mode: str = "hot_standby",
                         state_bytes: float = 0.0,
                         detect_s: float | None = None) -> "FailoverConfig":
        """Lower a `core.replication.TimingModel` into tick-engine
        failover parameters (active replication → `hot_standby`; passive
        → checkpoint restore whose cost scales with state size, restore
        bandwidth, and checkpoint age)."""
        kw = timing.tick_failover_kwargs(nbytes=state_bytes)
        if detect_s is not None:
            kw["detect_s"] = detect_s
        return cls(mode=mode, **kw)


@dataclasses.dataclass
class CheckpointConfig:
    interval_s: float = 30.0
    mode: str = "region"             # "region" | "global"
    upload_s: float = 4.0            # nominal per-task upload duration
    retry_failed_region: bool = True


@dataclasses.dataclass
class UpgradeConfig:
    """Deployment-drill policy (paper §V): the HOW of a canaried rolling
    upgrade. The WHEN comes from ``ChaosSpec.upgrade_at`` (first entry;
    per-job chaos lists schedule per job), falling back to
    ``t_upgrade_s``. Upgrades are deterministic in-trace events: they
    consume NO rng draws and never touch the pregenerated chaos
    timelines — both engines implement waves, canary config divergence
    and auto-rollback as pure time arithmetic inside the tick.

    A drill canaries the first ``round(canary_frac * n_jobs)`` jobs of a
    packed arena (or the explicit ``canary_jobs`` indices). Canaried
    jobs restart region-sized task slices on a ``wave_stagger_s``
    cadence, each wave paying ``wave_down_s`` of downtime — by default
    the hot-vs-cold `core.hotupdate.deploy_downtime` cost lowered from
    ``startup`` (a `core.startup.StartupConfig`; None = its defaults).
    Once a task's wave completes, the task runs ``canary_failover`` /
    ``canary_ckpt`` / ``canary_sel_scale`` instead of the base configs
    (None = unchanged; canary lazyload staggers are ignored). A drill
    controller EWMAs the canary-vs-stable mean-queue delta over
    ``rollback_window_s`` and, once it exceeds ``rollback_threshold``
    (default inf = never), schedules a rollback: the canary slice
    reverts to the base config and pays a second restart wave. Upgrade
    and rollback waves are *graceful* — queues persist, unlike crash
    failover — so an upgrade to an identical config with
    ``wave_down_s=0`` is an exact no-op."""
    t_upgrade_s: float = 30.0
    wave_stagger_s: float = 2.0
    hot: bool = True
    startup: object | None = None    # core.startup.StartupConfig
    wave_down_s: float | None = None  # override deploy_downtime lowering
    canary_frac: float = 0.5
    canary_jobs: tuple | None = None  # explicit job indices (overrides frac)
    rollback_threshold: float = math.inf
    rollback_window_s: float = 5.0
    canary_failover: FailoverConfig | None = None
    canary_ckpt: CheckpointConfig | None = None
    canary_sel_scale: float = 1.0


def inert_upgrade_leaves(n_tasks: int) -> dict:
    """Drill parameter leaves of a drill-free run: the traced arithmetic
    stays structurally present (stable pytree → one trace for drill and
    non-drill configs) but is an exact arithmetic no-op — act masks are
    identically zero, wave starts are +inf, the controller never arms."""
    z = lambda: np.zeros(n_tasks)                      # noqa: E731
    return {
        "up_cmask": z(), "up_start": np.full(n_tasks, np.inf),
        "up_rstag": np.full(n_tasks, np.inf), "up_wdelta": z(),
        "d_down_s": z(), "d_down_r": z(), "d_down_h": z(),
        "d_mode_s": z(), "d_mode_r": z(), "d_mode_h": z(),
        "d_restore": z(), "d_replay": z(), "d_sel": z(), "d_ck": z(),
        "up_t0": np.float64(np.inf), "up_down": np.float64(0.0),
        "up_thresh": np.float64(np.inf), "up_alpha": np.float64(0.0),
    }


def lower_upgrade(upgrade: UpgradeConfig | None, spec, *, n_tasks: int,
                  job_of_task, task_region, dt: float, base_failover,
                  base_ckpt, sel_task) -> dict:
    """Traced drill parameter leaves of an `UpgradeConfig` (see the
    reference `repro.streams.engine.lower_upgrade` for the leaf
    contract). ``upgrade=None`` returns the inert leaves; a real drill
    needs the deploy-downtime cost model, which this package does not
    carry yet."""
    if upgrade is None:
        return inert_upgrade_leaves(n_tasks)
    raise NotImplementedError(
        "deployment drills are not lowered by repro_torch yet: pass "
        "upgrade=None, or feed the reference lowering's leaves through "
        "torch_engine.from_reference")


@dataclasses.dataclass
class AutoscaleConfig:
    """In-trace DS2 autoscaler policy (paper §III-A), lowered into both
    engines' ticks as a traced windowed controller: per decision
    interval it EWMAs each task's utilization (records consumed plus a
    backlog-drain term over current capacity — the DS2 true-rate ratio),
    targets ``speed * need / target_utilization``, and fires a per-task
    speed rescale guarded by hysteresis, cooldown, a leaky
    actions-per-window rate limit, a failover-aware circuit breaker and
    a thrash latch. Like deployment drills, autoscale events are
    deterministic in-trace time arithmetic: they consume NO rng draws
    and never touch the pregenerated chaos timelines.

    * Rescales are *graceful* (queues persist) but pay downtime on the
      ``up_until`` leaf: ``rescale_down_s`` (default: the hot-vs-cold
      `core.hotupdate.deploy_downtime` lowering) plus
      ``move_cost_s * |delta|`` state-move seconds (default: the
      `repro.train.elastic.resize_move_seconds` reshard model at
      ``state_bytes_per_task`` / ``move_bandwidth_Bps``).
    * The breaker counts, per task, kills landing within
      ``fail_window_s`` of that task's last rescale (a crash right
      after a resize = a failed adjustment); ``breaker_failures`` such
      events open the breaker for ``breaker_reset_s``, during which the
      controller holds and the task gracefully load-sheds: its
      selectivity is scaled by ``shed_factor``.
    * The thrash latch freezes the controller for the rest of the run
      once the leaky direction-flip counter (decaying over
      ``thrash_window_s``) reaches ``thrash_flips`` — the
      autoscaler-vs-failover oscillation guard. The latch time lands in
      ``EngineMetrics.thrash_t``.
    * Source tasks never rescale (and never pay rescale downtime):
      source emission is governed by the traffic curves, not capacity.

    Defaults are sized for tick-scale drills (dt ~0.5 s, minutes-long
    horizons); production-scale values (paper: 120 s cooldowns, 12
    actions/hour, 1800 s breaker) live in `core.autoscaler.ScalerConfig`
    — the host-side decision loop this controller is lowered from. NOT
    lowered: in-trace rollback of a failed resize to the previous
    parallelism (`DS2Scaler.notify_result` keeps that host-side); the
    breaker + load-shed path is the traced graceful-degradation story.
    Queue capacities stay on the config axis (``qcap_scale``): the
    pallas lowering packs qcap into static per-run kernel tables, so an
    in-trace qcap mutation cannot reach the fused kernel."""
    t0_s: float = 0.0
    interval_s: float = 5.0
    ewma_alpha: float = 0.35
    target_utilization: float = 0.8
    backlog_drain_s: float = 60.0
    hysteresis: float = 0.15
    cooldown_s: float = 20.0
    min_scale: float = 0.25
    max_scale: float = 8.0
    max_actions: float = 12.0        # leaky bucket over rate_window_s
    rate_window_s: float = 3600.0
    breaker_failures: float = 3.0
    breaker_reset_s: float = 300.0
    fail_window_s: float = 10.0
    shed_factor: float = 0.5         # breaker-open selectivity scale
    thrash_flips: float = 6.0
    thrash_window_s: float = 60.0
    hot: bool = True
    startup: object | None = None    # core.startup.StartupConfig
    rescale_down_s: float | None = None   # override deploy_downtime
    move_cost_s: float | None = None      # s per |delta| scale unit
    state_bytes_per_task: float = 64e6
    move_bandwidth_Bps: float = 1e9


#: the 21 autoscale leaves (see `lower_autoscale`), in the reference's
#: order
AUTOSCALE_KEYS = (
    "as_mask", "as_on", "as_t0", "as_int", "as_alpha", "as_tgt",
    "as_drain", "as_hyst", "as_cool", "as_lo", "as_hi", "as_amax",
    "as_adec", "as_bfail", "as_brs", "as_fw", "as_shed", "as_tflip",
    "as_tdec", "as_down", "as_move")


def inert_autoscale_leaves(n_tasks: int) -> dict:
    """Autoscale leaves of an autoscaler-free run: structurally present
    (stable pytree → one trace for scaled and unscaled configs) but an
    exact arithmetic no-op — ``as_on`` gates every action to False, the
    EWMA coefficient is 0.0, the shed factor multiplies by exactly 1.0.
    Large finite sentinels (1e18) stand in for +inf where the traced
    arithmetic divides or subtracts (inf/inf → nan hazards)."""
    big = np.float64(1e18)
    return {
        "as_mask": np.zeros(n_tasks),
        "as_on": np.float64(0.0), "as_t0": np.float64(0.0),
        "as_int": big, "as_alpha": np.float64(0.0),
        "as_tgt": np.float64(1.0), "as_drain": big,
        "as_hyst": big, "as_cool": np.float64(0.0),
        "as_lo": np.float64(0.0), "as_hi": big,
        "as_amax": big, "as_adec": np.float64(0.0),
        "as_bfail": big, "as_brs": np.float64(0.0),
        "as_fw": np.float64(0.0), "as_shed": np.float64(1.0),
        "as_tflip": big, "as_tdec": np.float64(0.0),
        "as_down": np.float64(0.0), "as_move": np.float64(0.0),
    }


def lower_autoscale(auto: AutoscaleConfig | None, *, n_tasks: int,
                    dt: float, is_src_task=None) -> dict:
    """Traced autoscaler leaves of an `AutoscaleConfig` (see the
    reference `repro.streams.engine.lower_autoscale` for the leaf
    contract). ``auto=None`` returns the inert leaves; a real scaler
    needs the deploy-downtime and state-move cost models, which this
    package does not carry yet."""
    if auto is None:
        return inert_autoscale_leaves(n_tasks)
    raise NotImplementedError(
        "in-trace autoscaling is not lowered by repro_torch yet: pass "
        "autoscale=None, or feed the reference lowering's leaves through "
        "torch_engine.from_reference")


@dataclasses.dataclass
class _OpPlan:
    name: str
    lo: int
    hi: int
    par: int
    is_source: bool
    service_rate: float
    selectivity: float
    source_rate: float
    out_edges: list["_EdgePlan"] = dataclasses.field(default_factory=list)
    # precomputed all-alive fast-path rows (speed is static per run)
    cap_row: np.ndarray | None = None       # service_rate·dt·speed
    src_row: np.ndarray | None = None       # per-task source emission
    src_sum: float = 0.0


@dataclasses.dataclass
class _EdgePlan:
    kind: str                       # partitioner name
    src: _OpPlan
    dst: _OpPlan
    static: bool                    # head-of-line acceptance family
    share: np.ndarray | None = None         # hash: normalized key mass
    raw_share: np.ndarray | None = None     # weakhash: unnormalized mass
    grp_starts: np.ndarray | None = None    # weakhash/group_rescale segments
    grp_mass: np.ndarray | None = None      # weakhash: per-group mass sums
    grp_of_dst: np.ndarray | None = None    # weakhash/group_rescale: dst→grp
    mass_of_dst: np.ndarray | None = None   # weakhash: grp_mass gathered
    blk_of_src: np.ndarray | None = None    # rescale/group_rescale: src→blk
    blk_of_dst: np.ndarray | None = None    # dst→blk (-1 = unconnected)
    dst_in_blk: np.ndarray | None = None    # bool: dst has a block
    any_unblocked: bool = False             # static: some dst has no block
    blk_idx: np.ndarray | None = None       # blk_of_dst clipped to >= 0
    n_blocks: int = 0
    dst_qcap: float = 0.0                   # backlog threshold base
    # per-edge scratch (reused every tick — avoids small-array allocations)
    ratio_buf: np.ndarray | None = None
    live_buf: np.ndarray | None = None


@dataclasses.dataclass
class RoutingPlan:
    """Speed-independent lowering of a logical graph: arena layout, per-op
    scalars and per-edge routing constants. Built once per engine by
    `build_plan`; `lower_tensor_plan` turns it into per-phase row tables
    for `streams.torch_engine`."""
    graph: LogicalGraph
    dt: float
    queue_cap: float
    offs: dict[str, int]
    n_tasks: int
    qcap: np.ndarray                     # (n_tasks,)
    ops: list[_OpPlan]                   # topo order, out_edges populated
    by_name: dict[str, _OpPlan]
    arena_starts: np.ndarray
    backlog_perm: np.ndarray
    src_cols: np.ndarray


def build_plan(graph: LogicalGraph, dt: float,
               queue_cap: float) -> RoutingPlan:
    """Lower `graph` into a `RoutingPlan` (everything in
    `StreamEngine.__init__` that does not depend on host speeds/chaos)."""
    order = graph.topo_order()
    ops = {o.name: o for o in graph.ops}
    # expand() numbers tasks contiguously per op, in graph.ops order
    offs: dict[str, int] = {}
    off = 0
    for o in graph.ops:
        offs[o.name] = off
        off += o.parallelism
    n_tasks = off

    qcap = np.zeros(n_tasks)
    for o in graph.ops:
        qcap[offs[o.name]:offs[o.name] + o.parallelism] = \
            max(o.service_rate * dt * 4.0, queue_cap)

    plan_ops: list[_OpPlan] = []
    by_name: dict[str, _OpPlan] = {}
    for name in order:
        o = ops[name]
        p = _OpPlan(name, offs[name], offs[name] + o.parallelism,
                    o.parallelism, o.is_source, o.service_rate,
                    o.selectivity, o.source_rate)
        if o.is_source:
            p.src_row = np.full(o.parallelism,
                                o.source_rate * dt / o.parallelism)
            p.src_sum = float(p.src_row.sum())
        plan_ops.append(p)
        by_name[name] = p
    for name in order:
        for e in graph.downstream(name):
            by_name[name].out_edges.append(
                _plan_edge(e, by_name[name], by_name[e.dst],
                           float(qcap[by_name[e.dst].lo])))

    # metric plumbing: one reduceat over the arena gives every op's
    # backlog; permute arena (declaration) order → topo column order
    arena_order = sorted(plan_ops, key=lambda p: p.lo)
    arena_starts = np.array([p.lo for p in arena_order])
    topo_pos = {p.name: j for j, p in enumerate(plan_ops)}
    backlog_perm = np.argsort([topo_pos[p.name] for p in arena_order])
    src_cols = np.array([j for j, p in enumerate(plan_ops) if p.is_source])
    return RoutingPlan(graph, dt, queue_cap, offs, n_tasks, qcap, plan_ops,
                       by_name, arena_starts, backlog_perm, src_cols)


def _plan_edge(e, src: _OpPlan, dst: _OpPlan, dst_qcap: float) -> _EdgePlan:
    nd = dst.par
    ns = src.par
    plan = _EdgePlan(
        kind=e.partitioner, src=src, dst=dst,
        static=e.partitioner in ("rebalance", "rescale", "forward",
                                 "hash"),
        dst_qcap=dst_qcap)
    if e.partitioner in ("hash", "weakhash"):
        # hashed key-mass share (identical construction to the
        # reference engine — same bincount over the same Zipf mass)
        nkeys = max(nd * 64, 1024)
        if e.key_skew_zipf > 0:
            mass = 1.0 / np.arange(1, nkeys + 1) ** e.key_skew_zipf
        else:
            mass = np.ones(nkeys)
        mass /= mass.sum()
        owner = (np.arange(nkeys) * 2654435761 % nd).astype(int)
        share = np.bincount(owner, weights=mass, minlength=nd)
        if e.partitioner == "hash":
            plan.share = share / share.sum()
        else:
            plan.raw_share = share
    if e.partitioner == "weakhash":
        g = max(e.n_groups, 1)
        starts = np.array([grp * nd // g for grp in range(g)])
        bounds = np.append(starts, nd)
        plan.grp_starts = starts
        # per-group mass via the same slice-sum the reference performs
        plan.grp_mass = np.array(
            [plan.raw_share[bounds[i]:bounds[i + 1]].sum()
             for i in range(g)])
        plan.grp_of_dst = np.searchsorted(starts, np.arange(nd),
                                          side="right") - 1
        plan.mass_of_dst = plan.grp_mass[plan.grp_of_dst]
    if e.partitioner == "group_rescale":
        g = max(e.n_groups, 1)
        starts = np.array([grp * nd // g for grp in range(g)])
        plan.grp_starts = starts
        plan.grp_of_dst = np.searchsorted(starts, np.arange(nd),
                                          side="right") - 1
        plan.blk_of_src = np.arange(ns) * g // ns
        plan.blk_of_dst = plan.grp_of_dst
        plan.n_blocks = g
    if e.partitioner == "rescale":
        per = max(1, nd // ns)
        src_lo = (np.arange(ns) * per) % nd
        blocks, blk_of_src = np.unique(src_lo, return_inverse=True)
        plan.blk_of_src = blk_of_src
        plan.n_blocks = len(blocks)
        blk_of_dst = np.full(nd, -1)
        for b, lo in enumerate(blocks):
            blk_of_dst[lo:lo + per] = b
        plan.blk_of_dst = blk_of_dst
    if plan.blk_of_dst is not None:
        plan.dst_in_blk = plan.blk_of_dst >= 0
        plan.any_unblocked = not bool(plan.dst_in_blk.all())
        plan.blk_idx = np.clip(plan.blk_of_dst, 0, None)
    plan.ratio_buf = np.empty(nd)
    plan.live_buf = np.empty(nd, bool)
    return plan


# ----------------------------------------------------------------------
# Per-task failover normalization (per-job configs, paper §III-B)
# ----------------------------------------------------------------------
def per_task_failover(failover, n_tasks: int,
                      job_of_task: np.ndarray | None = None):
    """Normalize a `FailoverConfig` — or a per-job sequence of them — into
    per-task vectors ``(mode_codes i8, detect, restart_single,
    restart_region, extras)`` where ``extras`` is a dict of per-task
    hybrid-replication vectors: ``switch`` / ``stale`` (hot-standby
    failover latency + staleness replay), ``restore_base`` /
    ``replay_rate`` (passive-restore cost model; restore_base is scaled
    by the brownout factor at kill time, replay_rate by checkpoint age)
    and ``stagger`` (per-rank lazy-load region ready-time spacing).

    Mode codes follow `core.chaos.failover_mode_codes` (0 none, 1 region,
    2 single_task, 3 hot_standby). A sequence means one config per job of a packed arena
    (`job_of_task` maps tasks to jobs; `None` entries fall back to the
    default config), which is how per-job failover policies reach both
    engines and the chaos timeline: everything downstream consumes only
    the per-task vectors, so a shared config is just the constant
    vector."""
    if failover is None:
        failover = FailoverConfig()
    if isinstance(failover, FailoverConfig):
        c = failover
        extras = {k: np.full(n_tasks, float(getattr(c, a))) for k, a in
                  _EXTRA_FIELDS}
        return (failover_mode_codes(c.mode, n_tasks),
                np.full(n_tasks, float(c.detect_s)),
                np.full(n_tasks, float(c.single_restart_s)),
                np.full(n_tasks, float(c.region_restart_s)),
                extras)
    cfgs = [c if c is not None else FailoverConfig() for c in failover]
    if job_of_task is None:
        if len(cfgs) != 1:
            raise ValueError(
                "a per-job failover list needs a packed arena "
                f"(got {len(cfgs)} configs for a single-job graph)")
        job_of_task = np.zeros(n_tasks, dtype=int)
    job_of_task = np.asarray(job_of_task)
    n_jobs = int(job_of_task.max()) + 1
    if len(cfgs) != n_jobs:
        raise ValueError(f"per-job failover list must have one entry per "
                         f"job ({len(cfgs)} != {n_jobs})")
    code_of_job = np.concatenate(
        [failover_mode_codes(c.mode, 1) for c in cfgs])
    extras = {k: np.array([float(getattr(c, a)) for c in cfgs])[job_of_task]
              for k, a in _EXTRA_FIELDS}
    return (code_of_job[job_of_task].astype(np.int8),
            np.array([c.detect_s for c in cfgs])[job_of_task],
            np.array([c.single_restart_s for c in cfgs])[job_of_task],
            np.array([c.region_restart_s for c in cfgs])[job_of_task],
            extras)


# extras-dict key → FailoverConfig attribute
_EXTRA_FIELDS = (("switch", "standby_switch_s"),
                 ("stale", "standby_staleness_s"),
                 ("restore_base", "restore_base_s"),
                 ("replay_rate", "replay_rate"),
                 ("stagger", "lazyload_stagger_s"))


def region_rank(task_region: np.ndarray,
                job_of_task: np.ndarray | None) -> np.ndarray:
    """Per-task rank of its failure region *within its job* (the job's
    first region is rank 0). This is the deterministic ordering shared by
    lazy-load ready-time schedules (`lazy_ready_extra`) and
    deployment-drill rolling-upgrade waves (`lower_upgrade`): wave /
    ready slot ``i`` covers the job's rank-``i`` region."""
    task_region = np.asarray(task_region)
    if job_of_task is None:
        first = task_region.min() if len(task_region) else 0
    else:
        job_of_task = np.asarray(job_of_task)
        n_jobs = int(job_of_task.max()) + 1
        first_of_job = np.full(n_jobs, np.iinfo(np.int64).max)
        np.minimum.at(first_of_job, job_of_task, task_region)
        first = first_of_job[job_of_task]
    return (task_region - first).astype(float)


def lazy_ready_extra(stagger: np.ndarray, task_region: np.ndarray | None,
                     job_of_task: np.ndarray | None) -> np.ndarray:
    """Per-task lazy-load restore penalty: region ``rank`` within its job
    times the stagger. Models the State-LazyLoad ready-time schedule —
    regions materialize in priority order, and a task blocks only until
    its OWN region is restored, so later-ranked regions pay
    ``rank * stagger`` extra downtime. No regions → rank 0 → zero."""
    stagger = np.asarray(stagger, dtype=float)
    if task_region is None or not np.any(stagger):
        return np.zeros_like(stagger)
    return region_rank(task_region, job_of_task) * stagger


# ----------------------------------------------------------------------
# Tensorized plan lowering (per-phase row tables for the seed-batched
# tick — see streams/torch_engine.py and kernels/tick_phase)
# ----------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class PhaseTensors:
    """Flat routing tensors of one tick *phase*.

    A phase is one slot of the tick's static schedule: every op consumes
    (and produces) in exactly one phase, every edge routes in exactly one
    phase, and all of a phase's edges execute as ONE batch of gathers +
    segment reductions over the concatenated destination-channel axis
    (``D`` entries = sum of the phase's edges' dst parallelisms). Blocks
    (rescale families) and key-groups (weakhash) are numbered globally
    within the phase with one trailing dummy segment each, so one
    `segment_sum` covers every edge's blocks/groups at once. Here it is
    the intermediate from which `_compact_phase` builds the row tables."""
    cons_mask: np.ndarray          # (n_tasks,) f64: ops consuming here
    consumes: bool
    n_edges: int                   # E
    D: int                         # flat dst-channel entries
    dst_task: np.ndarray           # (D,) i32 arena task id per entry
    edge_of: np.ndarray            # (D,) i32 phase-local edge index
    job_of_entry: np.ndarray       # (D,) i32 job of the dst op
    src_op_of_edge: np.ndarray     # (E,) i32 topo op index of the source
    is_fwd: np.ndarray             # (D,) bool  forward
    is_blk: np.ndarray             # (D,) bool  rescale / group_rescale
    is_hash: np.ndarray            # (D,) bool  hash
    is_weakhash: np.ndarray        # (D,) bool
    is_backlog: np.ndarray         # (D,) bool
    is_norm: np.ndarray            # (D,) f64   rebalance|weakhash|backlog
    acc_static: np.ndarray         # (D,) bool  head-of-line accept family
    acc_block: np.ndarray          # (D,) bool  per-block accept
    fwd_src: np.ndarray            # (D,) i32   src task for forward
    B: int                         # blocks in phase (dummy slot = B)
    blk_of: np.ndarray             # (D,) i32
    dst_in_blk: np.ndarray         # (D,) f64
    bsrc_task: np.ndarray          # (Sb,) i32  blocky edges' src tasks
    bsrc_blk: np.ndarray           # (Sb,) i32
    G: int                         # weakhash groups (dummy slot = G)
    grp_of: np.ndarray             # (D,) i32
    share: np.ndarray              # (D,) f64  hash key-mass share (traced)
    mass: np.ndarray               # (D,) f64  weakhash group mass (traced)


@dataclasses.dataclass(eq=False)
class CompactPhase:
    """Sparse twin of `PhaseTensors`: per-phase *active* index sets in
    row-table form.

    Every segment reduction of the dense tick (per-op totals, per-edge
    normalizers, per-group capacities, per-block rates, head-of-line
    minima, per-job metric sums) becomes a small **row table** here: one
    row per segment, holding the segment's member indices padded to a
    pow2 row length with a 0.0 mask column. The tick reduces
    ``values[idx] * mask`` along the row axis in member order — a
    gather + reduce whose cost scales with the phase's live entries,
    with no scatter and no atomics (`kernels.tick_phase` for the routing
    block, `torch_engine` for the rest)."""
    consumes: bool
    D: int                         # flat dst-channel entries (exact)
    E: int                         # edges (exact)
    B: int                         # blocks (+1 dummy row in br/bs)
    G: int                         # weakhash groups (+1 dummy row)
    # consumption (arena-wide elementwise, mask traced)
    cons_mask: np.ndarray          # (n_tasks,) f64
    # qps rows: one row per consuming op (arena indices)
    q_idx: np.ndarray              # (Rq, Lq) i32
    q_mask: np.ndarray             # (Rq, Lq) f64
    q_ops: np.ndarray              # (Rq,) i32 topo op index
    # emitted rows: one row per job with active sources (arena indices)
    e_idx: np.ndarray              # (Re, Le) i32
    e_mask: np.ndarray             # (Re, Le) f64
    e_jobs: np.ndarray             # (Re,) i32
    # per-source-op slots of the phase's edges (arena indices)
    s_idx: np.ndarray              # (Rs, Ls) i32
    s_mask: np.ndarray             # (Rs, Ls) f64
    slot_of_edge: np.ndarray       # (E,) i32
    slot_ops: np.ndarray           # (Rs,) i32 topo op index
    # dst-channel entry arrays (exact D, as in the dense phase)
    dst_task: np.ndarray           # (D,) i32
    fwd_src: np.ndarray            # (D,) i32
    edge_of: np.ndarray            # (D,) i32
    grp_of: np.ndarray             # (D,) i32 (dummy = G)
    blk_of: np.ndarray             # (D,) i32 (dummy = B)
    m_fwd: np.ndarray              # (D,) f64 partitioner masks (traced —
    m_blk: np.ndarray              # (D,) f64  unlike the dense bools,
    m_hash: np.ndarray             # (D,) f64  these are runtime params)
    m_weakhash: np.ndarray         # (D,) f64
    m_backlog: np.ndarray          # (D,) f64
    is_norm: np.ndarray            # (D,) f64
    m_acc_static: np.ndarray       # (D,) f64
    m_acc_block: np.ndarray        # (D,) f64
    dst_in_blk: np.ndarray         # (D,) f64
    share: np.ndarray              # (D,) f64
    mass: np.ndarray               # (D,) f64
    # edge / group / block rows (indices into the D axis)
    er_idx: np.ndarray             # (E, Le2) i32
    er_mask: np.ndarray            # (E, Le2) f64
    gr_idx: np.ndarray             # (G+1, Lg) i32 (last row all-pad)
    gr_mask: np.ndarray            # (G+1, Lg) f64
    br_idx: np.ndarray             # (B+1, Lb) i32 (last row all-pad)
    br_mask: np.ndarray            # (B+1, Lb) f64
    # block-source rows (arena indices of the blocky edges' src tasks)
    bs_idx: np.ndarray             # (B+1, Lbs) i32 (last row all-pad)
    bs_mask: np.ndarray            # (B+1, Lbs) f64
    # dropped rows: one row per dst job (indices into the D axis)
    dj_idx: np.ndarray             # (Rd, Ld) i32
    dj_mask: np.ndarray            # (Rd, Ld) f64
    dj_jobs: np.ndarray            # (Rd,) i32

    @property
    def sig(self) -> tuple:
        shapes = tuple(getattr(self, f.name).shape
                       for f in dataclasses.fields(self)
                       if isinstance(getattr(self, f.name), np.ndarray))
        return (self.consumes, self.D, self.E, self.B, self.G) + shapes

    def traced(self) -> dict:
        """The per-phase traced-parameter dict (everything but `sig`)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), np.ndarray)}


@dataclasses.dataclass(eq=False)
class TensorPlan:
    """Phase-scheduled row-table lowering of a `RoutingPlan`: one
    `CompactPhase` per tick phase.

    Equality / hashing go through `key`, the bucket shape signature of
    every phase. The *number of phases* is bounded by the longest
    in-tick pipeline chain of a single job (plus head-of-line ordering
    between same-destination edges), NOT by the number of ops/edges:
    packing K jobs into one arena leaves it unchanged."""
    n_tasks: int
    n_ops: int
    n_jobs: int
    n_phases: int
    op_of_task: np.ndarray         # (n_tasks,) i32 topo op index
    is_src_task: np.ndarray        # (n_tasks,) f64
    job_of_task: np.ndarray        # (n_tasks,) i32
    par_of_op: np.ndarray          # (n_ops,) f64  max(parallelism, 1)
    src_mask_ops: np.ndarray       # (n_ops,) f64  1.0 at source columns
    phases: list
    key: tuple = ()

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, TensorPlan) and self.key == other.key


def _phase_schedule(plan: RoutingPlan):
    """Assign every op a consumption phase and every edge a routing phase
    such that executing each phase as one parallel batch reproduces the
    sequential numpy tick exactly:

    * an op consumes only after every in-edge has deposited
      (``cphase(op) > phase(e)`` for in-edges ``e``);
    * an edge routes no earlier than its source op produces
      (``phase(e) >= cphase(src)`` — same phase is fine, consumption runs
      before routing inside a phase, as in the numpy op turn);
    * edges sharing a destination op serialize in their numpy order
      (free-credit reads/writes on the shared destination queue must nest
      exactly), which also guarantees each dst op receives at most ONE
      edge per phase — deposits within a phase are scatter-unique.
    """
    ops = plan.ops
    topo_idx = {p.name: i for i, p in enumerate(ops)}
    in_waves: list[list[int]] = [[] for _ in ops]
    last_wave_into: dict[int, int] = {}
    cphase = [0] * len(ops)
    edges = []                               # (src_oi, dst_oi, ep, phase)
    for oi, p in enumerate(ops):
        cphase[oi] = max((w + 1 for w in in_waves[oi]), default=0)
        for ep in p.out_edges:
            di = topo_idx[ep.dst.name]
            w = cphase[oi]
            if di in last_wave_into:
                w = max(w, last_wave_into[di] + 1)
            last_wave_into[di] = w
            in_waves[di].append(w)
            edges.append((oi, di, ep, w))
    n_phases = max(cphase + [e[3] for e in edges], default=0) + 1
    return cphase, edges, n_phases


def _bucket(n: int) -> int:
    """Pow2 bucket size for a compact index set (0 stays 0)."""
    return 1 << (n - 1).bit_length() if n > 1 else n


def lower_tensor_plan(plan: RoutingPlan,
                      job_of_op: np.ndarray | None = None) -> TensorPlan:
    """Lower a `RoutingPlan` into per-phase `CompactPhase` row tables —
    the tables the reference builds for its ``"compact"`` and
    ``"pallas"`` phase modes, and the only lowering of this package
    (`torch_engine` runs each routing phase through
    `repro_torch.kernels.tick_phase`)."""
    ops = plan.ops
    n_ops = len(ops)
    n_tasks = plan.n_tasks
    if job_of_op is None:
        job_of_op = np.zeros(n_ops, dtype=int)
    job_of_op = np.asarray(job_of_op)
    n_jobs = int(job_of_op.max()) + 1 if n_ops else 1

    op_of_task = np.zeros(n_tasks, np.int32)
    is_src_task = np.zeros(n_tasks)
    job_of_task = np.zeros(n_tasks, np.int32)
    for oi, p in enumerate(ops):
        op_of_task[p.lo:p.hi] = oi
        job_of_task[p.lo:p.hi] = job_of_op[oi]
        if p.is_source:
            is_src_task[p.lo:p.hi] = 1.0
    par_of_op = np.array([max(p.par, 1) for p in ops], float)
    src_mask_ops = np.array([1.0 if p.is_source else 0.0 for p in ops])

    cphase, edges, n_phases = _phase_schedule(plan)
    phases: list[CompactPhase] = []
    for f in range(n_phases):
        cons = np.zeros(n_tasks)
        for oi, p in enumerate(ops):
            if cphase[oi] == f:
                cons[p.lo:p.hi] = 1.0
        mine = [(oi, di, ep) for (oi, di, ep, w) in edges if w == f]
        assert len({di for _, di, _ in mine}) == len(mine), \
            "phase schedule must keep destination ops unique per phase"
        E = len(mine)
        cols = {k: [] for k in
                ("dst_task", "edge_of", "job_of_entry", "is_fwd", "is_blk",
                 "is_hash", "is_weakhash", "is_backlog", "acc_static",
                 "acc_block", "fwd_src", "blk_of", "dst_in_blk", "grp_of",
                 "share", "mass")}
        src_op_of_edge = np.array([oi for oi, _, _ in mine], np.int32)
        bsrc_task, bsrc_blk = [], []
        blk_base = grp_base = 0
        n_blocks_total = sum(ep.n_blocks for _, _, ep in mine)
        n_groups_total = sum(len(ep.grp_starts)
                             if ep.kind == "weakhash" else 0
                             for _, _, ep in mine)
        for ei, (oi, di, ep) in enumerate(mine):
            nd = ep.dst.hi - ep.dst.lo
            kind = ep.kind
            blocky = kind in ("rescale", "group_rescale")
            cols["dst_task"].append(np.arange(ep.dst.lo, ep.dst.hi,
                                              dtype=np.int32))
            cols["edge_of"].append(np.full(nd, ei, np.int32))
            cols["job_of_entry"].append(
                np.full(nd, int(job_of_op[di]), np.int32))
            cols["is_fwd"].append(np.full(nd, kind == "forward"))
            cols["is_blk"].append(np.full(nd, blocky))
            cols["is_hash"].append(np.full(nd, kind == "hash"))
            cols["is_weakhash"].append(np.full(nd, kind == "weakhash"))
            cols["is_backlog"].append(np.full(nd, kind == "backlog"))
            cols["acc_static"].append(np.full(nd, ep.static))
            cols["acc_block"].append(np.full(nd, kind == "group_rescale"))
            cols["fwd_src"].append(
                np.arange(ep.src.lo, ep.src.hi, dtype=np.int32)
                if kind == "forward" else np.zeros(nd, np.int32))
            if blocky:
                cols["blk_of"].append(
                    (blk_base + ep.blk_idx).astype(np.int32))
                cols["dst_in_blk"].append(ep.dst_in_blk.astype(float))
                bsrc_task.append(np.arange(ep.src.lo, ep.src.hi,
                                           dtype=np.int32))
                bsrc_blk.append((blk_base + ep.blk_of_src)
                                .astype(np.int32))
                blk_base += ep.n_blocks
            else:
                cols["blk_of"].append(np.full(nd, n_blocks_total, np.int32))
                cols["dst_in_blk"].append(np.zeros(nd))
            if kind == "weakhash":
                cols["grp_of"].append(
                    (grp_base + ep.grp_of_dst).astype(np.int32))
                cols["mass"].append(ep.mass_of_dst.astype(float))
                grp_base += len(ep.grp_starts)
            else:
                cols["grp_of"].append(np.full(nd, n_groups_total, np.int32))
                cols["mass"].append(np.zeros(nd))
            cols["share"].append(ep.share.astype(float)
                                 if kind == "hash" else np.zeros(nd))
        cat = {k: (np.concatenate(v) if v else
                   np.zeros(0, np.int32 if k in
                            ("dst_task", "edge_of", "job_of_entry",
                             "fwd_src", "blk_of", "grp_of") else float))
               for k, v in cols.items()}
        ph = PhaseTensors(
            cons_mask=cons, consumes=bool(cons.any()), n_edges=E,
            D=len(cat["dst_task"]), dst_task=cat["dst_task"],
            edge_of=cat["edge_of"], job_of_entry=cat["job_of_entry"],
            src_op_of_edge=src_op_of_edge,
            is_fwd=cat["is_fwd"].astype(bool),
            is_blk=cat["is_blk"].astype(bool),
            is_hash=cat["is_hash"].astype(bool),
            is_weakhash=cat["is_weakhash"].astype(bool),
            is_backlog=cat["is_backlog"].astype(bool),
            is_norm=(cat["is_weakhash"].astype(bool)
                     | cat["is_backlog"].astype(bool)
                     | ~(cat["is_fwd"].astype(bool)
                         | cat["is_blk"].astype(bool)
                         | cat["is_hash"].astype(bool))).astype(float),
            acc_static=cat["acc_static"].astype(bool),
            acc_block=cat["acc_block"].astype(bool),
            fwd_src=cat["fwd_src"], B=n_blocks_total,
            blk_of=cat["blk_of"], dst_in_blk=cat["dst_in_blk"],
            bsrc_task=(np.concatenate(bsrc_task) if bsrc_task
                       else np.zeros(0, np.int32)),
            bsrc_blk=(np.concatenate(bsrc_blk) if bsrc_blk
                      else np.zeros(0, np.int32)),
            G=n_groups_total, grp_of=cat["grp_of"],
            share=cat["share"], mass=cat["mass"])
        phases.append(_compact_phase(ph, ops, cphase, f, mine, job_of_op))
    key = (n_tasks, n_ops, n_jobs, n_phases, tuple(p.sig for p in phases))
    return TensorPlan(n_tasks, n_ops, n_jobs, n_phases, op_of_task,
                      is_src_task, job_of_task, par_of_op, src_mask_ops,
                      phases, key)


def _rows(groups, n_rows=None, dtype=np.int32):
    """Row-table builder: `groups` is a list of 1-D index arrays, one
    per segment. Returns ``(idx, mask)`` of shape ``(R, L)`` with ``L``
    the pow2 bucket of the longest group — pads gather index 0 under a
    0.0 mask. `n_rows` appends all-pad rows up to a fixed row count
    (the +1 dummy rows of block/group tables)."""
    R = n_rows if n_rows is not None else len(groups)
    L = _bucket(max((len(g) for g in groups), default=0)) or 1
    idx = np.zeros((R, L), dtype)
    mask = np.zeros((R, L))
    for r, g in enumerate(groups):
        idx[r, :len(g)] = g
        mask[r, :len(g)] = 1.0
    return idx, mask


def _compact_phase(ph: PhaseTensors, ops, cphase, f, mine,
                   job_of_op) -> CompactPhase:
    """Convert one dense phase into its row-table sparse twin. The
    numerics contract vs the dense phase is exact up to the reduction
    order inside a row: rows preserve the dst-axis/arena order of each
    segment's members and pads contribute exact +0.0 (sums) or +inf
    (minima), so compact == dense at 1e-12 over full runs."""
    cons_ops = [(oi, p) for oi, p in enumerate(ops) if cphase[oi] == f]
    q_idx, q_mask = _rows([np.arange(p.lo, p.hi) for _, p in cons_ops])
    q_ops = np.array([oi for oi, _ in cons_ops], np.int32)
    by_job: dict[int, list] = {}
    for oi, p in enumerate(ops):
        if cphase[oi] == f and p.is_source:
            by_job.setdefault(int(job_of_op[oi]), []).append(
                np.arange(p.lo, p.hi))
    e_jobs = sorted(by_job)
    e_idx, e_mask = _rows([np.concatenate(by_job[j]) for j in e_jobs])

    # one slot per distinct source op of the phase's edges
    slot_index: dict[int, int] = {}
    slot_of_edge = np.zeros(ph.n_edges, np.int32)
    for ei, (oi, _, _) in enumerate(mine):
        if oi not in slot_index:
            slot_index[oi] = len(slot_index)
        slot_of_edge[ei] = slot_index[oi]
    slots = sorted(slot_index, key=slot_index.get)
    s_idx, s_mask = _rows([np.arange(ops[oi].lo, ops[oi].hi)
                           for oi in slots])

    # edge / group / block rows index into the D axis; block-source rows
    # index the arena. Dummy rows (B / G) stay all-pad: their sums are
    # 0.0 and their minima inf, matching the dense dummy segments.
    d_pos = np.arange(ph.D)
    er_idx, er_mask = _rows([d_pos[ph.edge_of == ei]
                             for ei in range(ph.n_edges)])
    gr_idx, gr_mask = _rows([d_pos[ph.grp_of == g] for g in range(ph.G)],
                            n_rows=ph.G + 1)
    br_idx, br_mask = _rows([d_pos[ph.blk_of == b] for b in range(ph.B)],
                            n_rows=ph.B + 1)
    bs_idx, bs_mask = _rows([ph.bsrc_task[ph.bsrc_blk == b]
                             for b in range(ph.B)], n_rows=ph.B + 1)
    dj = sorted(set(int(j) for j in ph.job_of_entry))
    dj_idx, dj_mask = _rows([d_pos[ph.job_of_entry == j] for j in dj])

    return CompactPhase(
        consumes=ph.consumes, D=ph.D, E=ph.n_edges, B=ph.B, G=ph.G,
        cons_mask=ph.cons_mask,
        q_idx=q_idx, q_mask=q_mask, q_ops=q_ops,
        e_idx=e_idx, e_mask=e_mask,
        e_jobs=np.array(e_jobs, np.int32),
        s_idx=s_idx, s_mask=s_mask, slot_of_edge=slot_of_edge,
        slot_ops=np.array(slots, np.int32),
        dst_task=ph.dst_task, fwd_src=ph.fwd_src, edge_of=ph.edge_of,
        grp_of=ph.grp_of, blk_of=ph.blk_of,
        m_fwd=ph.is_fwd.astype(float), m_blk=ph.is_blk.astype(float),
        m_hash=ph.is_hash.astype(float),
        m_weakhash=ph.is_weakhash.astype(float),
        m_backlog=ph.is_backlog.astype(float), is_norm=ph.is_norm,
        m_acc_static=ph.acc_static.astype(float),
        m_acc_block=ph.acc_block.astype(float),
        dst_in_blk=ph.dst_in_blk, share=ph.share, mass=ph.mass,
        er_idx=er_idx, er_mask=er_mask, gr_idx=gr_idx, gr_mask=gr_mask,
        br_idx=br_idx, br_mask=br_mask, bs_idx=bs_idx, bs_mask=bs_mask,
        dj_idx=dj_idx, dj_mask=dj_mask,
        dj_jobs=np.array(dj, np.int32))


# ----------------------------------------------------------------------
# Multi-job mega-arena (cluster-perspective co-location, paper §V)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class JobSlice:
    """One job's footprint inside a packed arena.

    ``task_lo:task_hi`` is the job's contiguous task-id slice of the flat
    arena; ``op_cols`` are its columns in the plan's topo op order (also
    contiguous — jobs have no cross edges, so the combined topo order is
    the per-job topo orders concatenated); ``src_cols`` are the subset of
    ``op_cols`` belonging to the job's sources (per-job source lag);
    ``hosts`` maps the job's *local* host ids to the global pool."""
    index: int
    name: str
    graph: LogicalGraph            # the original, un-namespaced graph
    prefix: str
    task_lo: int
    task_hi: int
    op_cols: np.ndarray            # indices into plan.ops (topo order)
    op_names: list[str]            # original names, aligned with op_cols
    src_cols: np.ndarray           # subset of op_cols: the job's sources
    hosts: np.ndarray              # local host id -> global host id
    region_lo: int = 0
    region_hi: int = 0
    # job-local host id per job-local task index (the placement BEFORE
    # lifting through `hosts`) — per-job ChaosSpecs draw stragglers and
    # kills in this local domain, exactly like an independent run
    local_host: np.ndarray | None = None


@dataclasses.dataclass
class PackedArena:
    """K co-located job graphs lowered into ONE flat task arena.

    Arena layout
    ------------
    * Ops of job j are namespaced ``f"j{j}."`` and concatenated in job
      order, so `build_plan` on the combined graph numbers every job's
      tasks contiguously with arena-global offsets — one `RoutingPlan`,
      one task arena, one engine tick for the whole co-located fleet.
      Jobs have no cross edges: records never flow between jobs.
    * Hosts are a single shared pool of size ``n_hosts``. Each job keeps
      its *local* round-robin placement (``local_tid % n_hosts_local``,
      identical to an independent `expand`) and a per-job ``hosts`` map
      lifts local host ids into the pool — overlapping maps co-locate
      jobs on shared hosts, disjoint maps reproduce K independent
      clusters exactly (the parity anchor in tests/test_colocation.py).
    * Failure regions never merge across jobs (no cross-job channels), so
      the arena's region list is the per-job region lists, offset.

    Shared-host kill semantics: a chaos kill of host h downs the tasks of
    EVERY job placed on h — under region failover each affected job's hit
    regions restart; under single_task each affected job drops in-flight
    records routed to its dead tasks. Cross-job interference is therefore
    a first-class swept quantity (one host kill couples many jobs'
    recovery, the paper's cluster-level coupling).

    Per-job metric segments: `job_of_op` / `job_of_task` segment the
    per-op metric columns and the task arena by job; engines use them for
    per-job emitted/dropped accounting and per-job recovery attribution
    (``"job"`` key on recovery events).
    """
    graph: LogicalGraph            # combined, namespaced
    plan: RoutingPlan
    phys: PhysicalGraph
    jobs: list[JobSlice]
    job_of_task: np.ndarray        # (n_tasks,) int
    job_of_op: np.ndarray          # (n_ops,) int, topo order
    n_hosts: int                   # global pool size (kill-draw domain)

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    @property
    def dt(self) -> float:
        return self.plan.dt

    @property
    def queue_cap(self) -> float:
        return self.plan.queue_cap

    def job(self, name_or_index) -> JobSlice:
        if isinstance(name_or_index, int):
            return self.jobs[name_or_index]
        return next(j for j in self.jobs if j.name == name_or_index)

    def lift_kills(self, job: int, host_kill_at) -> tuple:
        """Translate a job-local ``host_kill_at`` schedule into the global
        host pool (chaos specs address pool hosts; a drill written against
        one job's local hosts is lifted through that job's host map)."""
        m = self.jobs[job].hosts
        return tuple((t, int(m[h])) for (t, h) in host_kill_at)


def pack_arena(graphs, host_map="shared", *, n_hosts: int = 8,
               dt: float = 0.5, queue_cap: float = 256.0,
               names=None) -> PackedArena:
    """Lower K co-located job graphs into one `PackedArena`.

    `host_map` controls co-location:
      * ``"shared"``   — every job uses the same pool hosts 0..n_hosts-1
                         (full co-location; host kills couple all jobs);
      * ``"disjoint"`` — job j uses hosts ``[j*n_hosts, (j+1)*n_hosts)``
                         (no interference; packed == K independent runs);
      * explicit       — sequence of K int arrays, each mapping the job's
                         local host ids ``0..n_hosts-1`` to pool ids.

    `names` optionally labels jobs (default ``f"j{j}.{graph.name}"``).
    """
    graphs = list(graphs)
    if not graphs:
        raise ValueError("pack_arena requires at least one job graph")
    k = len(graphs)
    if host_map == "shared":
        maps = [np.arange(n_hosts) for _ in range(k)]
    elif host_map == "disjoint":
        maps = [j * n_hosts + np.arange(n_hosts) for j in range(k)]
    else:
        maps = [np.asarray(m, dtype=int) for m in host_map]
        if len(maps) != k:
            raise ValueError(f"host_map has {len(maps)} rows for {k} jobs")
        if any(len(m) != n_hosts for m in maps):
            raise ValueError("each host_map row must map all local hosts")
    n_pool = int(max(m.max() for m in maps)) + 1

    prefixes = [f"j{j}." for j in range(k)]
    parts = [namespaced(g, p) for g, p in zip(graphs, prefixes)]
    combined = LogicalGraph(
        "+".join(g.name for g in graphs),
        ops=tuple(o for g in parts for o in g.ops),
        edges=tuple(e for g in parts for e in g.edges))
    plan = build_plan(combined, dt, queue_cap)

    # physical assembly: per-job expand (regions/channels depend only on
    # connectivity) + manual host lift through the job's host map. Task
    # numbering follows combined-graph op order, which equals per-job
    # expand order with the job's task offset added — the same contract
    # build_plan's offsets assume.
    tasks: list[Task] = []
    channels: dict = {}
    regions: list[set[int]] = []
    task_region: dict[int, int] = {}
    jobs: list[JobSlice] = []
    job_of_task = np.zeros(plan.n_tasks, dtype=int)
    topo_pos = {p.name: i for i, p in enumerate(plan.ops)}
    job_of_op = np.zeros(len(plan.ops), dtype=int)
    task_off = 0
    for j, (g, pre) in enumerate(zip(graphs, prefixes)):
        local = expand(g, n_hosts=n_hosts)
        for tk in local.tasks:
            tasks.append(Task(pre + tk.op, tk.index, task_off + tk.task_id,
                              host=int(maps[j][tk.host])))
        for (s, d), conn in local.channels.items():
            channels[(pre + s, pre + d)] = conn
        region_lo = len(regions)
        for r in local.regions:
            regions.append({task_off + t for t in r})
        for t, r in local.task_region.items():
            task_region[task_off + t] = region_lo + r
        n_local = len(local.tasks)
        job_of_task[task_off:task_off + n_local] = j
        op_cols = np.array(sorted(topo_pos[pre + o.name] for o in g.ops))
        job_of_op[op_cols] = j
        jobs.append(JobSlice(
            index=j,
            name=(names[j] if names is not None else pre + g.name),
            graph=g, prefix=pre, task_lo=task_off,
            task_hi=task_off + n_local, op_cols=op_cols,
            op_names=[plan.ops[c].name[len(pre):] for c in op_cols],
            src_cols=np.array([c for c in op_cols
                               if plan.ops[c].is_source]),
            hosts=maps[j], region_lo=region_lo, region_hi=len(regions),
            local_host=np.array([tk.host for tk in local.tasks])))
        task_off += n_local
    assert task_off == plan.n_tasks
    phys = PhysicalGraph(combined, tasks, channels, regions, task_region)
    return PackedArena(combined, plan, phys, jobs, job_of_task, job_of_op,
                       n_pool)
