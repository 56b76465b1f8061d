"""Chaos engine (paper §V-B): deterministic fault injection at the hardware
level (storage latency/failures, stragglers, network degradation) and the
process level (host/TaskManager kills). All draws come from a seeded
generator, so every drill is reproducible bit-for-bit.

Copied from ``src/repro/core/chaos.py`` (plain numpy; the port imports
nothing of the JAX package): the spec, the engine, the deterministic
curves, the failover helpers, the checkpoint attempt and the per-seed /
per-job timeline builders. The config-grid timeline builders
(`GridTimelineBuilder`, `refit_failover`, `build_grid_timelines`) are not
carried over yet."""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    seed: int = 0
    # storage (HDFS-sim): slow uploads + hard failures
    storage_slow_prob: float = 0.0
    storage_slow_factor: float = 10.0
    storage_fail_prob: float = 0.0
    # process level
    host_kill_prob_per_s: float = 0.0
    host_kill_at: tuple[tuple[float, int], ...] = ()   # (time, host_id)
    # stragglers: fraction of hosts that are slow by `straggler_factor`
    straggler_frac: float = 0.0
    straggler_factor: float = 4.0
    # network
    net_delay_factor: float = 1.0
    # coordination (ZK-sim) outage windows
    zk_down: tuple[tuple[float, float], ...] = ()
    hdfs_down: tuple[tuple[float, float], ...] = ()
    # external systems (paper §IV): storage brownouts as latency-factor
    # *ramps* (t0, t1, peak) — the multiplier climbs 1→peak→1 over
    # [t0, t1) and stretches storage ops / checkpoint-attempt durations —
    # MQ/coordinator outage windows that gate source operators, and
    # region-correlated failure bursts (time, region_id) downing every
    # host that serves the region. All three are deterministic: they
    # consume NO rng draws, so they can never desynchronize the replayed
    # draw stream between the live engines and the pregenerated timelines.
    brownout_at: tuple[tuple[float, float, float], ...] = ()
    mq_down: tuple[tuple[float, float], ...] = ()
    burst_at: tuple[tuple[float, int], ...] = ()
    # deployment drills (paper §V): scheduled rolling-upgrade start times.
    # Like the family above these are deterministic and consume NO rng
    # draws — upgrade waves never touch the pregenerated kill/checkpoint
    # timelines, they are pure time arithmetic inside the engines' ticks
    # (streams.engine.UpgradeConfig carries the HOW: canary fraction,
    # wave stagger, hot-vs-cold restart costs, rollback policy).
    upgrade_at: tuple[float, ...] = ()
    # traffic dynamics (paper §III-A): deterministic source-rate
    # schedules. `diurnal` sinusoids (amp, period_s, phase_s) multiply
    # the source rate by 1 + amp*sin(2π(t + phase_s)/period_s); an
    # amp=0.0 entry is the exactly-1.0 identity (the constant-schedule
    # no-op guarantee is bit-exact). `flash_at` flash-crowd spikes
    # (t0, ramp_s, hold_s, peak) ramp 1→peak over ramp_s, hold at peak
    # for hold_s, then ramp back down over ramp_s; overlapping entries
    # multiply. `rate_phase_s` shifts every diurnal entry of THIS spec —
    # per-job spec lists de-synchronize co-located jobs' peaks across a
    # packed arena with otherwise identical schedules. All deterministic:
    # they consume NO rng draws (same contract as the family above), so
    # rate schedules never touch the pregenerated kill/ckpt timelines.
    diurnal: tuple[tuple[float, float, float], ...] = ()
    flash_at: tuple[tuple[float, float, float, float], ...] = ()
    rate_phase_s: float = 0.0


class ChaosEngine:
    def __init__(self, spec: ChaosSpec | None = None):
        self.spec = spec or ChaosSpec()
        self._rng = np.random.default_rng(self.spec.seed)
        self._killed: set[int] = set()
        self._stragglers: dict[int, bool] = {}
        self._extra_kill_at: list[tuple[float, int]] = []

    # -- storage -------------------------------------------------------
    def storage_latency_factor(self) -> float:
        if self.spec.storage_slow_prob and \
                self._rng.random() < self.spec.storage_slow_prob:
            return self.spec.storage_slow_factor
        return 1.0

    def storage_latency_factors(self, n: int) -> np.ndarray:
        """Vectorized batch of `n` latency factors. Draw-for-draw equivalent
        to `n` sequential `storage_latency_factor()` calls (numpy Generators
        produce the same stream for `random(n)` as for n scalar draws), so
        the vectorized engine stays bit-identical to the reference."""
        if not self.spec.storage_slow_prob:
            return np.ones(n)
        slow = self._rng.random(n) < self.spec.storage_slow_prob
        return np.where(slow, self.spec.storage_slow_factor, 1.0)

    def storage_fails(self) -> bool:
        return bool(self.spec.storage_fail_prob
                    and self._rng.random() < self.spec.storage_fail_prob)

    # -- hosts -----------------------------------------------------------
    def is_straggler(self, host_id: int) -> bool:
        if host_id not in self._stragglers:
            self._stragglers[host_id] = bool(
                self.spec.straggler_frac
                and self._rng.random() < self.spec.straggler_frac)
        return self._stragglers[host_id]

    def host_speed(self, host_id: int) -> float:
        return (1.0 / self.spec.straggler_factor
                if self.is_straggler(host_id) else 1.0)

    def step_kills(self, t0: float, t1: float, n_hosts: int) -> list[int]:
        """Hosts killed in (t0, t1]: scheduled kills + Poisson random kills.

        The Poisson draws are batched — one ``random(n_alive)`` call over
        the alive hosts in ascending id order, which numpy Generators
        guarantee is the same stream as n_alive sequential scalar draws —
        so large host pools (multi-job arenas) don't pay per-host Python
        rng calls every tick."""
        kills = [h for (t, h) in (tuple(self.spec.host_kill_at)
                                  + tuple(self._extra_kill_at))
                 if t0 < t <= t1 and h not in self._killed]
        if self.spec.host_kill_prob_per_s:
            p = 1.0 - np.exp(-self.spec.host_kill_prob_per_s * (t1 - t0))
            if self._killed:
                alive = np.array([h for h in range(n_hosts)
                                  if h not in self._killed])
            else:
                alive = np.arange(n_hosts)
            if len(alive):
                kills.extend(
                    int(h) for h in alive[self._rng.random(len(alive)) < p])
        self._killed.update(kills)
        return sorted(set(kills))

    def revive(self, host_id: int) -> None:
        self._killed.discard(host_id)

    def alive(self, host_id: int) -> bool:
        return host_id not in self._killed

    def schedule_kills(self, events) -> None:
        """Register extra deterministic (time, host) kill events, consumed
        by `step_kills` exactly like `spec.host_kill_at` (no rng drawn).
        Used to expand region-correlated failure bursts once task→host
        placement is known."""
        self._extra_kill_at.extend((float(t), int(h)) for t, h in events)

    # -- coordination services -------------------------------------------
    def zk_available(self, t: float) -> bool:
        return not any(a <= t < b for a, b in self.spec.zk_down)

    def hdfs_available(self, t: float) -> bool:
        return not any(a <= t < b for a, b in self.spec.hdfs_down)

    # -- external systems -------------------------------------------------
    def brownout_factor(self, t: float) -> float:
        """Deterministic storage-brownout latency multiplier at time t."""
        return brownout_factor_at(self.spec.brownout_at, t)

    def mq_available(self, t: float) -> bool:
        """MQ/coordinator availability — gates source operators."""
        return not any(a <= t < b for a, b in self.spec.mq_down)

    def traffic_factor(self, t: float) -> float:
        """Deterministic source-rate multiplier at time t (diurnal
        sinusoids × flash-crowd ramps, phase-shifted by the spec's
        ``rate_phase_s``)."""
        return traffic_factor_at(self.spec.diurnal, self.spec.flash_at, t,
                                 phase_s=self.spec.rate_phase_s)

    def leader_available(self, t: float) -> bool:
        """JobManager leader reachability at time t, lowered from the
        `cluster.coordinator.Coordinator` ZK → HDFS fallback chain: the
        leader address stays discoverable while EITHER service is up, so
        sources are throttled only where a `zk_down` window overlaps an
        `hdfs_down` window (both legs of the HA chain dark)."""
        return self.zk_available(t) or self.hdfs_available(t)


def brownout_factor_at(ramps, t: float) -> float:
    """Storage-brownout multiplier at time `t`: each (t0, t1, peak) ramp
    climbs linearly 1→peak over the first half of [t0, t1) and falls back
    peak→1 over the second half; overlapping ramps multiply (so merging
    two ramp tuples composes their factors)."""
    f = 1.0
    for (a, b, peak) in ramps:
        if a <= t < b:
            frac = 1.0 - abs(2.0 * (t - a) / (b - a) - 1.0)
            f *= 1.0 + (peak - 1.0) * frac
    return f


def brownout_curve(ramps, ts) -> np.ndarray:
    """Vectorized `brownout_factor_at` over an array of times."""
    ts = np.asarray(ts, dtype=float)
    out = np.ones(ts.shape)
    for (a, b, peak) in ramps:
        inside = (ts >= a) & (ts < b)
        if not inside.any():
            continue
        frac = 1.0 - np.abs(2.0 * (ts - a) / (b - a) - 1.0)
        out = np.where(inside, out * (1.0 + (peak - 1.0) * frac), out)
    return out


def traffic_factor_at(diurnal, flash_at, t: float, *,
                      phase_s: float = 0.0) -> float:
    """Source-rate multiplier at time `t`: diurnal sinusoids
    ``1 + amp*sin(2π(t + phase_s + phase)/period)`` × flash-crowd
    trapezoids ``(t0, ramp_s, hold_s, peak)`` (1→peak over ramp_s, held
    for hold_s, back down over ramp_s). Entries multiply; the result is
    floored at 0 (a deep diurnal trough cannot emit negative records).
    ``amp=0`` / ``peak=1`` entries are the exact 1.0 identity."""
    f = 1.0
    for (amp, period, phase) in diurnal:
        f *= 1.0 + amp * math.sin(
            2.0 * math.pi * (t + phase_s + phase) / period)
    for (t0, ramp, hold, peak) in flash_at:
        if t0 <= t < t0 + 2.0 * ramp + hold:
            u = t - t0
            if u < ramp:
                frac = u / ramp
            elif u < ramp + hold:
                frac = 1.0
            else:
                frac = 1.0 - (u - ramp - hold) / ramp
            f *= 1.0 + (peak - 1.0) * frac
    return max(f, 0.0)


def traffic_curve(diurnal, flash_at, ts, *, phase_s: float = 0.0
                  ) -> np.ndarray:
    """Vectorized `traffic_factor_at` over an array of times. The
    schedule-free call returns EXACT ones (multiplying source emission
    by it is a bit-exact no-op)."""
    ts = np.asarray(ts, dtype=float)
    out = np.ones(ts.shape)
    for (amp, period, phase) in diurnal:
        out = out * (1.0 + amp * np.sin(
            2.0 * np.pi * (ts + phase_s + phase) / period))
    for (t0, ramp, hold, peak) in flash_at:
        inside = (ts >= t0) & (ts < t0 + 2.0 * ramp + hold)
        if not inside.any():
            continue
        u = ts - t0
        frac = np.where(u < ramp, u / ramp,
                        np.where(u < ramp + hold, 1.0,
                                 1.0 - (u - ramp - hold) / ramp))
        out = np.where(inside, out * (1.0 + (peak - 1.0) * frac), out)
    return np.maximum(out, 0.0)


def mq_gate_curve(windows, ts) -> np.ndarray:
    """1.0/0.0 source gate per time (1 = MQ available, sources emit)."""
    ts = np.asarray(ts, dtype=float)
    gate = np.ones(ts.shape)
    for (a, b) in windows:
        gate[(ts >= a) & (ts < b)] = 0.0
    return gate


def coordinator_gate_curve(zk_down, hdfs_down, ts) -> np.ndarray:
    """1.0/0.0 source gate per time for coordinator leader loss: 0 only
    where a `zk_down` window overlaps an `hdfs_down` window (leader lost
    AND the HDFS fallback leg unreachable — the
    `cluster.coordinator.LeaderService` chain has no one to answer).
    Composes multiplicatively with `mq_gate_curve`."""
    ts = np.asarray(ts, dtype=float)
    zk_out = np.zeros(ts.shape, dtype=bool)
    for (a, b) in zk_down:
        zk_out |= (ts >= a) & (ts < b)
    hdfs_out = np.zeros(ts.shape, dtype=bool)
    for (a, b) in hdfs_down:
        hdfs_out |= (ts >= a) & (ts < b)
    gate = np.ones(ts.shape)
    gate[zk_out & hdfs_out] = 0.0
    return gate


def burst_kill_schedule(burst_at, task_host, task_region):
    """Expand region-correlated failure bursts into deterministic
    (time, host) kill events: a (t, region) burst downs every host
    serving >= 1 task of that region, under the same ``t0 < t <= t1``
    tick-window convention as `host_kill_at`. Pass local task/host views
    for per-job chaos domains."""
    if not burst_at:
        return ()
    if task_region is None:
        raise ValueError("burst_at requires task_region placement")
    task_host = np.asarray(task_host)
    task_region = np.asarray(task_region)
    out = []
    for (tb, reg) in burst_at:
        hosts = np.unique(task_host[task_region == int(reg)])
        out.extend((float(tb), int(h)) for h in hosts)
    return tuple(out)


def ckpt_age_curve(ts, ok, n_jobs: int) -> np.ndarray:
    """(n_ticks, n_jobs) checkpoint age at each tick start: ts[i] minus
    the tick-start time of the latest success STRICTLY before tick i
    (kills precede the tick's own attempt in every replay), with a 0.0
    start-of-run baseline — age = t until the first success, i.e. a
    passive restore replays from the beginning of the run. `ok` is the
    per-tick success count, (n_ticks,) for a shared coordinator
    (broadcast over jobs) or (n_ticks, n_jobs) for per-job ones."""
    ts = np.asarray(ts, dtype=float)
    ok = np.asarray(ok)
    ok2 = ok[:, None] if ok.ndim == 1 else ok
    ok2 = np.broadcast_to(ok2 > 0, (len(ts), n_jobs))
    last = np.zeros((len(ts), n_jobs))
    if len(ts) > 1:
        succ = np.where(ok2[:-1], ts[:-1, None], 0.0)
        last[1:] = np.maximum.accumulate(succ, axis=0)
    return ts[:, None] - last


def failover_recovery_entries(t: float, mode: str, hit: np.ndarray,
                              downtime,
                              job_of_task: np.ndarray | None = None
                              ) -> list[dict]:
    """Recovery-event dicts for one failover action over `hit` tasks.

    Single-job runs (``job_of_task=None``) keep the historical one-entry
    format. Packed multi-job arenas (`streams.engine.pack_arena`) emit one
    entry per affected job — ascending job id, with a ``"job"`` key — so a
    shared-host kill that downs tasks of several co-located jobs is
    attributable per job. `downtime` may be a scalar or a per-task vector
    (per-job failover configs): each job's entry reports the downtime of
    its own hit tasks, which per-job configs keep uniform within a job.
    Used by both the live `StreamEngine` and the pregenerated timeline so
    the two stay comparable with ``==``."""
    dt_arr = np.asarray(downtime, dtype=float)
    if job_of_task is None:
        d = float(dt_arr.flat[0]) if dt_arr.ndim else float(dt_arr)
        return [{"t": t, "mode": mode, "tasks": int(hit.sum()),
                 "downtime": d}]

    def _dt(j):
        if dt_arr.ndim == 0:
            return float(dt_arr)
        return float(dt_arr[hit & (job_of_task == j)][0])

    return [{"t": t, "mode": mode,
             "tasks": int((hit & (job_of_task == j)).sum()),
             "downtime": _dt(j), "job": int(j)}
            for j in np.unique(job_of_task[hit])]


_MODE_CODE = {"none": 0, "region": 1, "single_task": 2, "hot_standby": 3}


def failover_mode_codes(failover_mode, n_tasks: int) -> np.ndarray:
    """Normalize a failover mode (name string or per-task int-code vector)
    to an ``(n_tasks,)`` int8 code vector: 0 none, 1 region, 2
    single_task, 3 hot_standby. Per-task codes are how per-job
    `FailoverConfig`s reach the chaos timeline and the engines without
    `core` importing `streams`."""
    if isinstance(failover_mode, str):
        return np.full(n_tasks, _MODE_CODE[failover_mode], np.int8)
    codes = np.asarray(failover_mode, dtype=np.int8)
    if codes.shape != (n_tasks,):
        raise ValueError(f"mode codes must be (n_tasks,)={n_tasks}, "
                         f"got {codes.shape}")
    return codes


def _per_task(v, n_tasks: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(v, dtype=float), (n_tasks,))


def _resolve_failover_tick(t, host, task_host, task_region, mode_codes,
                           down_s, down_r, down, recoveries, job_of_task,
                           down_h=None, extra=None):
    """One host kill → failover response (shared by the pregenerated
    timeline, `refit_failover` and — semantically — the live engine's
    `_fail_host`): region-mode victims expand to their regions, then
    single_task-mode victims restart alone, then hot_standby victims
    switch to their standby replica. Entries keep that order when one
    shared-host kill hits jobs of several modes.

    `extra` is the per-task passive-restore surcharge at kill time —
    ``restore_base * brownout + ckpt_age * replay_rate + lazy_extra`` —
    added to region/single downtimes (restores re-read the checkpoint);
    hot_standby pays `down_h` (detect + switch + staleness replay) only,
    since the standby never touches checkpoint storage."""
    victims = task_host == host
    vr = victims & (mode_codes == 1)
    if vr.any():
        hit = np.isin(task_region, task_region[vr])
        d = down_r if extra is None else down_r + extra
        down[hit] = t + d[hit]
        recoveries.extend(failover_recovery_entries(
            t, "region", hit, d, job_of_task))
    vs = victims & (mode_codes == 2)
    if vs.any():
        d = down_s if extra is None else down_s + extra
        down[vs] = t + d[vs]
        recoveries.extend(failover_recovery_entries(
            t, "single_task", vs, d, job_of_task))
    vh = victims & (mode_codes == 3)
    if vh.any() and down_h is not None:
        down[vh] = t + down_h[vh]
        recoveries.extend(failover_recovery_entries(
            t, "hot_standby", vh, down_h, job_of_task))


def run_checkpoint_attempt(eng: ChaosEngine, alive: np.ndarray, *,
                           interval_s: float, mode: str, upload_s: float,
                           retry: bool, regions, task_lo: int = 0,
                           t: float = 0.0) -> bool:
    """One checkpoint attempt over the tasks covered by `alive` (their
    liveness at attempt time): per-task upload-factor draws against the
    interval timeout, then global abort-on-any-failure or per-region
    evaluation with one short-circuiting retry of a failed region.

    THE single definition of the attempt's rng consumption — shared by
    the live `StreamEngine` coordinators (whole-arena and per-job) and
    the pregenerated timeline replay, so the draw stream cannot
    desynchronize between them. `regions` hold global task ids;
    `task_lo` maps them into `alive` for per-job slices. `t` is the
    attempt time: a storage brownout active at `t` stretches every
    upload by the (deterministic) ramp factor, so a brownout-inflated
    attempt can never ack early — it fails the interval timeout
    instead. The brownout multiplier consumes no rng, so the draw
    stream is unchanged."""
    bf = eng.brownout_factor(t)
    factors = eng.storage_latency_factors(len(alive))
    task_fail = (upload_s * factors * bf > interval_s) | ~alive
    if mode == "global":
        return bool(not task_fail.any())
    for region in regions:
        bad = any(task_fail[tid - task_lo] for tid in region)
        if bad and retry:
            # one in-attempt retry of the region's uploads
            # (short-circuits on the first slow draw, exactly like the
            # engine's any(...) generator)
            bad = any(upload_s * eng.storage_latency_factor() * bf
                      > interval_s for _ in region)
        if bad:
            return False  # region keeps previous snapshot; attempt
            # counted failed by the caller, job continues (no abort)
    return True


# host-replay accounting: every build_chaos_timeline call is one full
# per-tick host replay. Config-grid sweeps must NOT scale this with the
# grid (`build_grid_timelines` replays per seed, then refits per config
# with vectorized draws) — benchmarks read the counter to prove it.
_TIMELINE_STATS = {"builds": 0, "grid_replays": 0}


def timeline_build_count() -> int:
    """Number of per-tick host timeline replays (`build_chaos_timeline`
    calls) so far in this process."""
    return _TIMELINE_STATS["builds"]


# ----------------------------------------------------------------------
# Pregenerated event tensors (accelerator backends / chaos sweeps)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ChaosTimeline:
    """Chaos events for one run, materialized as per-tick tensors.

    A `jit`-compiled engine cannot consume the sequential numpy rng draws
    of `ChaosEngine` mid-scan, so the whole chaos/failover/checkpoint
    control timeline is replayed here on the host — draw-for-draw in the
    exact order `streams.engine.StreamEngine` consumes the rng stream
    (straggler speeds at init; per tick: kill draws, then checkpoint
    storage draws) — and exported as dense arrays the device loop indexes
    by tick. Kill/checkpoint *times* are thereby quantized to tick
    boundaries, which is exactly the resolution the tick engines observe
    them at anyway.
    """
    dt: float
    n_ticks: int
    ts: np.ndarray             # (n_ticks,) tick-start times (accumulated)
    task_speed: np.ndarray     # (n_tasks,) chaos straggler speed factors
    kills: np.ndarray          # (n_ticks, n_hosts) bool host killed in tick
    ckpt_at: np.ndarray        # (n_ticks,) i16 checkpoint attempts in tick
    ckpt_ok: np.ndarray        # (n_ticks,) i16 successes in tick
    ckpt_attempts: int
    ckpt_success: int
    ckpt_failed: int
    recoveries: list[dict]     # same dict layout as EngineMetrics.recoveries
    # per-job checkpoint counters — populated only when per-job
    # CheckpointConfigs drive the replay ((n_jobs, 3) attempts/success/
    # failed); None for a single shared coordinator
    ckpt_by_job: np.ndarray | None = None
    # per-tick per-job success counts ((n_ticks, n_jobs) i16) — populated
    # by per-job coordinator replays so checkpoint-AGE tensors (hot-standby
    # vs passive restore cost) can be derived per job; None for a shared
    # coordinator (broadcast `ckpt_ok` instead, see `ckpt_age_curve`)
    ckpt_ok_by_job: np.ndarray | None = None


def build_chaos_timeline(
        spec: ChaosSpec, *, n_ticks: int, dt: float, n_hosts: int,
        task_host: np.ndarray, task_region: np.ndarray | None = None,
        regions: list | None = None,
        failover_mode="region", detect_s=1.0,
        region_restart_s=45.0, single_restart_s=3.0,
        ckpt_interval_s=None, ckpt_mode="region",
        ckpt_upload_s=4.0, ckpt_retry=True,
        job_of_task: np.ndarray | None = None,
        standby_switch_s=0.05, standby_staleness_s=0.5,
        restore_base_s=0.0, replay_rate=0.0,
        lazy_extra_s=0.0) -> ChaosTimeline:
    """Replay the engine's chaos rng consumption for `n_ticks` ticks.

    Host kills, checkpoint outcomes and failover downtimes are all
    data-independent of queue dynamics (downtime depends only on kills +
    failover config), so the full control timeline is computable here
    without simulating a single record. `task_host`/`task_region`/`regions`
    describe the physical placement (same arrays the engine derives from
    `PhysicalGraph`); failover/checkpoint parameters mirror
    `FailoverConfig`/`CheckpointConfig` field-for-field (passed as plain
    scalars to keep `core` free of a `streams` import).

    Per-job configs ride the same scalar contract as vectors/sequences:

    * `failover_mode` may be a per-task int8 code vector (see
      `failover_mode_codes`) and `detect_s` / `*_restart_s` per-task
      float vectors — how `streams.engine.per_task_failover` lowers a
      per-job `FailoverConfig` list.
    * `ckpt_interval_s` / `ckpt_mode` / `ckpt_upload_s` / `ckpt_retry`
      may be length-``n_jobs`` sequences (requires `job_of_task`; a None
      interval disables job j's coordinator): each job then runs its own
      coordinator drawing upload factors for its OWN tasks only, jobs in
      ascending id order within a tick — the stream contract mirrored by
      `StreamEngine._run_checkpoint_job`. `ckpt_at` counts attempts per
      tick (all jobs), and `ckpt_by_job` carries the per-job counters.

    Hybrid-replication parameters (all scalars or per-task vectors, 0/
    defaults keep historical numbers bit-identical): `standby_switch_s` /
    `standby_staleness_s` price a `hot_standby` (code 3) failover as
    detect + switch + staleness replay, with NO checkpoint-restore
    surcharge; `restore_base_s` (scaled by the brownout factor at kill
    time), `replay_rate` (seconds of replay per second of checkpoint
    age) and `lazy_extra_s` (lazy-load region ready-time offset) form
    the passive-restore surcharge added to region/single downtimes.
    """
    _TIMELINE_STATS["builds"] += 1
    eng = ChaosEngine(spec)
    task_host = np.asarray(task_host)
    n_tasks = len(task_host)
    mode_codes = failover_mode_codes(failover_mode, n_tasks)
    down_s = _per_task(detect_s, n_tasks) + _per_task(single_restart_s,
                                                      n_tasks)
    down_r = _per_task(detect_s, n_tasks) + _per_task(region_restart_s,
                                                      n_tasks)
    down_h = (_per_task(detect_s, n_tasks)
              + _per_task(standby_switch_s, n_tasks)
              + _per_task(standby_staleness_s, n_tasks))
    restore_base = _per_task(restore_base_s, n_tasks)
    replay = _per_task(replay_rate, n_tasks)
    lazy_extra = _per_task(lazy_extra_s, n_tasks)
    has_extra = bool(restore_base.any() or replay.any() or lazy_extra.any())
    if spec.burst_at:
        eng.schedule_kills(burst_kill_schedule(spec.burst_at, task_host,
                                               task_region))
    kills_possible = bool(spec.host_kill_at or spec.host_kill_prob_per_s
                          or spec.burst_at)
    if kills_possible and (mode_codes == 1).any() and task_region is None:
        raise ValueError(
            "failover_mode='region' with kills enabled requires task_region")
    per_job_ckpt = isinstance(ckpt_interval_s, (list, tuple, np.ndarray))
    if per_job_ckpt and job_of_task is None:
        raise ValueError("per-job ckpt_interval_s requires job_of_task")
    any_ckpt = (any(iv is not None for iv in ckpt_interval_s)
                if per_job_ckpt else ckpt_interval_s is not None)
    region_ckpt = (any(m != "global" for m in ckpt_mode)
                   if isinstance(ckpt_mode, (list, tuple, np.ndarray))
                   else ckpt_mode != "global")
    if any_ckpt and region_ckpt and regions is None:
        raise ValueError(
            "region checkpoint mode requires regions (the retry draws "
            "consume the rng stream — omitting them would desynchronize "
            "every later draw from the live engine)")
    # straggler draws happen at first sight of each host, in task order —
    # identical to StreamEngine.__init__'s per-task host_speed() queries
    task_speed = np.array([eng.host_speed(int(h)) for h in task_host])

    ts = np.zeros(n_ticks)
    kills = np.zeros((n_ticks, n_hosts), bool)
    ckpt_at = np.zeros(n_ticks, np.int16)
    ckpt_ok = np.zeros(n_ticks, np.int16)
    down = np.zeros(n_tasks)
    recoveries: list[dict] = []
    attempts = success = failed = 0
    if per_job_ckpt:
        n_jobs = int(np.max(job_of_task)) + 1
        jobs = _JobCkpt.from_seq(n_jobs, ckpt_interval_s, ckpt_mode,
                                 ckpt_upload_s, ckpt_retry, job_of_task,
                                 regions)
        ckpt_by_job = np.zeros((n_jobs, 3), int)
        ckpt_ok_job = np.zeros((n_ticks, n_jobs), np.int16)
        last_ok = np.zeros(n_jobs)
    else:
        next_ckpt = (ckpt_interval_s if ckpt_interval_s is not None
                     else math.inf)
        ckpt_by_job = None
        ckpt_ok_job = None
        last_ok = 0.0
    t = 0.0
    for i in range(n_ticks):
        ts[i] = t
        if kills_possible:
            hosts = eng.step_kills(t, t + dt, n_hosts=n_hosts)
            extra = None
            if hosts and has_extra:
                bf = eng.brownout_factor(t)
                age = (t - last_ok[job_of_task] if per_job_ckpt
                       else t - last_ok)
                extra = restore_base * bf + age * replay + lazy_extra
            for host in hosts:
                if host < n_hosts:
                    # scheduled kills are unbounded by n_hosts; a kill of
                    # a hostless id is a no-op (the engine just revives)
                    kills[i, host] = True
                _resolve_failover_tick(t, host, task_host, task_region,
                                       mode_codes, down_s, down_r, down,
                                       recoveries, job_of_task,
                                       down_h=down_h, extra=extra)
                eng.revive(host)   # replacement host, as in _fail_host
        if per_job_ckpt:
            for jc in jobs:
                if t + dt < jc.next_at:
                    continue
                ok = jc.attempt(eng, down, t)
                ckpt_at[i] += 1
                ckpt_ok[i] += int(ok)
                attempts += 1
                success += int(ok)
                failed += int(not ok)
                ckpt_by_job[jc.job] += (1, int(ok), int(not ok))
                ckpt_ok_job[i, jc.job] += int(ok)
                if ok:
                    last_ok[jc.job] = t
        elif t + dt >= next_ckpt:
            ckpt_at[i] = 1
            attempts += 1
            ok = run_checkpoint_attempt(
                eng, down <= t, interval_s=ckpt_interval_s,
                mode=ckpt_mode, upload_s=ckpt_upload_s, retry=ckpt_retry,
                regions=regions or (), t=t)
            ckpt_ok[i] = int(ok)
            success += int(ok)
            failed += int(not ok)
            next_ckpt += ckpt_interval_s
            if ok:
                last_ok = t
        t = t + dt
    return ChaosTimeline(dt, n_ticks, ts, task_speed, kills, ckpt_at,
                         ckpt_ok, attempts, success, failed, recoveries,
                         ckpt_by_job=ckpt_by_job,
                         ckpt_ok_by_job=ckpt_ok_job)


class _JobCkpt:
    """Per-job checkpoint coordinator state for the timeline replay —
    draws upload factors for the job's own task slice only, mirroring
    `StreamEngine._run_checkpoint_job` draw-for-draw."""

    def __init__(self, job, interval, mode, upload, retry, lo, hi, regions):
        self.job, self.interval, self.mode = job, interval, mode
        self.upload, self.retry = upload, retry
        self.lo, self.hi, self.regions = lo, hi, regions
        self.next_at = interval if interval is not None else math.inf

    @classmethod
    def from_seq(cls, n_jobs, intervals, modes, uploads, retries,
                 job_of_task, regions):
        def seq(v, default):
            if isinstance(v, (list, tuple, np.ndarray)):
                if len(v) != n_jobs:
                    raise ValueError(
                        f"per-job ckpt params need one entry per job "
                        f"({len(v)} != {n_jobs})")
                return list(v)
            return [v if v is not None else default] * n_jobs

        intervals = seq(intervals, None)
        modes = seq(modes, "region")
        uploads = seq(uploads, 4.0)
        retries = seq(retries, True)
        out = []
        for j in range(n_jobs):
            mask = np.asarray(job_of_task) == j
            lo = int(np.nonzero(mask)[0][0])
            hi = int(np.nonzero(mask)[0][-1]) + 1
            if int(mask.sum()) != hi - lo:
                raise ValueError("per-job ckpt needs contiguous job "
                                 "task slices")
            regs = [r for r in (regions or ())
                    if lo <= min(r) < hi]
            out.append(cls(j, intervals[j], modes[j], uploads[j],
                           retries[j], lo, hi, regs))
        return out

    def attempt(self, eng: ChaosEngine, down: np.ndarray, t: float) -> bool:
        self.next_at += self.interval
        return run_checkpoint_attempt(
            eng, down[self.lo:self.hi] <= t, interval_s=self.interval,
            mode=self.mode, upload_s=self.upload, retry=self.retry,
            regions=self.regions, task_lo=self.lo, t=t)


# ----------------------------------------------------------------------
# Per-job chaos specs (one ChaosSpec per co-located job)
# ----------------------------------------------------------------------
def build_perjob_chaos_timeline(
        specs, *, n_ticks: int, dt: float, n_hosts: int,
        task_host: np.ndarray, job_hosts, task_local_host: np.ndarray,
        job_of_task: np.ndarray,
        task_region: np.ndarray | None = None, regions: list | None = None,
        failover_mode="region", detect_s=1.0,
        region_restart_s=45.0, single_restart_s=3.0,
        ckpt_interval_s=None, ckpt_mode="region",
        ckpt_upload_s=4.0, ckpt_retry=True,
        standby_switch_s=0.05, standby_staleness_s=0.5,
        restore_base_s=0.0, replay_rate=0.0,
        lazy_extra_s=0.0) -> ChaosTimeline:
    """Per-job chaos replay: job ``j`` runs its own `ChaosEngine` seeded
    from ``specs[j]``, drawing stragglers and host kills in its *local*
    host domain (``len(job_hosts[j])`` hosts, the same domain an
    independent run of that job would draw in) and lifting kill targets
    into the shared pool through ``job_hosts[j]`` — so different kill
    rates / straggler intensities / drill schedules per co-located job
    share one arena while a lifted kill still downs EVERY job placed on
    that pool host.

    Draw-order contract (mirrored by `streams.engine.StreamEngine` with
    a per-job ``chaos=`` list): per-job straggler draws happen at first
    sight of each local host in task order (tasks of job j are
    contiguous, so engine j's draws batch together); per tick, jobs draw
    kills in ascending job order, then per-job checkpoint coordinators
    attempt in ascending job order, each drawing ONLY from its own
    engine. A pool host killed by several jobs' processes in one tick
    resolves once (first-killing job wins the recovery entry).

    Checkpoint parameters may be scalars (every job gets the same
    config, on its own coordinator and stream) or length-``n_jobs``
    sequences, as in `build_chaos_timeline`'s per-job coordinators —
    with per-job chaos there is no shared-coordinator mode, because
    there is no single engine to draw a whole-arena attempt from.
    """
    _TIMELINE_STATS["builds"] += 1
    specs = list(specs)
    n_jobs = len(specs)
    task_host = np.asarray(task_host)
    job_of_task = np.asarray(job_of_task)
    task_local_host = np.asarray(task_local_host)
    n_tasks = len(task_host)
    engines = [ChaosEngine(sp) for sp in specs]
    mode_codes = failover_mode_codes(failover_mode, n_tasks)
    down_s = _per_task(detect_s, n_tasks) + _per_task(single_restart_s,
                                                      n_tasks)
    down_r = _per_task(detect_s, n_tasks) + _per_task(region_restart_s,
                                                      n_tasks)
    down_h = (_per_task(detect_s, n_tasks)
              + _per_task(standby_switch_s, n_tasks)
              + _per_task(standby_staleness_s, n_tasks))
    restore_base = _per_task(restore_base_s, n_tasks)
    replay = _per_task(replay_rate, n_tasks)
    lazy_extra = _per_task(lazy_extra_s, n_tasks)
    has_extra = bool(restore_base.any() or replay.any() or lazy_extra.any())
    for j, (sp, eng) in enumerate(zip(specs, engines)):
        if sp.burst_at:
            # per-job bursts expand in the job's LOCAL host domain (the
            # same domain its kills draw in) and lift through job_hosts
            m = job_of_task == j
            eng.schedule_kills(burst_kill_schedule(
                sp.burst_at, task_local_host[m],
                None if task_region is None else task_region[m]))
    kills_possible = [bool(sp.host_kill_at or sp.host_kill_prob_per_s
                           or sp.burst_at)
                      for sp in specs]
    if any(kills_possible) and (mode_codes == 1).any() \
            and task_region is None:
        raise ValueError(
            "failover_mode='region' with kills enabled requires task_region")
    # straggler draws: first sight of each local host, in task order —
    # job slices are contiguous, so each engine consumes exactly the
    # stream an independent run of its job would
    task_speed = np.array([
        engines[int(job_of_task[tid])].host_speed(
            int(task_local_host[tid])) for tid in range(n_tasks)])

    any_ckpt = (any(iv is not None for iv in ckpt_interval_s)
                if isinstance(ckpt_interval_s, (list, tuple, np.ndarray))
                else ckpt_interval_s is not None)
    if any_ckpt:
        jobs_ck = _JobCkpt.from_seq(n_jobs, ckpt_interval_s, ckpt_mode,
                                    ckpt_upload_s, ckpt_retry,
                                    job_of_task, regions)
        ckpt_by_job = np.zeros((n_jobs, 3), int)
        ckpt_ok_job = np.zeros((n_ticks, n_jobs), np.int16)
    else:
        jobs_ck = []
        ckpt_by_job = None
        ckpt_ok_job = None
    last_ok = np.zeros(n_jobs)

    ts = np.zeros(n_ticks)
    kills = np.zeros((n_ticks, n_hosts), bool)
    ckpt_at = np.zeros(n_ticks, np.int16)
    ckpt_ok = np.zeros(n_ticks, np.int16)
    down = np.zeros(n_tasks)
    recoveries: list[dict] = []
    attempts = success = failed = 0
    t = 0.0
    for i in range(n_ticks):
        ts[i] = t
        failed_pool: set[int] = set()
        extra_memo: list = [None]

        def kill_extra(t=t):
            # per-task passive-restore surcharge at this tick, using each
            # task's OWN job's brownout ramps and checkpoint age
            if not has_extra:
                return None
            if extra_memo[0] is None:
                bfj = np.array([brownout_factor_at(sp.brownout_at, t)
                                for sp in specs])
                extra_memo[0] = (restore_base * bfj[job_of_task]
                                 + (t - last_ok)[job_of_task] * replay
                                 + lazy_extra)
            return extra_memo[0]

        for j, eng in enumerate(engines):
            if not kills_possible[j]:
                continue
            local_map = np.asarray(job_hosts[j])
            for lh in eng.step_kills(t, t + dt, n_hosts=len(local_map)):
                if lh < len(local_map):
                    pool = int(local_map[lh])
                    if pool not in failed_pool:
                        failed_pool.add(pool)
                        if pool < n_hosts:
                            kills[i, pool] = True
                        _resolve_failover_tick(
                            t, pool, task_host, task_region, mode_codes,
                            down_s, down_r, down, recoveries, job_of_task,
                            down_h=down_h, extra=kill_extra())
                eng.revive(lh)
        for jc in jobs_ck:
            if t + dt < jc.next_at:
                continue
            ok = jc.attempt(engines[jc.job], down, t)
            ckpt_at[i] += 1
            ckpt_ok[i] += int(ok)
            attempts += 1
            success += int(ok)
            failed += int(not ok)
            ckpt_by_job[jc.job] += (1, int(ok), int(not ok))
            ckpt_ok_job[i, jc.job] += int(ok)
            if ok:
                last_ok[jc.job] = t
        t = t + dt
    return ChaosTimeline(dt, n_ticks, ts, task_speed, kills, ckpt_at,
                         ckpt_ok, attempts, success, failed, recoveries,
                         ckpt_by_job=ckpt_by_job,
                         ckpt_ok_by_job=ckpt_ok_job)
