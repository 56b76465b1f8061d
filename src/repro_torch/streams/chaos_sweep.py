"""Chaos-sweep driver: batched failure-scenario screening (paper §V-B).

Counterpart of ``src/repro/streams/chaos_sweep.py`` (its `sweep` and the
summaries; the config-grid and cube drivers are not carried over yet).
StreamShield's release pipeline validates resiliency by sweeping many
injected-failure configurations, not one drill. `sweep` turns a seed
batch into per-scenario resiliency summaries with one device pass of
`torch_engine.run_batch`:

    result = sweep(nexmark.q2(parallelism=8), seeds=range(256),
                   base_spec=ChaosSpec(host_kill_prob_per_s=0.002),
                   duration_s=300.0)
    result.summaries[i].recovery_time_s  # per scenario
    result.aggregate()                   # fleet percentiles

Per scenario it reports recovery time, maximum backlog, SLO-violation
tick counts, dropped/emitted records and checkpoint success. A
`PackedArena` sweeps the whole co-located fleet in the same pass, and
``job_results`` then carries per-job breakdowns.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core.chaos import ChaosSpec
from repro_torch.streams.engine import (CheckpointConfig, FailoverConfig,
                                        PackedArena)
from repro_torch.streams.graph import LogicalGraph
from repro_torch.streams.torch_engine import TorchBatchMetrics, run_batch


@dataclasses.dataclass
class ScenarioSummary:
    seed: int
    n_failures: int              # recovery events (host kills that hit)
    recovery_time_s: float       # inf = never recovered, 0 = no SLO breach
    max_backlog: float           # peak total queued records
    max_lag: float               # peak source lag
    slo_threshold: float
    slo_violation_ticks: int
    slo_violation_frac: float
    dropped: float
    emitted: float
    ckpt_attempts: int
    ckpt_success: int


@dataclasses.dataclass
class SweepResult:
    graph_name: str
    duration_s: float
    n_ticks: int
    summaries: list[ScenarioSummary]
    batch: TorchBatchMetrics
    wall_s: float                # end-to-end sweep wall time
    # packed-arena sweeps: per-job breakdown (job name → its own
    # SweepResult over the job's metric segment); None for single jobs
    job_results: dict[str, "SweepResult"] | None = None
    # wall-time split of `wall_s`: host lowering, host timeline prep,
    # device pass (upload, ticks, copy back)
    lower_s: float = 0.0
    prep_s: float = 0.0
    device_s: float = 0.0

    @property
    def scenarios_per_s(self) -> float:
        return len(self.summaries) / self.wall_s if self.wall_s else 0.0

    def aggregate(self) -> dict:
        """Fleet-level percentiles across the scenario batch."""
        rec = np.array([s.recovery_time_s for s in self.summaries])
        fin = rec[np.isfinite(rec)]
        frac = np.array([s.slo_violation_frac for s in self.summaries])
        return {
            "scenarios": len(self.summaries),
            "failed_scenarios": int(sum(s.n_failures > 0
                                        for s in self.summaries)),
            "unrecovered": int(np.sum(~np.isfinite(rec))),
            "recovery_p50_s": float(np.median(fin)) if len(fin) else 0.0,
            "recovery_p95_s": float(np.percentile(fin, 95))
            if len(fin) else 0.0,
            "recovery_max_s": float(fin.max()) if len(fin) else 0.0,
            "slo_violation_frac_p50": float(np.median(frac)),
            "slo_violation_frac_p95": float(np.percentile(frac, 95)),
            "max_backlog": float(max(s.max_backlog
                                     for s in self.summaries)),
            "dropped_total": float(sum(s.dropped for s in self.summaries)),
            "scenarios_per_s": self.scenarios_per_s,
        }


def _recovery_time(ts: np.ndarray, lag: np.ndarray, down_bk: np.ndarray,
                   recs: list[dict]) -> float:
    """Time from the first failure until the job is healthy again: the
    failover outage window has passed, the per-tick lag growth is back
    at its pre-failure level, and downstream queues have drained (source
    lag is retained backlog, so an absolute lag threshold would read as
    never-recovered). inf = still unhealthy at horizon end."""
    t_fail = recs[0]["t"]
    outage_end = max(r["t"] + r["downtime"] for r in recs)
    pre = ts < t_fail
    dlag = np.diff(lag, prepend=lag[:1])
    grow_thr = (float(np.percentile(dlag[pre], 95)) if pre.any()
                else 0.0) + 1e-9
    bk_thr = max(2.0 * (float(np.median(down_bk[pre])) if pre.any()
                        else 0.0), 1.0)
    breach = (ts < outage_end) | (dlag > grow_thr) | (down_bk > bk_thr)
    breach &= ts >= t_fail
    if not breach.any():
        return 0.0
    last = int(np.nonzero(breach)[0][-1])
    if last == len(ts) - 1:
        return math.inf
    return float(ts[last + 1] - t_fail)


def summarize(batch: TorchBatchMetrics, seeds, *,
              graph: LogicalGraph | None = None,
              slo_lag: float | None = None,
              wall_s: float = 0.0, graph_name: str = "",
              duration_s: float = 0.0) -> SweepResult:
    """Per-scenario resiliency summaries from stacked batch metrics.

    `slo_lag` is the source-lag SLO threshold (records). When None it is
    derived per scenario as 2× the pre-failure steady-state median lag
    (the whole-run median for failure-free scenarios). `graph`
    identifies source ops so recovery can watch downstream queues."""
    ts = batch.t
    src_names = ({o.name for o in graph.ops if o.is_source}
                 if graph is not None else set())
    down_cols = [j for j, n in enumerate(batch.op_names)
                 if n not in src_names]
    summaries = []
    for i, seed in enumerate(seeds):
        lag = batch.source_lag[i]
        recs = batch.recoveries[i]
        t_fail = recs[0]["t"] if recs else None
        down_bk = batch.backlog[i][:, down_cols].sum(axis=1)
        if slo_lag is None:
            pre = lag[ts < t_fail] if t_fail is not None else lag
            steady = float(np.median(pre)) if len(pre) else 0.0
            thr = 2.0 * steady + 1e-9
        else:
            thr = slo_lag
        viol = int(np.sum(lag > thr))
        summaries.append(ScenarioSummary(
            seed=int(getattr(seed, "seed", seed)),   # ChaosSpec or int
            n_failures=len(recs),
            recovery_time_s=(_recovery_time(ts, lag, down_bk, recs)
                             if recs else 0.0),
            max_backlog=float(batch.backlog[i].sum(axis=1).max()),
            max_lag=float(lag.max()),
            slo_threshold=thr,
            slo_violation_ticks=viol,
            slo_violation_frac=viol / max(len(ts), 1),
            dropped=float(batch.dropped[i]),
            emitted=float(batch.emitted[i]),
            ckpt_attempts=int(batch.ckpt_attempts[i]),
            ckpt_success=int(batch.ckpt_success[i]),
        ))
    return SweepResult(graph_name, duration_s, len(ts), summaries, batch,
                       wall_s)


def sweep(graph: LogicalGraph | PackedArena, seeds, *,
          base_spec: ChaosSpec,
          duration_s: float, n_hosts: int = 8, dt: float = 0.5,
          queue_cap: float = 256.0,
          failover: FailoverConfig | None = None,
          ckpt: CheckpointConfig | None = None,
          slo_lag: float | None = None,
          task_speed_override: dict[int, float] | None = None,
          seed: int = 0,
          device: str | torch.device | None = None) -> SweepResult:
    """Sweep `seeds` chaos scenarios over `graph` in one device pass.

    `graph` may be a `PackedArena`: the co-located fleet sweeps in the
    same pass and the result carries per-job recovery/SLO breakdowns in
    ``job_results`` (keyed by job name) next to the fleet-level combined
    summaries."""
    seeds = list(seeds)
    logical = graph.graph if isinstance(graph, PackedArena) else graph
    timing: dict = {}
    t0 = time.perf_counter()
    batch = run_batch(graph, seeds, base_spec=base_spec,
                      duration_s=duration_s, n_hosts=n_hosts, dt=dt,
                      queue_cap=queue_cap, failover=failover, ckpt=ckpt,
                      task_speed_override=task_speed_override, seed=seed,
                      device=device, timing=timing)
    wall = time.perf_counter() - t0
    res = summarize(batch, seeds, graph=logical, slo_lag=slo_lag,
                    wall_s=wall, graph_name=logical.name,
                    duration_s=duration_s)
    res.lower_s = timing["lower_s"]
    res.prep_s = timing["prep_s"]
    res.device_s = timing["device_s"]
    if isinstance(graph, PackedArena) and batch.jobs:
        res.job_results = {
            job.name: summarize(batch.job_view(job), seeds,
                                graph=job.graph, slo_lag=slo_lag,
                                wall_s=wall, graph_name=job.name,
                                duration_s=duration_s)
            for job in batch.jobs}
    return res
