"""Workloads from the paper's Table III: Nexmark Q2, Q12, Data
Synchronization (DS), Sample Stitching (SS) — as logical graphs for the
engine, plus the HA and traffic drill specs.

Copied from ``src/repro/streams/nexmark.py`` (the graphs and drill specs;
the port imports nothing of the JAX package). The record-level operator
helpers of the original are not carried over yet.
"""
from __future__ import annotations

from repro_torch.core.chaos import ChaosSpec
from repro_torch.streams.graph import LogicalEdge, LogicalGraph, LogicalOp


# ----------------------------------------------------------------------
# Logical graphs (engine workloads)
# ----------------------------------------------------------------------
def ha_drill_spec(seed: int = 0, *, burst_t: float = 60.0,
                  burst_region: int = 0,
                  brownout=(40.0, 120.0, 6.0),
                  mq_outage=(150.0, 165.0),
                  host_kill_prob_per_s: float = 0.0) -> ChaosSpec:
    """The external-system HA drill the paper's release gate runs on the
    Nexmark workloads: a region-correlated failure burst mid-run, a
    storage brownout ramp stretching checkpoint uploads and passive
    restores around it, and an MQ/coordinator outage window gating the
    sources — all deterministic (no extra rng draws), so the same seed
    replays identically across the numpy, dense, compact and pallas
    engines."""
    return ChaosSpec(seed=seed,
                     host_kill_prob_per_s=host_kill_prob_per_s,
                     burst_at=((burst_t, burst_region),),
                     brownout_at=(tuple(brownout),),
                     mq_down=(tuple(mq_outage),))


def traffic_drill_spec(seed: int = 0, *,
                       diurnal=((0.35, 240.0, 0.0),),
                       flash=((90.0, 10.0, 30.0, 3.0),),
                       phase_s: float = 0.0,
                       burst_t: float | None = 110.0,
                       burst_region: int = 0,
                       host_kill_prob_per_s: float = 0.0) -> ChaosSpec:
    """The production traffic-dynamics drill: a diurnal load curve (an
    ``(amp, period_s, phase_s)`` sinusoid family, scaled down from the
    paper's 24h cycle to a sweepable horizon), a flash-crowd spike
    ``(t0, ramp_s, hold_s, peak)`` landing mid-run, and — by default —
    a region-correlated failure burst INSIDE the flash-crowd hold
    window, so rescale-during-recovery and autoscaler-vs-failover
    interactions actually exercise. All rate dynamics are deterministic
    curves (zero extra rng draws): the same seed replays identically
    across the numpy, dense, compact and pallas engines."""
    burst = ((float(burst_t), burst_region),) if burst_t is not None \
        else ()
    return ChaosSpec(seed=seed,
                     host_kill_prob_per_s=host_kill_prob_per_s,
                     burst_at=burst,
                     diurnal=tuple(tuple(d) for d in diurnal),
                     flash_at=tuple(tuple(f) for f in flash),
                     rate_phase_s=phase_s)



def q2(parallelism: int = 8, source_rate: float = 0.8e6,
       service_rate: float = 1.2e5, partitioner: str = "rebalance",
       n_groups: int = 1) -> LogicalGraph:
    """Filter bids on predefined conditions: two logical nodes, one source."""
    return LogicalGraph(
        "nexmark_q2",
        ops=(LogicalOp("source", parallelism, service_rate, is_source=True,
                       source_rate=source_rate),
             LogicalOp("filter", parallelism, service_rate,
                       selectivity=0.2)),
        edges=(LogicalEdge("source", "filter", partitioner,
                           n_groups=n_groups),))


def q12(parallelism: int = 8, source_rate: float = 0.8e6,
        service_rate: float = 1.2e5) -> LogicalGraph:
    """Count bids per bidder in processing-time windows: three nodes."""
    return LogicalGraph(
        "nexmark_q12",
        ops=(LogicalOp("source", parallelism, service_rate, is_source=True,
                       source_rate=source_rate),
             LogicalOp("window_count", parallelism, service_rate,
                       selectivity=0.05,
                       state_bytes_per_task=64 << 20),
             LogicalOp("sink", parallelism, service_rate)),
        edges=(LogicalEdge("source", "window_count", "hash",
                           key_skew_zipf=0.8),
               LogicalEdge("window_count", "sink", "forward")))


def q3(parallelism: int = 4, person_rate: float = 12e3,
       auction_rate: float = 12e3, service_rate: float = 5e3,
       sink_headroom: float = 1.2) -> LogicalGraph:
    """Incremental join of persons and auctions ("who is selling in
    particular states?"): two sources → filter/parse → keyed hash-join →
    sink, five nodes.

    The shape is deliberately *downstream-bottlenecked*: the sink's
    capacity is only ``sink_headroom``× the steady-state join output
    (person_rate·0.25 + auction_rate), so a canary selectivity scale
    above ``sink_headroom`` on the join overloads the canary slice's
    sink while the stable slice keeps draining — the divergence a
    deployment drill's auto-rollback controller detects. (A
    source-bottlenecked graph saturates both slices equally and a
    fully-drained one never builds backlog; neither can regress.)"""
    out_rate = person_rate * 0.25 + auction_rate
    sink_sr = sink_headroom * out_rate / parallelism
    return LogicalGraph(
        "nexmark_q3",
        ops=(LogicalOp("persons", parallelism, service_rate,
                       is_source=True, source_rate=person_rate),
             LogicalOp("auctions", parallelism, service_rate,
                       is_source=True, source_rate=auction_rate),
             LogicalOp("filter_p", parallelism, service_rate,
                       selectivity=0.25),
             LogicalOp("parse_a", parallelism, service_rate,
                       selectivity=1.0),
             LogicalOp("join", parallelism, service_rate,
                       selectivity=1.0,
                       state_bytes_per_task=128 << 20),
             LogicalOp("sink", parallelism, sink_sr)),
        edges=(LogicalEdge("persons", "filter_p", "forward"),
               LogicalEdge("auctions", "parse_a", "forward"),
               LogicalEdge("filter_p", "join", "hash",
                           key_skew_zipf=0.5),
               LogicalEdge("parse_a", "join", "hash", key_skew_zipf=0.5),
               LogicalEdge("join", "sink", "rebalance")))


def q11(parallelism: int = 4, source_rate: float = 16e3,
        service_rate: float = 10e3, session_sel: float = 0.3,
        sink_headroom: float = 1.2) -> LogicalGraph:
    """Bids per user per session window: source → keyed sessionizer →
    sink, three nodes with session state on the middle op.

    Downstream-bottlenecked like `q3` (the sink runs at
    ``sink_headroom``× the sessionizer's steady output), so canary
    configs that emit more windows — a shorter session gap lowered as a
    selectivity scale — regress the canary slice's backlog and exercise
    the drill auto-rollback path."""
    sink_sr = sink_headroom * source_rate * session_sel / parallelism
    return LogicalGraph(
        "nexmark_q11",
        ops=(LogicalOp("source", parallelism, service_rate,
                       is_source=True, source_rate=source_rate),
             LogicalOp("sessionize", parallelism, service_rate,
                       selectivity=session_sel,
                       state_bytes_per_task=96 << 20),
             LogicalOp("sink", parallelism, sink_sr)),
        edges=(LogicalEdge("source", "sessionize", "hash",
                           key_skew_zipf=0.7),
               LogicalEdge("sessionize", "sink", "forward")))


def ds(parallelism: int = 6, source_rate: float = 1e6,
       service_rate: float = 2.5e5) -> LogicalGraph:
    """Data synchronization: MQ → Hive, two nodes, forward chains (the
    region-checkpointing showcase: one region per chain)."""
    return LogicalGraph(
        "data_sync",
        ops=(LogicalOp("mq_source", parallelism, service_rate,
                       is_source=True, source_rate=source_rate,
                       state_bytes_per_task=512 << 20),
             LogicalOp("hive_sink", parallelism, service_rate,
                       state_bytes_per_task=512 << 20)),
        edges=(LogicalEdge("mq_source", "hive_sink", "forward"),))


def ss(parallelism: int = 8, feature_rate: float = 25e3,
       label_rate: float = 20e3, service_rate: float = 1.2e4) -> LogicalGraph:
    """Sample stitching: dual-stream keyed join for a recommender —
    all-to-all exchanges merge everything into ONE region (the single-task
    recovery showcase)."""
    sr = service_rate
    return LogicalGraph(
        "sample_stitching",
        ops=(LogicalOp("features", parallelism, sr, is_source=True,
                       source_rate=feature_rate),
             LogicalOp("labels", parallelism, sr, is_source=True,
                       source_rate=label_rate),
             LogicalOp("parse_f", parallelism, sr, selectivity=1.0),
             LogicalOp("parse_l", parallelism, sr, selectivity=1.0),
             LogicalOp("join", parallelism, sr, selectivity=0.9,
                       state_bytes_per_task=256 << 20),
             LogicalOp("stitch", parallelism, sr, selectivity=1.0),
             LogicalOp("sink", parallelism, sr)),
        edges=(LogicalEdge("features", "parse_f", "forward"),
               LogicalEdge("labels", "parse_l", "forward"),
               LogicalEdge("parse_f", "join", "hash", key_skew_zipf=0.6),
               LogicalEdge("parse_l", "join", "hash", key_skew_zipf=0.6),
               LogicalEdge("join", "stitch", "rebalance"),
               LogicalEdge("stitch", "sink", "forward")))


def q12_arena(n_tasks: int = 10_000, parallelism: int = 8,
              n_hosts: int = 64, source_rate: float = 0.8e6,
              service_rate: float = 1.2e5, dt: float = 0.5,
              queue_cap: float = 256.0, host_map: str = "shared"):
    """10k-task-scale Q12 mega-arena (ROADMAP's large-Nexmark item): K
    co-located Q12 jobs — ``K = n_tasks // (3 * parallelism)`` — packed
    into ONE flat arena over a shared host pool via
    `streams.engine.pack_arena`.

    At the default ``n_tasks=10_000`` that is 416 windowed-state jobs /
    1248 ops / 832 edges in one `RoutingPlan`: the workload whose
    per-op/per-edge unrolled jit trace was unbuildable, and which the
    tensorized phase-scheduled tick compiles in constant trace size
    (benchmarks/bench_compile.py). Returns a `PackedArena`; both engines
    and every sweep axis (seeds × mixes × configs) accept it directly.
    """
    from repro_torch.streams.engine import pack_arena

    per_job = 3 * parallelism
    n_jobs = max(1, n_tasks // per_job)
    jobs = [q12(parallelism=parallelism, source_rate=source_rate,
                service_rate=service_rate) for _ in range(n_jobs)]
    return pack_arena(jobs, host_map, n_hosts=n_hosts, dt=dt,
                      queue_cap=queue_cap)


def ss_arena(n_tasks: int = 10_000, parallelism: int = 8,
             n_hosts: int = 64, dt: float = 0.5,
             queue_cap: float = 256.0, host_map: str = "shared"):
    """10k-task-scale *deep-pipeline* mega-arena: K co-located Sample
    Stitching jobs — ``K = n_tasks // (7 * parallelism)`` — packed into
    ONE flat arena over a shared host pool.

    SS is the deepest paper workload (7 ops, dual sources, a serialized
    two-in-edge join): its packed arena schedules SIX tick phases, each
    touching only 1–2 ops of every job — the workload class where the
    compact (sparse-phase) lowering's per-phase active index sets beat
    the dense arena-wide tick (`engine.lower_tensor_plan(mode=...)`,
    benchmarks/bench_sweep_scale.py). Returns a `PackedArena`.
    """
    from repro_torch.streams.engine import pack_arena

    per_job = 7 * parallelism
    n_jobs = max(1, n_tasks // per_job)
    jobs = [ss(parallelism=parallelism) for _ in range(n_jobs)]
    return pack_arena(jobs, host_map, n_hosts=n_hosts, dt=dt,
                      queue_cap=queue_cap)


def drill_fleet(n_jobs: int = 8, parallelism: int = 4,
                n_hosts: int = 16, dt: float = 0.5,
                queue_cap: float = 256.0, host_map: str = "shared",
                sink_headroom: float = 1.2):
    """Heterogeneous deployment-drill fleet: alternating `q3` (join-
    shaped, 6 ops) and `q11` (session-window-shaped, 3 ops) jobs packed
    into ONE arena over a shared host pool.

    Every job is downstream-bottlenecked with ``sink_headroom``
    capacity slack, so a drill whose canary selectivity scale exceeds
    the headroom regresses exactly the canaried jobs — across two
    different graph shapes — while stable jobs keep draining. This is
    the fleet `chaos_sweep.deployment_drill` cubes sweep and the
    induced-regression fixture of tests/test_deployment_drill.py.
    Returns a `PackedArena`."""
    from repro_torch.streams.engine import pack_arena

    jobs = [q3(parallelism=parallelism, sink_headroom=sink_headroom)
            if i % 2 == 0
            else q11(parallelism=parallelism,
                     sink_headroom=sink_headroom)
            for i in range(n_jobs)]
    return pack_arena(jobs, host_map, n_hosts=n_hosts, dt=dt,
                      queue_cap=queue_cap)


def mega_arena(n_tasks: int = 100_000, workload: str = "q12",
               parallelism: int = 8, n_hosts: int = 256, dt: float = 0.5,
               queue_cap: float = 256.0, host_map: str = "shared"):
    """100k-task-scale mega-arena — the fused-Pallas-tick target size
    (10× `q12_arena` / `ss_arena`). ``workload`` picks the job template:

    * ``"q12"``  — K = n_tasks // (3·parallelism) windowed-count jobs
      (≈ 4166 jobs / 12498 ops at the default 100k).
    * ``"ss"``   — K = n_tasks // (7·parallelism) deep stitching
      pipelines (six tick phases, the compact/pallas showcase).
    * ``"mixed"``— alternating q12 + ss jobs until the task budget is
      spent, exercising ragged pow2 row buckets across phases.

    All jobs share one host pool, so one `ChaosSpec` kill stream fans
    out across every job — a (configs × seeds) grid over this arena in
    ``phase_mode="pallas"`` covers ≥1e6 job-scenarios in a single
    device pass (benchmarks/bench_tick_kernel.py). Returns a
    `PackedArena`.
    """
    from repro_torch.streams.engine import pack_arena

    if workload == "q12":
        mk = [(3 * parallelism, lambda: q12(parallelism=parallelism))]
    elif workload == "ss":
        mk = [(7 * parallelism, lambda: ss(parallelism=parallelism))]
    elif workload == "mixed":
        mk = [(3 * parallelism, lambda: q12(parallelism=parallelism)),
              (7 * parallelism, lambda: ss(parallelism=parallelism))]
    else:
        raise ValueError("workload must be q12|ss|mixed")
    jobs, total, i = [], 0, 0
    while total + mk[i % len(mk)][0] <= n_tasks or not jobs:
        per_job, ctor = mk[i % len(mk)]
        jobs.append(ctor())
        total += per_job
        i += 1
    return pack_arena(jobs, host_map, n_hosts=n_hosts, dt=dt,
                      queue_cap=queue_cap)
