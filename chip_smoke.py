#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing JSON lines; any failed check exits non-zero:

0. device: the card's name and power limit (``nvidia-smi``), torch/CUDA.
1. build: compiles every kernel of the path from ``src/repro_torch/csrc``.
2. kernel against plain: the counted wrapper `ops.tick_phase` on CUDA
   tensors (one launch each) against `tick_phase_ref` on the same
   tensors, phase by phase, on inputs made with numpy from ``--seed``: (a) Nexmark Q2 at parallelism 256 under every partitioner
   (the block and group branches), (b) every routing phase of the
   100k-task mixed mega-arena with 8 seeds, timed (CUDA events, median)
   beside the plain version and the byte bound.
3. path on card against path on CPU: `run_batch` on a 2016-task SS arena,
   4 seeds, 60 s, on ``cuda`` twice (bit-identical) and on ``cpu``.
4. main path at full size: `sweep` over the 100k-task mixed arena, 8
   seeds, 120 s (240 ticks), with the launch counter read around it;
   seed 0 is then rerun on the CPU path and compared.
5. the kernels line, the card line, and the result line.

Imports nothing of the JAX package. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = dict(rtol=1e-12, atol=1e-9)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP64_FLOPS = 34e12              # H100 SXM float64 rate outside tensor cores
SEEDS = 8                       # seed count of the full-size main path
PARTITIONERS = ("rebalance", "hash", "weakhash", "backlog", "rescale",
                "group_rescale")


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def errors(got, want) -> tuple[float, float, bool]:
    """(max abs err, max rel err, all within TOL) of two tensors."""
    import torch
    diff = (got - want).abs()
    ok = bool(torch.all(diff <= TOL["atol"] + TOL["rtol"] * want.abs())
              and torch.isfinite(got).all() and torch.isfinite(want).all())
    rel = diff / want.abs().clamp(min=1e-300)
    return float(diff.max()), float(torch.where(diff > 0, rel, 0.0).max()), ok


def cuda_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    CUDA events around each round."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return sorted(times)[len(times) // 2]


def phase_inputs(rng, S: int, qcap, device):
    """Task-state rows for one phase call: produced and free scaled to the
    queue capacities, 15% dead tasks, half the tasks in single-task
    failover mode, and seed 0's upper half dead (whole blocks and weakhash
    groups down: the fallback branches)."""
    import numpy as np
    import torch
    n = len(qcap)
    produced = rng.uniform(0, 1, (S, n)) * qcap * 0.02
    alive = (rng.uniform(size=(S, n)) > 0.15).astype(float)
    alive[0, n // 2:] = 0.0
    free = rng.uniform(0, 1, (S, n)) * qcap * 0.5
    ms = (rng.uniform(size=(S, n)) > 0.5).astype(float)
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                            device=device)
            for a in (produced, alive, free, ms)]


def phase_cost(eph, tb, S: int) -> tuple[float, float]:
    """(bytes, float64 operations) one phase call must move and do: every
    table read once, the task rows read at the entries the phase gathers,
    the outputs written once; operations counted over real (unpadded)
    row members and dst entries."""
    import numpy as np
    D, E = len(eph["dst_task"]), len(eph["slot_of_edge"])
    has_blk = eph["br_idx"].shape[0] > 1
    nnz = {k: int((eph[f"{k}_mask"] > 0.5).sum())
           for k in ("s", "er", "gr", "br", "bs")}
    prod_idx = [eph["s_idx"][eph["s_mask"] > 0.5],
                eph["fwd_src"][eph["m_fwd"] > 0.5]]
    if has_blk:
        prod_idx.append(eph["bs_idx"][eph["bs_mask"] > 0.5])
    n_prod = len(np.unique(np.concatenate(prod_idx)))
    table_bytes = sum(t.numel() * t.element_size() for t in tb.values())
    task_bytes = S * 8 * (n_prod + 3 * D)       # produced, alive/free/ms
    out_bytes = S * 8 * (2 * D + E)
    ops = S * (2 * nnz["s"] + 2 * nnz["bs"] + 2 * nnz["br"]
               + 6 * nnz["gr"] + 10 * nnz["er"] + 16 * D + nnz["er"]
               + nnz["br"] + 4 * nnz["er"])
    return float(table_bytes + task_bytes + out_bytes), float(ops)


def compare_phases(name, low_phases, qcap, S, rng, device, *,
                   timed=False):
    """Hold the kernel, through its counted wrapper, against the plain
    version on every routing phase; optionally time both and compute the
    bound. Returns the per-phase rows."""
    import torch
    from repro_torch.kernels.tick_phase import ops, pack_phase_tables
    from repro_torch.kernels.tick_phase.ref import tick_phase_ref

    rows = []
    for fi, ph in enumerate(low_phases):
        if not ph.D:
            continue
        eph = ph.traced()
        tb = pack_phase_tables(eph, qcap, device)
        produced, alive, free, ms = phase_inputs(rng, S, qcap, device)
        kw = dict(has_blk=ph.B > 0, has_grp=ph.G > 0)
        before = ops.launches
        got = ops.tick_phase(produced, alive, free, ms, tb, **kw)
        if ops.launches != before + 1:
            raise SystemExit(f"ops.tick_phase did not count one launch on "
                             f"{name} phase {fi}")
        want = tick_phase_ref(produced, alive, free, ms, tb, **kw)
        torch.cuda.synchronize()
        errs = [errors(g, w) for g, w in zip(got, want)]
        row = {"case": name, "phase": fi, "D": ph.D, "E": ph.E, "B": ph.B,
               "G": ph.G, "max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "bitwise_equal": all(bool(torch.equal(g, w))
                                    for g, w in zip(got, want)),
               "ok": all(e[2] for e in errs)}
        if timed:
            row["ms"] = cuda_ms(lambda: ops.tick_phase(
                produced, alive, free, ms, tb, **kw))
            row["plain_ms"] = cuda_ms(lambda: tick_phase_ref(
                produced, alive, free, ms, tb, **kw), reps=5)
            nbytes, n_ops = phase_cost(eph, tb, S)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = n_ops / FP64_FLOPS * 1e3
            row.update(bytes=nbytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
        emit(**row)
        if not row["ok"]:
            raise SystemExit(f"tick_phase kernel disagrees with the plain "
                             f"version on {name} phase {fi}")
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="0,1,2,3,4",
                    help="comma list of phases to run (all by default)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core.chaos import ChaosSpec
    from repro_torch.kernels import common
    from repro_torch.kernels.tick_phase import kernel, ops
    from repro_torch.streams import nexmark
    from repro_torch.streams.chaos_sweep import sweep
    from repro_torch.streams.engine import (FailoverConfig, build_plan,
                                            lower_tensor_plan)
    from repro_torch.streams.torch_engine import run_batch

    dev = torch.device("cuda")
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # 0. device
    emit(phase="device", nvidia_smi=card, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 1. build
    t0 = time.perf_counter()
    kernel.library()
    ptxas = [ln.strip() for ln in common.BUILD_LOG["tick_phase"]["ptxas"]
             .splitlines() if "registers" in ln or "Compiling" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=common.BUILD_LOG["tick_phase"]["seconds"],
         flags=list(common.NVCC_FLAGS + kernel.FLAGS), ptxas=ptxas)

    rng = np.random.default_rng(args.seed)
    kern = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    arena = None
    t_arena = 0.0

    def arena_100k():
        nonlocal arena, t_arena
        if arena is None:
            t = time.perf_counter()
            arena = nexmark.mega_arena(100_000, "mixed")
            t_arena = time.perf_counter() - t
        return arena

    # 2. kernel against plain
    if 2 in phases:
        for part in PARTITIONERS:
            g = nexmark.q2(parallelism=256, n_groups=16, partitioner=part)
            plan = build_plan(g, 0.5, 256.0)
            tp = lower_tensor_plan(plan)
            for r in compare_phases(f"q2/{part}", tp.phases, plan.qcap, 8,
                                    rng, dev):
                kern["max_abs_err"] = max(kern["max_abs_err"],
                                          r["max_abs_err"])
                kern["max_rel_err"] = max(kern["max_rel_err"],
                                          r["max_rel_err"])
        a = arena_100k()
        t = time.perf_counter()
        tp = lower_tensor_plan(a.plan, a.job_of_op)
        emit(phase="arena", tasks=a.plan.n_tasks, ops=len(a.plan.ops),
             jobs=a.n_jobs, build_s=t_arena,
             lower_s=time.perf_counter() - t)
        rows = compare_phases("mega_arena_100k_mixed", tp.phases,
                              a.plan.qcap, SEEDS, rng, dev, timed=True)
        for r in rows:
            kern["max_abs_err"] = max(kern["max_abs_err"], r["max_abs_err"])
            kern["max_rel_err"] = max(kern["max_rel_err"], r["max_rel_err"])
        for k in ("ms", "plain_ms", "bound_ms"):
            kern[k] = sum(r[k] for r in rows)
        kern["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                           for r in rows) else "operations")
        emit(phase="kernel_vs_plain", routing_phases=len(rows),
             per_tick_ms=kern["ms"], per_tick_plain_ms=kern["plain_ms"],
             per_tick_bound_ms=kern["bound_ms"],
             max_abs_err=kern["max_abs_err"],
             max_rel_err=kern["max_rel_err"],
             bitwise_equal=all(r["bitwise_equal"] for r in rows))

    # 3. the path on the card against the path on the CPU
    if 3 in phases:
        ss = nexmark.ss_arena(n_tasks=2016, parallelism=8, n_hosts=32)
        kw = dict(duration_s=60.0, n_hosts=32,
                  base_spec=ChaosSpec(host_kill_prob_per_s=0.01,
                                      straggler_frac=0.2),
                  failover=FailoverConfig(mode="region",
                                          region_restart_s=15.0))
        ops.launches = 0
        bc = run_batch(ss, range(4), device="cuda", **kw)
        n_launch = ops.launches
        bc2 = run_batch(ss, range(4), device="cuda", **kw)
        bp = run_batch(ss, range(4), device="cpu", **kw)
        fields = ("source_lag", "qps", "backlog", "emitted_by_job",
                  "dropped_by_job", "ckpt_epoch", "rollback_t", "thrash_t",
                  "n_rescale", "resource_s")
        worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
        for f in fields:
            a = torch.as_tensor(np.asarray(getattr(bc, f), float))
            b = torch.as_tensor(np.asarray(getattr(bp, f), float))
            fin = torch.isfinite(b)
            if not torch.equal(fin, torch.isfinite(a)) or not torch.equal(
                    a[~fin], b[~fin]):
                raise SystemExit(f"card and CPU paths disagree on {f}")
            ea, er, ok = errors(a[fin], b[fin]) if fin.any() else (0, 0, 1)
            if not ok:
                raise SystemExit(f"card and CPU paths disagree on {f}: "
                                 f"max abs {ea}, max rel {er}")
            worst["max_abs_err"] = max(worst["max_abs_err"], ea)
            worst["max_rel_err"] = max(worst["max_rel_err"], er)
        repeat = all(np.array_equal(getattr(bc, f), getattr(bc2, f))
                     for f in fields)
        same_as_cpu = [f for f in fields
                       if np.array_equal(getattr(bc, f), getattr(bp, f))]
        n_routing = sum(1 for ph in lower_tensor_plan(
            ss.plan, ss.job_of_op).phases if ph.D)
        emit(phase="card_vs_cpu", tasks=2016, seeds=4, ticks=len(bc.t),
             launches=n_launch, expected_launches=n_routing * len(bc.t),
             bit_identical_rerun=repeat, bit_identical_to_cpu=same_as_cpu,
             recoveries=[len(r) for r in bc.recoveries], **worst)
        if n_launch != n_routing * len(bc.t):
            raise SystemExit("the card path did not launch tick_phase once "
                             "per routing phase and tick")
        if not repeat:
            raise SystemExit("two card runs of the same batch differ")

    # 4. the main path at full size
    if 4 in phases:
        a = arena_100k()
        n_routing = sum(1 for ph in lower_tensor_plan(
            a.plan, a.job_of_op).phases if ph.D)
        spec = nexmark.ha_drill_spec(host_kill_prob_per_s=0.002)
        fo = FailoverConfig(mode="region", region_restart_s=15.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.launches = 0
        res = sweep(a, range(SEEDS), base_spec=spec, duration_s=120.0,
                    n_hosts=256, failover=fo, device="cuda")
        launches = ops.launches
        b = res.batch
        n_ticks = len(b.t)
        finite = bool(np.isfinite(b.qps).all()
                      and np.isfinite(b.backlog).all()
                      and np.isfinite(b.source_lag).all())
        emit(phase="main_path", tasks=a.plan.n_tasks, jobs=a.n_jobs,
             seeds=SEEDS, ticks=n_ticks, arena_build_s=t_arena,
             lower_s=res.lower_s, prep_s=res.prep_s,
             device_s=res.device_s, wall_s=res.wall_s,
             scenarios_per_s=res.scenarios_per_s,
             ticks_per_s=n_ticks / res.device_s,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             launches=launches, expected_launches=n_routing * n_ticks,
             finite=finite, qps_shape=list(b.qps.shape),
             emitted=[float(x) for x in b.emitted],
             recoveries=[len(r) for r in b.recoveries],
             job_results=len(res.job_results or {}),
             aggregate=res.aggregate())
        if launches != n_routing * n_ticks:
            raise SystemExit(f"tick_phase launched {launches} times on the "
                             f"main path, expected {n_routing * n_ticks}")
        if not finite or not (b.emitted > 0).all():
            raise SystemExit("main path outputs are not finite or empty")
        if not all(len(r) > 0 for r in b.recoveries):
            raise SystemExit("no recovery fired on the main path")
        # seed 0 of the main path against the plain CPU path
        t = time.perf_counter()
        cpu = run_batch(a, [0], duration_s=120.0, base_spec=spec,
                        n_hosts=256, failover=fo, device="cpu")
        worst = {"max_abs_err": 0.0, "max_rel_err": 0.0}
        for f in ("source_lag", "qps", "backlog", "emitted_by_job",
                  "dropped_by_job", "resource_s"):
            ea, er, ok = errors(torch.as_tensor(getattr(b, f)[:1]),
                                torch.as_tensor(getattr(cpu, f)))
            if not ok:
                raise SystemExit(f"main path seed 0 disagrees with the CPU "
                                 f"path on {f}: {ea} {er}")
            worst["max_abs_err"] = max(worst["max_abs_err"], ea)
            worst["max_rel_err"] = max(worst["max_rel_err"], er)
        emit(phase="main_path_vs_cpu", seed=0, cpu_s=time.perf_counter() - t,
             **worst)
        kern["launches"] = launches

    # 5. the kernels line, the card line, the result line
    if {2, 4} <= phases:
        print(json.dumps({"kernels": [{
            "name": "tick_phase", "route": "cuda",
            "source": "src/repro_torch/csrc/tick_phase.cu",
            "replaces": "src/repro/kernels/tick_phase/kernel.py:43",
            "launches": kern["launches"],
            "max_abs_err": kern["max_abs_err"],
            "max_rel_err": kern["max_rel_err"],
            "ms": kern["ms"], "kernel_ms": kern["ms"],
            "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
            "bound_by": kern["bound_by"], "library_ms": None}]}),
            flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
