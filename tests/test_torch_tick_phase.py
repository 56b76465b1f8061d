"""The port's tick-phase plain version equals the JAX package's kernel.

`repro_torch.kernels.tick_phase.ref.tick_phase_ref` (torch, CPU) is held
at 1e-12 against the JAX package's `tick_phase` through both its jnp
reference (``impl="ref"``) and the Pallas kernel body under the
interpreter (``impl="interpret"``), on every routing phase of a packed SS
arena and of Q2 under the block and group partitioners, with the same
numpy inputs. The CUDA kernel is held against the plain version on the
card by `tests/test_torch_cuda.py`.
"""
import numpy as np
import pytest
import torch

from repro.kernels.tick_phase import pack_phase_tables as r_pack
from repro.kernels.tick_phase import tick_phase as r_tick_phase
from repro.streams import nexmark as rnx
from repro.streams.engine import FailoverConfig as RFo
from repro.streams.jax_engine import _Lowered as RLowered
from repro.streams.jax_engine import _enable_x64
from repro_torch.kernels.tick_phase import ops, pack_phase_tables
from repro_torch.kernels.tick_phase.ref import tick_phase_ref

TOL = dict(rtol=1e-12, atol=1e-9)
S = 8


def _graph(name):
    if name == "ss_arena":
        return rnx.ss_arena(n_tasks=168, parallelism=4, n_hosts=8)
    return rnx.q2(parallelism=16, partitioner=name, n_groups=4)


def _inputs(seed, n, qcap):
    """Task rows scaled to the queue capacities, seed 0's upper half dead
    (whole blocks / groups down), and a random single-task mode row."""
    rng = np.random.default_rng(seed)
    produced = rng.uniform(0, 1, (S, n)) * qcap * 0.02
    alive = (rng.uniform(size=(S, n)) > 0.15).astype(float)
    alive[0, n // 2:] = 0.0
    free = rng.uniform(0, 1, (S, n)) * qcap * 0.5
    mode_single = (rng.uniform(size=n) > 0.5).astype(float)
    return produced, alive, free, mode_single


def _phases(name):
    low = RLowered(_graph(name), n_hosts=8, dt=0.5, queue_cap=256.0,
                   failover=RFo(mode="single_task"), ckpt=None, seed=0,
                   phase_mode="pallas")
    return low, [(fi, ph) for fi, ph in enumerate(low.tensor.phases)
                 if ph.D]


CASES = [(g, fi) for g in ("ss_arena", "weakhash", "rescale",
                           "group_rescale")
         for fi, _ in _phases(g)[1]]


@pytest.mark.parametrize("graph,fi", CASES)
@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_plain_version_matches_jax(graph, fi, impl):
    import jax.numpy as jnp

    low, phases = _phases(graph)
    ph = dict(phases)[fi]
    qcap = low.arrays["qcap"]
    produced, alive, free, mode_single = _inputs(fi, low.plan.n_tasks, qcap)
    eph = low.arrays["edges"][fi]
    with _enable_x64():
        tb = r_pack(eph, qcap, mode_single)
        want = r_tick_phase(jnp.asarray(produced), jnp.asarray(alive),
                            jnp.asarray(free), tb, has_blk=ph.B > 0,
                            has_grp=ph.G > 0, impl=impl)
        want = [np.asarray(w) for w in want]
    tt = pack_phase_tables(eph, qcap, "cpu")
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    ms_eff = np.broadcast_to(mode_single, (S, len(mode_single))).copy()
    got = tick_phase_ref(t(produced), t(alive), t(free), t(ms_eff), tt,
                         has_blk=ph.B > 0, has_grp=ph.G > 0)
    for name, g, w in zip(("accepted", "dropped", "overflow"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


def test_cases_cover_every_branch():
    """Blocks, groups, drops and head-of-line limits all occur."""
    kinds = {g: [(ph.B > 0, ph.G > 0) for _, ph in _phases(g)[1]]
             for g in ("ss_arena", "weakhash", "rescale", "group_rescale")}
    assert any(b for v in kinds.values() for b, _ in v)
    assert any(g for v in kinds.values() for _, g in v)
    low, phases = _phases("ss_arena")
    dropped = limited = 0.0
    for fi, ph in phases:
        produced, alive, free, mode_single = _inputs(
            fi, low.plan.n_tasks, low.arrays["qcap"])
        tt = pack_phase_tables(low.arrays["edges"][fi], low.arrays["qcap"],
                               "cpu")
        ms = torch.as_tensor(np.broadcast_to(mode_single,
                                             alive.shape).copy())
        _, drop, ovf = tick_phase_ref(
            torch.as_tensor(produced), torch.as_tensor(alive),
            torch.as_tensor(free), ms, tt, has_blk=ph.B > 0,
            has_grp=ph.G > 0)
        dropped += float(drop.sum())
        limited += float(ovf.sum())
    assert dropped > 0.0 and limited > 0.0


def test_wrapper_takes_plain_version_for_cpu_tensors():
    """CPU tensors go to the plain version and count no kernel launch;
    a tensor on any other device raises instead of falling back."""
    low, phases = _phases("rescale")
    fi, ph = phases[0]
    n = low.plan.n_tasks
    produced, alive, free, mode_single = _inputs(0, n, low.arrays["qcap"])
    tt = pack_phase_tables(low.arrays["edges"][fi], low.arrays["qcap"],
                           "cpu")
    rows = [torch.as_tensor(a) for a in (produced, alive, free)]
    ms = torch.as_tensor(np.broadcast_to(mode_single, (S, n)).copy())
    before = ops.launches
    got = ops.tick_phase(*rows, ms, tt, has_blk=True, has_grp=False)
    want = tick_phase_ref(*rows, ms, tt, has_blk=True, has_grp=False)
    assert ops.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.tick_phase(rows[0].to("meta"), *rows[1:], ms, tt,
                       has_blk=True, has_grp=False)


def test_pack_rejects_edge_rows_that_do_not_partition_dst():
    low, phases = _phases("ss_arena")
    fi, _ = phases[0]
    eph = dict(low.arrays["edges"][fi])
    er_mask = eph["er_mask"].copy()
    er_mask[0, 0] = 0.0                      # drop one dst entry
    eph["er_mask"] = er_mask
    with pytest.raises(ValueError, match="partition"):
        pack_phase_tables(eph, low.arrays["qcap"], "cpu")
