"""Wrapper of the fused tick-phase kernel, with dispatch by device.

Counterpart of ``src/repro/kernels/tick_phase/ops.py``.
`pack_phase_tables` stacks one phase's `engine.CompactPhase` dict into
the kernel's operand layout: two packed tables (int structure and float
masks/params) plus the pow2 row tables, int32 indices throughout.
`tick_phase` takes the plain version (`ref.tick_phase_ref`) for CPU
tensors and launches the CUDA kernel (`kernel.launch`) for CUDA tensors;
``launches`` counts the kernel launches.

The TPU package's ``choose_seed_block`` / ``table_bytes`` size the seed
block against VMEM; the CUDA kernel has no such block and they are not
carried over.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import route
from repro_torch.kernels.tick_phase import ref

# di/df packed-table row layouts (keep in sync with ref.tick_phase_ref and
# the DI_*/DF_* enums of csrc/tick_phase.cu). Unlike the TPU tables, df has
# no mode_single row: the drop mask reads the per-tick ms_eff operand.
DI_ROWS = ("dst_task", "fwd_src", "edge_of", "grp_of", "blk_of")
DF_ROWS = ("m_fwd", "m_blk", "m_hash", "m_weakhash", "m_backlog",
           "is_norm", "m_acc_static", "m_acc_block", "dst_in_blk",
           "share", "mass", "qcap_d")
# kernel operand order after the four task-state rows
TABLE_KEYS = ("di", "df", "s_idx", "s_mask", "soe", "er_idx", "er_mask",
              "gr_idx", "gr_mask", "br_idx", "br_mask", "bs_idx",
              "bs_mask")

#: CUDA kernel launches made through `tick_phase` (the CPU path does not
#: count); a caller resets it to 0 and reads it after a run
launches = 0


def pack_phase_tables(eph: dict, qcap, device) -> dict:
    """Pack one phase's `CompactPhase` dict of numpy arrays into the
    kernel operand layout on ``device``. ``qcap_d`` is gathered
    onto the dst axis here, once per run.

    The edge rows must partition the D axis (every dst entry sits in
    exactly one edge row, the row of its ``edge_of``): the kernel's last
    stage writes each entry's acceptance from its edge row alone."""
    def arr(k):
        return np.asarray(eph[k])

    dst = arr("dst_task").astype(np.int64)
    D = len(dst)
    er_idx, er_mask = arr("er_idx"), arr("er_mask")
    members = er_idx[er_mask > 0.5]
    rows = np.nonzero(er_mask > 0.5)[0]
    if not (len(members) == D and np.array_equal(np.sort(members),
                                                  np.arange(D))
            and np.array_equal(arr("edge_of")[members], rows)):
        raise ValueError("edge rows must partition the dst axis")
    qcap = np.asarray(qcap)

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    def f64(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float64),
                               device=device)

    return {
        "di": i32(np.stack([arr(k) for k in DI_ROWS])),
        "df": f64(np.stack([arr(k) for k in DF_ROWS[:-1]] + [qcap[dst]])),
        "s_idx": i32(arr("s_idx")), "s_mask": f64(arr("s_mask")),
        "soe": i32(arr("slot_of_edge")),
        "er_idx": i32(er_idx), "er_mask": f64(er_mask),
        "gr_idx": i32(arr("gr_idx")), "gr_mask": f64(arr("gr_mask")),
        "br_idx": i32(arr("br_idx")), "br_mask": f64(arr("br_mask")),
        "bs_idx": i32(arr("bs_idx")), "bs_mask": f64(arr("bs_mask")),
    }


def tick_phase(produced, alive, free, ms_eff, tb, *, has_blk: bool,
               has_grp: bool):
    """``(accepted, dropped_d, overflow_e)`` of one fused routing phase
    over a ``(S, n_tasks)`` seed batch — see `ref.tick_phase_ref` for
    the contract. CPU tensors take the plain version; CUDA tensors
    launch the kernel, or the call raises."""
    global launches
    if route(produced, alive, free, ms_eff, *tb.values()) == "ref":
        return ref.tick_phase_ref(produced, alive, free, ms_eff, tb,
                                  has_blk=has_blk, has_grp=has_grp)
    from repro_torch.kernels.tick_phase import kernel
    out = kernel.launch(produced, alive, free, ms_eff, tb,
                        has_blk=has_blk, has_grp=has_grp)
    launches += 1
    return out
