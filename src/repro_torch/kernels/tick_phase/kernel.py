"""Launch of the hand-written CUDA tick-phase kernel (``csrc/tick_phase.cu``).

Replaces the TPU kernel ``src/repro/kernels/tick_phase/kernel.py::
_phase_kernel``. The source is compiled for ``sm_90a`` at first use
(`common.build_library`) and called through its plain C entry
``tick_phase_launch(ptrs, dims, stream)``: an array of device pointers in
`PTRS` order, an array of sizes in `DIMS` order, and the current CUDA
stream. The entry launches a short chain of stages on that stream and
returns ``cudaGetLastError()``; `launch` raises when it is not 0. The
kernel allocates nothing and does not synchronise: `launch` allocates the
outputs and one float64 workspace with `torch.empty`.

Compiled with ``-fmad=false`` so that no product and sum are contracted
into one rounding: every operation rounds as the plain version's does.
A ``-fmad=true`` build gave bitwise-equal outputs on every routing phase
of the 100k-task mixed arena on an H100 (its products are with 0/1
masks or not followed by an add), so the flag costs nothing here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import CSRC, build_library
from repro_torch.kernels.tick_phase.ops import DF_ROWS, DI_ROWS, TABLE_KEYS

SOURCE = CSRC / "tick_phase.cu"
FLAGS = ("-fmad=false",)
# pointer / size operand order of tick_phase_launch (the P_* / D_* enums)
PTRS = ("produced", "alive", "free", "ms_eff") + TABLE_KEYS + (
    "work", "accepted", "dropped", "overflow")
DIMS = ("S", "n_tasks", "D", "E", "Rs", "Ls", "Le", "G1", "Lg", "B1", "Lb",
        "Lbs", "has_blk", "has_grp")


@functools.cache
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built once per process, so a
    launch does not re-hash the source)."""
    lib = build_library("tick_phase", [SOURCE], FLAGS)
    lib.tick_phase_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib.tick_phase_launch.restype = ctypes.c_int
    return lib


def workspace_size(S: int, dims: dict) -> int:
    """float64 workspace elements: tot_slot (S,Rs), prod_blk / alive_blk /
    lam_b (S,B1), capsum / capsum_fb (S,G1), rs / lam_e (S,E), arriving /
    ratio (S,D) — carved in this order by the C entry."""
    return S * (dims["Rs"] + 3 * dims["B1"] + 2 * dims["G1"]
                + 2 * dims["E"] + 2 * dims["D"])


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"tick_phase operand {name}: expected contiguous "
                         f"{dtype} {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def launch(produced, alive, free, ms_eff, tb, *, has_blk: bool,
           has_grp: bool):
    """Run the kernel on CUDA tensors; same contract as
    `ref.tick_phase_ref`."""
    dev = produced.device
    S, n = produced.shape
    D = tb["di"].shape[1]
    dims = {"S": S, "n_tasks": n, "D": D, "E": tb["er_idx"].shape[0],
            "Rs": tb["s_idx"].shape[0], "Ls": tb["s_idx"].shape[1],
            "Le": tb["er_idx"].shape[1], "G1": tb["gr_idx"].shape[0],
            "Lg": tb["gr_idx"].shape[1], "B1": tb["br_idx"].shape[0],
            "Lb": tb["br_idx"].shape[1], "Lbs": tb["bs_idx"].shape[1],
            "has_blk": int(has_blk), "has_grp": int(has_grp)}
    if S < 1 or D < 1 or dims["E"] < 1 or dims["Rs"] < 1:
        raise ValueError(f"tick_phase needs S, D, E, Rs >= 1: {dims}")
    f64, i32 = torch.float64, torch.int32
    for name, t in (("produced", produced), ("alive", alive),
                    ("free", free), ("ms_eff", ms_eff)):
        _check(name, t, f64, (S, n))
    _check("di", tb["di"], i32, (len(DI_ROWS), D))
    _check("df", tb["df"], f64, (len(DF_ROWS), D))
    _check("soe", tb["soe"], i32, (dims["E"],))
    for k in ("s", "er", "gr", "br", "bs"):
        idx, mask = tb[f"{k}_idx"], tb[f"{k}_mask"]
        _check(f"{k}_idx", idx, i32, idx.shape)
        _check(f"{k}_mask", mask, f64, idx.shape)
    if tb["bs_idx"].shape[0] != dims["B1"]:
        raise ValueError("bs and br row tables must have B+1 rows each")
    ops = {"produced": produced, "alive": alive, "free": free,
           "ms_eff": ms_eff, **{k: tb[k] for k in TABLE_KEYS}}
    if any(t.device != dev for t in ops.values()):
        raise ValueError("tick_phase operands must lie on one device")
    ops["work"] = torch.empty(workspace_size(S, dims), dtype=f64,
                              device=dev)
    out = (torch.empty((S, D), dtype=f64, device=dev),
           torch.empty((S, D), dtype=f64, device=dev),
           torch.empty((S, dims["E"]), dtype=f64, device=dev))
    ops["accepted"], ops["dropped"], ops["overflow"] = out
    ptrs = (ctypes.c_void_p * len(PTRS))(*(ops[k].data_ptr() for k in PTRS))
    sizes = (ctypes.c_longlong * len(DIMS))(*(dims[k] for k in DIMS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().tick_phase_launch(ptrs, sizes, stream)
    if err:
        raise RuntimeError(f"tick_phase kernel launch failed: CUDA error "
                           f"{err}")
    return out
