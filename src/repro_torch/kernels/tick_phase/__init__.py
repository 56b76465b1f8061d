"""Fused tick-phase kernel: one routing phase of the seed-batched tick.

`ops.tick_phase` runs the plain PyTorch version (`ref.py`) on CPU
tensors and the hand-written CUDA kernel (`kernel.py`,
``csrc/tick_phase.cu``) on CUDA tensors; `ops.pack_phase_tables` packs
one phase's `engine.CompactPhase` tables into the kernel's operands.
Consumed by `streams.torch_engine`.
"""
from repro_torch.kernels.tick_phase.ops import (DF_ROWS, DI_ROWS, TABLE_KEYS,
                                                pack_phase_tables,
                                                tick_phase)

__all__ = ["DF_ROWS", "DI_ROWS", "TABLE_KEYS", "pack_phase_tables",
           "tick_phase"]
