"""PyTorch/CUDA port of the StreamShield reproduction.

A package beside the JAX reference ``src/repro/``: it imports ``torch``
and ``numpy`` only, never ``jax`` and nothing of ``repro``. The slice
ported so far is the chaos-sweep main path: ``streams.chaos_sweep.sweep``
→ ``streams.torch_engine.run_batch`` → the seed-batched tick → the
hand-written CUDA kernel ``kernels.tick_phase`` (``csrc/tick_phase.cu``).
"""
