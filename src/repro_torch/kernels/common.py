"""Kernel dispatch and build helpers of the port.

Counterpart of ``src/repro/kernels/common.py``. Dispatch is by the
device of the tensors a wrapper is given, never by an environment
variable: CPU tensors go to the kernel's plain PyTorch version, CUDA
tensors go to the hand-written kernel or the call raises. There is no
fallback from one to the other.

Kernels are CUDA C++ sources under ``src/repro_torch/csrc/`` with a plain
C interface. `build_library` compiles one with ``nvcc`` for ``sm_90a``
into ``build/kernels/`` of the checkout at first use, keyed on a hash of
the sources and flags, and loads it with `ctypes`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: per-library build record: seconds spent in nvcc (0.0 when the library
#: was already built) and the compiler's ``-Xptxas -v`` report
BUILD_LOG: dict[str, dict] = {}

_LIBS: dict[pathlib.Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def route(*tensors: torch.Tensor) -> str:
    """``"ref"`` when every tensor lies on the CPU, ``"cuda"`` when every
    tensor lies on a CUDA device; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "ref"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"kernel operands must all lie on the CPU or all on "
                     f"CUDA, got {sorted(kinds)}")


def resolve_device(device: str | torch.device | None) -> torch.device:
    """An entry point's ``device`` argument: ``None`` means CUDA, and
    raises when no CUDA device is present (the plain CPU path is only
    taken when asked for)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass "
                               "device='cpu' to run the plain path")
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit at first use")
    return str(path)


def build_library(name: str, sources, flags=()) -> ctypes.CDLL:
    """Compile ``sources`` into ``build/kernels/<name>-<hash>.so`` unless
    that file exists, then load it (once per process)."""
    sources = [pathlib.Path(s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for s in sources:
        h.update(s.read_bytes())
    so = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    with _LOCK:
        if so in _LIBS:
            return _LIBS[so]
        t0 = time.perf_counter()
        log = ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # a private file renamed into place: another process never
            # loads a half-written library
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
                   *map(str, sources)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n"
                                   f"{' '.join(cmd)}\n{res.stderr}")
            os.replace(tmp, so)
            log = res.stderr
        _LIBS[so] = ctypes.CDLL(str(so))
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": log, "path": str(so)}
        return _LIBS[so]
