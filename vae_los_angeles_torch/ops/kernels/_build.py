"""Build and load the port's CUDA kernels.

Each ``vae_los_angeles_torch/csrc/<name>.cu`` has a plain C interface. At
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/torch_kernels/lib<name>.so`` beside the package, and loaded with
``ctypes``; it is rebuilt when the source is newer than the library. Nothing
is compiled when a module is imported, so the CPU tests import every module
on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import signal
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time; 0.0 when an up-to-date library was reused
    log: str  # nvcc/ptxas output (registers, shared memory, spills); "" when reused


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if not candidate.exists():
            raise RuntimeError(
                "nvcc not found on PATH or under CUDA_HOME "
                f"({cuda_home}); the CUDA toolkit is needed to build the kernels"
            )
        nvcc = str(candidate)
    return nvcc


def _stale(name: str) -> bool:
    so = BUILD_DIR / f"lib{name}.so"
    return not so.exists() or so.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu``; returns (process, tmp path, cmd, t0)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}.so"
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    # its own process group, so that stopping it stops the compilers it runs
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return proc, tmp, cmd, time.perf_counter()


def _finish(name: str, started) -> Built:
    proc, tmp, cmd, t0 = started
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    so = BUILD_DIR / f"lib{name}.so"
    os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    return Built(ctypes.CDLL(str(so)), so, seconds, log)


_BUILT: dict = {}


def build_all(names) -> dict:
    """Compile every stale ``csrc/<name>.cu`` at once (one nvcc each, all
    started together) and load each library once per process."""
    started = {n: _start(n) for n in names if n not in _BUILT and _stale(n)}
    try:
        for n in names:
            if n in _BUILT:
                continue
            if n in started:
                _BUILT[n] = _finish(n, started.pop(n))
            else:
                so = BUILD_DIR / f"lib{n}.so"
                _BUILT[n] = Built(ctypes.CDLL(str(so)), so, 0.0, "")
    finally:  # a failed build stops the others: no nvcc outlives the call
        for proc, tmp, _, _ in started.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:  # its group has ended already
                pass
            proc.wait()
            tmp.unlink(missing_ok=True)
    return {n: _BUILT[n] for n in names}


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return build_all([name])[name]
