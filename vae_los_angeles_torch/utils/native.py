"""Build and load the port's host C++ (counterpart of
``vae_los_angeles_tpu/utils/native.py``).

The one native piece is the DNA-methylation preparation's pivot
(``data/_native/pivot_impute.cpp``): dedup, the dense patient × probe
matrix and the per-patient mean imputation in one pass over flat arrays,
where the pandas formulation builds an O(patients · probes) cross-product
of Python tuples. It is host code, not a kernel of the card.

At first use it is compiled with ``g++ -O3 -shared -fPIC`` into
``build/torch_kernels/pivot_impute-<hash>.so`` beside the package (the
hash is of the source, so an edit rebuilds; the file is published
atomically), and loaded with ctypes. Unlike the JAX package's loader,
nothing degrades quietly: a failed build or load raises, and says that
``build_imputed_matrix(..., engine="pandas")`` needs no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "data" / "_native" / "pivot_impute.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LOADED: dict = {}


def _library(src: Path, stem: str) -> Path:
    """The built library of ``src``, compiled first where it is missing."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}-{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {src.name} ({e}); "
                           "build_imputed_matrix(..., engine='pandas') needs no compiler") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}\n"
                           "build_imputed_matrix(..., engine='pandas') needs no compiler")
    os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    return so


def load_pivot_impute():
    """The ctypes function ``pivot_impute`` (built at first use, loaded once
    a process); raises when it cannot be built or loaded."""
    if "pivot_impute" not in _LOADED:
        so = _library(SOURCE, "pivot_impute")
        try:
            fn = ctypes.CDLL(str(so)).pivot_impute
        except OSError as e:
            raise RuntimeError(f"cannot load {so} ({e}); remove it to rebuild, or use "
                               "build_imputed_matrix(..., engine='pandas')") from e
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # pat
            ctypes.POINTER(ctypes.c_int32),  # probe
            ctypes.POINTER(ctypes.c_double),  # beta
            ctypes.c_int64,  # n
            ctypes.c_int32,  # P
            ctypes.c_int32,  # K
            ctypes.POINTER(ctypes.c_double),  # out (P*K)
        ]
        _LOADED["pivot_impute"] = fn
    return _LOADED["pivot_impute"]


def pivot_impute(pat, probe, beta, n_patients: int, n_probes: int) -> np.ndarray:
    """The (n_patients, n_probes) float64 matrix of the rows (pat[i],
    probe[i], beta[i]): the first occurrence of a cell wins (a NaN beta
    too), an unobserved cell takes its patient's mean over the non-NaN
    cells (summed in probe order), a patient without one stays NaN."""
    pat = np.ascontiguousarray(pat, dtype=np.int32)
    probe = np.ascontiguousarray(probe, dtype=np.int32)
    beta = np.ascontiguousarray(beta, dtype=np.float64)
    if not pat.ndim == probe.ndim == beta.ndim == 1 or not len(pat) == len(probe) == len(beta):
        raise ValueError(f"pat, probe and beta must be 1-D of one length, got {pat.shape}, "
                         f"{probe.shape}, {beta.shape}")
    out = np.empty((n_patients, n_probes), dtype=np.float64)
    rc = load_pivot_impute()(
        pat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        probe.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        beta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(beta), n_patients, n_probes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise ValueError(f"pivot_impute failed with code {rc}: a code outside "
                         f"[0, {n_patients}) x [0, {n_probes})")
    return out
