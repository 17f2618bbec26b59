"""Build and load the hand-written CUDA kernels under ``repro_torch/csrc``.

Every ``*.cu`` source is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The library lands
in ``build/`` at the repository root under a name keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the cached library.  Nothing here runs at import time: the first kernel
launch builds.  A failed build raises; there is no prebuilt binary.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["library", "check", "build_seconds", "SOURCES"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("segment_reduce.cu", "block_transpose.cu", "onehot_encode.cu",
           "window_scan.cu", "decode_attention.cu", "decode_attention_tc.cu",
           "linear_scan.cu", "flash_attention.cu", "flash_attention_tc.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# (name, argtypes): every pointer and the stream as c_void_p, or ctypes would
# pass them as 32-bit ints and cut them.
_SIGNATURES = {
    "repro_segment_reduce": (_P, _P, _P, _P, _I64, _I32, _I64, _I64, _I32,
                             _I32, _I32, _I64, _I32, _P),
    "repro_segment_reduce_reg": (_P, _P, _P, _P, _P, _I64, _I32, _I64, _I32, _I32, _I32,
                                 _I64, _P),
    "repro_block_transpose": (_P, _P, _I64, _I64, _P),
    "repro_onehot_encode": (_P, _P, _I64, _I64, _P),
    "repro_window_scan": (_P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I64, _P),
    "repro_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                               _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                               _I64, _I32, _F32, _P),
    "repro_decode_attention_tc": (_P, _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I64,
                                  _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I32,
                                  _I32, _F32, _P),
    "repro_linear_scan": (_P, _P, _P, _I32, _I64, _I32, _I64, _I64, _I64, _I64, _I32, _P),
    "repro_linear_scan_bwd": (_P, _P, _P, _P, _P, _I32, _I64, _I32, _I64, _I64, _I64, _I64,
                              _I64, _I64, _I32, _P),
    "repro_flash_attention": (_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I64, _I64,
                              _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                              _I32, _I64, _F32, _P),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_BUILD_SECONDS: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch cannot be built on this machine")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for name, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        so = Path(tmp) / target.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(so)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, target)   # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The kernel library, built on first use (thread-safe; once loaded,
    returned without taking the lock)."""
    global _LIB, _BUILD_SECONDS
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
        t0 = time.perf_counter()
        if not target.exists():
            _compile(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _BUILD_SECONDS = time.perf_counter() - t0
        _LIB = lib
        return lib


def build_seconds() -> float | None:
    """Seconds the first ``library()`` call took (build or load), else None."""
    return _BUILD_SECONDS


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")
