"""Build and load the port's CUDA kernels: ``nvcc`` by hand into a shared
library with a plain C interface, bound with ``ctypes``.

The library is built at first use into ``build/gym_tpu_torch/`` at the root
of the checkout, keyed by a hash of the sources and flags, so a fresh
checkout builds it on its first kernel launch and later processes reuse it.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(_ROOT, "build", "gym_tpu_torch")
SOURCES = (os.path.join(_HERE, "csrc", "fused_attention.cu"),)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# the ptxas report (registers, shared memory, spills) of the last build
build_log = ""


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of gym_tpu_torch are built on the "
        "machine with the card (set CUDA_HOME or put nvcc on PATH)")


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"gym_kernels_{_tag()}.so")


def build() -> str:
    """Compile the sources unless a library of the same hash exists; returns
    its path. The compiler's ``-Xptxas -v`` report is kept in ``build_log``
    and beside the library."""
    global build_log
    path = library_path()
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        if os.path.exists(log_path):
            with open(log_path) as f:
                build_log = f.read()
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}")
    with open(log_path, "w") as f:
        f.write(build_log)
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.gym_attn_fwd.argtypes = [vp] * 5 + [strides] + [i32] * 5 + [
            f32, i32, vp]
        lib.gym_attn_fwd.restype = i32
        lib.gym_attn_bwd.argtypes = [vp] * 11 + [strides] + [i32] * 5 + [
            f32, i32, vp]
        lib.gym_attn_bwd.restype = i32
        lib.gym_attn_smem_bytes.argtypes = [i32, i32]
        lib.gym_attn_smem_bytes.restype = ctypes.c_longlong
        lib.gym_attn_error_string.argtypes = [i32]
        lib.gym_attn_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if code != 0:
        msg = lib.gym_attn_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
