"""Build and load the port's CUDA kernels: ``nvcc`` by hand into a shared
library with a plain C interface, bound with ``ctypes``. Each source is
compiled by its own ``nvcc``, all started together, and the objects are
linked into one library.

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
_CSRC = os.path.join(_HERE, "csrc")
SOURCES = tuple(os.path.join(_CSRC, f) for f in ("fused_attention.cu",
                                                 "flash_attention.cu",
                                                 "threefry.cu"))
HEADERS = tuple(os.path.join(_CSRC, f) for f in ("attn_common.cuh",
                                                 "hopper.cuh"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for src in SOURCES + HEADERS:
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
    nvcc = _nvcc()
    tmp = f"{path}.tmp{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    outs = [p.communicate()[0] for p in procs]
    build_log = "".join(outs)
    for cmd, p, out in zip(compiles, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    build_log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                           f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        os.remove(obj)
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
        lib.gym_flash_fwd.argtypes = [vp] * 6 + [strides] + [i32] * 4 + [
            f32, i32, vp]
        lib.gym_flash_fwd.restype = i32
        lib.gym_flash_split_kv.argtypes = [vp] * 5 + [strides] + [
            i32] * 4 + [vp]
        lib.gym_flash_split_kv.restype = i32
        lib.gym_flash_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.gym_flash_occupancy.restype = i32
        lib.gym_attn_smem_bytes.argtypes = [i32, i32]
        lib.gym_attn_smem_bytes.restype = ctypes.c_longlong
        u32, i64 = ctypes.c_uint, ctypes.c_longlong
        lib.gym_threefry_bits.argtypes = [u32, u32, i64, vp, vp]
        lib.gym_threefry_bits.restype = i32
        lib.gym_bernoulli_segments.argtypes = [vp, i32, i64, f32, vp, vp]
        lib.gym_bernoulli_segments.restype = i32
        lib.gym_attn_error_string.argtypes = [i32]
        lib.gym_attn_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError``)."""
    if code != 0:
        msg = lib.gym_attn_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
