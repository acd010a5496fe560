"""Lazy nvcc build and ctypes binding of the port's CUDA kernels.

The pattern of supersampler_tpu/native.py:26-60, for CUDA: the sources
in ``csrc/*.cu`` have a plain C interface and compile with ``nvcc`` for
``sm_90a`` into one shared library under ``build/torch_kernels/`` at
the first CUDA call, and again whenever a source is newer than the
library. Each source compiles in its own ``nvcc`` process, all started
together, then one more links them. A failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = [os.path.join(_PKG, "csrc", f)
            for f in ("scan.cu", "sweep.cu", "walk.cu")]
_OUT_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
_LIB = os.path.join(_OUT_DIR, "libspsp_torch_kernels.so")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
          "-v"]

_lock = threading.Lock()
_lib = None
#: wall seconds of this process's nvcc build (None: the library was
#: already up to date)
build_seconds = None
#: ptxas's report of that build (registers, spills, per kernel)
build_log = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the "
                           "CUDA kernels cannot be built")
    return found


def _stale() -> bool:
    if not os.path.exists(_LIB):
        return True
    built = os.path.getmtime(_LIB)
    return any(os.path.getmtime(s) > built for s in _SOURCES)


def _finish(cmd, proc) -> str:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}{err}")
    return err


def _build() -> str:
    """Compile and link; returns ptxas's report."""
    os.makedirs(_OUT_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs, jobs = [], []
    for src in _SOURCES:
        obj = os.path.join(_OUT_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    tmp = f"{_LIB}.{tag}.tmp"
    try:
        report = "".join(_finish(cmd, proc) for cmd, proc in jobs)
        cmd = [nvcc, *_ARCH, "-shared", "-o", tmp, *objs]
        _finish(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    finally:
        for _cmd, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, _LIB)
    return report


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            t0 = time.perf_counter()
            build_log = _build()
            build_seconds = time.perf_counter() - t0
        lb = ctypes.CDLL(_LIB)
        lb.spsp_cuda_error_string.restype = ctypes.c_char_p
        lb.spsp_cuda_error_string.argtypes = [_I]
        lb.spsp_scan.restype = _I
        lb.spsp_scan.argtypes = (
            [_P, _I64, _I64, _I, _I, _P] + [_P] * 9 + [_P])
        lb.spsp_scan2.restype = _I
        lb.spsp_scan2.argtypes = [_P, _I64, _I64, _I, _I] + [_P] * 9 + [_P]
        lb.spsp_sweep.restype = _I
        lb.spsp_sweep.argtypes = (
            [_P] * 7 + [_P, _P, _U32, _U32, _I, _I, _I, _I, _I]
            + [_P] * 4 + [_P])
        lb.spsp_walk.restype = _I
        lb.spsp_walk.argtypes = [_P, _I] + [_P] * 8
        lb.spsp_walk_work_bytes.restype = _I64
        lb.spsp_walk_work_bytes.argtypes = [_I]
        _lib = lb
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err:
        msg = _lib.spsp_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def launch(name: str, dev, *args) -> None:
    """Call the C entry ``name`` on ``args`` and the current stream of
    ``dev``, with ``dev`` made the current device for the call: a launch
    into the stream of a card that is not current is not reliably
    refused (the scan then returned wrong tables with no error), and an
    entry's cudaFuncSetAttribute acts on the current device. Raises on
    a CUDA error."""
    with torch.cuda.device(dev):
        err = getattr(lib(), name)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    check(err, name)
