"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds, not minutes). Libraries land in ``build/`` beside
the package, named by a hash of the source, the shared header and the
flags, so an edited source rebuilds and an unchanged one is reused. The
first :func:`load` builds every missing library at once, one ``nvcc``
process per source, all started together.

Calling conventions the kernel wrappers rely on: every pointer and the
stream are ``c_void_p``; every C entry returns ``cudaGetLastError()``
after its launch, and :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("gemv", "flat_gemm", "decode_attention", "flash_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error code."""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise KernelBuildError(
            "nvcc not found on PATH or under CUDA_HOME; the port's kernels "
            "build only on a machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every library that is not built yet, all in parallel.
    Returns seconds per source compiled now (0.0 = reused)."""
    nvcc = None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {}
    for name in SOURCES:
        dst = lib_path(name)
        if dst.exists():
            secs[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst, time.perf_counter())
    failed = []
    for name, (proc, tmp, dst, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, dst)   # atomic: concurrent builds agree
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` with ``argtypes`` set
    from ``signatures`` (C entry name -> ctypes argument types); every
    entry returns ``int``."""
    lib = _libs.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, entry: str, code: int) -> None:
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise KernelLaunchError(f"{entry}: CUDA error {code} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


VP, I32, I64, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_float)
