"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/paddle_tpu_torch/<name>-<hash>.so

The file name carries a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source never loads a stale library.
``ptxas -v`` output (registers, spills) is kept beside the library. Pointers and the stream cross
the boundary as ``c_void_p``; every C entry returns ``cudaGetLastError()``
and :func:`check` raises when it is not 0.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels build on the machine that has the card")
    return path


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(names) -> dict[str, str]:
    """Compile every named source that has no current library yet, all
    ``nvcc`` processes started together. Returns ``{name: ptxas log}``.
    Raises with the compiler's output when any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: ptxas_log(name) for name in names}


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the current library for ``name``."""
    log = _target(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C entry to its ctypes ``argtypes`` (every entry returns int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def dtype_code(dtype, what: str) -> int:
    """The C entries' element-type code: 0 = fp32, 1 = bf16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    return codes[dtype]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize()`` would not report it)."""
    if err != 0:
        msg = lib.ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
