"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -split-compile=0
         -o build/paddle_tpu_torch/<name>-<hash>.so

``-split-compile=0`` runs the device compiler's optimizer on every core:
``mega_decode.cu`` (44 kernels) took 93 s with it against 258 s without on
the H100's 8-core host, with the same registers and spills for every
kernel.

The file name carries a hash of the source, every other ``csrc`` file (the
shared ``*.cuh`` headers, and sources another includes, as
``mega_decode_f16.cu`` includes ``mega_decode.cu``) and the flags, so an
edited source never loads a stale library.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")

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
    for other in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(other.read_bytes())
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


# per-device buffers of the split reductions, kept once grown, so a
# captured CUDA graph never sees one freed; launches that share one run in
# stream order
_kept: dict[tuple, list[torch.Tensor]] = {}


def kept(device, kind: str, n: int, dtype=torch.int32) -> torch.Tensor:
    """At least ``n`` values of ``dtype`` on ``device`` for the kernels of
    ``kind``, zero when first made. int32 buffers are arrival counters:
    zero on entry, and each kernel leaves them zero (the last block to
    arrive resets its count); fp32 ones are scratch (partials written by
    one block, read by the last to arrive)."""
    held = _kept.setdefault((device.index, kind, dtype), [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, 1 << 12), dtype=dtype, device=device))
    return held[-1]


# the activation types every kernel family is built for, in the order of
# their C dtype codes
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def kernel_takes(dtype) -> bool:
    """Whether the kernels take activations of ``dtype`` (fp32, bf16,
    fp16): the one pure predicate of every family but flash (each module
    re-exports it), decided before any launch. On CUDA tensors of another
    dtype (fp64, say) a wrapper runs its plain twin and counts that in its
    ``.twin_routes``."""
    return dtype in KERNEL_DTYPES


def dtype_code(dtype, what: str) -> int:
    """The C entries' element-type code: 0 = fp32, 1 = bf16, 2 = fp16."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes float32, bfloat16 or float16, "
                        f"got {dtype}")
    return KERNEL_DTYPES.index(dtype)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize()`` would not report it)."""
    if err != 0:
        msg = lib.ptt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
