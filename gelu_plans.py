"""The GELU kernels under other launch plans and source variants, on one GPU.

    python3 gelu_plans.py

from the root of a checkout on a machine with a CUDA card and ``nvcc``.
At ``chip_smoke.py``'s flagship GELU shape [8192, 6144], fp32 and bf16,
it times the forward, the backward and the bias backward of
``paddle_tpu_torch/csrc/fused_mlp.cu`` (device time, CUDA-graph replays as
in ``chip_smoke.py``) under

- the package's plan (``ops.fused_mlp.gelu_plan``);
- one persistent wave: as many blocks as the card holds at once
  (``GELU_BLOCKS_PER_SM`` an SM), each walking a long band;
- bands of 1, 2, 4 and 8 rows a thread (with dbias partials, never more
  bands than ``GELU_PART_SHARE`` allows);

and, under the package's plan, copies of the source built with one change
each: blocks of 256 threads (4 an SM) in place of 128 (8 an SM), 16
blocks an SM (``__launch_bounds__`` caps the registers at 32), plain
stores in place of ``st.global.cs``, and 2 / 1 rows of loads in flight
(forward / backward) in place of 4 / 2. ``F.gelu`` and
``gelu_backward`` (tanh) are timed beside them. The copies build into
``build/paddle_tpu_torch/gelu_plans/`` and are never loaded by the package.
Prints one line per case and a JSON summary line last.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "paddle_tpu_torch" / "gelu_plans"
SHAPE = (8192, 6144)
# (label, threads a block, [(text in fused_mlp.cu, its replacement)])
VARIANTS = (
    ("256-thread blocks", 256, [
        ("kGeluThreads = 128;", "kGeluThreads = 256;"),
        ("__launch_bounds__(kGeluThreads, 8)",
         "__launch_bounds__(kGeluThreads, 4)")]),
    ("16 blocks an SM", 128, [("__launch_bounds__(kGeluThreads, 8)",
                               "__launch_bounds__(kGeluThreads, 16)")]),
    ("plain stores", 128, [("st.global.cs.v4.u32", "st.global.v4.u32")]),
    ("loads 2 / 1 rows ahead", 128, [
        ("kGeluFwdDepth = 4", "kGeluFwdDepth = 2"),
        ("kGeluBwdDepth = 2", "kGeluBwdDepth = 1")]),
)


def build_variants(signatures) -> dict:
    """{label: (ctypes library, threads a block)} of the source copies,
    their nvcc runs started together."""
    from paddle_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC_DIR / "fused_mlp.cu").read_text()
    procs = {}
    threads = {}
    for i, (label, t, edits) in enumerate(VARIANTS):
        threads[label] = t
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{label}: {old!r} not in fused_mlp.cu")
            text = text.replace(old, new)
        cu, so = OUT / f"variant{i}.cu", OUT / f"variant{i}.so"
        cu.write_text(text)
        procs[label] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        spills = sorted({int(b) for b in re.findall(
            r"(\d+) bytes spill stores", log)})
        print(f"[build] {label}: spill stores (bytes, by instantiation) "
              f"{spills}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = (lib, threads[label])
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("gelu_plans: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_mlp as fm

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"[device] {card}", flush=True)
    package = _build.load("fused_mlp", fm._SIGNATURES)
    libs = {"package": (package, fm.GELU_THREADS),
            **build_variants(fm._SIGNATURES)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, n = SHAPE
    results = {}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        elt = torch.finfo(dtype).bits // 8
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        x = (2 * torch.randn(SHAPE, generator=gen, device=dev)).to(dtype)
        dy = torch.randn(SHAPE, generator=gen, device=dev).to(dtype)
        bias = (0.5 * torch.randn(n, generator=gen, device=dev)).to(dtype)
        out = torch.empty_like(x)
        name = str(dtype)[6:]
        lib_ms = {
            "fwd": cs.time_ms(lambda: torch.nn.functional.gelu(
                x, approximate="tanh"), 20, 3),
            "bwd": cs.time_ms(lambda: torch.ops.aten.gelu_backward(
                dy, x, approximate="tanh"), 20, 3)}
        print(f"[library] {name}: F.gelu {lib_ms['fwd']:.4f} ms, "
              f"gelu_backward {lib_ms['bwd']:.4f} ms", flush=True)
        for kind, b in (("fwd", None), ("bwd", None), ("bwd bias", bias)):
            partials = b is not None
            plan = fm.gelu_plan(rows, n, elt, sms, partials)
            lanes = fm.GELU_THREADS // plan.strip
            max_bands = (max(1, int(fm.GELU_PART_SHARE * 3 * rows * elt / 4))
                         if partials else rows)
            wave = max(1, sms * fm.GELU_BLOCKS_PER_SM // plan.strips)
            plans = {"plan": plan.band, "one persistent wave": -(-rows // wave)}
            for r in (1, 2, 4, 8):
                plans[f"{r} rows a thread"] = max(lanes * r,
                                                  -(-rows // max_bands))
            runs = [(p, band, package) for p, band in plans.items()]
            for label, (lib, threads) in libs.items():
                if label != "package":
                    runs.append((label, plan.band if partials else
                                 plan.band * threads // fm.GELU_THREADS, lib))
            want, want_db = ((fm.gelu_fwd_reference(x), None) if kind == "fwd"
                             else fm.gelu_bwd_reference(dy, x, b))
            for label, band, lib in runs:
                bands = -(-rows // band)
                part = dbias = counters = None
                if partials:
                    part = torch.empty((bands, n), device=dev)
                    dbias = torch.empty(n, device=dev)
                    counters = _build.arrival_counters(dev, f"plans {label}",
                                                       plan.strips)

                def call(lib=lib, band=band, part=part, dbias=dbias,
                         counters=counters, b=b):
                    stream = torch.cuda.current_stream().cuda_stream
                    ptr = None if b is None else b.data_ptr()
                    if kind == "fwd":
                        err = lib.ptt_gelu_fwd(x.data_ptr(), ptr,
                                               out.data_ptr(), rows, n,
                                               plan.strip, band, 1, code, 0,
                                               stream)
                    else:
                        err = lib.ptt_gelu_bwd(
                            dy.data_ptr(), x.data_ptr(), ptr, out.data_ptr(),
                            *(None if t is None else t.data_ptr()
                              for t in (part, dbias, counters)),
                            rows, n, plan.strip, band, 1, code, 0, stream)
                    if err:
                        raise RuntimeError(f"{label}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                held = cs.fused_held(out, want, dtype)[1]
                if partials:
                    held = max(held, cs.fused_held(dbias, want_db,
                                                   torch.float32)[1])
                if not held <= cs.FUSED_TOL[dtype]:
                    raise AssertionError(f"{name} {kind} {label}: held "
                                         f"error {held}")
                ms = cs.time_ms(call, 20, 3)
                key = f"{name} {kind} {label}"
                results[key] = dict(ms=ms, band=band, strip=plan.strip,
                                    blocks=plan.strips * bands)
                print(f"[plan] {key}: strip {plan.strip}, band {band} "
                      f"({plan.strips * bands} blocks): {ms:.4f} ms; "
                      f"library {lib_ms[kind[:3]]:.4f} ms", flush=True)
        results[f"{name} library"] = lib_ms
    print(json.dumps({"gelu_plans": dict(card=card, shape=list(SHAPE),
                                         results=results)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
