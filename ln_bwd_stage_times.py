"""Where the LN backward kernel spends its time, stage by stage, on one GPU.

    python3 ln_bwd_stage_times.py

from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It compiles a copy of ``paddle_tpu_torch/csrc/fused_mlp.cu`` in which
thread 0 of every block of ``ln_bwd_kernel`` records ``%globaltimer`` at
each stage boundary into ``build/paddle_tpu_torch/ln_bwd_stamps/``: the
block's start, the end of its first group's rows, its partial row
written (the groups' sums added), its arrival at its set's counter, and,
in the blocks that arrive last, the end of the set's sum and of the sets'
sum. It runs the kernel at ``chip_smoke.py``'s LN shapes ([8192, 1536],
[2048, 768], [77, 200]; fp32 and bf16, without dso) and prints each
stage in microseconds from the first block's start: the spread of the
blocks' starts, the rows (mean and longest), the group sums, the arrival
and the two levels of partial sums, beside the kernel's time in a CUDA
graph (from the unstamped kernel of the package). The stamps cost a few
percent; the instrumented copy is never loaded by the package itself.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "paddle_tpu_torch" / "ln_bwd_stamps"
NSTAMP = 8   # stamps a block

HEADER = '''
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) do { if (threadIdx.x == 0 && g_stamps) \\
  g_stamps[blockIdx.x * 8 + (i)] = gtime(); } while (0)
extern "C" int ptt_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
'''

# (where, anchor, stamp): 0 start, 1 first group's rows done, 2 partial
# row written, 3 arrived, 4 set summed, 5 sets summed
STAMPS = (
    ("after", "  const int k = (int)threadIdx.x / threads, t = (int)threadIdx.x "
              "% threads;\n", "STAMP(0)"),
    ("before", "  // the block's partial row: the groups' column sums added",
     "STAMP(1)"),
    ("before", "  // The last block of each set of `set` blocks adds", "STAMP(2)"),
    ("after", "  if (threadIdx.x == 0) last = atomicAdd(p.counters + si, 1) == "
              "nb - 1;\n", "STAMP(3)"),
    ("after", "    sum_rows(p.part + b0 * w, nb, h, p.dgamma, p.dbeta);\n",
     "STAMP(4); STAMP(5)"),
    ("after", "  sum_rows(p.part + b0 * w, nb, h, level2, level2 + h);\n",
     "STAMP(4)"),
    ("after", "  sum_rows(p.part + blocks * w, sets, h, p.dgamma, p.dbeta);\n",
     "STAMP(5)"),
)


def stamped_source() -> str:
    src = (ROOT / "paddle_tpu_torch" / "csrc" / "fused_mlp.cu").read_text()
    src = src.replace('#include "common.cuh"\n',
                      '#include "common.cuh"\n' + HEADER, 1)
    for where, anchor, stamp in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"stage anchor not found once: {anchor!r}")
        i = src.index(anchor) + (len(anchor) if where == "after" else 0)
        src = src[:i] + f"  {stamp};\n" + src[i:]
    return src


def build_stamped(signatures):
    from paddle_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "fused_mlp_stamped.cu", OUT / "fused_mlp_stamped.so"
    src.write_text(stamped_source())
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(ROOT / "paddle_tpu_torch" / "csrc"), "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on the stamped copy:\n{done.stdout}"
                           f"{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    lib.ptt_set_stamps.argtypes = [ctypes.c_void_p]
    return lib


def stamped_call(lib, args, plan, code):
    """One stamped launch of ``ln_bwd(*args)`` on ``plan``: the stamps
    ``[blocks, NSTAMP]`` in ns (0: not reached)."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_mlp as fm

    dy, dso, s, mean, rstd, g = args
    rows, h = s.shape
    dev = s.device
    dx = torch.empty_like(s)
    dg = torch.empty(h, dtype=torch.float32, device=dev)
    db = torch.empty_like(dg)
    part = _build.kept(dev, "ln_bwd", plan.scratch(h), torch.float32)
    counters = _build.kept(dev, "ln_bwd", plan.sets + 1)
    stamps = torch.zeros(plan.blocks * NSTAMP, dtype=torch.int64, device=dev)
    _build.check(lib, lib.ptt_set_stamps(stamps.data_ptr()), "stamps")
    err = lib.ptt_ln_bwd(
        dy.data_ptr(), None if dso is None else dso.data_ptr(), s.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dg.data_ptr(), db.data_ptr(), part.data_ptr(), counters.data_ptr(),
        rows, h, plan.per, plan.threads, plan.groups, plan.band, plan.blocks,
        plan.set, fm._vec(s, dy, dso, g, dx), code, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "stamped ln_bwd")
    torch.cuda.synchronize()
    want = fm.ln_bwd_reference(*args)
    for got, ref in zip((dx, dg, db), want):
        if not torch.allclose(got.float(), ref.float(), rtol=2e-2, atol=2e-2):
            raise AssertionError("the stamped kernel disagrees with the plain "
                                 "version")
    return stamps.view(plan.blocks, NSTAMP).cpu().numpy().astype(np.int64)


def report(st, plan):
    """Stage times (us) from one launch's stamps."""
    us = lambda a: a / 1e3  # noqa: E731
    t0 = st[:, 0].min()
    rows = st[:, 1] - st[:, 0]
    summed = st[st[:, 4] > 0]
    top = st[st[:, 5] > 0]
    return dict(
        start_spread_us=us(st[:, 0].max() - t0),
        rows_mean_us=us(rows.mean()), rows_max_us=us(rows.max()),
        last_rows_done_us=us(st[:, 1].max() - t0),
        group_sums_max_us=us((st[:, 2] - st[:, 1]).max()),
        last_arrival_us=us(st[:, 3].max() - t0),
        set_sum_us=us((summed[:, 4] - summed[:, 3]).max()),
        sets_sum_us=(us((top[:, 5] - top[:, 4]).max())
                     if plan.sets > 1 else 0.0),
        span_us=us(top[:, 5].max() - t0))


def main() -> int:
    if not torch.cuda.is_available():
        print("ln_bwd_stage_times: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.ops import fused_mlp as fm

    card = cs.card_line()
    lib = build_stamped(fm._SIGNATURES)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for si, shape in enumerate(cs.FUSED_LN_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            t = cs.fused_inputs("ln_bwd", shape, dtype, dev, cs.SEED + si)
            kern = cs.fused_calls("ln_bwd", "plain", t)[0]
            _, mean, rstd = fm.ln_fwd_reference(t["x"], None, t["g"], t["b"],
                                                1e-5)
            args = (t["dy"], None, t["x"], mean, rstd, t["g"])
            plan = fm.ln_bwd_plan(*shape, t["x"].element_size(), sms)
            code = fm._check("ln_bwd", t["x"])
            for _ in range(3):    # warm: the last launch's stamps are read
                st = stamped_call(lib, args, plan, code)
            rep = report(st, plan)
            rep["graph_ms"] = cs.time_ms(kern, iters=20, replays=3)
            label = f"{str(dtype)[6:]} {list(shape)}"
            out[label] = rep
            print(f"[ln-bwd stages] {label} {tuple(plan)}: kernel "
                  f"{rep['graph_ms'] * 1e3:.1f} us in a graph; stamped span "
                  f"{rep['span_us']:.1f} us: starts spread "
                  f"{rep['start_spread_us']:.1f}, rows mean "
                  f"{rep['rows_mean_us']:.1f} / longest "
                  f"{rep['rows_max_us']:.1f} (last done at "
                  f"{rep['last_rows_done_us']:.1f}), group sums "
                  f"{rep['group_sums_max_us']:.1f}, last arrival at "
                  f"{rep['last_arrival_us']:.1f}, set sum "
                  f"{rep['set_sum_us']:.1f}, sets sum "
                  f"{rep['sets_sum_us']:.1f} ({card})", flush=True)
            del t
    print(json.dumps({"ln_bwd_stages": out, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
