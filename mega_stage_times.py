"""Where the mega kernels spend their time, stage by stage, on one GPU.

    python3 mega_stage_times.py

from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It compiles a copy of ``paddle_tpu_torch/csrc/mega_decode.cu`` in which
thread 0 of every block records ``%globaltimer`` at each stage boundary
into ``build/paddle_tpu_torch/mega_stamps/``, one row of stamps a block
ticket: QKV producers at their start, LN1's statistics, the product and
the published rows; consumers (lane, head, split) at their start, the end
of their wait for the producers, the end of the causal block or the page
walk, the arrival, the merge of the last split, the output projection
with the slab sums, and LN2 in the lane's last slab; MLP blocks by ticket
too: GEMM1 producers at their start, the end of their product and the
published hidden columns; GEMM2 consumers at their start, the end of
their wait for the split's producers, the end of their product, and (the
last split of an h tile) the split sums. It runs both kernels once at
``chip_smoke.py``'s phase-10 serving shapes and at its decode round (fp32
and bf16; fp weights and KV, then int8 g128 weights with an int8 KV cache
at the serving shapes) and prints each lane's stage times in
microseconds: its producers' (mean over heads), the causal splits' and
the longest page split's, and the merging blocks' (longest over the
heads); and the MLP's stages (mean and longest over the blocks of each
role), with the MLP given the lanes' q_lens (the step's call). The stamps cost a few percent; the graph-timed kernel times
printed beside them come from the unstamped kernels of the package. The
instrumented copy is never loaded by the package itself.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "paddle_tpu_torch" / "mega_stamps"
STAMP_BASE_MLP = 100_000   # MLP stamps after the attention blocks' rows

HEADER = '''#include "common.cuh"
__device__ unsigned long long* g_stamps;
__shared__ int g_slot;   // the block's ticket
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_A(i) do { if (threadIdx.x == 0 && g_stamps) \\
  g_stamps[g_slot * 16 + (i)] = gtime(); \\
} while (0)
#define STAMP_M(i) do { if (threadIdx.x == 0 && g_stamps) \\
  g_stamps[STAMP_BASE_MLP + g_slot * 16 + (i)] = gtime(); \\
} while (0)
#define STAMP_M1(i) do { if (threadIdx.x == 0 && g_stamps && \\
  g_stamps[STAMP_BASE_MLP + g_slot * 16 + (i)] == 0) \\
  g_stamps[STAMP_BASE_MLP + g_slot * 16 + (i)] = gtime(); \\
} while (0)
extern "C" int ptt_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
'''

# (where, anchor text, stamp): the stamp goes after or before the first
# occurrence of the anchor in the source. Attention stamps: producers 0
# start, 1 LN1 statistics, 2 product, 3 published; consumers 0 start, 4
# waited, 5 walked, 6 arrived last, 7 merged, 8 projected, 9 / 10 LN2
STAMPS = (
    ("after", "  const int t = ticket, per = a.ngroups * a.nh;\n",
     "if (threadIdx.x == 0) g_slot = t; STAMP_A(0)"),
    ("after", "  ln_stats(x, vr, nv, a.h, a.eps, mean, rstd);\n"
              "  __syncthreads();\n", "STAMP_A(1)"),
    ("before", "  if (comp > 0) {\n    emit_rows", "STAMP_A(2)"),
    ("after", "atomicAdd(flag + l * nh + hh, 1);\n  }\n", "STAMP_A(3)"),
    ("after", "    wait_flags(qf, 1, kvf, 2);\n", "STAMP_A(4)"),
    ("after", "    wait_flags(qf, 1, nullptr, 0);\n", "STAMP_A(4)"),
    ("before", "  const long pf = wk::partial_floats(C, D);", "STAMP_A(5)"),
    ("after", "  if (!wk::arrive(a.counters + lane * nh + hh, Z)) return;\n",
     "STAMP_A(6)"),
    ("before", "  if (a.so)\n    out_proj<T, int8_t, D, R>(a, qs, q_len, lane",
     "STAMP_A(7)"),
    ("after", "    out_proj<T, T, D, R>(a, qs, q_len, lane, hh, u, idx, mean, "
              "rstd);\n", "STAMP_A(8)"),
    ("before", "  // LN2: each row's (mean, M2)", "STAMP_A(9)"),
    ("after", "to_f(b2[c + e]))));\n  }\n", "STAMP_A(10)"),
    ("after", "  const int R = pre[a.b];\n",
     "if (threadIdx.x == 0) g_slot = ticket; STAMP_M(0)"),
    ("before", "      // bias + tanh-GELU in fp32 on the rounded product",
     "STAMP_M(1)"),
    ("after", "    if (tid == 0) atomicAdd(a.flags + ticket / pps, 1);\n",
     "STAMP_M(2)"),
    ("after", "          if (p0 == 0) wait_count(a.flags + sp, nsp);\n",
     "STAMP_M1(3)"),
    ("before", "    sk::for_each_acc<T, W, kMlpCols>(acc, rp, [&](int i, int "
               "cc, float v) {", "STAMP_M(4)"),
    ("after", "  if (last_flag) {\n    __threadfence();\n", "STAMP_M(5)"),
    ("before", "    if (tid == 0) arrive[hj] = 0;", "STAMP_M(6)"),
    ("before", "  if (tid == 0 && atomicAdd(done, 1)", "STAMP_M(7)"),
)


def stamped_source() -> str:
    src = (ROOT / "paddle_tpu_torch" / "csrc" / "mega_decode.cu").read_text()
    src = src.replace('#include "paged_walk.cuh"',
                      f"#define STAMP_BASE_MLP {STAMP_BASE_MLP}\n" + HEADER
                      + '#include "paged_walk.cuh"', 1)
    for where, anchor, stamp in STAMPS:
        if anchor not in src:
            raise RuntimeError(f"stage anchor not found: {anchor!r}")
        i = src.index(anchor) + (len(anchor) if where == "after" else 0)
        src = src[:i] + f"  {stamp};\n" + src[i:]
    return src


def build_stamped(signatures):
    from paddle_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "mega_decode_stamped.cu", OUT / "mega_stamped.so"
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


def lane_report(prod, cons, lane, q_len, ctx):
    """One lane's stage times (us) from its producers' stamps ``[3, nh,
    16]`` and its consumers' ``[z, nh, 16]`` (0: not reached)."""
    us = lambda a, b: (a - b) / 1e3  # noqa: E731
    parts = [f"producers {name}: LN1 {np.mean(us(p[:, 1], p[:, 0])):.1f}, "
             f"product {np.mean(us(p[:, 2], p[:, 1])):.1f}, publish "
             f"{np.mean(us(p[:, 3], p[:, 2])):.1f}"
             for name, p in zip("QKV", prod)]
    causal = cons[0]
    parts.append(f"causal split: wait {np.mean(us(causal[:, 4], causal[:, 0])):.1f}"
                 f", block {np.mean(us(causal[:, 5], causal[:, 4])):.1f}")
    walked = cons[1:][cons[1:, :, 4] > 0]
    if len(walked):
        parts.append(f"page splits ({len(walked)} walked): wait "
                     f"{np.mean(us(walked[:, 4], walked[:, 0])):.1f}, pages "
                     f"{np.max(us(walked[:, 5], walked[:, 4])):.1f} (longest)")
    merged = cons[cons[:, :, 6] > 0]
    parts.append(f"merge {np.max(us(merged[:, 7], merged[:, 6])):.1f}, "
                 f"out proj + slab sums "
                 f"{np.max(us(merged[:, 8], merged[:, 7])):.1f}")
    ln2 = cons[cons[:, :, 9] > 0]
    if len(ln2):
        parts.append(f"LN2 {np.max(us(ln2[:, 10], ln2[:, 9])):.1f}")
    return (f"  lane {lane} (q_len {q_len}, ctx {ctx}): " + "; ".join(parts))


def mlp_report(mt, plan, live):
    """The MLP's stages (us) from its blocks' stamps ``[blocks, 16]`` in
    ticket order: producers, then consumers."""
    us = lambda a, b: (a - b) / 1e3  # noqa: E731
    t0 = mt[:, 0][mt[:, 0] > 0].min()
    prod, cons = mt[:plan.producers], mt[plan.producers:]
    last = cons[cons[:, 5] > 0]

    def mm(v):
        return f"{np.mean(v):.1f} / {np.max(v):.1f}"

    return (f"  MLP ({live} live rows; {plan.producers} producers, "
            f"{plan.consumers} consumers of {plan.splits} splits; mean / "
            f"longest): span {us(mt.max(), t0):.1f} us; producers start "
            f"{mm(us(prod[:, 0], t0))}, GEMM1 {mm(us(prod[:, 1], prod[:, 0]))}"
            f", GELU + publish {mm(us(prod[:, 2], prod[:, 1]))}, last "
            f"published at {us(prod[:, 2].max(), t0):.1f}; consumers start "
            f"{mm(us(cons[:, 0], t0))}, waited until "
            f"{mm(us(cons[:, 3], t0))}, GEMM2 after the wait "
            f"{mm(us(cons[:, 4], cons[:, 3]))}, split sums "
            + (mm(us(last[:, 6], last[:, 5])) if len(last) else "-")
            + f", last block done at {us(cons[:, 7].max(), t0):.1f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("mega_stage_times: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import mega_decode as md

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    unstamped = _build.load("mega_decode", md._SIGNATURES)
    stamped = build_stamped(md._SIGNATURES)
    stamps = torch.zeros(2 * STAMP_BASE_MLP, dtype=torch.int64, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for shape, case, wd, gs, kv in (
                ("serving", cs.MEGA_SERVING, None, -1, False),
                ("serving", cs.MEGA_SERVING, "int8", 128, True),
                ("decode round", cs.MEGA_DECODE_ROUND, None, -1, False)):
            (b, chunk, _, nh, d, ps, pps, _), _, _ = case
            args, (y2, s_res) = cs.mega_inputs(case, wd, gs, kv, dtype, dev)
            xb, p, pools, pt, ctx, q_lens = args
            kw = dict(k_scales=pools.get("k_scales"),
                      v_scales=pools.get("v_scales"))
            plan = md.mega_plan(b, nh, pps, ps, d, chunk,
                                pools["k_pages"].element_size(), sms)
            z, per = 1 + plan.splits, -(-b // plan.group) * nh
            mplan = md.mlp_plan(p["b2"].shape[0], p["b1"].shape[0])

            def attn():
                return md.mega_attn_layer(xb, p, pools["k_pages"],
                                          pools["v_pages"], pt, ctx,
                                          q_lens, **kw)

            def mlp():
                return md.mega_mlp(y2, s_res, p, q_lens=q_lens, chunk=chunk)

            _build._libs["mega_decode"] = unstamped
            ms = (cs.time_ms(attn), cs.time_ms(mlp))
            _build._libs["mega_decode"] = stamped
            stamped.ptt_set_stamps(stamps.data_ptr())
            for fn in (attn, mlp):
                fn()                      # warm
                stamps.zero_()
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
                if fn is attn:
                    st = stamps[:plan.blocks * 16].view(-1, 16).cpu()
                else:
                    m = stamps[STAMP_BASE_MLP:STAMP_BASE_MLP
                               + 16 * mplan.blocks]
                    mt = m.view(-1, 16).cpu()
            stamped.ptt_set_stamps(None)
            _build._libs["mega_decode"] = unstamped
            st = st.numpy().astype(np.float64)
            t0 = st[:, 0][st[:, 0] > 0].min()
            prod = st[:3 * per].reshape(3, -1, nh, 16)   # [comp, group, head]
            cons = st[3 * per:].reshape(z, b, nh, 16)    # [split, lane, head]
            label = (f"{str(dtype)[6:]} {shape}, weights {wd or 'fp'}"
                     f"{'' if gs < 0 else f' g{gs}'}, "
                     f"{'int8' if kv else 'fp'} KV")
            print(f"== {label}: attention {1e3 * ms[0]:.1f} us, MLP "
                  f"{1e3 * ms[1]:.1f} us (graph-timed, unstamped); stamped "
                  f"attention span {(st.max() - t0) / 1e3:.1f} us, "
                  f"{plan.blocks} blocks: {3 * per} producers of "
                  f"{plan.group} lanes, {b} x {nh} x {z} consumers ({card})")
            for lane in range(b):
                if int(q_lens[lane]) == 0:
                    print(f"  lane {lane}: idle")
                    continue
                rows = cons[:, lane]
                print(lane_report(prod[:, lane // plan.group], rows, lane,
                                  int(q_lens[lane]), int(ctx[lane]))
                      + f"; ends at {(rows.max() - t0) / 1e3:.1f} us")
            print(mlp_report(mt.numpy().astype(np.float64), mplan,
                             int(q_lens.sum())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
