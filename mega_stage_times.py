"""Where the mega kernels spend their time, stage by stage, on one GPU.

    python3 mega_stage_times.py

from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It compiles a copy of ``paddle_tpu_torch/csrc/mega_decode.cu`` in which
thread 0 of every block records ``%globaltimer`` at each stage boundary
(attention: LN1, QKV, page walk, new rows, output projection, epilogue of
the lane's last block; MLP: GEMM1, GELU, GEMM2 and the ffn-tile sums) into
``build/paddle_tpu_torch/mega_stamps/``, runs both kernels once at
``chip_smoke.py``'s phase-10 serving shapes (fp32 and bf16; fp weights
and KV, then int8 g128 weights with an int8 KV cache) and prints each
lane's stage times in microseconds. The stamps cost a few percent; the
graph-timed kernel times printed beside them come from the unstamped
kernels of the package. The instrumented copy is never loaded by the
package itself.
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
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP_A(i) do { if (threadIdx.x == 0 && g_stamps) \\
  g_stamps[(blockIdx.x * gridDim.y + blockIdx.y) * 16 + (i)] = gtime(); \\
} while (0)
#define STAMP_M(i) do { if (threadIdx.x == 0 && g_stamps) \\
  atomicMax(g_stamps + STAMP_BASE_MLP + \\
            (blockIdx.y * gridDim.x + blockIdx.x) * 16 + (i), gtime()); \\
} while (0)
extern "C" int ptt_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
'''

# (where, anchor text, stamp): the stamp goes after or before the first
# occurrence of the anchor in the source
STAMPS = (
    ("after", "  const bool kvq = a.ks != nullptr;\n", "STAMP_A(0)"),
    ("before", "\n  // -- this head's Q, K and V columns", "STAMP_A(1)"),
    ("before", "  // -- attention: the pool", "STAMP_A(2)"),
    ("before", "  // the new rows: read back", "STAMP_A(3)"),
    ("before", "  for (int i = tid; i < q_len * D; i += kThreads) {\n"
               "    const int r = i / D, c = i % D;\n"
               "    const float l = Ls[r];", "STAMP_A(4)"),
    ("before", "  // -- the lane's last block sums", "STAMP_A(5)"),
    ("after", "  if (!last_flag) return;\n", "STAMP_A(6)"),
    ("before", "  if (tid == 0) a.counters[b] = 0;", "STAMP_A(7)"),
    ("after", "  const T* y2 = static_cast<const T*>(a.y2);\n", "STAMP_M(0)"),
    ("before", "  // bias + tanh-GELU", "STAMP_M(8)"),
    ("before", "  // GEMM2: hidden", "STAMP_M(9)"),
    ("after", "    if (!last_flag) continue;\n", "STAMP_M(10)"),
    ("before", "    if (tid == 0) *counter = 0;", "STAMP_M(11)"),
    ("before", "}\n\ntemplate <typename T, int D, int RPT>\nint launch_attn",
     "STAMP_M(12)"),
)


def stamped_source() -> str:
    src = (ROOT / "paddle_tpu_torch" / "csrc" / "mega_decode.cu").read_text()
    src = src.replace('#include "common.cuh"',
                      f"#define STAMP_BASE_MLP {STAMP_BASE_MLP}\n" + HEADER, 1)
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
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(ROOT / "paddle_tpu_torch" / "csrc"), "-o",
                    str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    lib.ptt_set_stamps.argtypes = [ctypes.c_void_p]
    return lib


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
    unstamped = _build.load("mega_decode", md._SIGNATURES)
    stamped = build_stamped(md._SIGNATURES)
    stamps = torch.zeros(2 * STAMP_BASE_MLP, dtype=torch.int64, device=dev)
    (b, _, _, nh, *_), _, _ = cs.MEGA_SERVING
    names = ("LN1", "QKV", "pages", "new rows", "out proj")
    for dtype in (torch.float32, torch.bfloat16):
        for wd, gs, kv in ((None, -1, False), ("int8", 128, True)):
            args, (y2, s_res) = cs.mega_inputs(cs.MEGA_SERVING, wd, gs, kv,
                                               dtype, dev)
            xb, p, pools, pt, ctx, q_lens = args
            kw = dict(k_scales=pools.get("k_scales"),
                      v_scales=pools.get("v_scales"))

            def attn():
                return md.mega_attn_layer(xb, p, pools["k_pages"],
                                          pools["v_pages"], pt, ctx,
                                          q_lens, **kw)

            def mlp():
                return md.mega_mlp(y2, s_res, p)

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
                    st = stamps[:b * nh * 16].view(b * nh, 16).cpu()
                else:
                    m = stamps[STAMP_BASE_MLP:STAMP_BASE_MLP + 16 * 4096]
                    mt = m.view(-1, 16).cpu()
            stamped.ptt_set_stamps(None)
            _build._libs["mega_decode"] = unstamped
            st = st.numpy().astype(np.float64)
            t0 = st[:, 0].min()
            label = (f"{str(dtype)[6:]}, weights {wd or 'fp'}"
                     f"{'' if gs < 0 else f' g{gs}'}, "
                     f"{'int8' if kv else 'fp'} KV")
            print(f"== {label}: attention {1e3 * ms[0]:.1f} us, MLP "
                  f"{1e3 * ms[1]:.1f} us (graph-timed, unstamped); stamped "
                  f"attention span {(st.max() - t0) / 1e3:.1f} us ({card})")
            for lane in range(b):
                rows = st[lane * nh:(lane + 1) * nh]
                if int(q_lens[lane]) == 0:
                    print(f"  lane {lane}: idle")
                    continue
                d = np.diff(rows[:, :6], axis=1).mean(0) / 1e3
                last = rows[rows[:, 6] > 0][0]
                print(f"  lane {lane} (q_len {int(q_lens[lane])}, ctx "
                      f"{int(ctx[lane])}): " + ", ".join(
                          f"{n} {v:.1f}" for n, v in zip(names, d))
                      + f", epilogue {(last[7] - last[6]) / 1e3:.1f}; ends "
                      f"at {(last[7] - t0) / 1e3:.1f} us")
            mt = mt.numpy().astype(np.float64)
            mt = mt[mt[:, 0] > 0]
            t0 = mt[:, 0].min()
            print(f"  MLP ({len(mt)} blocks): span "
                  f"{(mt.max() - t0) / 1e3:.1f} us, last start "
                  f"{(mt[:, 0].max() - t0) / 1e3:.1f}, GEMM1 "
                  f"{np.mean(mt[:, 8] - mt[:, 0]) / 1e3:.1f}, GELU "
                  f"{np.mean(mt[:, 9] - mt[:, 8]) / 1e3:.1f}, GEMM2 and sums "
                  f"{np.mean(mt[:, 12] - mt[:, 9]) / 1e3:.1f} us a block")
    return 0


if __name__ == "__main__":
    sys.exit(main())
