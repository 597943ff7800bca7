// Ragged grouped GEMM for Hopper (sm_90a): the MoE expert FFN's matmuls.
// out[i] = x[i] @ deq(W)[g(i)] for rows pre-sorted by expert, with
// group_offsets [E + 1] giving each expert's row range; fp (the activation
// type), int8 or split-half int4 expert stacks with per-expert scales
// [E, G, N] (per channel G = 1, or one row per group of K); forward and the
// input gradient dx[i] = dy[i] @ deq(W)[g(i)]^T. fp32 accumulation, the
// result written in the activation type.
//
// Replaces paddle_tpu/ops/pallas/grouped_matmul.py::_gmm_kernel (fp
// forward, ptt_gmm), ::_gmm_q_kernel (int8, ptt_gmm_q), ::_gmm_q4_kernel
// (int4, ptt_gmm_q4), ::_gmm_bwd_kernel (fp dx, ptt_gmm_bwd) and
// ::_gmm_q_bwd_kernel (int8 dx, ptt_gmm_q_bwd). A quantized element
// dequantizes as q * s[g] rounded to the activation type (common.cuh deq,
// the Pallas kernels widen both to x.dtype and multiply there), g the scale
// group of its ORIGINAL in-dim row; fp weights are read in the activation
// type. The two nibbles of one int4 byte are rows i and K/2 + i.
//
// One template <T, bits, bwd> serves all five: the weight-only GEMM of
// csrc/quant_matmul.cu (C[M, J] = A[M, R] . B[R, J]; forward A = x, R = K,
// B = deq(W_e); backward A = dy, R = N, B = deq(W_e)^T) with each row tile
// bound to ONE expert, whose weight and scale pointers it offsets to. The
// binding is the device-side twin of the Pallas kernel's scalar-prefetched
// tile -> group table (_pack_layout): expert e owns ceil(n_e / 32) row
// tiles, numbered expert after expert, and block row y finds its expert by
// scanning the E + 1 offsets. Row tiles never straddle two experts, so no
// row is padded or moved; grid rows past the last live tile, and every
// expert with no rows, read no weight bytes. Offsets follow the twin's
// token_group_ids: rows before offsets[1] belong to expert 0, rows from
// offsets[E - 1] on to expert E - 1, everything clamped into [0, M].
//
// What bounds it on the H100: at the serving shape (48 routed rows over 4
// experts, w1 768 x 3072 and w2 3072 x 768) bytes: each live expert's
// weights are read once per row tile (~9.4 MB fp32 per GEMM for 3 live
// experts), ~3 us at 3.35 TB/s, against ~0.2 GFLOP. At prefill (4,096
// rows) operations: ~19 GFLOP per GEMM, ~0.3 ms at the fp32 CUDA-core
// peak. The design reads each weight tile once per 32 rows with 16-byte
// loads (the next stage's tile in flight in registers), dequantizes it into
// fp32 shared memory and runs a 32 x 64 register-tiled fp32 FMA product on
// the CUDA cores. Few live tiles at decode (w2: 12 column tiles per expert)
// split the reduction across blocks until ~2 blocks per SM are in flight;
// the LAST block of a tile to arrive (an arrival counter it resets) sums the
// fp32 partials in split order: deterministic, no float atomics. Not yet
// near the bound: no tensor cores, no cp.async / TMA ring — later work.
#include "common.cuh"

#include <cstdint>
#include <type_traits>

namespace {

using ptt::deq;
using ptt::load_row16;
using ptt::Row16;
using ptt::store;
using ptt::to_f;

constexpr int kThreads = 256;
constexpr int BM = 32;           // rows per tile (one expert each)
constexpr int BJ = 64;           // output columns per block
constexpr int BR = 64;           // reduction indices per stage
constexpr int kBPitch = BJ + 4;  // float4-aligned rows of the B tile
constexpr int kAPitch = BM + 2;  // float2-aligned rows of the A tile

struct Args {
  const void* a;       // x [M, K] (forward) or dy [M, N] (backward), T
  const void* w;       // [E, KW, N]: T (fp), int8 (KW = K), int4 (KW = K/2)
  const float* s;      // [E, K / gs, N], null for fp weights
  const int* offs;     // [E + 1] row offsets of the experts
  void* out;           // [M, N] (forward) or [M, K] (backward), T
  float* ws;           // [splits, M, J] fp32 partials when splits > 1
  int* counters;       // one arrival count per output tile, zero on entry
  int M, K, N, E, gs, splits, per, vec;
};

// kBits: 0 = fp weights (the activation type), 8 = int8, 4 = packed int4
template <typename T, int kBits, bool kBwd>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const Args p) {
  using W = std::conditional_t<kBits == 0, T, int8_t>;
  constexpr bool kInt4 = kBits == 4;
  constexpr int RW = kInt4 ? 32 : 64;   // stored weight rows per tile
  constexpr int NS = kInt4 ? 2 : 1;     // original rows per stored row
  static_assert(!(kInt4 && kBwd), "int4 dx runs the plain contraction");
  __shared__ __align__(16) float Bs[BR * kBPitch];
  __shared__ __align__(16) float As[BR * kAPitch];
  __shared__ int bind[3];
  __shared__ int last_flag;

  const int M = p.M, K = p.K, N = p.N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // -- bind this row tile to its expert and rows [r0, r1)
  if (tid == 0) {
    int t = blockIdx.y, ex = -1, lo = 0, hi = 0;
    for (int e = 0; e < p.E; ++e) {
      const int a = e == 0 ? 0 : min(max(__ldg(p.offs + e), 0), M);
      const int b = e == p.E - 1 ? M
                                 : min(max(__ldg(p.offs + e + 1), a), M);
      const int nt = (b - a + BM - 1) / BM;
      if (t < nt) {
        ex = e;
        lo = a + t * BM;
        hi = min(b, lo + BM);
        break;
      }
      t -= nt;
    }
    bind[0] = ex;
    bind[1] = lo;
    bind[2] = hi;
  }
  __syncthreads();
  const int ex = bind[0];
  if (ex < 0) return;  // a dead tile: no weight bytes, no counter
  const int m0 = bind[1], m1 = bind[2];

  const T* A = static_cast<const T*>(p.a);
  const int KW = kInt4 ? K / 2 : K;
  const W* Wt = static_cast<const W*>(p.w) + (long)ex * KW * N;
  const float* S = kBits ? p.s + (long)ex * (K / p.gs) * N : nullptr;
  // forward: tile over output (N) columns, stages over stored rows;
  // backward: tile over stored rows, stages over N columns
  const int nst = kBwd ? (N + BR - 1) / BR : (KW + RW - 1) / RW;
  const int t_begin = blockIdx.z * p.per;
  const int t_end = min(nst, t_begin + p.per);
  const int A_cols = kBwd ? N : K;
  const int J = kBwd ? K : N;

  // -- the stage's loads, kept in registers until the previous stage's
  // compute is done
  const bool w_loader = tid < RW * 4;
  const int li = tid / 4, lc = (tid % 4) * 16;  // stored row, column segment
  Row16<W> raw;
  float sc[NS][kBits ? 16 : 1];
  float av[8];

  auto load_stage = [&](int t) {
    const int wr0 = kBwd ? blockIdx.x * RW : t * RW;
    const int wc0 = kBwd ? t * BR : blockIdx.x * BJ;
    if (w_loader) {
      const int row = wr0 + li, col = wc0 + lc;
      const bool row_ok = row < KW;
      load_row16(raw, Wt + (long)row * N, col, N, row_ok, p.vec);
      if constexpr (kBits != 0) {
#pragma unroll
        for (int h = 0; h < NS; ++h) {
          const long g = (long)((h * KW + row) / p.gs) * N;
#pragma unroll
          for (int e = 0; e < 16; ++e)
            sc[h][e] =
                (row_ok && col + e < N) ? __ldg(S + g + col + e) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int flat = u * kThreads + tid;
      const int r = flat % BR, mm = m0 + flat / BR;
      int c;
      bool ok;
      if (kBwd) {
        c = wc0 + r;
        ok = c < N;
      } else if (kInt4) {
        const int pr = wr0 + (r % 32);
        c = (r < 32 ? 0 : KW) + pr;
        ok = pr < KW;
      } else {
        c = wr0 + r;
        ok = c < K;
      }
      av[u] = (ok && mm < m1) ? to_f(A[(long)mm * A_cols + c]) : 0.f;
    }
  };

  auto store_stage = [&]() {
    if (w_loader) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = lc + e;
        float v[NS];
        if constexpr (kBits == 0) {
          v[0] = to_f(raw[e]);
        } else if constexpr (kInt4) {
          const int byte = (int)(uint8_t)raw[e];
          v[0] = deq<T>(((byte & 0xF) ^ 8) - 8, sc[0][e]);
          v[NS - 1] = deq<T>((((byte >> 4) & 0xF) ^ 8) - 8, sc[NS - 1][e]);
        } else {
          v[0] = deq<T>((int)raw[e], sc[0][e]);
        }
#pragma unroll
        for (int h = 0; h < NS; ++h) {
          if constexpr (kBwd)
            Bs[c * kBPitch + h * 32 + li] = v[h];
          else
            Bs[(h * 32 + li) * kBPitch + c] = v[h];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int flat = u * kThreads + tid;
      As[(flat % BR) * kAPitch + flat / BR] = av[u];
    }
  };

  float acc[2][4] = {};
  if (t_begin < t_end) load_stage(t_begin);
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // the previous stage's readers are done
    store_stage();
    __syncthreads();
    if (t + 1 < t_end) load_stage(t + 1);  // in flight during the products
#pragma unroll 8
    for (int r = 0; r < BR; ++r) {
      const float2 a = *reinterpret_cast<const float2*>(As + r * kAPitch +
                                                        ty * 2);
      const float4 b = *reinterpret_cast<const float4*>(Bs + r * kBPitch +
                                                        tx * 4);
      acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
      acc[0][2] = fmaf(a.x, b.z, acc[0][2]);
      acc[0][3] = fmaf(a.x, b.w, acc[0][3]);
      acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
      acc[1][2] = fmaf(a.y, b.z, acc[1][2]);
      acc[1][3] = fmaf(a.y, b.w, acc[1][3]);
    }
  }

  // output column of local column jl (-1 past the edge)
  auto out_col = [&](int jl) -> int {
    const int c = blockIdx.x * (kBwd ? RW : BJ) + jl;
    return c < J ? c : -1;
  };
  T* out = static_cast<T*>(p.out);

  if (p.splits == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + ty * 2 + i;
      if (m >= m1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = out_col(tx * 4 + j);
        if (c >= 0) store(out + (long)m * J + c, acc[i][j]);
      }
    }
    return;
  }
  // split reduction: publish this split's partial; the last block of the
  // tile to arrive sums all partials in split order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
    if (m >= m1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = out_col(tx * 4 + j);
      if (c >= 0) p.ws[((long)blockIdx.z * M + m) * J + c] = acc[i][j];
    }
  }
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0)
    last_flag = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  long off[2][4];
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 2 + i, c = out_col(tx * 4 + j);
      off[i][j] = (m < m1 && c >= 0) ? (long)m * J + c : -1;
    }
  const long plane = (long)M * J;
  for (int z0 = 0; z0 < p.splits; z0 += 4) {
    float part[4][2][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          part[u][i][j] = (z0 + u < p.splits && off[i][j] >= 0)
                              ? __ldcg(p.ws + (z0 + u) * plane + off[i][j])
                              : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[i][j] += part[u][i][j];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (off[i][j] >= 0) store(out + off[i][j], sum[i][j]);
  if (tid == 0) p.counters[tile] = 0;  // ready for the next launch
}

template <int kBits, bool kBwd>
int launch(const void* a, const void* w, const void* s, const void* offs,
           void* out, void* ws, void* counters, int M, int K, int N, int E,
           int G, int tiles, int splits, int per, int vec, int dtype,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (E < 1 || G <= 0 || K % G || (kBits == 4 && K % 2) || splits < 1 ||
      per < 1 || tiles < 1 || (kBits != 0 && s == nullptr))
    return (int)cudaErrorInvalidValue;
  const int KW = kBits == 4 ? K / 2 : K;
  const int RW = kBits == 4 ? 32 : 64;
  const Args p{a, w, static_cast<const float*>(s),
               static_cast<const int*>(offs), out, static_cast<float*>(ws),
               static_cast<int*>(counters), M, K, N, E, K / G, splits, per,
               vec};
  const int gx = kBwd ? (KW + RW - 1) / RW : (N + BJ - 1) / BJ;
  dim3 grid(gx, tiles, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gmm_kernel<float, kBits, kBwd><<<grid, kThreads, 0, st>>>(p);
  else if (dtype == 1)
    gmm_kernel<__nv_bfloat16, kBits, kBwd><<<grid, kThreads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a: x [M, K] (forward) or dy [M, N] (backward), rows sorted by expert;
// w [E, K, N] in the activation type (fp), [E, K, N] int8 or [E, K/2, N]
// packed int4; s [E, G, N] fp32 (null for fp); offs [E + 1] int32; out
// [M, N] (forward) or [M, K] (backward); ws [splits, M, N or K] fp32
// (unused when splits == 1); counters: one int per output tile (tiles x
// column tiles), all zero. tiles: grid rows, at least the live row tiles
// (sum over experts of ceil(rows / 32)). Each block reduces `per` stages
// of its split. vec: w's rows are 16-byte aligned. dtype: 0 = fp32,
// 1 = bf16 (a, out and fp w).
#define PTT_GMM_ENTRY(name, bits, bwd)                                      \
  int name(const void* a, const void* w, const void* s, const void* offs,  \
           void* out, void* ws, void* counters, int M, int K, int N, int E, \
           int G, int tiles, int splits, int per, int vec, int dtype,      \
           int device, void* stream) {                                     \
    return launch<bits, bwd>(a, w, s, offs, out, ws, counters, M, K, N, E, \
                             G, tiles, splits, per, vec, dtype, device,    \
                             stream);                                      \
  }
PTT_GMM_ENTRY(ptt_gmm, 0, false)
PTT_GMM_ENTRY(ptt_gmm_q, 8, false)
PTT_GMM_ENTRY(ptt_gmm_q4, 4, false)
PTT_GMM_ENTRY(ptt_gmm_bwd, 0, true)
PTT_GMM_ENTRY(ptt_gmm_q_bwd, 8, true)
#undef PTT_GMM_ENTRY

}  // extern "C"
