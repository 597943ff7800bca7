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
// ::_gmm_q_bwd_kernel (int8 dx, ptt_gmm_q_bwd); gmm_tc_kernel and
// gmm_wg_kernel take the bf16 / fp16 fp-weight forward (ptt_gmm_tc) and dx
// (ptt_gmm_bwd_tc) of the first and the fourth on the tensor cores,
// gmm_sk_kernel the int8 / int4 forward of the second and the third at the
// serving rows (ptt_gmm_sk, the skinny route), and gmm_dx_kernel the bf16 /
// fp16 dx of the fifth at any rows (ptt_gmm_dx_tc, the dx route). A
// quantized element dequantizes as q * s[g] rounded to the activation
// type (common.cuh deq, the Pallas kernels widen both to x.dtype and
// multiply there), g the scale group of its ORIGINAL in-dim row; fp
// weights are read in the activation type. The two nibbles of one int4
// byte are rows i and K/2 + i.
//
// Both kernels compute C[M, J] = A[M, R] . B[R, J] (forward A = x, R = K,
// B = deq(W_e); backward A = dy, R = N, B = deq(W_e)^T) with each row tile
// bound to ONE expert, whose weight and scale pointers it offsets to. The
// binding (bind_tile) is the device-side twin of the Pallas kernel's
// scalar-prefetched tile -> group table (_pack_layout): expert e owns
// ceil(n_e / BM) row tiles (BM 32, or 128 for the prefill tile), numbered
// expert after expert, and block row y finds its expert by scanning the
// E + 1 offsets. Row tiles never straddle two experts, so no
// row is padded or moved; grid rows past the last live tile, and every
// expert with no rows, read no weight bytes. Offsets follow the twin's
// token_group_ids: rows before offsets[1] belong to expert 0, rows from
// offsets[E - 1] on to expert E - 1, everything clamped into [0, M].
//
// gmm_kernel<T, bits, bwd> (ptt_gmm, _q, _q4, _bwd, _q_bwd): fp32 activations
// with fp32 weights, the int8 / int4 stacks the skinny and dx routes below do
// not take (fp32 activations, the prefill rows' forward, odd widths, unaligned
// pointers), and the bf16 fp-weight calls the copies below cannot take (K or N
// not a multiple of 8, a pointer not 16-byte aligned). The weight-only GEMM of
// csrc/quant_matmul.cu per row tile of 32: each weight tile read once per 32
// rows with 16-byte loads (the next stage in flight in registers), dequantized
// into fp32 shared memory, a 32 x 64 register-tiled fp32 FMA product on the
// CUDA cores. At the serving shape (a) (48 routed rows over 4 experts, one
// empty; w1 768 x 3072, w2 3072 x 768) it is bound by bytes: each live
// expert's weights read once (9.4 MB fp32 per GEMM for 3 live experts, ~3 us
// at 3.35 TB/s, against ~0.2 GFLOP); at prefill (b) (4,096 rows) by
// operations: ~19 GFLOP per GEMM, ~0.3 ms at the fp32 CUDA-core peak of 67
// TFLOP/s. fp32 stays here because tensor cores would make it TF32.
//
// gmm_tc_kernel<T, bwd> and gmm_wg_kernel<T, bwd> (ptt_gmm_tc,
// ptt_gmm_bwd_tc): bf16 or fp16 activations T with fp weights of the same
// type, K and N multiples of 8, 16-byte aligned x / dy, W and out. On the
// tensor cores, fed by a multi-stage cp.async ring of T A and B tiles (nothing
// widened in shared memory) whose copies zero-fill the ragged row, K and N
// edges; fp32 sums rounded once to T. Forward: A = x rows (K-major), B = W_e
// [k][n] (MN-major); dx: A = dy rows, B = the rows of W_e, [n][k] (K-major).
// One barrier a
// stage: the copy into a slot is issued right after the barrier that ends
// the reads of it. The wrapper picks the tile by rows per expert
// (ops/grouped_matmul.py _plan):
// - serving, gmm_tc_kernel (32 rows x 128 columns, 8 warps side by side
//   along N on mma.sync m16n8k16 with ldmatrix / ldmatrix.trans, tiles at
//   a row pitch of cols + 8: a 16-byte shift a row keeps ldmatrix free of
//   bank conflicts; 4 stages of 64): at (a) bound by bytes, 29.1 MB of
//   bf16 weights for w1 + w2 (8.7 us at 3.35 TB/s). Each live expert's
//   weights stream once, 48 KB of weight tiles in flight a block; the
//   reduction is split over blocks only until about a third of the SMs
//   hold a live block (the wrapper's choice: fewer, longer blocks stream
//   faster than a deeper split, whose partials cost a second pass);
// - prefill, gmm_wg_kernel (128 x 128, two warpgroups of 64 rows on wgmma
//   m64n128k16, both operands read from 128-byte-swizzled tiles, 3 stages
//   of 32 KB, two blocks an SM): at (b) bound by operations, 38.7 GFLOP
//   for w1 + w2 (39 us at 989 TFLOP/s); each weight tile is read once per
//   128 rows and each A tile once per 128 columns. (On the card an
//   mma.sync 128 x 128 tile of 8 warps ran slower at (b), and a wgmma
//   group kept in flight across the next barrier, 3 to 5 stages, was no
//   faster.)
// The prefill rows' forward of int8 / int4 stacks still runs gmm_kernel;
// the same ring could take dequantized bf16 tiles of them.
//
// gmm_sk_kernel<T, bits> (ptt_gmm_sk): the bf16 / fp16 int8 and split-half
// int4 forward at the serving rows (ceil(M / E) <= 64), K (int4: K / 2) a
// multiple of 64, N of 16, scale groups of 16k rows, x / W / scales / out
// 16-byte aligned (ops/grouped_matmul.py _plan route "sk"). A block is
// (row tile of up to 64 rows of one expert, 64 output columns, K split):
// bind_tile at 64 rows, then the skinny tile of skinny_gemm.cuh over the
// expert's stack and scales and its live rows only, so no product is spent
// on a dead row (16-bit rounds the tile up to 16 rows), and experts without
// rows read nothing. The weight stripe, its scale rows and the rows'
// k-slices stream through one cp.async ring of 64-row stages in 96 KB (up
// to 16 stages: two blocks an SM), each live expert's weight read once a
// launch. T on the tensor cores (mma.sync m16n8k16, the weight as the A
// operand, dequantized in registers: q * T(s) rounded once; int4 gives
// two A fragments a load). At the serving shape (a) it is bound by bytes
// (int8 w1 + w2 of 3 live experts 14.9 MB, 4.5 us at 3.35 TB/s; int4
// 8.3 MB). fp32 stays on gmm_kernel, which an H100 ran faster there than
// this tile's CUDA-core branch.
//
// gmm_dx_kernel<T> (ptt_gmm_dx_tc): the bf16 / fp16 dx of int8 stacks at any
// rows, K a multiple of 64, N of 16, scale groups of 16k rows, dy / W /
// scales / dx 16-byte aligned (_plan route "dx"). A block is (64 stored rows
// = 64 dx columns of one expert's stack, a row tile of up to 64 rows of that
// expert, a split of N): bind_tile at 64 rows, then the dx tile of
// dx_tile.cuh (the weight-only GEMM's, qmm_dx_kernel) over the expert's
// [K, N] stripe, its scale rows and the tile's dy rows: W the A operand of
// mma.sync with no transpose, each byte dequantized in registers with its
// own n's scale (q * T(s), rounded once), dy's n-slices and the stripe
// streamed through the 96 KB cp.async ring. At the serving rows (a) it is
// bound by bytes (as gmm_sk_kernel: 14.9 MB for w1 + w2 of 3 live experts);
// N is split DX_PER stages a split while the grid keeps half to two blocks
// an SM. At the prefill rows (b) (~67 row tiles) no split: each 64-row tile
// walks all of N and an expert's stripe is re-read from L2 by its tiles; it
// is bound by operations there (38.7 GFLOP for w1 + w2, 39 us at 989
// TFLOP/s), and mma.sync on 4-warp blocks does not reach that rate (a
// wgmma tile would).
//
// Split reductions (all five kernels): few live tiles at decode split the
// reduction across blocks; the LAST block of a tile to arrive (an arrival
// counter it resets) sums the fp32 partials in split order: deterministic,
// no float atomics.
#include "common.cuh"
#include "dx_tile.cuh"
#include "skinny_gemm.cuh"

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

// Row tile t of bm rows -> (expert, first row, end row), expert -1 past
// the last live tile: expert e owns ceil(n_e / bm) tiles, numbered expert
// after expert; rows before offs[1] belong to expert 0 and rows from
// offs[E - 1] on to expert E - 1, everything clamped into [0, M].
__device__ __forceinline__ void bind_tile(const int* offs, int E, int M,
                                          int bm, int t, int (&bind)[3]) {
  int ex = -1, lo = 0, hi = 0;
  for (int e = 0; e < E; ++e) {
    const int a = e == 0 ? 0 : min(max(__ldg(offs + e), 0), M);
    const int b = e == E - 1 ? M : min(max(__ldg(offs + e + 1), a), M);
    const int nt = (b - a + bm - 1) / bm;
    if (t < nt) {
      ex = e;
      lo = a + t * bm;
      hi = min(b, lo + bm);
      break;
    }
    t -= nt;
  }
  bind[0] = ex;
  bind[1] = lo;
  bind[2] = hi;
}

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
  if (tid == 0) bind_tile(p.offs, p.E, M, BM, blockIdx.y, bind);
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
  else if (dtype == 2)
    gmm_kernel<__half, kBits, kBwd><<<grid, kThreads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ---- bf16 / fp16 fp weights on the tensor cores ------------------------

constexpr int kBK = 64;  // reduction indices per stage

// T: bf16 or fp16, the activations and the weights
template <typename T>
struct TcArgs {
  const T* a;         // x [M, K] (forward) or dy [M, N] (dx)
  const T* w;         // [E, K, N]
  const int* offs;    // [E + 1] row offsets of the experts
  T* out;             // [M, N] (forward) or [M, K] (dx)
  float* ws;          // [splits, M, J] fp32 partials when splits > 1
  int* counters;      // one arrival count per output tile, zero on entry
  int M, K, N, E, splits, per;
};

// The epilogue of both tensor-core kernels: a thread's fragments (i, j)
// (mma.sync C layout) hold rows row0 + 16 i + g (+ 8) and columns col0 +
// 8 j + 2 c4 (+ 1) of C [M, J]; rows >= m1 and columns >= J are dropped.
// One split: rounded to T and stored. Several: each block publishes its
// fp32 partial, and the last block of the tile to arrive (an arrival count
// it resets) sums all partials in split order, so two launches give the
// same bits. Every thread of the block calls it.
template <typename T, int MF, int NF>
__device__ __forceinline__ void store_acc(const TcArgs<T>& p,
                                          const float (&acc)[MF][NF][4],
                                          int row0, int col0, int m1, int J,
                                          int& last_flag) {
  const int lane = threadIdx.x % 32, g = lane / 4, c4 = lane % 4;
  const auto row_of = [&](int i, int h) { return row0 + i * 16 + g + 8 * h; };
  const auto col_of = [&](int j) { return col0 + j * 8 + 2 * c4; };
  if (p.splits == 1) {
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row_of(i, h);
        if (m >= m1) continue;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int c = col_of(j);
          if (c < J)
            *reinterpret_cast<uint32_t*>(p.out + (long)m * J + c) =
                ptt::pack2<T>(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    return;
  }
  const int M = p.M;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row_of(i, h);
      if (m >= m1) continue;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int c = col_of(j);
        if (c < J)
          *reinterpret_cast<float2*>(p.ws + ((long)blockIdx.z * M + m) * J +
                                     c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    last_flag = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  const long plane = (long)M * J;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row_of(i, h);
      if (m >= m1) continue;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int c = col_of(j);
        if (c >= J) continue;
        const float* src = p.ws + (long)m * J + c;
        float2 sum = make_float2(0.f, 0.f);
        for (int z0 = 0; z0 < p.splits; z0 += 4) {
          float2 part[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            part[u] = z0 + u < p.splits
                          ? __ldcg(reinterpret_cast<const float2*>(
                                src + (z0 + u) * plane))
                          : make_float2(0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            sum.x += part[u].x;
            sum.y += part[u].y;
          }
        }
        *reinterpret_cast<uint32_t*>(p.out + (long)m * J + c) =
            ptt::pack2<T>(sum.x, sum.y);
      }
    }
  if (threadIdx.x == 0) p.counters[tile] = 0;  // ready for the next launch
}

// ---- the serving tile on mma.sync --------------------------------------
//
// 32 rows x 128 columns a block, 8 warps side by side along N (16 columns
// each, two 16 x 8 mma tiles of both row fragments), a 4-stage ring of A
// [32][64 + 8] and B (forward [64][128 + 8], dx [128][64 + 8]) tiles;
// registers and shared memory for two blocks an SM.
constexpr int kSvBM = 32, kSvBN = 128, kSvWN = 16, kSvStages = 4;
constexpr int kSvThreads = 32 * (kSvBN / kSvWN);
constexpr int kSvAP = kBK + 8;  // A pitch
__host__ __device__ constexpr int sv_bp(bool bwd) {  // B pitch
  return bwd ? kBK + 8 : kSvBN + 8;
}
__host__ __device__ constexpr int sv_stage(bool bwd) {  // elements a stage
  return kSvBM * kSvAP + (bwd ? kSvBN : kBK) * sv_bp(bwd);
}
constexpr size_t sv_smem_bytes(bool bwd) {
  return 2 * kSvStages * sv_stage(bwd);   // 16-bit elements
}

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kSvThreads, 2)
gmm_tc_kernel(const TcArgs<T> p) {
  constexpr int MF = kSvBM / 16, NF = kSvWN / 8, AP = kSvAP;
  constexpr int BP = sv_bp(kBwd), kStage = sv_stage(kBwd);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  __shared__ int bind[3];
  __shared__ int last_flag;

  const int M = p.M, K = p.K, N = p.N;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) bind_tile(p.offs, p.E, M, kSvBM, blockIdx.y, bind);
  __syncthreads();
  const int ex = bind[0];
  if (ex < 0) return;  // a dead tile: no weight bytes, no counter
  const int m0 = bind[1], m1 = bind[2];

  const int R = kBwd ? N : K;  // reduction length
  const int J = kBwd ? K : N;  // output columns
  const int j0 = blockIdx.x * kSvBN;
  const T* A = p.a + (long)m0 * R;
  const T* W = p.w + (long)ex * K * N;
  const int nst = (R + kBK - 1) / kBK;
  const int t_begin = blockIdx.z * p.per;
  const int n_t = min(nst, t_begin + p.per) - t_begin;

  // stage t of this split into ring slot `slot`: A rows [m0, m1) x
  // reduction [r0, r0 + 64); B forward W_e rows [r0, r0 + 64) x columns
  // [j0, j0 + 128), dx W_e rows [j0, j0 + 128) x columns [r0, r0 + 64)
  const auto load_stage = [&](int t, int slot) {
    T* As = ring + slot * kStage;
    T* Bs = As + kSvBM * AP;
    const int r0 = (t_begin + t) * kBK;
    ptt::cp_tile_2d<kSvBM, kBK, AP, kSvThreads>(As, A + r0, R, m1 - m0,
                                                R - r0);
    if constexpr (kBwd)
      ptt::cp_tile_2d<kSvBN, kBK, BP, kSvThreads>(
          Bs, W + (long)j0 * N + r0, N, K - j0, N - r0);
    else
      ptt::cp_tile_2d<kBK, kSvBN, BP, kSvThreads>(
          Bs, W + (long)r0 * N + j0, N, K - r0, N - j0);
  };

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kSvStages - 1; ++s) {
    if (s < n_t) load_stage(s, s);
    ptt::cp_async_commit();
  }
  for (int t = 0; t < n_t; ++t) {
    ptt::cp_async_wait<kSvStages - 2>();
    // stage t has landed, and every warp is done with stage t - 1, whose
    // slot the next copy takes
    __syncthreads();
    if (t + kSvStages - 1 < n_t)
      load_stage(t + kSvStages - 1, (t + kSvStages - 1) % kSvStages);
    ptt::cp_async_commit();
    const T* As = ring + (t % kSvStages) * kStage;
    const T* Bs = As + kSvBM * AP;
    const int n0 = warp * kSvWN;  // the warp's 16 columns
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[MF][4], bfr[4];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        ptt::ldsm_x4(af[i], As + (i * 16 + ptt::a_row(lane)) * AP + kk * 16 +
                                ptt::a_col(lane));
      if constexpr (kBwd)  // W_e rows [n][k]
        ptt::ldsm_x4(bfr, Bs + (n0 + ptt::b_row(lane)) * BP + kk * 16 +
                              ptt::b_col(lane));
      else  // W_e [k][n]
        ptt::ldsm_x4_t(bfr, Bs + (kk * 16 + ptt::a_row(lane)) * BP + n0 +
                                ptt::a_col(lane));
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
          ptt::mma16<T>(acc[i][j], af[i], bfr[2 * j], bfr[2 * j + 1]);
    }
  }
  ptt::cp_async_wait<0>();
  store_acc(p, acc, m0, j0 + warp * kSvWN, m1, J, last_flag);
}

// ---- the prefill tile on wgmma -----------------------------------------
//
// 128 rows x 128 columns a block: two consumer warpgroups of 64 rows
// (m64n128k16, A and B from shared memory in the 128-byte-swizzled
// layout, B MN-major in the forward and K-major in dx), a 3-stage ring of
// 32 KB stages filled by all 256 threads (fence.proxy.async before wgmma
// reads them), each stage's products waited for before the next barrier;
// two blocks an SM, so one block's barrier and copies overlap the other's
// products.
constexpr int kWgThreads = 256, kWgBM = 128, kWgBN = 128, kWgStages = 3;
constexpr int kWgA = kWgBM * kBK;             // A elements a stage
constexpr int kWgStage = kWgA + kBK * kWgBN;  // A + B elements a stage
// the ring and 1,024 bytes to align the swizzle atoms
constexpr size_t kWgSmemBytes = 2 * kWgStages * kWgStage + 1024;

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kWgThreads, 2)
gmm_wg_kernel(const TcArgs<T> p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(
      smem_raw + ((1024 - (ptt::smem_addr(smem_raw) & 1023)) & 1023));
  __shared__ int bind[3];
  __shared__ int last_flag;

  const int M = p.M, K = p.K, N = p.N;
  const int tid = threadIdx.x, wg = tid / 128, w4 = (tid / 32) % 4;
  if (tid == 0) bind_tile(p.offs, p.E, M, kWgBM, blockIdx.y, bind);
  __syncthreads();
  const int ex = bind[0];
  if (ex < 0) return;  // a dead tile: no weight bytes, no counter
  const int m0 = bind[1], m1 = bind[2];

  const int R = kBwd ? N : K;  // reduction length
  const int J = kBwd ? K : N;  // output columns
  const int j0 = blockIdx.x * kWgBN;
  const T* A = p.a + (long)m0 * R;
  const T* W = p.w + (long)ex * K * N;
  const int nst = (R + kBK - 1) / kBK;
  const int t_begin = blockIdx.z * p.per;
  const int n_t = min(nst, t_begin + p.per) - t_begin;

  const auto load_stage = [&](int t, int slot) {
    T* As = ring + slot * kWgStage;
    T* Bs = As + kWgA;
    const int r0 = (t_begin + t) * kBK;
    ptt::cp_tile_sw128_2d<kWgBM, kBK, kWgThreads>(As, A + r0, R, m1 - m0,
                                                  R - r0);
    if constexpr (kBwd)
      ptt::cp_tile_sw128_2d<kWgBN, kBK, kWgThreads>(
          Bs, W + (long)j0 * N + r0, N, K - j0, N - r0);
    else
      ptt::cp_tile_sw128_2d<kBK, kWgBN, kWgThreads>(
          Bs, W + (long)r0 * N + j0, N, K - r0, N - j0);
  };

  float acc[1][16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
  // a warpgroup whose rows all lie past the tile's end skips the products
  const bool live = m0 + 64 * wg < m1;

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < n_t) load_stage(s, s);
    ptt::cp_async_commit();
  }
  for (int t = 0; t < n_t; ++t) {
    ptt::cp_async_wait<kWgStages - 2>();
    ptt::fence_proxy_async();  // the copies are visible to wgmma's reads
    // stage t has landed, and both warpgroups are done with stage t - 1,
    // whose slot the next copy takes
    __syncthreads();
    if (t + kWgStages - 1 < n_t)
      load_stage(t + kWgStages - 1, (t + kWgStages - 1) % kWgStages);
    ptt::cp_async_commit();
    if (!live) continue;
    // the warpgroup's 8 row atoms of A (1,024 bytes apart), 32 bytes a
    // k-step inside the 128-byte rows
    const T* As = ring + (t % kWgStages) * kWgStage + wg * 8 * 512;
    const T* Bs = ring + (t % kWgStages) * kWgStage + kWgA;
    ptt::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const uint64_t a = ptt::gmma_desc_sw128(As + ks * 16, 16, 1024);
      if constexpr (kBwd)
        // W_e rows [n][k], K-major: 8-row atoms along n 1,024 bytes apart
        ptt::wgmma_ss_n128<T, 0>(acc[0], a,
                              ptt::gmma_desc_sw128(Bs + ks * 16, 16, 1024));
      else
        // W_e [k][n], MN-major: k-step ks is k atoms 2 ks, 2 ks + 1 (1,024
        // bytes apart); the two 64-column blocks (kBK / 8) atoms apart
        ptt::wgmma_ss_n128<T, 1>(
            acc[0], a,
            ptt::gmma_desc_sw128(Bs + 2 * ks * 512, (kBK / 8) * 1024, 1024));
    }
    ptt::wgmma_commit();
    ptt::wgmma_wait<0>();
    ptt::fence_operands(acc[0]);
  }
  ptt::cp_async_wait<0>();
  // per warp the accumulator is the mma.sync C layout of its 16 rows
  store_acc(p, acc, m0 + 64 * wg + 16 * w4, j0, m1, J, last_flag);
}

// tile 0: the serving tile (gmm_tc_kernel), 1: the prefill tile
// (gmm_wg_kernel)
template <typename T, bool kBwd>
int launch_tc(const TcArgs<T>& p, int tile, int tiles, int device,
              cudaStream_t st) {
  const int J = kBwd ? p.K : p.N;
  cudaError_t err;
  if (tile == 0) {
    constexpr size_t bytes = sv_smem_bytes(kBwd);
    err = ptt::allow_smem<gmm_tc_kernel<T, kBwd>>(device, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((J + kSvBN - 1) / kSvBN, tiles, p.splits);
    gmm_tc_kernel<T, kBwd><<<grid, kSvThreads, bytes, st>>>(p);
  } else {
    err = ptt::allow_smem<gmm_wg_kernel<T, kBwd>>(device, (int)kWgSmemBytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((J + kWgBN - 1) / kWgBN, tiles, p.splits);
    gmm_wg_kernel<T, kBwd><<<grid, kWgThreads, kWgSmemBytes, st>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool kBwd>
int launch_tc_typed(const void* a, const void* w, const void* offs,
                    void* out, void* ws, void* counters, int M, int K, int N,
                    int E, int tile, int tiles, int splits, int per,
                    int device, cudaStream_t st) {
  const TcArgs<T> p{static_cast<const T*>(a), static_cast<const T*>(w),
                    static_cast<const int*>(offs), static_cast<T*>(out),
                    static_cast<float*>(ws), static_cast<int*>(counters),
                    M, K, N, E, splits, per};
  return launch_tc<T, kBwd>(p, tile, tiles, device, st);
}

template <bool kBwd>
int launch_tc_entry(const void* a, const void* w, const void* offs,
                    void* out, void* ws, void* counters, int M, int K, int N,
                    int E, int tile, int tiles, int splits, int per,
                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (E < 1 || M < 1 || K < 8 || N < 8 || K % 8 || N % 8 || tiles < 1 ||
      splits < 1 || per < 1 || (splits > 1 && ws == nullptr) ||
      (long)(splits - 1) * per * kBK >= (kBwd ? N : K) ||
      (tile != 0 && tile != 1) || (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  if (misaligned(a) || misaligned(w) || misaligned(out))
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 2
             ? launch_tc_typed<__half, kBwd>(a, w, offs, out, ws, counters, M,
                                             K, N, E, tile, tiles, splits,
                                             per, device, st)
             : launch_tc_typed<__nv_bfloat16, kBwd>(
                   a, w, offs, out, ws, counters, M, K, N, E, tile, tiles,
                   splits, per, device, st);
}

// ---- the skinny route: int8 / int4 stacks at the serving rows ----------

constexpr int kSkCols = 64;          // output columns a block
constexpr int kSkRing = 96 << 10;    // the ring's shared memory: 2 blocks an SM

struct SkArgs {
  const void* x;       // [M, K], T
  const void* w;       // [E, K, N] int8 or [E, K / 2, N] packed int4
  const float* s;      // [E, G, N]
  const int* offs;     // [E + 1] row offsets of the experts
  void* out;           // [M, N], T
  float* ws;           // [splits, M, N] fp32 partials when splits > 1
  int* counters;       // one arrival count per output tile, zero on entry
  int M, K, N, E, G, splits, per;
};

// 16-bit activations T (bf16, fp16) only: an H100 ran fp32 faster on
// gmm_kernel
template <typename T, int kBits>
using SkShape = ptt::sk::Shape<T,
                               std::conditional_t<kBits == 4, uint8_t, int8_t>,
                               kSkCols>;

template <typename T, int kBits>
__global__ void __launch_bounds__(SkShape<T, kBits>::kThreads)
gmm_sk_kernel(const SkArgs p) {
  namespace sk = ptt::sk;
  using W = std::conditional_t<kBits == 4, uint8_t, int8_t>;
  using S = SkShape<T, kBits>;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int bind[3];
  __shared__ int last_flag;
  if (threadIdx.x == 0) bind_tile(p.offs, p.E, p.M, sk::RP, blockIdx.y, bind);
  __syncthreads();
  const int ex = bind[0];
  if (ex < 0) return;  // a dead tile: no weight bytes, no counter
  const int m0 = bind[1], R = bind[2] - m0;
  const int KW = kBits == 4 ? p.K / 2 : p.K;   // stored rows
  const int n0 = blockIdx.x * kSkCols, z = blockIdx.z;
  const int ncols = min(kSkCols, p.N - n0);
  const int s0 = z * p.per, s1 = min(KW / sk::KS, s0 + p.per);
  const T* x = static_cast<const T*>(p.x) + (long)m0 * p.K;
  const sk::WTile<W> wt{static_cast<const W*>(p.w) + (long)ex * KW * p.N,
                        p.s + (long)ex * p.G * p.N, p.N, n0, ncols,
                        p.K / p.G, p.G, kBits == 4 ? p.K / 2 : 0};
  float acc[8][4];
  sk::run_tile<T, W, kSkCols, true, false>(
      acc, ring, kSkRing, wt, s0 * sk::KS, s1 * sk::KS,
      [&](int r) { return x + (long)r * p.K; }, R, p.w, [] {});
  T* out = static_cast<T*>(p.out) + (long)m0 * p.N + n0;
  if (p.splits == 1) {
    sk::for_each_acc<T, W, kSkCols>(acc, R, [&](int m, int c, float v) {
      if (c < ncols) store(out + (long)m * p.N + c, v);
    });
    return;
  }
  float* part = p.ws + (long)m0 * p.N;
  sk::for_each_acc<T, W, kSkCols>(acc, R, [&](int m, int c, float v) {
    if (c < ncols) part[((long)z * p.M + m) * p.N + n0 + c] = v;
  });
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    last_flag = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  // the last block sums the partials in split order and casts
  sk::sum_splits<kSkCols, S::kThreads>(
      part, (long)p.M * p.N, p.N, n0, ncols, R, p.splits,
      [&](int m, int c, float4 v) { sk::store4(out + (long)m * p.N + c, v); });
  if (threadIdx.x == 0) p.counters[tile] = 0;  // ready for the next launch
}

template <typename T, int kBits>
int launch_sk(const SkArgs& p, int tiles, int device, cudaStream_t st) {
  cudaError_t err =
      ptt::allow_smem<gmm_sk_kernel<T, kBits>>(device, kSkRing);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + kSkCols - 1) / kSkCols, tiles, p.splits);
  gmm_sk_kernel<T, kBits>
      <<<grid, SkShape<T, kBits>::kThreads, kSkRing, st>>>(p);
  return (int)cudaGetLastError();
}

// ---- the tensor-core dx of int8 stacks: dx_tile.cuh, tiles bound to experts

struct DxArgs {
  const void* dy;      // [M, N], T
  const void* w;       // [E, K, N] int8
  const float* s;      // [E, G, N]
  const int* offs;     // [E + 1] row offsets of the experts
  void* out;           // dx [M, K], T
  float* ws;           // [splits, M, K] fp32 partials when splits > 1
  int* counters;       // one arrival count per output tile, zero on entry
  int M, K, N, E, G, splits, per;
};

// T, the activations: bf16 or fp16. Block (x, y, z): stored rows [64 x, 64
// x + 64) of its expert's stack (dx columns), row tile y of 64 rows bound to
// its expert on the device, the n stages [z per, z per + per) of 64
// columns: one tile of dx_tile.cuh over the expert's stack, scale rows and
// rows only. A dead tile (past the last live one) returns before any load
// and touches no counter, so experts without rows read nothing.
template <typename T>
__global__ void __launch_bounds__(ptt::dx::kThreads)
gmm_dx_kernel(const DxArgs p) {
  namespace sk = ptt::sk;
  namespace dx = ptt::dx;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int bind[3];
  if (threadIdx.x == 0) bind_tile(p.offs, p.E, p.M, sk::RP, blockIdx.y, bind);
  __syncthreads();
  const int ex = bind[0];
  if (ex < 0) return;  // a dead tile: no weight bytes, no counter
  const int m0 = bind[1];
  const int8_t* w = static_cast<const int8_t*>(p.w) + (long)ex * p.K * p.N;
  const dx::Tile t{p.dy, w, p.s + (long)ex * p.G * p.N, p.out, p.ws,
                   p.counters, p.M, p.K, p.N, p.G, p.splits, p.per};
  dx::run<T, int8_t>(ring, t, blockIdx.x * dx::kRows, m0, bind[2] - m0,
                     blockIdx.z);
}

template <typename T>
int launch_dx(const DxArgs& p, int tiles, int device, cudaStream_t st) {
  namespace dx = ptt::dx;
  cudaError_t err = ptt::allow_smem<gmm_dx_kernel<T>>(device, dx::kRing);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.K / dx::kRows, tiles, p.splits);
  gmm_dx_kernel<T><<<grid, dx::kThreads, dx::kRing, st>>>(p);
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
// 1 = bf16, 2 = fp16 (a, out and fp w).
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

// The 16-bit fp-weight forward and dx on the tensor cores. a, w, out of dtype
// 1 = bf16 or 2 = fp16 and 16-byte aligned, K and N multiples of 8; offs, ws,
// counters as above; tile: 0 = serving (32-row tiles), 1 = prefill (128-row
// tiles); tiles: grid rows, at least the live row tiles at that tile's rows;
// each block reduces `per` stages of 64 of its split.
#define PTT_GMM_TC_ENTRY(name, bwd)                                         \
  int name(const void* a, const void* w, const void* offs, void* out,       \
           void* ws, void* counters, int M, int K, int N, int E, int tile,  \
           int tiles, int splits, int per, int dtype, int device,           \
           void* stream) {                                                  \
    return launch_tc_entry<bwd>(a, w, offs, out, ws, counters, M, K, N, E,  \
                                tile, tiles, splits, per, dtype, device,    \
                                stream);                                    \
  }
PTT_GMM_TC_ENTRY(ptt_gmm_tc, false)
PTT_GMM_TC_ENTRY(ptt_gmm_bwd_tc, true)
#undef PTT_GMM_TC_ENTRY

// The skinny route's forward: x [M, K], w [E, K, N] int8 (bits 8) or [E,
// K / 2, N] packed int4 (bits 4), s [E, G, N] fp32, offs [E + 1], out [M,
// N]; ws [splits, M, N] fp32 (unused when splits == 1); counters: one int
// per output tile (tiles x 64-column tiles), all zero. The stored rows (K
// or K / 2) a multiple of 64, N of 16, K / G of 16; x, w, s, out 16-byte
// aligned; tiles: grid rows, at least the live 64-row tiles; each block
// reduces `per` 64-row stages of its split. dtype: 1 = bf16, 2 = fp16 (x
// and out).
int ptt_gmm_sk(const void* x, const void* w, const void* s, const void* offs,
               void* out, void* ws, void* counters, int M, int K, int N,
               int E, int G, int bits, int tiles, int splits, int per,
               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int KW = bits == 4 ? K / 2 : K;
  if ((bits != 8 && bits != 4) || (dtype != 1 && dtype != 2) || M < 1 ||
      E < 1 || K < 1 ||
      (bits == 4 && K % 2) || KW % ptt::sk::KS || N < 16 || N % 16 ||
      G < 1 || K % G || (K / G) % 16 || tiles < 1 || splits < 1 ||
      per < 1 || (long)(splits - 1) * per * ptt::sk::KS >= KW ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (misaligned(x) || misaligned(w) || misaligned(s) || misaligned(out))
    return (int)cudaErrorMisalignedAddress;
  const SkArgs p{x, w, static_cast<const float*>(s),
                 static_cast<const int*>(offs), out, static_cast<float*>(ws),
                 static_cast<int*>(counters), M, K, N, E, G, splits, per};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return bits == 8 ? launch_sk<__half, 8>(p, tiles, device, st)
                     : launch_sk<__half, 4>(p, tiles, device, st);
  return bits == 8 ? launch_sk<__nv_bfloat16, 8>(p, tiles, device, st)
                   : launch_sk<__nv_bfloat16, 4>(p, tiles, device, st);
}

// The tensor-core dx of int8 stacks: dy [M, N], w [E, K, N] int8, s [E, G,
// N] fp32, offs [E + 1], out dx [M, K]; ws [splits, M, K] fp32 (unused when
// splits == 1); counters: one int per output tile (tiles x K / 64), all
// zero. K a multiple of 64, N of 16, K / G of 16; dy, w, s, out 16-byte
// aligned; tiles: grid rows, at least the live 64-row tiles; each block
// reduces `per` 64-column stages of N of its split. dtype: 1 = bf16, 2 =
// fp16 (dy and out).
int ptt_gmm_dx_tc(const void* dy, const void* w, const void* s,
                  const void* offs, void* out, void* ws, void* counters,
                  int M, int K, int N, int E, int G, int tiles, int splits,
                  int per, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nst = (N + ptt::sk::KS - 1) / ptt::sk::KS;
  if ((dtype != 1 && dtype != 2) || M < 1 || E < 1 || K < 1 ||
      K % ptt::dx::kRows || N < 16 || N % 16 || G < 1 || K % G ||
      (K / G) % 16 || tiles < 1 || splits < 1 || per < 1 ||
      (long)(splits - 1) * per >= nst || (long)splits * per < nst ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (misaligned(dy) || misaligned(w) || misaligned(s) || misaligned(out))
    return (int)cudaErrorMisalignedAddress;
  const DxArgs p{dy, w, static_cast<const float*>(s),
                 static_cast<const int*>(offs), out, static_cast<float*>(ws),
                 static_cast<int*>(counters), M, K, N, E, G, splits, per};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 2 ? launch_dx<__half>(p, tiles, device, st)
                    : launch_dx<__nv_bfloat16>(p, tiles, device, st);
}

}  // extern "C"
