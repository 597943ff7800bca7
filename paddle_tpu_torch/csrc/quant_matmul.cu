// Weight-only quantized GEMM for Hopper (sm_90a): int8 and split-half int4
// weights with per-channel or per-group fp32 scales, fp32, bf16 or fp16
// activations, forward y = x @ deq(W) (+ bias) and backward
// dx = dy @ deq(W)^T.
//
// Replaces paddle_tpu/ops/pallas/quant_matmul.py::_qmm_kernel (int8
// forward), ::_qmm4_kernel (int4 forward), ::_qmm_bwd_kernel and
// ::_qmm4_bwd_kernel (the backwards). Computes what they compute: each
// weight element dequantizes as q * s[g] with g the scale group of its
// ORIGINAL in-dim row, rounded to the activation type (the Pallas kernels
// widen both to x.dtype and multiply there), products accumulate in fp32,
// the result is written in the activation type. int4 is split-half packed:
// byte i of the [K/2, N] array holds row i in its low nibble and row
// K/2 + i in its high nibble, so the two nibbles of one byte read
// different scale rows.
//
// Three kernels. ops/quant_matmul.py qmm_plan picks one before the launch,
// from shapes and alignment alone:
//
// qmm_tc_kernel<T, W> ("tc": the bf16 / fp16 (T) int8 (W = int8_t) or
// split-half int4 (W = uint8_t) forward at M <= 64 tokens, the stored rows (K,
// or K / 2 for int4) a multiple of 64, N of 16, scale groups of a multiple of
// 16 rows, 16-byte aligned rows) — what the serving step runs. A block owns 64
// output columns
// and a K-slice (the plan splits the stored rows until the blocks fill the
// card's SMs: GPT-125M's four int8 GEMMs at M 24 launch 144 blocks
// each). The
// weight tile, its scale rows and x's k-slice stream through one cp.async
// ring of 16-byte chunks, stages of 64 stored rows in 96 KB
// (skinny_gemm.cuh), so each weight byte is read once and a block's whole
// K-slice is in flight at once. 16-bit activations multiply on the tensor
// cores: mma.sync m16n8k16 with W as the A operand (the 64 columns are four
// warps' 16-row sides, the 24 tokens three n8 tiles); a weight tile reaches
// the A fragments by ldmatrix.x2.trans and dequantizes in registers to T
// (q * T(s), rounded once, as the reference). An int4 stage is 64 stored
// rows feeding reduction rows k.. (low nibbles) and K/2 + k.. (high
// nibbles): one ldmatrix gives both halves' A fragments, each multiplied
// with its own k-slice of x (both slices side by side in a token row, both
// halves' scale rows in the stage), so int4 moves half of int8's weight
// bytes for the same mma count. 16-bit only: an H100 ran fp32 faster on
// qmm_kernel than on this tile's CUDA-core branch. Each K-slice leaves an
// fp32 partial; the last block of a column tile to arrive (a counter it
// resets) sums them in split order, adds the fp32 bias and casts:
// deterministic.
//
// qmm_dx_kernel<T, W> ("tc" for bwd: the bf16 / fp16 int8 or int4 dx at
// any M on the same widths and alignment) computes dx^T = W . dy^T: a block
// owns 64 stored rows (64 dx columns; int4 128: column k0 + i from byte row
// i's low nibble, K/2 + k0 + i from its high one) and a pass of up to 64 dy
// rows (the passes are a grid dimension: each weight byte is read from
// device memory once a pass, the repeats from L2), and walks the reduction
// over N in stages of 64 columns, split across blocks (3 stages a split
// where the grid then keeps half to two blocks an SM: each split's partial
// is read back by the tile's last block). The weight tile [64 rows][64 n],
// its scale rows over n (the at most 4 groups the 64 rows touch, both
// halves' for int4) and dy's n-slice stream through one cp.async ring of
// 16-byte chunks in 96 KB (sk::issue_w, as many stages as fit). A weight
// row is contiguous along the reduction, so W is the A operand of mma.sync
// m16n8k16 with no transpose: ldmatrix of byte pairs, each byte dequantized
// in registers with its own n's scale, the mma's reduction index permuted
// within a 16-wide step and dy's B fragments read to match (dx_stage). int4
// turns one ldmatrix into two A fragments multiplied with the same B
// fragment. Split partials are summed in split order by the last block of
// a tile (sk::sum_splits): deterministic, counters left at zero. The tile
// is dx_tile.cuh's, which the int8 grouped GEMM's dx (grouped_matmul.cu
// gmm_dx_kernel) runs with each row tile bound to an expert.
//
// qmm_kernel ("cc": everything else — fp32, the forward at more rows, odd
// widths, unaligned pointers) reads each weight tile once per 32 activation
// rows with 16-byte loads one stage ahead in registers, dequantizes it into
// fp32 shared memory and runs a 32 x 64 register-tiled FMA product (2 x 4
// outputs a thread), with the same split sums.
//
// What bounds them on the H100: at the serving shapes (M = 24 token rows,
// GPT-125M's wqkv 768x2304, wo 768x768, w1 768x3072, w2 3072x768) bytes in
// bf16 — the int8 weights of one layer are 7.1 MB, ~2.1 us at 3.35 TB/s,
// against 0.34 GFLOP, ~0.3 us on the bf16 tensor cores — and operations in
// fp32 (~5.1 us at 67 TFLOP/s on the CUDA cores). At that size a launch's
// fixed costs (the first bytes' latency, the split sums' second pass)
// weigh as much as the bytes.
#include "common.cuh"
#include "dx_tile.cuh"
#include "skinny_gemm.cuh"

#include <cstdint>

namespace {

using ptt::deq;
using ptt::ldsm_x4;
using ptt::load_row16;
using ptt::Row16;
using ptt::store;
using ptt::to_f;
namespace sk = ptt::sk;

constexpr int kThreads = 256;
constexpr int BM = 32;           // activation rows per block
constexpr int BJ = 64;           // output columns per block
constexpr int BR = 64;           // reduction indices per stage
constexpr int kBPitch = BJ + 4;  // float4-aligned rows of the B tile
constexpr int kAPitch = BM + 2;  // float2-aligned rows of the A tile

struct Args {
  const void* a;       // x [M, K] (forward) or dy [M, N] (backward), T
  const int8_t* w;     // [KW, N]: int8 (KW = K) or packed int4 (KW = K / 2)
  const float* s;      // [K / gs, N]
  const float* bias;   // [N] or null (forward only), added in fp32
  void* out;           // [M, N] (forward) or [M, K] (backward), T
  float* ws;           // [splits, M, J] fp32 partials when splits > 1
  int* counters;       // one arrival count per output tile, zero on entry
  int M, K, N, gs, splits, per, vec;
};

template <typename T, bool kInt4, bool kBwd>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const Args p) {
  constexpr int RW = kInt4 ? 32 : 64;   // stored weight rows per tile
  constexpr int NS = kInt4 ? 2 : 1;     // original rows per stored row
  __shared__ __align__(16) float Bs[BR * kBPitch];
  __shared__ __align__(16) float As[BR * kAPitch];
  __shared__ int last_flag;

  const T* A = static_cast<const T*>(p.a);
  const int M = p.M, K = p.K, N = p.N;
  const int KW = kInt4 ? K / 2 : K;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
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
  Row16<int8_t> raw;
  float sc[NS][16];
  float av[8];

  auto load_stage = [&](int t) {
    const int wr0 = kBwd ? blockIdx.x * RW : t * RW;
    const int wc0 = kBwd ? t * BR : blockIdx.x * BJ;
    if (w_loader) {
      const int row = wr0 + li, col = wc0 + lc;
      const bool row_ok = row < KW;
      load_row16(raw, p.w + (long)row * N, col, N, row_ok, p.vec);
#pragma unroll
      for (int h = 0; h < NS; ++h) {
        const long g = (long)((h * KW + row) / p.gs) * N;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          sc[h][e] = (row_ok && col + e < N) ? __ldg(p.s + g + col + e) : 0.f;
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
      av[u] = (ok && mm < M) ? to_f(A[(long)mm * A_cols + c]) : 0.f;
    }
  };

  auto store_stage = [&]() {
    if (w_loader) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int c = lc + e;
        float v[NS];
        if constexpr (kInt4) {
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
    if (!kBwd) {
      const int c = blockIdx.x * BJ + jl;
      return c < N ? c : -1;
    }
    const int wr0 = blockIdx.x * RW;
    if (kInt4) {
      const int pr = wr0 + (jl % 32);
      return pr < KW ? (jl < 32 ? 0 : KW) + pr : -1;
    }
    return wr0 + jl < K ? wr0 + jl : -1;
  };
  T* out = static_cast<T*>(p.out);
  auto finish = [&](int m, int c, float v) {
    if (!kBwd && p.bias) v += p.bias[c];
    store(out + (long)m * J + c, v);
  };

  if (p.splits == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + ty * 2 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = out_col(tx * 4 + j);
        if (c >= 0) finish(m, c, acc[i][j]);
      }
    }
    return;
  }
  // split reduction: publish this split's partial; the last block of the
  // tile to arrive sums all partials in split order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
    if (m >= M) continue;
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
  // each (row, column) sums its partials in split order; the loads of a
  // thread's 8 outputs over 4 splits are issued together
  long off[2][4];
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 2 + i, c = out_col(tx * 4 + j);
      off[i][j] = (m < M && c >= 0) ? (long)m * J + c : -1;
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
      if (off[i][j] >= 0)
        finish(m0 + ty * 2 + i, out_col(tx * 4 + j), sum[i][j]);
  if (tid == 0) p.counters[tile] = 0;  // ready for the next launch
}

// ---- the tensor-core route (the 16-bit int8 / int4 forward, M <= 64) ----

constexpr int kTcCols = 64;          // output columns a block
constexpr int kTcRing = 96 << 10;    // the ring's shared memory: 2 blocks an SM

struct TcArgs {
  const void* x;       // [M, K], T
  const void* w;       // [K, N] int8 or [K / 2, N] packed int4
  const float* s;      // [G, N]
  const float* bias;   // [N] or null, added in fp32
  void* out;           // [M, N], T
  float* ws;           // [splits, M, N] fp32 partials when splits > 1
  int* counters;       // one arrival count per column tile, zero on entry
  int M, K, N, G, splits, per;
};

// T, the activations: bf16 or fp16; W, the weight kind: int8_t (int8) or
// uint8_t (split-half packed int4)
template <typename T, typename W>
using TcShape = ptt::sk::Shape<T, W, kTcCols>;

template <typename T, typename W>
__global__ void __launch_bounds__(TcShape<T, W>::kThreads)
qmm_tc_kernel(const TcArgs p) {
  using S = TcShape<T, W>;
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ int last_flag;
  const int KW = S::kQ4 ? p.K / 2 : p.K;   // stored rows
  const int n0 = blockIdx.x * kTcCols, z = blockIdx.y;
  const int ncols = min(kTcCols, p.N - n0);
  const int s0 = z * p.per, s1 = min(KW / sk::KS, s0 + p.per);
  const T* x = static_cast<const T*>(p.x);
  const sk::WTile<W> wt{static_cast<const W*>(p.w), p.s, p.N, n0, ncols,
                        p.K / p.G, p.G, S::kQ4 ? p.K / 2 : 0};
  float acc[8][4];
  sk::run_tile<T, W, kTcCols, true, false>(
      acc, ring, kTcRing, wt, s0 * sk::KS, s1 * sk::KS,
      [&](int r) { return x + (long)r * p.K; }, p.M, p.w, [] {});
  T* out = static_cast<T*>(p.out);
  if (p.splits == 1) {
    sk::for_each_acc<T, W, kTcCols>(acc, p.M, [&](int m, int c, float v) {
      if (c >= ncols) return;
      if (p.bias) v += p.bias[n0 + c];
      store(out + (long)m * p.N + n0 + c, v);
    });
    return;
  }
  sk::for_each_acc<T, W, kTcCols>(acc, p.M, [&](int m, int c, float v) {
    if (c < ncols) p.ws[((long)z * p.M + m) * p.N + n0 + c] = v;
  });
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_flag = atomicAdd(p.counters + blockIdx.x, 1) == p.splits - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  // the last block sums the partials in split order, adds the bias, casts
  sk::sum_splits<kTcCols, S::kThreads>(
      p.ws, (long)p.M * p.N, p.N, n0, ncols, p.M, p.splits,
      [&](int m, int c, float4 v) {
        if (p.bias) {
          v.x += p.bias[n0 + c];
          v.y += p.bias[n0 + c + 1];
          v.z += p.bias[n0 + c + 2];
          v.w += p.bias[n0 + c + 3];
        }
        sk::store4(out + (long)m * p.N + n0 + c, v);
      });
  if (threadIdx.x == 0) p.counters[blockIdx.x] = 0;   // ready for the next
}

template <typename T, typename W>
int launch_tc(const TcArgs& p, int device, cudaStream_t st) {
  cudaError_t err = ptt::allow_smem<qmm_tc_kernel<T, W>>(device, kTcRing);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + kTcCols - 1) / kTcCols, p.splits);
  qmm_tc_kernel<T, W><<<grid, TcShape<T, W>::kThreads, kTcRing, st>>>(p);
  return (int)cudaGetLastError();
}

// ---- the tensor-core dx (the 16-bit int8 / int4 backward, any M) ----

namespace dx = ptt::dx;

struct DxArgs {
  const void* dy;      // [M, N], T
  const void* w;       // [K, N] int8 or [K / 2, N] packed int4
  const float* s;      // [G, N]
  void* out;           // dx [M, K], T
  float* ws;           // [splits, M, K] fp32 partials when splits > 1
  int* counters;       // one arrival count per (row tile, token pass)
  int M, K, N, G, splits, per;
};

// T, the activations: bf16 or fp16; W, the weight kind: int8_t (int8) or
// uint8_t (split-half packed int4). Block (x, y, z): stored rows [64 x, 64
// x + 64), tokens [64 y, 64 y + 64) of dy, the n stages [z per, z per +
// per) of 64 columns: one tile of dx_tile.cuh.
template <typename T, typename W>
__global__ void __launch_bounds__(dx::kThreads)
qmm_dx_kernel(const DxArgs p) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int m0 = blockIdx.y * sk::RP;
  const dx::Tile t{p.dy, p.w, p.s, p.out, p.ws, p.counters,
                   p.M, p.K, p.N, p.G, p.splits, p.per};
  dx::run<T, W>(ring, t, blockIdx.x * dx::kRows, m0, min(sk::RP, p.M - m0),
                blockIdx.z);
}

template <typename T, typename W>
int launch_dx(const DxArgs& p, int device, cudaStream_t st) {
  cudaError_t err = ptt::allow_smem<qmm_dx_kernel<T, W>>(device, dx::kRing);
  if (err != cudaSuccess) return (int)err;
  const int kw = std::is_same_v<W, uint8_t> ? p.K / 2 : p.K;
  dim3 grid(kw / dx::kRows, (p.M + sk::RP - 1) / sk::RP, p.splits);
  qmm_dx_kernel<T, W><<<grid, dx::kThreads, dx::kRing, st>>>(p);
  return (int)cudaGetLastError();
}

template <bool kInt4, bool kBwd>
int launch(const void* a, const void* w, const void* s, const void* bias,
           void* out, void* ws, void* counters, int M, int K, int N, int G,
           int splits, int per, int vec, int dtype, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || K % G || (kInt4 && K % 2) || splits < 1 || per < 1)
    return (int)cudaErrorInvalidValue;
  const int KW = kInt4 ? K / 2 : K;
  const int RW = kInt4 ? 32 : 64;
  const Args p{a, static_cast<const int8_t*>(w), static_cast<const float*>(s),
               static_cast<const float*>(bias), out, static_cast<float*>(ws),
               static_cast<int*>(counters), M, K, N, K / G, splits, per, vec};
  const int gx = kBwd ? (KW + RW - 1) / RW : (N + BJ - 1) / BJ;
  dim3 grid(gx, (M + BM - 1) / BM, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    qmm_kernel<float, kInt4, kBwd><<<grid, kThreads, 0, st>>>(p);
  else if (dtype == 1)
    qmm_kernel<__nv_bfloat16, kInt4, kBwd><<<grid, kThreads, 0, st>>>(p);
  else if (dtype == 2)
    qmm_kernel<__half, kInt4, kBwd><<<grid, kThreads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// a: x [M, K] (forward) or dy [M, N] (backward); w [K, N] int8 or [K/2, N]
// packed int4; s [G, N] fp32; bias [N] fp32 or null (forward); out [M, N]
// (forward) or [M, K] (backward); ws [splits, M, N or K] fp32 (unused when
// splits == 1); counters: one int per output tile, all zero. Each block
// reduces `per` stages of its split. vec: w's rows are 16-byte aligned.
// dtype: 0 = fp32, 1 = bf16, 2 = fp16 (a and out).
#define PTT_QMM_ENTRY(name, int4, bwd)                                       \
  int name(const void* a, const void* w, const void* s, const void* bias,   \
           void* out, void* ws, void* counters, int M, int K, int N, int G, \
           int splits, int per, int vec, int dtype, int device,             \
           void* stream) {                                                  \
    return launch<int4, bwd>(a, w, s, bias, out, ws, counters, M, K, N, G,  \
                             splits, per, vec, dtype, device, stream);      \
  }
PTT_QMM_ENTRY(ptt_qmm_int8, false, false)
PTT_QMM_ENTRY(ptt_qmm_int4, true, false)
PTT_QMM_ENTRY(ptt_qmm_int8_bwd, false, true)
PTT_QMM_ENTRY(ptt_qmm_int4_bwd, true, true)
#undef PTT_QMM_ENTRY

// The tensor-core route's forward: x [M, K], w [K, N] int8 (bits 8) or
// [K / 2, N] packed int4 (bits 4), s [G, N], bias [N] fp32 or null, out
// [M, N]; ws [splits, M, N] fp32 (unused when splits == 1); counters: one
// int per 64-column tile, all zero. 1 <= M <= 64, the stored rows (K or
// K / 2) a multiple of 64, N of 16, (K / G) % 16 == 0, x / w / s / out
// 16-byte aligned; each block reduces `per` 64-row stages of stored rows of
// its split. dtype: 1 = bf16, 2 = fp16 (x and out).
int ptt_qmm_tc(const void* x, const void* w, const void* s, const void* bias,
               void* out, void* ws, void* counters, int M, int K, int N,
               int G, int bits, int splits, int per, int dtype, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int KW = bits == 4 ? K / 2 : K;
  if ((bits != 8 && bits != 4) || (dtype != 1 && dtype != 2) || M < 1 ||
      M > ptt::sk::RP || K < 1 || (bits == 4 && K % 2) ||
      KW % ptt::sk::KS || N % 16 || G < 1 || K % G || (K / G) % 16 ||
      splits < 1 || per < 1 ||
      (long)(splits - 1) * per * ptt::sk::KS >= KW ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (misaligned(x) || misaligned(w) || misaligned(s) || misaligned(out))
    return (int)cudaErrorMisalignedAddress;
  const TcArgs p{x, w, static_cast<const float*>(s),
                 static_cast<const float*>(bias), out,
                 static_cast<float*>(ws), static_cast<int*>(counters), M, K,
                 N, G, splits, per};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return bits == 8 ? launch_tc<__half, int8_t>(p, device, st)
                     : launch_tc<__half, uint8_t>(p, device, st);
  return bits == 8 ? launch_tc<__nv_bfloat16, int8_t>(p, device, st)
                   : launch_tc<__nv_bfloat16, uint8_t>(p, device, st);
}

// The tensor-core dx: dy [M, N], w [K, N] int8 (bits 8) or [K / 2, N]
// packed int4 (bits 4), s [G, N], out dx [M, K]; ws [splits, M, K] fp32
// (unused when splits == 1); counters: one int per (64 stored rows, 64
// tokens) tile, all zero. M >= 1, the stored rows (K or K / 2) a multiple
// of 64, N of 16, (K / G) % 16 == 0, dy / w / s / out 16-byte aligned; each
// block reduces `per` 64-column stages of n of its split. dtype: 1 = bf16,
// 2 = fp16 (dy and out).
int ptt_qmm_dx_tc(const void* dy, const void* w, const void* s, void* out,
                  void* ws, void* counters, int M, int K, int N, int G,
                  int bits, int splits, int per, int dtype, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int KW = bits == 4 ? K / 2 : K;
  const int nst = (N + ptt::sk::KS - 1) / ptt::sk::KS;
  if ((bits != 8 && bits != 4) || (dtype != 1 && dtype != 2) || M < 1 ||
      K < 1 || (bits == 4 && K % 2) || KW % dx::kRows || N < 16 || N % 16 ||
      G < 1 || K % G || (K / G) % 16 || splits < 1 || per < 1 ||
      (long)(splits - 1) * per >= nst || (long)splits * per < nst ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (misaligned(dy) || misaligned(w) || misaligned(s) || misaligned(out))
    return (int)cudaErrorMisalignedAddress;
  const DxArgs p{dy, w, static_cast<const float*>(s), out,
                 static_cast<float*>(ws), static_cast<int*>(counters), M, K,
                 N, G, splits, per};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return bits == 8 ? launch_dx<__half, int8_t>(p, device, st)
                     : launch_dx<__half, uint8_t>(p, device, st);
  return bits == 8 ? launch_dx<__nv_bfloat16, int8_t>(p, device, st)
                   : launch_dx<__nv_bfloat16, uint8_t>(p, device, st);
}

}  // extern "C"
