// The tensor-core dx tile for Hopper (sm_90a), shared by the weight-only
// GEMM's dx (quant_matmul.cu qmm_dx_kernel) and the int8 grouped GEMM's dx
// (grouped_matmul.cu gmm_dx_kernel, each row tile bound to one expert).
//
// One block computes dx^T = W . dy^T for 64 stored weight rows (64 dx
// columns; split-half int4 128: column k0 + i from byte row i's low nibble,
// K/2 + k0 + i from its high one) and up to 64 dy rows [m0, m0 + R), over
// its split of the reduction along N: stages of 64 columns. The weight
// tile [64 rows][64 n], its scale rows over n (the at most 4 groups the 64
// rows touch, both halves' for int4; groups of 16k rows) and dy's n-slice
// stream through one cp.async ring of 16-byte chunks in 96 KB (sk::issue_w,
// as many stages as fit: two blocks an SM). A weight row is contiguous
// along the reduction, so W is the A operand of mma.sync m16n8k16 with no
// transpose: ldmatrix of byte pairs, each byte dequantized in registers
// with its own n's scale (q * T(s), rounded once, as the reference), the
// mma's reduction index permuted within a 16-wide step and dy's B
// fragments read to match (dx_stage). Products accumulate in fp32; the
// block's sums leave token-major through shared memory in 16-byte stores,
// to dx itself (one split) or to the split's fp32 partial plane, and the
// tile's last block to arrive (a counter it resets) sums the partials in
// split order (sk::sum_splits): deterministic, bitwise equal on repeats.
#pragma once

#include "common.cuh"
#include "skinny_gemm.cuh"

#include <cstdint>

namespace ptt {
namespace dx {

constexpr int kRows = 64;          // stored weight rows a block
constexpr int kRing = 96 << 10;    // the ring: two blocks an SM
constexpr int kThreads = 128;      // a warp per 16 stored rows
// a dy row of a stage: 64 n of T padded to 160 bytes (40 words), so the 4
// token rows a half-warp's 8-byte B loads touch fall in 4 bank octets
constexpr int kYP = sk::KS * 2 + 32;

// One block's tile: dy and dx whole, the weight and its scales those the
// tile reads (a grouped GEMM's expert stack and scale rows), the arrival
// counters of the grid's (x, y) tiles (the block's is read at the end, from
// blockIdx: a pointer kept across the stages would cost int4 two registers).
struct Tile {
  const void* dy;      // [M, N], T
  const void* w;       // [K, N] int8 or [K / 2, N] packed int4
  const float* s;      // [G, N]
  void* out;           // dx [M, K], T
  float* ws;           // [splits, M, K] fp32 partials when splits > 1
  int* counters;       // [gridDim.y, gridDim.x], zero on entry and exit
  int M, K, N, G, splits, per;
};

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// dy's rows [m0, m0 + R) over n in [n, n + 64) (zeros past N) into a stage
// at pitch kYP; the rows up to the next 8 are zero-filled (an n8 tile).
template <typename T>
__device__ __forceinline__ void issue_dy(unsigned char* ys, const T* dy,
                                         int ld, int m0, int R, int n,
                                         int ncols) {
  constexpr int CPR = sk::KS * 2 / 16, VEC = 8;   // 16-byte chunks a row
  const int rows = (R + 7) / 8 * 8;
  for (int i = threadIdx.x; i < rows * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < R && c * VEC < ncols;
    cp_async16(ys + r * kYP + c * 16,
               ok ? dy + (long)(m0 + r) * ld + n + c * VEC : dy, ok);
  }
}

// One stage of dx^T = W . dy^T on the tensor cores: warp w's 16 stored rows
// are the A operand's rows, the tokens n8 tiles. A row of W is contiguous
// along the reduction n, so ldmatrix (no .trans) of byte pairs gives lane
// (g = lane / 4, t = lane % 4) the bytes of rows g and g + 8 at n 4t ..
// 4t + 3 of a 16-wide step; the mma's reduction index j of the step is
// therefore n pi(j) = 4 (j % 8 / 2) + 2 (j / 8) + j % 2, and dy's B
// fragment of token g is its 4 elements at n 4t .. 4t + 3, one 8-byte
// load. Each byte dequantizes in registers with its own n's scale (q *
// T(s), one rounding); int4's low nibbles feed dx column k0 + row
// (acc[0]), its high nibbles kh + k0 + row (acc[1]), both with the same B
// fragments. int4 loads the stage's four steps of bytes first (two
// ldmatrix.x4) and dequantizes them together, int8 goes step by step: on
// an H100 each order ran its weight kind faster than the other (4% for
// int4, 1.3x for int8), and int4 step by step spilled.
template <typename T, typename W>
__device__ __forceinline__ void dx_stage(float (&acc)[2][8][4],
                                         const unsigned char* st,
                                         const unsigned char* ys, int glo,
                                         int ghi, int R) {
  using S = sk::Shape<T, W, kRows>;
  constexpr int KT = sk::KS / 16;   // 16-wide steps a stage
  const int lane = threadIdx.x & 31, ws = (threadIdx.x >> 5) * 16;
  const int t4 = 4 * (lane & 3), g = lane >> 2;
  const float* ss = reinterpret_cast<const float*>(st + S::W_BYTES) + t4;
  // step kt's A fragments from rows g / g + 8's bytes r
  const auto dequant = [&](int kt, const uint32_t (&r)[2],
                           uint32_t (&a)[S::kH][4]) {
#pragma unroll
    for (int h = 0; h < S::kH; ++h) {
      float4 s4 = *reinterpret_cast<const float4*>(
          ss + (h ? ghi : glo) * kRows + 16 * kt);
      s4 = make_float4(round_to<T>(s4.x), round_to<T>(s4.y),
                       round_to<T>(s4.z), round_to<T>(s4.w));
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        // byte j of r[q]: int8 its value; int4 its low nibble at bits 8j..,
        // its high at 8j + 4..
        const auto val = [&](int j) {
          return S::kQ4
                     ? (float)((int)(r[q] << (28 - 8 * j - 4 * h)) >> 28)
                     : (float)(int8_t)((r[q] >> (8 * j)) & 0xFF);
        };
        a[h][q] = pack2<T>(val(0) * s4.x, val(1) * s4.y);
        a[h][q + 2] = pack2<T>(val(2) * s4.z, val(3) * s4.w);
      }
    }
  };
  const auto mma = [&](int kt, const uint32_t (&a)[S::kH][4]) {
#pragma unroll
    for (int p = 0; p < sk::RP / 8; ++p) {
      if (8 * p < R) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            ys + (8 * p + g) * kYP + (16 * kt + t4) * 2);
#pragma unroll
        for (int h = 0; h < S::kH; ++h)
          mma16<T>(acc[h][p], a[h], b.x, b.y);
      }
    }
  };
  if constexpr (S::kQ4) {
    // matrices (rows 0-7, n 32u), (rows 8-15, 32u), (0-7, 32u + 16), (8-15,
    // 32u + 16): steps 2u and 2u + 1
    const unsigned char* wrow =
        st + (ws + (lane & 7) + (lane & 8)) * S::WP + (lane >> 4) * 16;
    uint32_t r[KT][2], a[KT][S::kH][4];
#pragma unroll
    for (int u = 0; u < KT / 2; ++u) {
      uint32_t d[4];
      ldsm_x4(d, wrow + 32 * u);
      r[2 * u][0] = d[0];
      r[2 * u][1] = d[1];
      r[2 * u + 1][0] = d[2];
      r[2 * u + 1][1] = d[3];
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) dequant(kt, r[kt], a[kt]);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) mma(kt, a[kt]);
  } else {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t r[2], a[S::kH][4];
      ldsm_x2(r, st + (ws + (lane & 15)) * S::WP + 16 * kt);
      dequant(kt, r, a);
      mma(kt, a);
    }
  }
}

// T, the activations: bf16 or fp16; W, the weight kind: int8_t (int8) or
// uint8_t (split-half packed int4). The block's tile: stored rows [k0, k0 +
// 64) of p.w, dy rows [m0, m0 + R) (1 <= R <= 64), the n stages [z per, z
// per + per) of 64 columns; ring: kRing bytes of dynamic shared memory.
template <typename T, typename W>
__device__ __forceinline__ void run(unsigned char* ring, const Tile& p,
                                    int k0, int m0, int R, int z) {
  using S = sk::Shape<T, W, kRows>;
  static_assert(S::kThreads == kThreads, "a warp per 16 stored rows");
  __shared__ int last_flag;
  const int kh = S::kQ4 ? p.K / 2 : 0, gs = p.K / p.G;
  const int nst = (p.N + sk::KS - 1) / sk::KS;
  const int s0 = z * p.per, n_st = min(nst, s0 + p.per) - s0;
  const T* dy = static_cast<const T*>(p.dy);
  // the scale rows a stage carries: the groups the 64 rows touch (each
  // warp's 16 rows lie in one), int4 the high half's after the low half's
  const auto groups = [&](int h) {
    return (h * kh + k0 + kRows - 1) / gs - (h * kh + k0) / gs + 1;
  };
  const int sg = S::kQ4 ? max(groups(0), groups(1)) : groups(0);
  const int ws = (threadIdx.x >> 5) * 16;
  const int glo = (k0 + ws) / gs - k0 / gs;
  const int ghi = sg + (kh + k0 + ws) / gs - (kh + k0) / gs;
  const int yoff = S::W_BYTES + S::kH * sg * kRows * 4;
  const int stage = yoff + (R + 7) / 8 * 8 * kYP;
  const int depth = min(sk::kMaxStages, kRing / stage);
  const auto issue = [&](int s) {
    unsigned char* st = ring + (s % depth) * stage;
    const int n = (s0 + s) * sk::KS, ncols = min(sk::KS, p.N - n);
    const sk::WTile<W> wt{static_cast<const W*>(p.w), p.s, p.N, n, ncols,
                          gs, p.G, kh};
    sk::issue_w<T, W, kRows, false>(st, wt, k0, k0 + kRows, sg);
    issue_dy(st + yoff, dy, p.N, m0, R, n, ncols);
  };

  float acc[2][8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][i][j] = 0.f;
  for (int s = 0; s < depth - 1; ++s) {
    if (s < n_st) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_st; ++s) {
    // stage s has landed and every thread is past stage s - 1
    sk::cp_async_wait_n(depth - 2);
    __syncthreads();
    if (s + depth - 1 < n_st) issue(s + depth - 1);
    cp_async_commit();
    const unsigned char* st = ring + (s % depth) * stage;
    dx_stage<T, W>(acc, st, st + yoff, glo, ghi, R);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's [R, 64 kH] sums through shared memory (the ring is free):
  // token-major fp32 rows, then 16-byte stores of 4 columns; local column
  // c is dx column k0 + c (c < 64), int4's high half kh + k0 + c - 64
  constexpr int CW = S::kH * kRows, CP = CW + 4;
  static_assert(sk::RP * CP * 4 <= kRing, "the sums fit in the ring");
  float* cs = reinterpret_cast<float*>(ring);
  {
    const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < S::kH; ++h)
#pragma unroll
      for (int pp = 0; pp < 8; ++pp)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cs[(8 * pp + t2 + (e & 1)) * CP + h * kRows + ws + g +
             8 * (e >> 1)] = acc[h][pp][e];
  }
  __syncthreads();
  const auto col = [&](int c) {
    return c < kRows ? k0 + c : kh + k0 + c - kRows;
  };
  T* out = static_cast<T*>(p.out);
  constexpr int CQ = CW / 4;
  for (int i = threadIdx.x; i < R * CQ; i += kThreads) {
    const int m = i / CQ, c = 4 * (i % CQ);
    const float4 v = *reinterpret_cast<const float4*>(cs + m * CP + c);
    if (p.splits == 1)
      sk::store4(out + (long)(m0 + m) * p.K + col(c), v);
    else
      sk::store4(p.ws + ((long)z * p.M + m0 + m) * p.K + col(c), v);
  }
  if (p.splits == 1) return;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    last_flag = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  // the last block sums the partials in split order and casts, each half
#pragma unroll
  for (int h = 0; h < S::kH; ++h) {
    const int c0 = col(h * kRows);
    sk::sum_splits<kRows, kThreads>(
        p.ws + (long)m0 * p.K, (long)p.M * p.K, p.K, c0, kRows, R,
        p.splits, [&](int m, int c, float4 v) {
          sk::store4(out + (long)(m0 + m) * p.K + c0 + c, v);
        });
  }
  if (threadIdx.x == 0) p.counters[tile] = 0;   // ready for the next
}

}  // namespace dx
}  // namespace ptt
