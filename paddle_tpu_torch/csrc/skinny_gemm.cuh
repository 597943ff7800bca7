// Skinny GEMM tiles for Hopper (sm_90a), shared by the weight-only GEMM's
// tensor-core route (quant_matmul.cu), the mega MLP (mega_decode.cu) and
// the quantized grouped GEMM's skinny route (grouped_matmul.cu).
//
// A block multiplies up to RP = 64 activation rows ("tokens") by NT columns
// of a weight [K, ldw] over a reduction range [k0, k1), walked in stages of
// KS = 64 rows (the last may hold fewer). The weight tile (with its fp32
// scale rows when it is quantized) and the activations' matching k-slice stream
// through one cp.async ring of 16-byte chunks, so each weight byte is read
// from device memory once. With kEdge (the mega MLP, which takes any width,
// group and address) a chunk that is clipped by an edge or does not start
// on 16 bytes is copied element by element instead, and int8 scales may
// change inside a 16-row step; without it (the weight-only GEMM's route,
// whose plan admits only whole, aligned chunks and groups of 16k rows)
// every chunk goes by cp.async. A stage holds
// only the token rows the block has (16 at a decode round), and the ring is
// as deep as the block's shared memory allows (up to 16 stages): at this
// size the kernels wait on memory latency, and the bytes in flight set the
// rate. Products accumulate in fp32 registers:
//
// - bf16 or fp16 activations T (the tensor cores; one template, the mma's
//   suffix and the roundings differ): mma.sync m16n8k16 with the weight as
//   the A operand (out^T = W^T . x^T), so the weight's columns fill the
//   16-row side and the tokens are n8 tiles (24 tokens: three tiles, no
//   padding). A warp owns 16 weight columns. A T weight tile [k][n]
//   gives its A fragments by ldmatrix.x4.trans (row g <-> column g, row
//   g + 8 <-> column g + 8). An int8 tile is read as b16 pairs of columns by
//   ldmatrix.x2.trans: a lane receives rows k 2t, 2t + 1 of columns 2g and
//   2g + 1, so A row g is column 2g and row g + 8 column 2g + 1; each value
//   dequantizes in registers to T (q * s rounded once) before the mma.
//   The activations' B fragments come by ldmatrix.x4 from the [token][k]
//   slice.
// - fp32 activations (the CUDA cores, never TF32): a thread owns 4
//   columns x every 16th token (4 NT threads a block), FMA over the stage
//   from float4s; an int8 stage dequantizes once (q * s in fp32) into an
//   fp32 tile first.
//
// Split-half int4 (W = uint8_t, the layout of ops/quant_matmul.py
// pack_int4): stored byte row i of a [K/2, N] weight holds reduction row i
// in its low nibble and row K/2 + i in its high nibble (kh = K/2 in the
// WTile). A stage is 64 stored rows, so it feeds 128 reduction rows: rows
// k .. k + 63 (lo) and kh + k .. kh + k + 63 (hi). It carries both halves'
// scale rows (SG from group k / gs, then SG from group (kh + k) / gs) and
// each token row holds both k-slices side by side (x[r, k : k + 64] then
// x[r, kh + k : kh + k + 64]). Lane -> (k, column) map on the tensor cores:
// ldmatrix.x2.trans of byte pairs gives lane (g = lane / 4, t = lane % 4)
// register q (q = 0, 1) = bytes {(row 8q + 2t, col 2g), (8q + 2t, 2g + 1),
// (8q + 2t + 1, 2g), (8q + 2t + 1, 2g + 1)}; each byte's low nibble is
// reduction row k + kk + that row, its high nibble kh + k + kk + that row.
// So one ldmatrix yields two A fragments (lo, hi: A row g = column 2g, row
// g + 8 = column 2g + 1, as for int8), each multiplied with its own slice's
// B fragment: two mma a weight load, half of int8's weight bytes. Only
// 16-bit activations take int4 (the tensor cores).
//
// Either way a thread holds acc[8][4]; for_each_acc maps each to its
// (token, column).
#pragma once

#include "common.cuh"

#include <cstdint>
#include <type_traits>

namespace ptt {

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

namespace sk {

constexpr int KS = 64;          // reduction rows a stage
constexpr int RP = 64;          // activation rows a pass
constexpr int SG = KS / 16;     // scale rows a stage, groups of 16k rows
constexpr int kMaxStages = 16;

// Scale rows a stage holds: the groups of gs rows that KS rows from a
// multiple of KS can touch (SG when gs is a multiple of 16).
__host__ __device__ constexpr int scale_rows(int gs) {
  return gs % 16 == 0 ? SG : (63 / gs + 2 < KS ? 63 / gs + 2 : KS);
}

// Shared-memory geometry of one block: T the activations, W the weight (T, or
// int8 / packed int4 with fp32 scales), NT weight columns. Rows of the weight
// and activation slices are padded by 16 bytes: an odd number of 16-byte
// chunks a row, so the 8 rows an ldmatrix reads fall in 8 bank quads. A stage
// is the weight rows, scale_rows(gs) scale rows and xrows(R) token rows.
template <typename T, typename W, int NT>
struct Shape {
  static constexpr bool kQ4 = std::is_same_v<W, uint8_t>;  // int4 pairs
  static constexpr bool kQ = std::is_same_v<W, int8_t> || kQ4;
  static constexpr int kH = kQ4 ? 2 : 1;   // reduction rows a stored row
  static constexpr bool kTC = is16<T>;   // bf16 or fp16: the tensor cores
  static_assert(NT == 32 || NT == 64, "a warp per 16 columns, 2 or 4 warps");
  static_assert(kTC ? (kQ || std::is_same_v<W, T>)
                    : (std::is_same_v<W, int8_t> || std::is_same_v<W, float>),
                "bf16 / fp16 activations take weights of their type, int8 "
                "or int4, fp32 fp32 or int8");
  // bf16 / fp16: a warp per 16 columns; fp32: a thread per (4 columns,
  // token class of 16)
  static constexpr int kThreads = kTC ? NT * 2 : NT * 4;
  static constexpr int WP = NT * (int)sizeof(W) + 16;   // bytes a weight row
  static constexpr int XP = kH * KS * (int)sizeof(T) + 16;  // a token row
  static constexpr int W_BYTES = KS * WP;
  // fp32 activations with int8 weights: one dequantized fp32 stage
  static constexpr int WF_BYTES = !kTC && kQ ? KS * (NT + 4) * 4 : 0;
  // token rows a stage holds: the tensor cores read them 16 at a time
  __host__ __device__ static constexpr int xrows(int R) {
    return kTC ? (R + 15) / 16 * 16 : R;
  }
  // where a stage's token rows start
  __host__ __device__ static constexpr int xoff(int gs) {
    return W_BYTES + (kQ ? kH * scale_rows(gs) * NT * 4 : 0);
  }
};

// Columns [n0, n0 + ncols) of a weight [K, ldw] (split-half int4: [K/2,
// ldw] stored rows); quantized weights with scales [G, ldw], gs rows a
// group; int4: kh = K/2, the first reduction row of the high nibbles.
template <typename W>
struct WTile {
  const W* w;
  const float* s;
  long ldw;
  int n0, ncols, gs, G;
  int kh = 0;
};

// Waits until at most n of this thread's committed groups are in flight (n
// < kMaxStages; the ring's depth is known at run time only).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
#define PTT_WAIT_CASE(i) \
  case i:                \
    cp_async_wait<i>();  \
    break;
    PTT_WAIT_CASE(0) PTT_WAIT_CASE(1) PTT_WAIT_CASE(2) PTT_WAIT_CASE(3)
    PTT_WAIT_CASE(4) PTT_WAIT_CASE(5) PTT_WAIT_CASE(6) PTT_WAIT_CASE(7)
    PTT_WAIT_CASE(8) PTT_WAIT_CASE(9) PTT_WAIT_CASE(10) PTT_WAIT_CASE(11)
    PTT_WAIT_CASE(12) PTT_WAIT_CASE(13)
#undef PTT_WAIT_CASE
    default:
      cp_async_wait<14>();
  }
}

// One 16-byte chunk of shared memory from n elements of E at src (the rest
// zero; none read when n <= 0): cp.async when all 16 bytes are there and
// src starts on 16 bytes, else element by element through registers (the
// barrier before the stage is read covers both). base: any valid address.
template <typename E>
__device__ __forceinline__ void copy_chunk(unsigned char* dst, const E* src,
                                           int n, const void* base) {
  constexpr int VEC = 16 / (int)sizeof(E);
  if (n >= VEC && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src, true);
  } else if (n <= 0) {
    cp_async16(dst, base, false);
  } else {
    const unsigned char* b = reinterpret_cast<const unsigned char*>(src);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      dst[e] = e < n * (int)sizeof(E) ? b[e] : (unsigned char)0;
  }
}

// The weight rows [k, min(k + KS, kend)) (zeros past kend and past ncols)
// and their sg scale rows.
template <typename T, typename W, int NT, bool kEdge>
__device__ __forceinline__ void issue_w(unsigned char* st, const WTile<W>& t,
                                        int k, int kend, int sg) {
  using S = Shape<T, W, NT>;
  constexpr int CPR = NT * (int)sizeof(W) / 16, VEC = 16 / (int)sizeof(W);
#pragma unroll
  for (int u = 0; u < (KS * CPR + S::kThreads - 1) / S::kThreads; ++u) {
    const int i = u * S::kThreads + (int)threadIdx.x;
    if (i >= KS * CPR) break;
    const int r = i / CPR, c = i % CPR, col = c * VEC;
    const W* src = t.w + (long)(k + r) * t.ldw + t.n0 + col;
    if constexpr (kEdge)
      copy_chunk(st + r * S::WP + c * 16, src,
                 k + r < kend ? t.ncols - col : 0, t.w);
    else
      cp_async16(st + r * S::WP + c * 16, col < t.ncols ? src : t.w,
                 col < t.ncols);
  }
  if constexpr (S::kQ) {
    constexpr int SC = NT / 4;   // 16-byte chunks a scale row
    // int4: the low half's sg rows, then the high half's
    for (int i = threadIdx.x; i < S::kH * sg * SC; i += S::kThreads) {
      const int j = i / SC, col = (i % SC) * 4;
      const int h = S::kQ4 ? j / sg : 0;
      const int g = min((h * t.kh + k) / t.gs + j - h * sg, t.G - 1);
      const float* src = t.s + (long)g * t.ldw + t.n0 + col;
      if constexpr (kEdge)
        copy_chunk(st + S::W_BYTES + (j * NT + col) * 4, src, t.ncols - col,
                   t.s);
      else
        cp_async16(st + S::W_BYTES + (j * NT + col) * 4,
                   col < t.ncols ? src : t.s, col < t.ncols);
    }
  }
}

// The tokens' k-slice [k, min(k + KS, kend)) into xs (zeros past kend):
// token r at xrow(r) + k (xrow(r) + j is element j of its reduction axis);
// split-half int4 puts the slice at kh + k beside it in the same row.
// Tokens past R read nothing; on the tensor cores those up to the next 16
// are zero-filled (a B fragment holds 16 tokens).
template <typename T, typename W, int NT, bool kEdge, typename XRow>
__device__ __forceinline__ void issue_x(unsigned char* xs, XRow xrow, int k,
                                        int kend, int R, const void* base,
                                        int kh) {
  using S = Shape<T, W, NT>;
  constexpr int CPR = KS * (int)sizeof(T) / 16, VEC = 16 / (int)sizeof(T);
  constexpr int CH = S::kH * CPR;   // 16-byte chunks a token row
  const int rows = S::xrows(R);
  for (int i = threadIdx.x; i < rows * CH; i += S::kThreads) {
    const int r = i / CH, c = i % CH;
    const int e = (S::kQ4 && c >= CPR ? kh - CPR * VEC : 0) + c * VEC;
    if (kEdge && r < R)
      copy_chunk(xs + r * S::XP + c * 16, xrow(r) + k + e, kend - k - e,
                 base);
    else
      cp_async16(xs + r * S::XP + c * 16,
                 r < R ? static_cast<const void*>(xrow(r) + k + e) : base,
                 r < R);
  }
}

// One stage on the tensor cores (T activations, bf16 or fp16; the token
// rows at xs). kRS: the scale rounds to T before the product (the
// weight-only GEMM's dequantization; the mega MLP's rounds q * s once, in
// fp32).
template <typename T, typename W, int NT, bool kRS, bool kEdge>
__device__ __forceinline__ void mma_stage(float (&acc)[8][4],
                                          const unsigned char* st,
                                          const unsigned char* xs, int k,
                                          int gs, int R) {
  using S = Shape<T, W, NT>;
  const int lane = threadIdx.x & 31, ns = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 16) {
    uint32_t a[4];
    if constexpr (S::kQ) {
      uint32_t r[2];
      ldsm_x2_t(r, st + (kk + (lane & 15)) * S::WP + ns);
      // the scales of columns 2g, 2g + 1 for this lane's rows k 8q + 2t + e
      const float* ss = reinterpret_cast<const float*>(st + S::W_BYTES) +
                        ns + 2 * (lane >> 2);
      float2 sc[2][2];
      if (!kEdge || gs % 16 == 0) {   // a 16-row step in one group
        sc[0][0] = *reinterpret_cast<const float2*>(
            ss + ((k + kk) / gs - k / gs) * NT);
        sc[0][1] = sc[1][0] = sc[1][1] = sc[0][0];
      } else {
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sc[q][e] = *reinterpret_cast<const float2*>(
                ss + ((k + kk + 8 * q + 2 * (lane & 3) + e) / gs - k / gs) *
                         NT);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int v = (int)r[q];
        const float b0 = (float)(int8_t)(v & 0xFF);
        const float b1 = (float)(int8_t)((v >> 8) & 0xFF);
        const float b2 = (float)(int8_t)((v >> 16) & 0xFF);
        const float b3 = (float)(int8_t)(v >> 24);
        float s00 = sc[q][0].x, s01 = sc[q][0].y;
        float s10 = sc[q][1].x, s11 = sc[q][1].y;
        if (kRS) {
          s00 = round_to<T>(s00);
          s01 = round_to<T>(s01);
          s10 = round_to<T>(s10);
          s11 = round_to<T>(s11);
        }
        a[2 * q] = pack2<T>(b0 * s00, b2 * s10);       // column 2g
        a[2 * q + 1] = pack2<T>(b1 * s01, b3 * s11);   // column 2g + 1
      }
    } else {
      ldsm_x4_t(a, st + (kk + ((lane >> 4) << 3) + (lane & 7)) * S::WP +
                       (ns + ((lane >> 3) & 1) * 8) * 2);
    }
#pragma unroll
    for (int p = 0; p < RP / 16; ++p) {
      if (16 * p < R) {
        uint32_t b[4];
        ldsm_x4(b, xs + (16 * p + b_row(lane)) * S::XP +
                       (kk + b_col(lane)) * 2);
        mma16<T>(acc[2 * p], a, b[0], b[1]);
        if (16 * p + 8 < R) mma16<T>(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
  }
}

// One split-half int4 stage on the tensor cores (T activations, bf16 or
// fp16; each token row at xs holds the low half's 64 k then the high
// half's): per 16-row step one ldmatrix of stored bytes, both nibbles
// sign-extended and scaled in registers (q * T(s), rounded once) into the
// lo and hi A fragments, each multiplied with its own slice (see the map
// at the top). Groups of 16k rows: a 16-row step of either half lies in
// one group.
template <typename T, int NT, bool kRS>
__device__ __forceinline__ void mma_stage_q4(float (&acc)[8][4],
                                             const unsigned char* st,
                                             const unsigned char* xs, int k,
                                             int kh, int gs, int R) {
  using S = Shape<T, uint8_t, NT>;
  const int lane = threadIdx.x & 31, ns = (threadIdx.x >> 5) * 16;
  const float* ss = reinterpret_cast<const float*>(st + S::W_BYTES) + ns +
                    2 * (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < KS; kk += 16) {
    uint32_t r[2];
    ldsm_x2_t(r, st + (kk + (lane & 15)) * S::WP + ns);
    // columns 2g, 2g + 1: the low half's scale row, then the high half's
    float2 sl = *reinterpret_cast<const float2*>(
        ss + ((k + kk) / gs - k / gs) * NT);
    float2 sh = *reinterpret_cast<const float2*>(
        ss + (SG + (kh + k + kk) / gs - (kh + k) / gs) * NT);
    if (kRS) {
      sl = make_float2(round_to<T>(sl.x), round_to<T>(sl.y));
      sh = make_float2(round_to<T>(sh.x), round_to<T>(sh.y));
    }
    uint32_t alo[4], ahi[4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      // byte j of r[q]: its low nibble at bits 8j.., its high at 8j + 4..
      const auto nib = [&](int j, int h) {
        return (float)((int)(r[q] << (28 - 8 * j - 4 * h)) >> 28);
      };
      alo[2 * q] = pack2<T>(nib(0, 0) * sl.x, nib(2, 0) * sl.x);
      alo[2 * q + 1] = pack2<T>(nib(1, 0) * sl.y, nib(3, 0) * sl.y);
      ahi[2 * q] = pack2<T>(nib(0, 1) * sh.x, nib(2, 1) * sh.x);
      ahi[2 * q + 1] = pack2<T>(nib(1, 1) * sh.y, nib(3, 1) * sh.y);
    }
#pragma unroll
    for (int p = 0; p < RP / 16; ++p) {
      if (16 * p < R) {
        uint32_t b[4];
        const unsigned char* xr = xs + (16 * p + b_row(lane)) * S::XP;
        ldsm_x4(b, xr + (kk + b_col(lane)) * 2);
        mma16<T>(acc[2 * p], alo, b[0], b[1]);
        if (16 * p + 8 < R) mma16<T>(acc[2 * p + 1], alo, b[2], b[3]);
        ldsm_x4(b, xr + (KS + kk + b_col(lane)) * 2);
        mma16<T>(acc[2 * p], ahi, b[0], b[1]);
        if (16 * p + 8 < R) mma16<T>(acc[2 * p + 1], ahi, b[2], b[3]);
      }
    }
  }
}

// One stage on the CUDA cores (fp32 activations; the token rows at xs
// (pointer to floats)): a thread owns 4 columns
// (a quad) x every 16th token (its class), acc[i][j] holding token class +
// 16 i, column 4 quad + j. An int8 stage is first dequantized (q * s in
// fp32, each value once) into the fp32 tile wf; fp32 weights are read from
// the ring. Weights and tokens come as float4s, 4 k a trip: 16 FMAs a
// token for 4 + 1 loads.
template <typename W, int NT>
__device__ __forceinline__ void fma_stage(float (&acc)[8][4],
                                          const unsigned char* st,
                                          const float* xs, int k, int gs,
                                          int R, float* wf) {
  using S = Shape<float, W, NT>;
  constexpr int CQ = NT / 4, FP = NT + 4;   // quads, the fp32 tile's pitch
  const int cq = threadIdx.x % CQ, tg = threadIdx.x / CQ;
  const int ni = R > tg ? (R - tg + 15) / 16 : 0;
  const float* wsrc;
  int wp;
  if constexpr (S::kQ) {
    const float* ss = reinterpret_cast<const float*>(st + S::W_BYTES);
    for (int i = threadIdx.x; i < KS * CQ; i += S::kThreads) {
      const int r = i / CQ, q = i % CQ;
      const int v = *reinterpret_cast<const int*>(st + r * S::WP + 4 * q);
      const float4 sc = *reinterpret_cast<const float4*>(
          ss + ((k + r) / gs - k / gs) * NT + 4 * q);
      *reinterpret_cast<float4*>(wf + r * FP + 4 * q) = make_float4(
          (float)(int8_t)(v & 0xFF) * sc.x,
          (float)(int8_t)((v >> 8) & 0xFF) * sc.y,
          (float)(int8_t)((v >> 16) & 0xFF) * sc.z,
          (float)(int8_t)(v >> 24) * sc.w);
    }
    __syncthreads();
    wsrc = wf;
    wp = FP;
  } else {
    wsrc = reinterpret_cast<const float*>(st);
    wp = S::WP / 4;
  }
#pragma unroll 1
  for (int kk = 0; kk < KS; kk += 4) {
    float4 w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = *reinterpret_cast<const float4*>(wsrc + (kk + e) * wp + 4 * cq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < ni) {
        const float4 x = *reinterpret_cast<const float4*>(
            xs + (tg + 16 * i) * (S::XP / 4) + kk);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][0] = fmaf(xv[e], w[e].x, acc[i][0]);
          acc[i][1] = fmaf(xv[e], w[e].y, acc[i][1]);
          acc[i][2] = fmaf(xv[e], w[e].z, acc[i][2]);
          acc[i][3] = fmaf(xv[e], w[e].w, acc[i][3]);
        }
      }
    }
  }
}

// acc = x[tokens < R] . W[k0 : k1, columns] (k0 a multiple of KS; split-
// half int4: k0, k1 in stored rows, each feeding rows k and t.kh + k), through
// a ring of ring_bytes of shared memory (at least two stages); without
// kEdge, k1 - k0 a multiple of KS and every chunk whole and aligned.
// xrow(r): token r's row (see issue_x); base: any valid global address.
// wait(): called once the first stages of the weight are in flight and
// before any token is read (a consumer waits for its producers there; the
// weight does not depend on them). The ring is free again on return.
template <typename T, typename W, int NT, bool kRS, bool kEdge,
          typename XRow, typename Wait>
__device__ void run_tile(float (&acc)[8][4], unsigned char* ring,
                         int ring_bytes, const WTile<W>& t, int k0, int k1,
                         XRow xrow, int R, const void* base, Wait wait) {
  using S = Shape<T, W, NT>;
  static_assert(!(S::kQ4 && kEdge), "split-half int4 takes whole chunks");
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // fp32 activations with int8 weights: the dequantized tile after the ring
  float* wf = reinterpret_cast<float*>(ring + ring_bytes - S::WF_BYTES);
  const int sg = kEdge ? scale_rows(t.gs) : SG;
  const int xoff = kEdge ? S::xoff(t.gs) : S::xoff(16);
  const int stage = xoff + S::xrows(R) * S::XP;
  const int depth = min(kMaxStages, (ring_bytes - S::WF_BYTES) / stage);
  const int n = (k1 - k0 + KS - 1) / KS;
  for (int s = 0; s < depth - 1; ++s) {
    if (s < n)
      issue_w<T, W, NT, kEdge>(ring + s * stage, t, k0 + s * KS, k1, sg);
    cp_async_commit();
  }
  wait();
  for (int s = 0; s < depth - 1; ++s) {
    if (s < n)
      issue_x<T, W, NT, kEdge>(ring + s * stage + xoff, xrow, k0 + s * KS,
                               k1, R, base, t.kh);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    // stage s's weight and tokens have landed (groups: W 0..d-2, X 0..d-2,
    // then one a stage), and every thread is past stage s - 1
    cp_async_wait_n(depth - 2);
    __syncthreads();
    const int nx = s + depth - 1;
    if (nx < n) {
      unsigned char* st = ring + (nx % depth) * stage;
      issue_w<T, W, NT, kEdge>(st, t, k0 + nx * KS, k1, sg);
      issue_x<T, W, NT, kEdge>(st + xoff, xrow, k0 + nx * KS, k1, R, base,
                               t.kh);
    }
    cp_async_commit();
    const unsigned char* st = ring + (s % depth) * stage;
    if constexpr (S::kTC && S::kQ4)
      mma_stage_q4<T, NT, kRS>(acc, st, st + xoff, k0 + s * KS, t.kh, t.gs,
                               R);
    else if constexpr (S::kTC)
      mma_stage<T, W, NT, kRS, kEdge>(acc, st, st + xoff, k0 + s * KS, t.gs,
                                      R);
    else
      fma_stage<W, NT>(acc, st, reinterpret_cast<const float*>(st + xoff),
                       k0 + s * KS, t.gs, R, wf);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// fn(token, column, value) for every accumulator of this thread whose
// token is < R (columns relative to the tile; the caller masks ncols).
template <typename T, typename W, int NT, typename Fn>
__device__ __forceinline__ void for_each_acc(const float (&acc)[8][4], int R,
                                             Fn fn) {
  using S = Shape<T, W, NT>;
  if constexpr (S::kTC) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int ns = (threadIdx.x >> 5) * 16;
    const int c0 = ns + (S::kQ ? 2 * g : g);
    const int c1 = ns + (S::kQ ? 2 * g + 1 : g + 8);
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * mt + 2 * t + (e & 1);
        if (tok < R) fn(tok, (e >> 1) ? c1 : c0, acc[mt][e]);
      }
  } else {
    const int cq = threadIdx.x % (NT / 4), tg = threadIdx.x / (NT / 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = tg + 16 * i;
      if (tok >= R) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) fn(tok, 4 * cq + j, acc[i][j]);
    }
  }
}

// Four consecutive values as T (one 8- or 16-byte access; p aligned).
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2<T>(v.x, v.y),
                                            pack2<T>(v.z, v.w));
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack2<T>(u.x), b = unpack2<T>(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// The split reduction's second pass: for rows i < R and the ncols (a
// multiple of 4, at most NT) columns from c0, the fp32 partials part[z *
// plane + i * ld + c] summed over z in order (from 0), then fn(i, c - c0,
// float4 of the 4 columns from c); nothing past ncols is read. A thread
// takes 4 columns of up to 4 rows and keeps 4 rows x 4 splits of loads in
// flight together (the partials were written by other blocks: read
// through L2).
template <int NT, int THREADS, typename Fn>
__device__ __forceinline__ void sum_splits(const float* part, long plane,
                                           long ld, int c0, int ncols, int R,
                                           int splits, Fn fn) {
  constexpr int CQ = NT / 4, RS = THREADS / CQ;
  const int c = c0 + 4 * ((int)threadIdx.x % CQ);
  if (c - c0 >= ncols) return;
  for (int rb = threadIdx.x / CQ; rb < R; rb += 4 * RS) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < splits; z0 += 4) {
      float4 q[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = rb + u * RS;
          q[u][w] = i < R && z0 + w < splits
                        ? __ldcg(reinterpret_cast<const float4*>(
                              part + (z0 + w) * plane + i * ld + c))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (z0 + w < splits) {
            v[u].x += q[u][w].x;
            v[u].y += q[u][w].y;
            v[u].z += q[u][w].z;
            v[u].w += q[u][w].w;
          }
        }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (rb + u * RS < R) fn(rb + u * RS, c - c0, v[u]);
  }
}

}  // namespace sk
}  // namespace ptt
