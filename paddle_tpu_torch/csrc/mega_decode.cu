// The mega-kernel serving layer for Hopper (sm_90a): one kernel for the
// attention side of a decoder layer and one for its MLP side, fp32, bf16 or
// fp16 activations, fp or int8 weights (per channel or per group along K),
// fp or int8 KV pools.
//
// ptt_mega_attn replaces paddle_tpu/ops/pallas/mega_decode.py::
// _mega_attn_kernel. Per lane b (q_len[b] new rows of a [b, chunk, h]
// block) it computes LN1 -> this step's Q, K, V (int8 weights dequantize
// element by element, q * s rounded to the activation type) -> with int8
// pools the new K / V rows quantized inline (scale = max(absmax, 1e-8) *
// fp32(1/127), q = clip(rint(x / scale)), IEEE division, ties to even: the
// serving write's quantizer) -> attention over the ctx_lens[b] tokens
// already in the paged pool (int8 pages dequantize in fp32 with their
// scale planes) and, causally, over the lane's own new rows (with int8
// pools their quantize-dequantize image) -> the output projection ->
// residual + bo -> LN2. Every rounding of mega_attn_layer_reference is
// kept (the QKV product rounded before and after its bias, the attention
// output, the projection, the residual stream), so the kernel differs from
// it only in summation order.
//
// Translation: on the TPU the grid (lane, head, page) runs in order and the
// output GEMM accumulates across heads in a VMEM block. Here the grid is
// one row of blocks sized from shapes only (nothing reads ctx_lens on the
// host, so a captured step stays valid), each taking its role from a
// ticket in the order the blocks start:
// - producers, one per (lane group, head, Q / K / V): LN1 of the group's
//   rows (ops/mega_decode.py mega_plan batches lanes up to 16 rows, so a
//   decode round reads each weight column once, not once a lane) and that
//   component's columns; K and V producers emit the new rows; each
//   publishes its rows to device memory and raises the lanes' flags;
// - consumers (lane, head, split): split 0 attends the causal block of
//   the lane's new rows once Q, K and V are published; split z >= 1 walks
//   its range of pool pages (paged_walk.cuh: a cp.async ring of key
//   tiles; pool keys need no causal mask, every new row sees the whole
//   context) once Q is; a split past the context arrives and exits.
// A consumer waits only for producers, whose tickets are earlier, so they
// have started, and they never wait: no deadlock whatever the card runs
// at once. The last split of a (lane, head) to arrive merges the (acc, m,
// l) partials in split order and runs the head's output projection in
// 128-column slabs into fp32 partials [b, heads, chunk, h]; the last head
// to finish a slab sums it over the heads in head order (deterministic, no
// float atomics) and writes the slab's residual stream s; the lane's last
// slab writes LN2(s). Without the fused epilogue the slab sums are the
// output. Idle lanes (q_len 0) skip everything; rows past q_len are written
// as zeros in every output. LN1 is formed on the fly from the raw x tile of
// each reduction step (per-row statistics first), so no block writes it to
// device memory.
//
// ptt_mega_mlp replaces _mega_mlp_kernel: out = s_res + b2 +
// gelu_tanh(y2 @ w1 + b1) @ w2 with the [rows, ffn] hidden state rounded to
// the activation type. On the TPU one resident output block accumulates the
// ffn tiles in order over every row of the lane block. Here only the live
// rows are computed (given q_lens, the rows r with r % chunk < q_lens[r /
// chunk]: 24 of 128 in a served round, 8 at a decode round; the others are
// written as zeros), and each weight is read once a launch: one row of
// blocks from shapes alone, roles from a ticket as in the attention
// kernel. GEMM1 producers own 32 ffn columns over all of h and publish
// their hidden columns (the live rows packed, kept in L2) with a count;
// GEMM2 consumers own (32 h columns, an ffn split), put their first w2
// stages in flight, wait for their split's producers, and leave fp32
// partials [splits, live rows, h]; the last split of an h tile to arrive
// sums them in split order and writes the epilogue (deterministic, no
// float atomics). Products: skinny_gemm.cuh (a cp.async ring of weight,
// scale and row stages; bf16 and fp16 on the tensor cores, int8
// dequantized to the activation type in registers; fp32 FMA on the CUDA
// cores). Any h that is
// a multiple of 4, any ffn and scale group and any input alignment: the
// last tiles and stages are clipped, and a clipped or unaligned chunk is
// copied element by element.
//
// What bounds them on the H100: at GPT-125M serving (8 lanes x chunk 16,
// h 768, 12 heads of 64, ffn 3072, 128 MLP rows) the function needs one
// read of each weight (fp32 28.3 MB a layer, bf16 14.2 MB, int8 7.1 MB)
// and of the context pages: bytes, not operations (~0.5 GFLOP a layer).
// The attention kernel streams its weight tiles (wqkv 64 rows, wo 128
// columns a step, rows padded off the bank period) through cp.async rings
// of 2 to 8 stages (as many as keep two blocks an SM) and its page tiles
// through a ring of 3, and spreads a lane's page walk, head sum and
// epilogue over many blocks. bf16 or fp16 with weights of the same type
// multiplies the QKV and output products on the tensor cores (mma.sync
// m16n8k16, fp32 sums);
// fp32 (which must not become TF32) and int8 weights use FMA on the CUDA
// cores, a thread holding up to 4 rows (8 past 16 rows a block) and the
// reduction sliced over lanes when rows are few. The page walk's products
// stay on the CUDA cores (one new row a lane at a decode round). The MLP
// kernel reads each weight once (18.9 / 9.4 MB fp32 / bf16 at GPT-125M, 4.7
// int8) and its partials are splits x live rows x h fp32 (0.3 MB at 24
// rows), so bytes bound it: ~0.0058 / 0.0029 ms at 3.35 TB/s. Its GEMM2
// waits for GEMM1's last producers, so at best it takes the time of both
// halves' bytes in turn.
#include "paged_walk.cuh"

// The element types of this library: fp32 and bf16; built from
// mega_decode_f16.cu (PTT_MEGA_F16 1), fp16 alone. Two libraries of one
// source, so their nvcc processes run side by side: with all three types
// one process took 187 s on the H100's 8-core host, the build's critical
// path.
#ifndef PTT_MEGA_F16
#define PTT_MEGA_F16 0
#endif
#include "skinny_gemm.cuh"

#include <algorithm>
#include <cstdint>

namespace {

using ptt::store;
using ptt::to_f;
namespace wk = ptt::walk;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using ptt::round_to;


// LayerNorm of one element as the plain version spells it:
// ((x - mean) * rstd) * g + b in fp32, no contraction into FMAs
__device__ __forceinline__ float ln_elem(float x, float mean, float rstd,
                                         float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b);
}

// ---- the attention layer ----

constexpr int kGK = 64;          // reduction rows a QKV tile
constexpr int kSlab = 128;       // output columns an output-projection tile
constexpr int kMaxStages = 8;    // the weight rings' stages: 2 to 8, as many
constexpr int kSmemBudget = 112 << 10;   // as keep 2 blocks an SM
constexpr int kSmemMax = 232448;         // (or 1, for the widest shapes)
constexpr int kRedBytes = 8 << 10;       // a producer's k-slice sums (at most)

__host__ __device__ inline int align16(long v) { return (int)((v + 15) / 16 * 16); }

// Byte offsets of one attention block's shared memory (NR producer rows, C
// consumer rows, head dim D, activations of sT bytes; which weights and
// pools are int8). The rows [NR][D + 4] fp32 (a producer's Q, K or V
// columns, a consumer's queries) and the row statistics stay; the rest is
// one region `u` whose use changes with the role: a producer holds its QKV
// ring and the LN1 tile ya there (then the k-slice sums in its place); the causal split its
// new K and V rows, then acc and scores (home); a page split acc and
// scores, then the page ring (ring); the merging block the output
// projection's ring, then its 16-bit A tile (oa).
struct Layout {
  int stats, idx, rv, u;         // from the start of shared memory
  int g_stage, g_gb, g_w, g_s;   // QKV stage: bytes, gamma / beta, W, scales
  int g_stages, ya;              // QKV stages; LN1 tile / k-slice sums (from u)
  int home, ring;                // the causal split's acc, a page split's ring
  int o_stage, o_s, o_stages, oa;   // projection stage: bytes, scales; stages
  int total;
};

template <int D>
Layout attn_layout(int NR, int C, int sT, bool wq8, bool kv8, bool wo8,
                   int pages) {
  Layout L{};
  const int m16 = (NR + 15) / 16 * 16, c16 = (C + 15) / 16 * 16;
  const long st4 = (2L * NR + 4L * C) * 4;   // mean, rstd; m, l, alpha, ncols
  L.stats = align16((long)NR * (D + 4) * 4);
  L.idx = L.stats + (int)st4 + 4 * pages;    // after a page split's page ids
  L.rv = L.idx + 4 * 128;   // scale-row table, row flags, compact row list
  L.u = L.stats + align16(st4 + 4L * pages + 4 * 128 + 8L * NR);
  L.g_gb = align16((long)NR * (kGK * sT + 16));
  L.g_w = L.g_gb + align16(2L * kGK * sT);
  L.g_s = L.g_w + kGK * (D * (wq8 ? 1 : sT) + 16);
  L.g_stage = L.g_s + (wq8 ? (kGK / 16 + 2) * D * 4 : 0);
  const int ya = std::max(align16((long)m16 * (kGK + 4) * 4), kRedBytes);
  const int cq = align16((long)C * (D + 4) * 4);
  const int accss = align16((long)C * D * 4 + (long)C * (wk::kKeys + 1) * 4);
  const int tile = kv8 ? wk::Tile<int8_t, D>::kBytes
                   : sT == 4 ? wk::Tile<float, D>::kBytes
                             : wk::Tile<__nv_bfloat16, D>::kBytes;
  L.home = 2 * cq;
  L.ring = accss;
  L.o_s = D * (kSlab * (wo8 ? 1 : sT) + 16);
  L.o_stage = L.o_s + (wo8 ? (D / 16 + 1) * kSlab * 4 : 0);
  const int oa = align16((long)c16 * (D + 8) * 2);
  // the region u before the projection (n QKV stages) and in it (n stages)
  auto attn_u = [&](int n) {
    return std::max(n * L.g_stage + ya,
                    std::max(L.home + accss, accss + wk::kStages * tile));
  };
  auto proj_u = [&](int n) { return n * L.o_stage + oa; };
  const int cap = L.u + std::max(attn_u(2), proj_u(2)) <= kSmemBudget
                      ? kSmemBudget : kSmemMax;
  L.g_stages = 2;
  while (L.g_stages < kMaxStages &&
         L.u + std::max(attn_u(L.g_stages + 1), proj_u(2)) <= cap)
    ++L.g_stages;
  L.o_stages = 2;
  while (L.o_stages < kMaxStages &&
         L.u + std::max(attn_u(L.g_stages), proj_u(L.o_stages + 1)) <= cap)
    ++L.o_stages;
  L.ya = L.g_stages * L.g_stage;
  L.oa = L.o_stages * L.o_stage;
  L.total = L.u + std::max(attn_u(L.g_stages), proj_u(L.o_stages));
  return L;
}

// cp.async.wait_group n for a ring of a runtime number of stages
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: ptt::cp_async_wait<0>(); break;
    case 1: ptt::cp_async_wait<1>(); break;
    case 2: ptt::cp_async_wait<2>(); break;
    case 3: ptt::cp_async_wait<3>(); break;
    case 4: ptt::cp_async_wait<4>(); break;
    case 5: ptt::cp_async_wait<5>(); break;
    case 6: ptt::cp_async_wait<6>(); break;
    default: ptt::cp_async_wait<0>(); break;
  }
}

// four values of T at p, written by other blocks (read through L2)
__device__ __forceinline__ float4 ld4_cg(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
template <typename T>
__device__ __forceinline__ float4 ld4_cg(const T* p) {
  static_assert(ptt::is16<T>, "four 16-bit values");
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  return wk::ld4(reinterpret_cast<const T*>(&u));
}

struct AttnArgs {
  const void* x;                        // [b, C, h] T
  const void *ln1_g, *ln1_b, *ln2_g, *ln2_b;  // [h] T
  const void* wqkv;                     // [h, 3 nh D] T or int8
  const float* sqkv;                    // [h / gq, 3 nh D] or null
  const void* bqkv;                     // [3 nh D] T
  const void* wo;                       // [nh D, h] T or int8
  const float* so;                      // [nh D / go, h] or null
  const void* bo;                       // [h] T
  const void *kp, *vp;                  // [P, ps, nh, D] T or int8
  const float *ks, *vs;                 // [P, ps, nh] fp32, or null
  const int *pt, *ctx, *qlen;           // [b, pps], [b], [b]
  void *y2, *s;                         // [b, C, h] T (s null: no epilogue)
  void *ko, *vo;                        // [b, C, nh, D] T or int8
  float *kso, *vso;                     // [b, C, nh] with int8 pools
  float* part;                          // [b, nh, 1 + splits, partial_floats(C, D)]
  float* ws;                            // [b, nh, C, h] projection partials
  float* pub;                           // [b, C, 3, nh, D] published Q, K, V
  float* ln2;                           // [b, nslab, C, 2] slab mean, M2
  int* counters;                        // [b nh] splits, [b nslab] slabs, [b] lanes
  int *qflag, *kvflag;                  // [b nh] each: Q, K + V published
  unsigned* ticket;                     // the block ticket
  int b, C, h, nh, num_pages, ps, pps, gq, go, head_major, fuse;
  int pages_per_split, splits, group, ngroups, NR, nblocks;
  float eps, inv127, scale;
  Layout L;
};

// LayerNorm statistics of rows vr[0 .. rows) of x, one warp a row
template <typename T>
__device__ __forceinline__ void ln_stats(const T* x, const int* vr, int rows,
                                         int h, float eps, float* mean,
                                         float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const T* xr = x + (long)vr[r] * h;
    float sum = 0.f;
#pragma unroll 4
    for (int c = lane; c < h; c += 32) sum += to_f(xr[c]);
    const float mu = wk::warp_sum(sum) / h;
    float sq = 0.f;
#pragma unroll 4
    for (int c = lane; c < h; c += 32) {
      const float d = to_f(xr[c]) - mu;
      sq += d * d;
    }
    const float rs = 1.f / sqrtf(wk::warp_sum(sq) / h + eps);
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// one weight of a [K, N] matrix as the plain version multiplies it: T as
// it is, int8 q * s in fp32 rounded to T once
template <typename T>
__device__ __forceinline__ float4 deq4(float4 q, float4 s) {
  return make_float4(round_to<T>(q.x * s.x), round_to<T>(q.y * s.y),
                     round_to<T>(q.z * s.z), round_to<T>(q.w * s.w));
}

// How a block's threads share a [rows, N] product on the CUDA cores (N in
// steps of 4 columns): thread (rb, cg, s) owns columns 4 cg .. 4 cg + 3 of
// rows rb, rb + nrb, ... (up to R of them, so a weight load feeds R rows)
// and the reduction indices kk = s mod ks of each tile. The reduction is
// sliced (ks up to 32) until every thread has work; the ks slices of an
// output sit on neighbouring lanes and are summed by shuffles when it ends.
constexpr int kMaxRows = 8;

struct Split {
  int cg, s, rb, ks, nrb, rpt;
  bool on;
  __device__ Split(int rows, int N, int R) {
    const int ncg = N / 4, slots = kThreads / ncg;
    nrb = min(max((rows + R - 1) / R, 1), slots);
    ks = 1;
    while (ks < 32 && 2 * ks * nrb <= slots) ks *= 2;
    const int t = threadIdx.x;
    s = t % ks;
    cg = (t / ks) % ncg;
    rb = t / (ks * ncg);
    on = rb < nrb;
    rpt = (rows + nrb - 1) / nrb;
  }
};

// acc += A[rows][kk] W[kk][4 cg ..] over this thread's kk of [0, nk): A fp32
// rows at apitch, W (T, or int8 with scale_of(kk) giving the 4 scales of
// its row) rows at wpitch elements
template <typename T, typename W, int R, typename ScaleOf>
__device__ __forceinline__ void split_fma(const Split& m, float (&acc)[R][4],
                                          const float* A, int apitch,
                                          int rows, const W* w, int wpitch,
                                          int nk, ScaleOf scale_of) {
  if (!m.on) return;
#pragma unroll 4
  for (int kk = m.s; kk < nk; kk += m.ks) {
    float4 wv = wk::ld4(w + kk * wpitch + 4 * m.cg);
    if constexpr (std::is_same_v<W, int8_t>) wv = deq4<T>(wv, scale_of(kk));
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = m.rb + i * m.nrb;
      if (i < m.rpt && r < rows) {
        const float av = A[r * apitch + kk];
        acc[i][0] = fmaf(av, wv.x, acc[i][0]);
        acc[i][1] = fmaf(av, wv.y, acc[i][1]);
        acc[i][2] = fmaf(av, wv.z, acc[i][2]);
        acc[i][3] = fmaf(av, wv.w, acc[i][3]);
      }
    }
  }
}

// Sums the reduction slices (every thread of the block takes part)
template <int R>
__device__ __forceinline__ void split_sum(const Split& m, float (&acc)[R][4]) {
  for (int o = 1; o < m.ks; o *= 2)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
}

// How the warps share a 16-bit product on the tensor cores: `units` (16-row
// m-tile, 16-column n-pair) items; with fewer units than warps the k-steps
// of a tile are sliced over nks warps per unit (summed in slice order at
// the end). A warp holds up to kMU units (j = 0 .. kMU - 1 at unit
// first + j * per).
struct MmaSplit {
  int units, per, nks, ksl, first;
  bool on;
  __device__ MmaSplit(int m16, int np) {
    const int warp = threadIdx.x / 32;
    units = m16 * np;
    per = units >= kWarps ? kWarps : units;
    nks = units >= kWarps ? 1 : kWarps / units;
    ksl = warp / per;
    on = ksl < nks;
    first = warp % per;
  }
};

// This head's columns of y1 @ wqkv for component comp (0 Q, 1 K, 2 V) over
// rows vr[0 .. nr) of x (the rows that hold a new token, packed): x,
// gamma / beta and the W tiles (with their scale rows) stream through a
// ring of L.g_stages stages; each tile's y1 = LN1(x) rows, rounded to T,
// are formed once into the tile at ya. bf16 / fp16 with weights of the same
// type multiply on
// the tensor cores (mma.sync m16n8k16, fp32 sums), fp32 and int8 weights on
// the CUDA cores. The result lands in dst ([nr][D + 4] fp32) as
// round(round(y1 @ W) + bias), the plain version's two roundings. Ends
// after a barrier.
template <typename T, typename W, int D, int R>
__device__ void qkv_product(const AttnArgs& a, const T* x, const int* vr,
                            const float* mean, const float* rstd, int nr,
                            int comp, int hh, unsigned char* ring,
                            unsigned char* yt, float* red, int* srow,
                            float* dst) {
  constexpr bool kQ8 = std::is_same_v<W, int8_t>;
  constexpr bool kMma = ptt::is16<T> && !kQ8;
  constexpr int kAP = kGK + 16 / (int)sizeof(T);       // x tile pitch
  constexpr int kACh = kGK * (int)sizeof(T) / 16;      // 16-byte chunks
  constexpr int kWCh = D * (int)sizeof(W) / 16;
  // W rows 16 bytes apart from a multiple of 128: the lanes of a sliced
  // reduction (and the rows of an ldmatrix) fall in different banks
  constexpr int kWRow = D * (int)sizeof(W) + 16;
  constexpr int kYP = kGK + 4;                         // fp32 LN1 tile pitch
  constexpr int kYB = kGK + 8;                         // 16-bit LN1 tile pitch
  constexpr int NP = D / 16, kMU = R == 4 ? 1 : 4;
  const int tid = threadIdx.x, h = a.h, N = 3 * a.nh * D, gs = a.gq;
  const int nk = h / kGK, m16 = (nr + 15) / 16;
  const W* w = static_cast<const W*>(a.wqkv);
  const T* g1 = static_cast<const T*>(a.ln1_g);
  const T* b1 = static_cast<const T*>(a.ln1_b);
  const T* bias = static_cast<const T*>(a.bqkv);
  const Layout& L = a.L;
  const int col = a.head_major ? (hh * 3 + comp) * D : (comp * a.nh + hh) * D;
  const int ns = L.g_stages;
  auto issue_tile = [&](int t) {
    unsigned char* st = ring + (t % ns) * L.g_stage;
    const int k0 = t * kGK;
    for (int i = tid; i < nr * kACh; i += kThreads) {
      const int r = i / kACh, c = i % kACh;
      ptt::cp_async16(st + r * kAP * (int)sizeof(T) + c * 16,
                      x + (long)vr[r] * h + k0 + c * (16 / (int)sizeof(T)),
                      true);
    }
    for (int i = tid; i < 2 * kACh; i += kThreads) {
      const int v = i / kACh, c = i % kACh;
      ptt::cp_async16(st + L.g_gb + v * kGK * (int)sizeof(T) + c * 16,
                      (v ? b1 : g1) + k0 + c * (16 / (int)sizeof(T)), true);
    }
    for (int i = tid; i < kGK * kWCh; i += kThreads) {
      const int k = i / kWCh, c = i % kWCh;
      ptt::cp_async16(st + L.g_w + k * kWRow + c * 16,
                      w + (long)(k0 + k) * N + col + c * (16 / (int)sizeof(W)),
                      true);
    }
    if constexpr (kQ8) {
      const int g0 = k0 / gs, ng = (k0 + kGK - 1) / gs - g0 + 1;
      for (int i = tid; i < ng * (D / 4); i += kThreads) {
        const int g = i / (D / 4), c = i % (D / 4);
        ptt::cp_async16(st + L.g_s + (g * D + 4 * c) * 4,
                        a.sqkv + (long)(g0 + g) * N + col + 4 * c, true);
      }
    }
  };
  const Split m(nr, D, R);
  const MmaSplit mm(m16, NP);
  float acc[R][4] = {};
  float macc[kMU][2][4] = {};
  const int lane = tid % 32;
  for (int i = 0; i < ns - 1; ++i) {
    if (i < nk) issue_tile(i);
    ptt::cp_async_commit();
  }
  for (int t = 0, stage = 0; t < nk; ++t) {
    cp_async_wait_n(ns - 2);
    __syncthreads();   // tile t is in; the readers of tile t - 1 are done
    if (t + ns - 1 < nk) issue_tile(t + ns - 1);
    ptt::cp_async_commit();
    const unsigned char* st = ring + stage * L.g_stage;
    const T* xa = reinterpret_cast<const T*>(st);
    const T* gb = reinterpret_cast<const T*>(st + L.g_gb);
    const W* wt = reinterpret_cast<const W*>(st + L.g_w);
    const float* sc = reinterpret_cast<const float*>(st + L.g_s);
    const int k0 = t * kGK;
    if (++stage == ns) stage = 0;
    // LN1 of the tile's rows, rounded to T (zeros past them, up to the
    // tensor cores' 16-row tiles); with int8 weights the scale row of each
    // reduction index
    if constexpr (kQ8)
      for (int i = tid; i < kGK; i += kThreads)
        srow[i] = (k0 + i) / gs - k0 / gs;
    const int yrows = kMma ? m16 * 16 : nr;
    for (int i = tid; i < yrows * kGK; i += kThreads) {
      const int r = i / kGK, kk = i % kGK;
      float v = 0.f;
      if (r < nr)
        v = round_to<T>(ln_elem(to_f(xa[r * kAP + kk]), mean[r], rstd[r],
                                to_f(gb[kk]), to_f(gb[kGK + kk])));
      if constexpr (kMma)
        store(reinterpret_cast<T*>(yt) + r * kYB + kk, v);
      else
        reinterpret_cast<float*>(yt)[r * kYP + kk] = v;
    }
    __syncthreads();
    if constexpr (kMma) {
      if (mm.on) {
        const T* yb = reinterpret_cast<const T*>(yt);
        const T* wb = reinterpret_cast<const T*>(wt);
        for (int s = mm.ksl; s < kGK / 16; s += mm.nks) {
#pragma unroll
          for (int j = 0; j < kMU; ++j) {
            const int u = mm.first + j * mm.per;
            if (u < mm.units) {
              const int mt = u / NP, np = u % NP;
              uint32_t af[4], bfr[4];
              ptt::ldsm_x4(af, yb + (mt * 16 + ptt::a_row(lane)) * kYB +
                                   s * 16 + ptt::a_col(lane));
              ptt::ldsm_x4_t(bfr, wb + (s * 16 + ptt::a_row(lane)) *
                                           (kWRow / 2) +
                                      np * 16 + ptt::a_col(lane));
              ptt::mma16<T>(macc[j][0], af, bfr[0], bfr[1]);
              ptt::mma16<T>(macc[j][1], af, bfr[2], bfr[3]);
            }
          }
        }
      }
    } else {
      split_fma<T, W, R>(m, acc, reinterpret_cast<const float*>(yt), kYP, nr,
                         wt, kWRow / (int)sizeof(W), kGK, [&](int kk) {
        return wk::ld4(sc + srow[kk] * D + 4 * m.cg);
      });
    }
  }
  ptt::cp_async_wait<0>();
  // the product rounds to T, its bias adds and rounds again
  auto fin = [&](int r, int c, float v) {
    dst[r * (D + 4) + c] = round_to<T>(round_to<T>(v) + to_f(bias[col + c]));
  };
  if constexpr (kMma) {
    const int g = lane / 4, t4 = lane % 4;
    if (mm.nks > 1) {   // the k-slices' sums, in slice order (red is ya)
      __syncthreads();
      if (mm.on) {
        const int u = mm.first, mt = u / NP, np = u % NP;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + g + 8 * (e / 2);
            const int c = np * 16 + 8 * hf + 2 * t4 + e % 2;
            red[(mm.ksl * m16 * 16 + r) * D + c] = macc[0][hf][e];
          }
      }
      __syncthreads();
      for (int i = tid; i < nr * D; i += kThreads) {
        const int r = i / D, c = i % D;
        float v = 0.f;
        for (int s = 0; s < mm.nks; ++s) v += red[(s * m16 * 16 + r) * D + c];
        fin(r, c, v);
      }
    } else if (mm.on) {
#pragma unroll
      for (int j = 0; j < kMU; ++j) {
        const int u = mm.first + j * mm.per;
        if (u < mm.units) {
          const int mt = u / NP, np = u % NP;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = mt * 16 + g + 8 * (e / 2);
              if (r < nr) fin(r, np * 16 + 8 * hf + 2 * t4 + e % 2,
                              macc[j][hf][e]);
            }
        }
      }
    }
  } else {
    split_sum(m, acc);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = m.rb + i * m.nrb;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m.on && m.s == 0 && i < m.rpt && r < nr)
          fin(r, 4 * m.cg + j, acc[i][j]);
    }
  }
  __syncthreads();
}

// A K or V producer emits the new rows of its head (int8 pools: the
// serving write's quantizer, scale = max(absmax, 1e-8) * fp32(1/127), q =
// clip(rint(x / scale)), IEEE division) and leaves in rows what later
// steps will read back: the rows as stored, or their quantize-dequantize
// image.
template <typename T, bool kKV8, int D>
__device__ __forceinline__ void emit_rows(const AttnArgs& a, float* rows,
                                          const int* vr, int nr, long row0,
                                          int hh, int comp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nr; r += kWarps) {
    float* row = rows + r * (D + 4);
    const long g = row0 + vr[r];   // the row of x it came from
    const long o = (g * a.nh + hh) * D;
    if constexpr (kKV8) {
      float mx = 0.f;
      for (int d = lane; d < D; d += 32) mx = fmaxf(mx, fabsf(row[d]));
      const float sc = __fmul_rn(fmaxf(wk::warp_max(mx), 1e-8f), a.inv127);
      int8_t* out = static_cast<int8_t*>(comp == 2 ? a.vo : a.ko);
      for (int d = lane; d < D; d += 32) {
        const int q = min(max(__float2int_rn(__fdiv_rn(row[d], sc)), -127),
                          127);
        out[o + d] = (int8_t)q;
        row[d] = (float)q * sc;
      }
      if (lane == 0) (comp == 2 ? a.vso : a.kso)[g * a.nh + hh] = sc;
    } else {
      T* out = static_cast<T*>(comp == 2 ? a.vo : a.ko);
      for (int d = lane; d < D; d += 32) store(out + o + d, row[d]);
    }
  }
}

// A producer: component comp (0 Q, 1 K, 2 V) of head hh for the rows of
// lane group grp (a.group lanes of C rows, consecutive in x) that hold a
// new token, packed (a decode step's one-row lanes share each weight
// tile): LN1, the product, the new K / V rows emitted (rows without a new
// token written as zeros), the rows published to pub and, once they are
// visible, the lane's flag raised (Q: qflag, K and V: kvflag) for each
// lane with rows.
template <typename T, typename KV, typename W, int D, int R>
__device__ void produce(const AttnArgs& a, int grp, int hh, int comp,
                        unsigned char* smem) {
  constexpr bool kKV8 = std::is_same_v<KV, int8_t>;
  const Layout& L = a.L;
  const int tid = threadIdx.x, C = a.C, nh = a.nh;
  const int l0 = grp * a.group, nl = min(a.group, a.b - l0), nr = nl * C;
  const long row0 = (long)l0 * C;   // the group's first row of x
  float* dst = reinterpret_cast<float*>(smem);
  float* mean = reinterpret_cast<float*>(smem + L.stats);
  float* rstd = mean + a.NR;
  int* srow = reinterpret_cast<int*>(smem + L.idx);
  int* rv = reinterpret_cast<int*>(smem + L.rv);
  int* vr = rv + a.NR;
  unsigned char* u = smem + L.u;
  __shared__ int n_valid;
  int any = 0;
  for (int i = tid; i < nr; i += kThreads) {
    rv[i] = i % C < min(max(a.qlen[l0 + i / C], 0), C);
    any |= rv[i];
  }
  any = __syncthreads_or(any);
  if (comp > 0) {   // K / V rows without a new token: zeros
    for (int i = tid; i < nr * D; i += kThreads) {
      if (rv[i / D]) continue;
      const long o = ((row0 + i / D) * nh + hh) * D + i % D;
      if constexpr (kKV8)
        static_cast<int8_t*>(comp == 2 ? a.vo : a.ko)[o] = 0;
      else
        store(static_cast<T*>(comp == 2 ? a.vo : a.ko) + o, 0.f);
    }
    if constexpr (kKV8)
      for (int r = tid; r < nr; r += kThreads)
        if (!rv[r]) (comp == 2 ? a.vso : a.kso)[(row0 + r) * nh + hh] = 0.f;
  }
  if (!any) return;
  if (tid == 0) {   // the rows with a new token, in order
    int n = 0;
    for (int i = 0; i < nr; ++i)
      if (rv[i]) vr[n++] = i;
    n_valid = n;
  }
  __syncthreads();
  const int nv = n_valid;
  const T* x = static_cast<const T*>(a.x) + row0 * a.h;
  ln_stats(x, vr, nv, a.h, a.eps, mean, rstd);
  __syncthreads();
  qkv_product<T, W, D, R>(a, x, vr, mean, rstd, nv, comp, hh, u, u + L.ya,
                          reinterpret_cast<float*>(u + L.ya), srow, dst);
  if (comp > 0) {
    emit_rows<T, kKV8, D>(a, dst, vr, nv, row0, hh, comp);
    __syncthreads();
  }
  for (int i = tid; i < nv * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    __stcg(reinterpret_cast<float4*>(
               a.pub + (((row0 + vr[r]) * 3 + comp) * nh + hh) * D + c),
           *reinterpret_cast<const float4*>(dst + r * (D + 4) + c));
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* flag = comp == 0 ? a.qflag : a.kvflag;
    for (int l = l0; l < l0 + nl; ++l)
      if (min(max(a.qlen[l], 0), C) > 0) atomicAdd(flag + l * nh + hh, 1);
  }
}

// Waits (thread 0 polling, the block at a barrier) until *f >= n and, if g
// is given, *g >= m. Only a consumer waits, and only on producers, which
// hold earlier tickets: they have started and never wait.
__device__ __forceinline__ void wait_flags(const int* f, int n, const int* g,
                                           int m) {
  if (threadIdx.x == 0) {
    const volatile int* vf = f;
    const volatile int* vg = g;
    while (*vf < n || (vg != nullptr && *vg < m)) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// The output projection of one head, o [q_len, D] (os) @ wo[hh D : (hh +
// 1) D, :], in 128-column slabs through a ring (the slabs in an order
// rotated by the head, so the slabs' last arrivals spread over the
// blocks; bf16 / fp16 with weights of the same type on the tensor cores);
// each slab's fp32
// partial goes to ws. One fence, then the block arrives at every slab's
// counter; for each slab it finished last it sums the slab over the heads
// in head order and writes the residual stream (or, without the fused
// epilogue, the rounded sum), with each row's mean and M2 over the slab.
// The lane's last slab merges those in slab order (Chan's pairwise
// formulas) and writes LN2 of the residual stream.
template <typename T, typename W, int D, int R>
__device__ void out_proj(const AttnArgs& a, const float* os, int q_len,
                         int b, int hh, unsigned char* ring, int* orow,
                         float* row_mean, float* row_rstd) {
  __shared__ int n_mine, lane_last;
  constexpr bool kQ8 = std::is_same_v<W, int8_t>;
  constexpr bool kMma = ptt::is16<T> && !kQ8;
  constexpr int kWCh = kSlab * (int)sizeof(W) / 16;   // chunks a W row
  constexpr int kWRow = kSlab * (int)sizeof(W) + 16;  // its padded bytes
  constexpr int kC4 = kSlab / 4;
  constexpr int kMU = R == 4 ? 1 : 4;
  const int tid = threadIdx.x, nb = a.b;
  const int C = a.C, h = a.h, nh = a.nh, nslab = (h + kSlab - 1) / kSlab;
  const int go = a.go, g0 = hh * D / go, ns = a.L.o_stages;
  const int warp = tid / 32, lane = tid % 32, m16 = (q_len + 15) / 16;
  const W* w = static_cast<const W*>(a.wo);
  const Layout& L = a.L;
  float* wsl = a.ws + (long)b * nh * C * h;            // the lane's partials
  float* stats = a.ln2 + (long)b * nslab * C * 2;      // [nslab][C][2]
  int* slab_cnt = a.counters + nh * nb + b * nslab;
  int* lane_cnt = a.counters + (nh + nslab) * nb + b;
  const T* x = static_cast<const T*>(a.x) + (long)b * C * h;
  const T* bo = static_cast<const T*>(a.bo);
  T* y2 = static_cast<T*>(a.y2) + (long)b * C * h;
  T* sout = a.s ? static_cast<T*>(a.s) + (long)b * C * h : nullptr;
  auto slab_of = [&](int i) { return (i + hh) % nslab; };
  auto issue_tile = [&](int i) {
    unsigned char* st = ring + (i % ns) * L.o_stage;
    const int n0 = slab_of(i) * kSlab;
    for (int j = tid; j < D * kWCh; j += kThreads) {
      const int k = j / kWCh, c = j % kWCh;
      const int col = n0 + c * (16 / (int)sizeof(W));
      const bool ok = col < h;
      ptt::cp_async16(st + k * kWRow + c * 16,
                      ok ? w + (long)(hh * D + k) * h + col : w, ok);
    }
    if constexpr (kQ8) {
      const int ng = (hh * D + D - 1) / go - g0 + 1;
      for (int j = tid; j < ng * kC4; j += kThreads) {
        const int g = j / kC4, c = 4 * (j % kC4);
        const bool ok = n0 + c < h;
        ptt::cp_async16(st + L.o_s + (g * kSlab + c) * 4,
                        ok ? a.so + (long)(g0 + g) * h + n0 + c : a.so, ok);
      }
    }
  };
  const Split m(q_len, kSlab, R);
  T* oa = reinterpret_cast<T*>(ring + L.oa);
  __syncthreads();   // os is written
  if constexpr (kQ8)   // the scale row of each of the head's wo rows
    for (int k = tid; k < D; k += kThreads) orow[k] = (hh * D + k) / go - g0;
  if constexpr (kMma)   // the head's output as a T A tile, zero rows
    for (int i = tid; i < m16 * 16 * D; i += kThreads) {   // past q_len
      const int r = i / D, c = i % D;
      store(oa + r * (D + 8) + c, r < q_len ? os[r * (D + 4) + c] : 0.f);
    }
  for (int i = 0; i < ns - 1; ++i) {
    if (i < nslab) issue_tile(i);
    ptt::cp_async_commit();
  }
  for (int i = 0; i < nslab; ++i) {
    cp_async_wait_n(ns - 2);
    __syncthreads();
    if (i + ns - 1 < nslab) issue_tile(i + ns - 1);
    ptt::cp_async_commit();
    const unsigned char* st = ring + (i % ns) * L.o_stage;
    const W* wt = reinterpret_cast<const W*>(st);
    const float* sc = reinterpret_cast<const float*>(st + L.o_s);
    if constexpr (kMma) {   // warp w: columns 16 w .. 16 w + 15 of every m-tile
      const T* wb = reinterpret_cast<const T*>(wt);
      float acc[kMU][2][4] = {};
#pragma unroll
      for (int s = 0; s < D / 16; ++s) {
        uint32_t bfr[4];
        ptt::ldsm_x4_t(bfr, wb + (s * 16 + ptt::a_row(lane)) * (kWRow / 2) +
                                warp * 16 + ptt::a_col(lane));
#pragma unroll
        for (int j = 0; j < kMU; ++j)
          if (j < m16) {
            uint32_t af[4];
            ptt::ldsm_x4(af, oa + (j * 16 + ptt::a_row(lane)) * (D + 8) +
                                 s * 16 + ptt::a_col(lane));
            ptt::mma16<T>(acc[j][0], af, bfr[0], bfr[1]);
            ptt::mma16<T>(acc[j][1], af, bfr[2], bfr[3]);
          }
      }
      const int g = lane / 4, t4 = lane % 4;
#pragma unroll
      for (int j = 0; j < kMU; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = j * 16 + g + 8 * e;
            const int c = slab_of(i) * kSlab + warp * 16 + 8 * hf + 2 * t4;
            if (j < m16 && r < q_len && c < h)
              *reinterpret_cast<float2*>(wsl + ((long)hh * C + r) * h + c) =
                  make_float2(acc[j][hf][2 * e], acc[j][hf][2 * e + 1]);
          }
    } else {
      const int col = slab_of(i) * kSlab + 4 * m.cg;
      float acc[R][4] = {};
      split_fma<T, W, R>(m, acc, os, D + 4, q_len, wt,
                         kWRow / (int)sizeof(W), D, [&](int k) {
        return wk::ld4(sc + orow[k] * kSlab + 4 * m.cg);
      });
      split_sum(m, acc);
      if (m.on && m.s == 0 && col < h) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = m.rb + j * m.nrb;
          if (j < m.rpt && r < q_len)
            *reinterpret_cast<float4*>(wsl + ((long)hh * C + r) * h + col) =
                make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        }
      }
    }
  }
  ptt::cp_async_wait<0>();
  // one fence for all the head's slabs, then the arrivals
  __threadfence();
  __syncthreads();
  int* mine = reinterpret_cast<int*>(ring);   // the ring is idle
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < nslab; ++i) {
      const int sl = slab_of(i);
      if (atomicAdd(slab_cnt + sl, 1) == nh - 1) {
        slab_cnt[sl] = 0;   // ready for the next launch
        mine[n++] = sl;
      }
    }
    n_mine = n;
  }
  __syncthreads();
  if (n_mine == 0) return;
  __threadfence();
  // the slabs' head sums, in head order; the projection rounds, then the
  // residual stream; rows past q_len are zeros. A row's 32 column groups
  // are a warp: its mean and M2 over the slab by shuffles.
  const int span = (C * kC4 + 31) / 32 * 32;   // whole warps
  for (int k = 0; k < n_mine; ++k) {
    const int sl = mine[k], n0 = sl * kSlab, nc = min(kSlab, h - n0);
    for (int j = tid; j < span; j += kThreads) {
      const int r = j / kC4, c = n0 + 4 * (j % kC4);
      const bool row = r < q_len, col = c < h;
      float mv[4] = {0.f, 0.f, 0.f, 0.f};
      if (row && col) {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < nh; k0 += 8) {
          float4 part[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            part[e] = k0 + e < nh
                          ? __ldcg(reinterpret_cast<const float4*>(
                                wsl + ((long)(k0 + e) * C + r) * h + c))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[0] += part[e].x;
            v[1] += part[e].y;
            v[2] += part[e].z;
            v[3] += part[e].w;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float mm = round_to<T>(v[e]);   // the projection, rounded
          if (a.fuse)
            mm = round_to<T>((to_f(x[(long)r * h + c + e]) + mm) +
                             to_f(bo[c + e]));
          store((a.fuse ? sout : y2) + (long)r * h + c + e, mm);
          mv[e] = mm;
        }
      } else if (r < C && col) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          store(y2 + (long)r * h + c + e, 0.f);
          if (sout) store(sout + (long)r * h + c + e, 0.f);
        }
      }
      if (!a.fuse) continue;
      float sum = (mv[0] + mv[1]) + (mv[2] + mv[3]);
#pragma unroll
      for (int o = kC4 / 2; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mu = sum / nc;
      float q = 0.f;
      if (row && col)
#pragma unroll
        for (int e = 0; e < 4; ++e) q += (mv[e] - mu) * (mv[e] - mu);
#pragma unroll
      for (int o = kC4 / 2; o > 0; o /= 2)
        q += __shfl_xor_sync(0xffffffffu, q, o);
      if (row && j % kC4 == 0) {
        stats[((long)sl * C + r) * 2] = mu;
        stats[((long)sl * C + r) * 2 + 1] = q;
      }
    }
  }
  if (!a.fuse) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    lane_last = atomicAdd(lane_cnt, n_mine) + n_mine == nslab;
    if (lane_last) *lane_cnt = 0;
  }
  __syncthreads();
  if (!lane_last) return;
  __threadfence();
  // LN2: each row's (mean, M2) merged over the slabs in slab order, then
  // y2 = LN2(s) of the whole rows
  for (int r = tid; r < q_len; r += kThreads) {
    float n = 0.f, mu = 0.f, m2 = 0.f;
    for (int s0 = 0; s0 < nslab; s0 += 8) {
      float2 st8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        st8[e] = s0 + e < nslab
                     ? __ldcg(reinterpret_cast<const float2*>(
                           stats + ((long)(s0 + e) * C + r) * 2))
                     : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (s0 + e >= nslab) break;
        const float nb_ = (float)min(kSlab, h - (s0 + e) * kSlab);
        const float tot = n + nb_, d = st8[e].x - mu;
        mu += d * (nb_ / tot);
        m2 += st8[e].y + d * d * (n * nb_ / tot);
        n = tot;
      }
    }
    row_mean[r] = mu;
    row_rstd[r] = 1.f / sqrtf(m2 / h + a.eps);
  }
  __syncthreads();
  const T* g2 = static_cast<const T*>(a.ln2_g);
  const T* b2 = static_cast<const T*>(a.ln2_b);
  const int h4 = h / 4;
  for (int i = tid; i < q_len * h4; i += kThreads) {
    const int r = i / h4, c = 4 * (i % h4);
    const float4 sv = ld4_cg(sout + (long)r * h + c);
    const float mu = row_mean[r], rs = row_rstd[r];
    const float in[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(y2 + (long)r * h + c + e,
            round_to<T>(ln_elem(in[e], mu, rs, to_f(g2[c + e]),
                                to_f(b2[c + e]))));
  }
}

// A consumer, split z of (lane, head hh): z = 0 attends the causal block
// of the lane's new rows (after Q, K and V are published), z >= 1 the
// pool's keys [(z - 1) span, z span) below the context (after Q is); a
// split past the context arrives and exits. The last split to arrive
// merges the partials in split order and runs the head's output projection.
template <typename T, typename KV, int D, int R>
__device__ void consume(const AttnArgs& a, int c, unsigned char* smem) {
  const int nh = a.nh, C = a.C, h = a.h, tid = threadIdx.x;
  const int z = c / (a.b * nh), lane = (c / nh) % a.b, hh = c % nh;
  const int Z = 1 + a.splits;
  const int q_len = min(max(a.qlen[lane], 0), C);
  const int ctx = max(a.ctx[lane], 0);
  if (q_len == 0) {   // idle lane: zero rows out (K / V: the producers)
    if (hh == 0 && z == 0) {
      T* y2 = static_cast<T*>(a.y2) + (long)lane * C * h;
      T* sout = a.s ? static_cast<T*>(a.s) + (long)lane * C * h : nullptr;
      for (int i = tid; i < C * h; i += kThreads) {
        store(y2 + i, 0.f);
        if (sout) store(sout + i, 0.f);
      }
    }
    return;
  }
  const int span = a.pages_per_split * a.ps;
  const int ctx_keys = min(ctx, a.pps * a.ps);
  const int k0 = (z - 1) * span, k1 = min(ctx_keys, k0 + span);
  const bool walks = z == 0 || k1 > k0;
  const Layout& L = a.L;
  float* qs = reinterpret_cast<float*>(smem);
  float* mean = reinterpret_cast<float*>(smem + L.stats);
  float* rstd = mean + a.NR;
  float* ms = rstd + a.NR;
  int* idx = reinterpret_cast<int*>(smem + L.idx);
  unsigned char* u = smem + L.u;
  float* kn = reinterpret_cast<float*>(u);        // z = 0: the new rows
  float* vn = kn + C * (D + 4);
  float* accs = reinterpret_cast<float*>(u + (z == 0 ? L.home : 0));
  wk::Rows st{qs, accs, accs + C * D, ms, ms + C, ms + 2 * C,
              reinterpret_cast<int*>(ms + 3 * C), q_len};
  int* qf = a.qflag + lane * nh + hh;
  int* kvf = a.kvflag + lane * nh + hh;
  // component comp of the lane's new rows, as the producers published it
  auto load = [&](float* dst, int comp) {
    for (int i = tid; i < q_len * (D / 4); i += kThreads) {
      const int r = i / (D / 4), cc = 4 * (i % (D / 4));
      *reinterpret_cast<float4*>(dst + r * (D + 4) + cc) =
          __ldcg(reinterpret_cast<const float4*>(
              a.pub + ((((long)lane * C + r) * 3 + comp) * nh + hh) * D +
              cc));
    }
  };
  if (walks && z == 0) {
    wait_flags(qf, 1, kvf, 2);
    load(qs, 0);
    load(kn, 1);
    load(vn, 2);
    wk::reset<D>(st);
    // the causal block over the lane's own new rows, kKeys at a time
    for (int t0 = 0; t0 < q_len; t0 += wk::kKeys) {
      __syncthreads();
      wk::attend<float, D, wk::kRows4>(
          st, kn + t0 * (D + 4), vn + t0 * (D + 4), D + 4, nullptr, nullptr,
          min(wk::kKeys, q_len - t0), a.scale,
          [&](int r) { return r + 1 - t0; });
    }
    __syncthreads();
  } else if (walks) {
    const int tpp = (a.ps + wk::kKeys - 1) / wk::kKeys;   // tiles a page
    const int nkeys = k1 - k0;
    const int n = (nkeys / a.ps) * tpp +
                  (nkeys % a.ps + wk::kKeys - 1) / wk::kKeys;
    const int p0 = (z - 1) * a.pages_per_split;
    int* pg = st.ncols + C;
    wk::stage_pages(pg, a.pt + (long)lane * a.pps, p0,
                    (nkeys + a.ps - 1) / a.ps, a.num_pages);
    wait_flags(qf, 1, nullptr, 0);
    load(qs, 0);
    wk::reset<D>(st);
    auto tile_of = [&](int i) {
      const int p = p0 + i / tpp, t0 = (i % tpp) * wk::kKeys;
      const int page = pg[i / tpp];
      const int key0 = p * a.ps + t0;
      return wk::TileAt{((long)page * a.ps + t0) * nh + hh,
                        min(min(wk::kKeys, a.ps - t0), k1 - key0), key0};
    };
    // every new row sees the whole context
    wk::walk<KV, D>(st, u + L.ring, static_cast<const KV*>(a.kp),
                    static_cast<const KV*>(a.vp), a.ks, a.vs, nh, n, tile_of,
                    a.scale, [&](int, int key0) { return ctx_keys - key0; });
  }
  const long pf = wk::partial_floats(C, D);
  float* part0 = a.part + (long)(lane * nh + hh) * Z * pf;
  if (walks) wk::save<D>(st, part0 + z * pf, C);
  if (!wk::arrive(a.counters + lane * nh + hh, Z)) return;
  if (tid == 0) {   // every split has passed its wait: ready for the next launch
    *qf = 0;
    *kvf = 0;
  }
  // the head's attention output, merged in split order and rounded to T
  wk::merge<D>(
      q_len, C, Z, [&](int s) { return part0 + s * pf; },
      [&](int s) { return s == 0 || (s - 1) * span < ctx_keys; },
      [&](int r, int cc, float4 v) {
        float* o = qs + r * (D + 4) + cc;
        o[0] = round_to<T>(v.x);
        o[1] = round_to<T>(v.y);
        o[2] = round_to<T>(v.z);
        o[3] = round_to<T>(v.w);
      });
  if (a.so)
    out_proj<T, int8_t, D, R>(a, qs, q_len, lane, hh, u, idx, mean, rstd);
  else
    out_proj<T, T, D, R>(a, qs, q_len, lane, hh, u, idx, mean, rstd);
}

// R: rows of a product a thread holds on the CUDA cores, m-tiles a warp
// holds on the tensor cores (4 / 1 for up to 16 rows a block; the wide
// variant, compiled apart, keeps the common one lean). A block's role
// comes from its ticket (taken in the order blocks start; the counter
// returns to 0 after every launch): the first 3 ngroups nh are the
// producers (Q of every group and head, then K, then V), the rest the
// consumers (lane, head, split), so a waiting consumer only waits for
// blocks that have started.
template <typename T, typename KV, int D, int R>
__global__ void __launch_bounds__(kThreads, 2)
mega_attn_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  if (threadIdx.x == 0)
    ticket = (int)atomicInc(a.ticket, (unsigned)(a.nblocks - 1));
  __syncthreads();
  const int t = ticket, per = a.ngroups * a.nh;
  if (t < 3 * per) {
    const int comp = t / per, grp = (t % per) / a.nh, hh = t % a.nh;
    if (a.sqkv)
      produce<T, KV, int8_t, D, R>(a, grp, hh, comp, smem);
    else
      produce<T, KV, T, D, R>(a, grp, hh, comp, smem);
    return;
  }
  consume<T, KV, D, R>(a, t - 3 * per, smem);
}

template <typename T, typename KV, int D, int R>
int launch_rows(const AttnArgs& a, int device, cudaStream_t st) {
  cudaError_t err =
      ptt::allow_smem<mega_attn_kernel<T, KV, D, R>>(device, a.L.total);
  if (err != cudaSuccess) return (int)err;
  mega_attn_kernel<T, KV, D, R><<<a.nblocks, kThreads, a.L.total, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int D>
int launch_attn(AttnArgs a, int device, cudaStream_t st) {
  a.L = attn_layout<D>(a.NR, a.C, (int)sizeof(T), a.sqkv != nullptr,
                       std::is_same_v<KV, int8_t>, a.so != nullptr,
                       a.pages_per_split);
  // a Split over D or kSlab columns gives a thread at most 4 rows up to 16
  // rows a block (at least 4 row lanes), 8 up to 64 (at least 8)
  return a.NR <= 16 ? launch_rows<T, KV, D, 4>(a, device, st)
                    : launch_rows<T, KV, D, kMaxRows>(a, device, st);
}

template <typename T, typename KV>
int dispatch_dim(const AttnArgs& a, int D, int device, cudaStream_t st) {
  switch (D) {
    case 32: return launch_attn<T, KV, 32>(a, device, st);
    case 64: return launch_attn<T, KV, 64>(a, device, st);
    case 80: return launch_attn<T, KV, 80>(a, device, st);
    case 96: return launch_attn<T, KV, 96>(a, device, st);
    case 128: return launch_attn<T, KV, 128>(a, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- the MLP layer ----

constexpr int kMlpCols = 32;        // weight columns a block: ffn (GEMM1), h (GEMM2)
constexpr int kMlpRing = 96 << 10;  // the ring's shared memory: 2 blocks an SM

struct MlpArgs {
  const void* y2;      // [t, h] T
  const void* s_res;   // [t, h] T, or null without the epilogue
  const void* w1;      // [h, f] T or int8
  const float* s1;     // [h / g1, f] or null
  const void* b1;      // [f] T
  const void* w2;      // [f, h] T or int8
  const float* s2;     // [f / g2, h] or null
  const void* b2;      // [h] T
  const int* qlen;     // [b] rows each lane feeds, or null: every row
  void* out;           // [t, h] T
  void* hid;           // [t, f] T: the hidden state of the live rows, packed
  float* part;         // [splits, t, h] fp32: GEMM2's partials, packed rows
  int* flags;          // [splits] producers published, [h / 32] column
                       // arrivals, consumers done, the block ticket
  int t, h, f, g1, g2, fuse, b, chunk, splits;
};

constexpr float kK0 = 0.7978845608028654f;   // sqrt(2 / pi)
constexpr float kA = 0.044715f;

// Waits (thread 0 polling, the block at a barrier) until *f >= n. Only a
// consumer waits, and only on producers, which hold earlier tickets: they
// have started and never wait. One poller a block, a quarter microsecond
// apart, leaves the memory system to the producers.
__device__ __forceinline__ void wait_count(const int* f, int n) {
  if (threadIdx.x == 0) {
    const volatile int* v = f;
    while (*v < n) __nanosleep(256);
    __threadfence();
  }
  __syncthreads();
}

// One block of the MLP kernel; its role comes from its ticket (taken in
// the order blocks start, back to 0 after every launch):
// - tickets [0, ceil(f / 32)) are producers: GEMM1 for 32 ffn columns
//   (fewer in the last) of every
//   live row (y2's rows gathered by the lanes' q_len), bias + tanh-GELU in
//   fp32 on the rounded product, the hidden rounded to T and published to
//   `hid`; then the producer counts itself in its ffn split's counter
//   (a split: fs rows of whole 64-row stages, the last split ends at f);
// - the rest are consumers (h tile of 32 columns, ffn split): their w2
//   stages go in flight first, then they wait for the split's counter to
//   reach its producers and run GEMM2 over the split's hidden columns into
//   fp32 partials. The last split of an h tile to arrive sums the partials
//   in split order and writes the epilogue, zeros in the rows no lane
//   feeds; the last consumer to finish resets the split counters.
// Each weight is read once a launch (per 64 live rows); nothing reads
// q_lens on the host.
template <typename T, typename W>
__global__ void __launch_bounds__(ptt::sk::Shape<T, W, kMlpCols>::kThreads)
mega_mlp_kernel(const MlpArgs a) {
  namespace sk = ptt::sk;
  using S = sk::Shape<T, W, kMlpCols>;
  extern __shared__ __align__(16) unsigned char smem[];
  int* pre = reinterpret_cast<int*>(smem + kMlpRing);   // live rows before
  int* rowid = pre + a.b + 1;                          // lane l; a pass's rows
  __shared__ int ticket, last_flag;
  const int tid = threadIdx.x;
  const int nprod = (a.f + kMlpCols - 1) / kMlpCols;
  const int nht = (a.h + kMlpCols - 1) / kMlpCols;
  const int fs = (a.f + sk::KS - 1) / sk::KS / a.splits * sk::KS;
  const int pps = fs / kMlpCols;   // producers of a full ffn split
  int* arrive = a.flags + a.splits;
  int* done = arrive + nht;
  if (tid == 0)
    ticket = (int)atomicInc(reinterpret_cast<unsigned*>(done + 1),
                            (unsigned)(nprod + nht * a.splits - 1));
  for (int l = tid; l < a.b; l += S::kThreads)
    pre[l + 1] = a.qlen ? min(max(a.qlen[l], 0), a.chunk) : a.chunk;
  __syncthreads();
  if (tid == 0) {
    pre[0] = 0;
    for (int l = 0; l < a.b; ++l) pre[l + 1] += pre[l];
  }
  __syncthreads();
  const int R = pre[a.b];
  // the row of live row i: lane l with pre[l] <= i < pre[l + 1]
  auto row_of = [&](int i) {
    int lo = 0, hi = a.b;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (pre[mid] <= i) lo = mid; else hi = mid;
    }
    return lo * a.chunk + (i - pre[lo]);
  };
  float acc[8][4];
  T* hid = static_cast<T*>(a.hid);

  if (ticket < nprod) {
    const int n0 = ticket * kMlpCols, ncols = min(kMlpCols, a.f - n0);
    const sk::WTile<W> wt{static_cast<const W*>(a.w1), a.s1, a.f, n0,
                          ncols, a.g1, a.s1 ? a.h / a.g1 : 1};
    const T* y2 = static_cast<const T*>(a.y2);
    const T* b1 = static_cast<const T*>(a.b1);
    for (int p0 = 0; p0 < R; p0 += sk::RP) {
      const int rp = min(sk::RP, R - p0);
      for (int i = tid; i < rp; i += S::kThreads) rowid[i] = row_of(p0 + i);
      __syncthreads();
      sk::run_tile<T, W, kMlpCols, false, true>(
          acc, smem, kMlpRing, wt, 0, a.h,
          [&](int r) { return y2 + (long)rowid[r] * a.h; }, rp, a.y2, [] {});
      // bias + tanh-GELU in fp32 on the rounded product; the hidden
      // rounds to T
      sk::for_each_acc<T, W, kMlpCols>(acc, rp, [&](int i, int c, float v) {
        if (c >= ncols) return;
        const float u = round_to<T>(v) + to_f(b1[n0 + c]);
        store(hid + (long)(p0 + i) * a.f + n0 + c,
              0.5f * u * (1.f + tanhf(kK0 * (u + kA * u * u * u))));
      });
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(a.flags + ticket / pps, 1);
    return;
  }

  const int c = ticket - nprod, hj = c % nht, sp = c / nht;
  const int k0 = sp * fs, n0 = hj * kMlpCols, ncols = min(kMlpCols, a.h - n0);
  const int nsp = min(pps, nprod - sp * pps);   // the split's producers
  const sk::WTile<W> wt{static_cast<const W*>(a.w2), a.s2, a.h, n0,
                        ncols, a.g2, a.s2 ? a.f / a.g2 : 1};
  for (int p0 = 0; p0 < R; p0 += sk::RP) {
    const int rp = min(sk::RP, R - p0);
    sk::run_tile<T, W, kMlpCols, false, true>(
        acc, smem, kMlpRing, wt, k0, min(a.f, k0 + fs),
        [&](int r) { return hid + (long)(p0 + r) * a.f; }, rp, a.w2, [&] {
          if (p0 == 0) wait_count(a.flags + sp, nsp);
        });
    sk::for_each_acc<T, W, kMlpCols>(acc, rp, [&](int i, int cc, float v) {
      if (cc < ncols) a.part[((long)sp * a.t + p0 + i) * a.h + n0 + cc] = v;
    });
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_flag = atomicAdd(arrive + hj, 1) == a.splits - 1;
  __syncthreads();
  if (last_flag) {
    __threadfence();
    // the splits summed in order; the second product rounded, then the
    // epilogue; rows no lane feeds are written as zeros
    const T* sres = static_cast<const T*>(a.s_res);
    const T* b2 = static_cast<const T*>(a.b2);
    T* out = static_cast<T*>(a.out);
    sk::sum_splits<kMlpCols, S::kThreads>(
        a.part, (long)a.t * a.h, a.h, n0, ncols, R, a.splits,
        [&](int i, int c, float4 v) {
          const long e = (long)row_of(i) * a.h + n0 + c;
          v = make_float4(round_to<T>(v.x), round_to<T>(v.y),
                          round_to<T>(v.z), round_to<T>(v.w));
          if (a.fuse) {   // element loads: s_res and b2 may sit anywhere
            const T* r = sres + e;
            const T* bb = b2 + n0 + c;
            v = make_float4(round_to<T>((to_f(r[0]) + v.x) + to_f(bb[0])),
                            round_to<T>((to_f(r[1]) + v.y) + to_f(bb[1])),
                            round_to<T>((to_f(r[2]) + v.z) + to_f(bb[2])),
                            round_to<T>((to_f(r[3]) + v.w) + to_f(bb[3])));
          }
          sk::store4(out + e, v);
        });
    constexpr int Q = kMlpCols / 4;
    for (int i = tid; i < a.t * Q; i += S::kThreads) {
      const int r = i / Q, lane = r / a.chunk;
      if ((i % Q) * 4 < ncols && r % a.chunk >= pre[lane + 1] - pre[lane])
        sk::store4(out + (long)r * a.h + n0 + (i % Q) * 4,
                   make_float4(0.f, 0.f, 0.f, 0.f));
    }
    if (tid == 0) arrive[hj] = 0;   // ready for the next launch
  }
  if (tid == 0 && atomicAdd(done, 1) == nht * a.splits - 1) {
    for (int j = 0; j < a.splits; ++j) a.flags[j] = 0;
    *done = 0;
  }
}

template <typename T, typename W>
int launch_mlp(const MlpArgs& a, int device, cudaStream_t st) {
  using S = ptt::sk::Shape<T, W, kMlpCols>;
  const int smem = kMlpRing + (a.b + 1 + ptt::sk::RP) * 4;
  cudaError_t err = ptt::allow_smem<mega_mlp_kernel<T, W>>(device, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (a.f + kMlpCols - 1) / kMlpCols +
                     (a.h + kMlpCols - 1) / kMlpCols * a.splits;
  mega_mlp_kernel<T, W><<<blocks, S::kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}


// Shared-memory bytes one attention block uses (chunk C, head_dim D;
// dtype 0 = fp32, 1 = bf16, 2 = fp16; whether wqkv / the pools / wo are
// int8; pages a
// split walks; lanes a producer takes), or -1 for a head dim that is not
// built.
int ptt_mega_attn_smem_bytes(int C, int D, int dtype, int wq8, int kv8,
                             int wo8, int pages, int group) {
  const int st = dtype == 0 ? 4 : 2, NR = group * C;
  switch (D) {
    case 32: return attn_layout<32>(NR, C, st, wq8, kv8, wo8, pages).total;
    case 64: return attn_layout<64>(NR, C, st, wq8, kv8, wo8, pages).total;
    case 80: return attn_layout<80>(NR, C, st, wq8, kv8, wo8, pages).total;
    case 96: return attn_layout<96>(NR, C, st, wq8, kv8, wo8, pages).total;
    case 128: return attn_layout<128>(NR, C, st, wq8, kv8, wo8, pages).total;
    default: return -1;
  }
}

// Pointers as in AttnArgs (all contiguous and 16-byte aligned; sqkv / so /
// ks / vs / kso / vso null for fp weights or fp pools; s null without the
// fused epilogue). part, ws, pub, ln2, counters: scratch of at least b * nh
// * (1 + splits) * partial_floats(C, D), b * nh * C * h, b * C * 3 * nh * D
// and b * ceil(h / 128) * C * 2 fp32, and b * (3 nh + ceil(h / 128) + 1) +
// 1 int32 counters ([b nh] split arrivals, [b nslab] slabs, [b] lanes, [b
// nh] Q flags, [b nh] K / V flags, the block ticket), zero on entry and left
// zero. gq, go: K rows per scale group of wqkv and wo (multiples of 16 with
// int8 weights). The grid walks pages_per_split pages a split, splits =
// ceil(pps / pages_per_split); a QKV producer takes `group` lanes (group *
// C <= 64). C <= 64, D 32 / 64 / 80 / 96 / 128, h a multiple of 64.
// dtype: 0 = fp32, 1 = bf16 (this library), 2 = fp16 (the one built from
// mega_decode_f16.cu) (x, LN and bias vectors, y2, s, fp weights and fp
// pools).
int ptt_mega_attn(const void* x, const void* ln1_g, const void* ln1_b,
                  const void* ln2_g, const void* ln2_b, const void* wqkv,
                  const void* sqkv, const void* bqkv, const void* wo,
                  const void* so, const void* bo, const void* kp,
                  const void* vp, const void* ks, const void* vs,
                  const void* pt, const void* ctx, const void* qlen, void* y2,
                  void* s, void* ko, void* vo, void* kso, void* vso,
                  void* part, void* ws, void* pub, void* ln2, void* counters,
                  int b, int C, int h, int nh, int D, int num_pages, int ps,
                  int pps, int gq, int go, int head_major, int fuse,
                  int pages_per_split, int group, float eps, float inv127,
                  float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || C > 64 || h % 64 || pages_per_split < 1 || group < 1 ||
      group * C > 64 || (sqkv && gq % 16) || (so && go % 16) ||
      (ks == nullptr) != (vs == nullptr) || (fuse != 0) != (s != nullptr) ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int splits = (pps + pages_per_split - 1) / pages_per_split;
  const int ngroups = (b + group - 1) / group;
  const int nslab = (h + kSlab - 1) / kSlab;
  int* cnt = static_cast<int*>(counters);
  int* qflag = cnt + b * (nh + nslab + 1);
  AttnArgs a{x, ln1_g, ln1_b, ln2_g, ln2_b, wqkv,
             static_cast<const float*>(sqkv), bqkv, wo,
             static_cast<const float*>(so), bo, kp, vp,
             static_cast<const float*>(ks), static_cast<const float*>(vs),
             static_cast<const int*>(pt), static_cast<const int*>(ctx),
             static_cast<const int*>(qlen), y2, s, ko, vo,
             static_cast<float*>(kso), static_cast<float*>(vso),
             static_cast<float*>(part), static_cast<float*>(ws),
             static_cast<float*>(pub), static_cast<float*>(ln2), cnt, qflag,
             qflag + b * nh, reinterpret_cast<unsigned*>(qflag + 2 * b * nh),
             b, C, h, nh, num_pages, ps, pps, sqkv ? gq : 1, so ? go : 1,
             head_major, fuse, pages_per_split, splits, group, ngroups,
             group * C, 3 * ngroups * nh + b * nh * (1 + splits), eps, inv127,
             scale, Layout{}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const bool kv8 = ks != nullptr;
#if PTT_MEGA_F16
  if (dtype == 2)
    return kv8 ? dispatch_dim<__half, int8_t>(a, D, device, st)
               : dispatch_dim<__half, __half>(a, D, device, st);
#else
  if (dtype == 0)
    return kv8 ? dispatch_dim<float, int8_t>(a, D, device, st)
               : dispatch_dim<float, float>(a, D, device, st);
  if (dtype == 1)
    return kv8 ? dispatch_dim<bf16, int8_t>(a, D, device, st)
               : dispatch_dim<bf16, bf16>(a, D, device, st);
#endif
  return (int)cudaErrorInvalidValue;
}

// Pointers as in MlpArgs (out, hid and part 16-byte aligned; the inputs
// anywhere); g1, g2: K rows per scale group of w1 and w2 (both weights int8
// or neither); the rows t are b lanes of chunk rows (qlen null: every row
// is live); h a multiple of 4, ceil(f / 64) % splits == 0. hid: t * f of
// T; part: splits * t * h fp32; flags: splits + ceil(h / 32) + 2 int32,
// zero on entry and left zero. dtype: 0 = fp32, 1 = bf16 (this library),
// 2 = fp16 (the one built from mega_decode_f16.cu).
int ptt_mega_mlp(const void* y2, const void* s_res, const void* w1,
                 const void* s1, const void* b1, const void* w2,
                 const void* s2, const void* b2, const void* qlen, void* out,
                 void* hid, void* part, void* flags, int t, int h, int f,
                 int g1, int g2, int b, int chunk, int splits, int fuse,
                 int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool q8 = s1 != nullptr;
  if (t < 1 || h < 4 || h % 4 || f < 1 || b < 1 || chunk < 1 ||
      b * chunk != t || splits < 1 ||
      ((f + ptt::sk::KS - 1) / ptt::sk::KS) % splits ||
      (s2 != nullptr) != q8 ||
      (q8 && (g1 < 1 || g2 < 1 || h % g1 || f % g2)) ||
      (fuse != 0) != (s_res != nullptr))
    return (int)cudaErrorInvalidValue;
  const MlpArgs a{y2, s_res, w1, static_cast<const float*>(s1), b1, w2,
                  static_cast<const float*>(s2), b2,
                  static_cast<const int*>(qlen), out, hid,
                  static_cast<float*>(part), static_cast<int*>(flags), t, h,
                  f, g1, g2, fuse, b, chunk, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#if PTT_MEGA_F16
  if (dtype == 2)
    return q8 ? launch_mlp<__half, int8_t>(a, device, st)
              : launch_mlp<__half, __half>(a, device, st);
#else
  if (dtype == 0)
    return q8 ? launch_mlp<float, int8_t>(a, device, st)
              : launch_mlp<float, float>(a, device, st);
  if (dtype == 1)
    return q8 ? launch_mlp<bf16, int8_t>(a, device, st)
              : launch_mlp<bf16, bf16>(a, device, st);
#endif
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
