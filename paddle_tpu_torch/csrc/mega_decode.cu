// The mega-kernel serving layer for Hopper (sm_90a): one kernel for the
// attention side of a decoder layer and one for its MLP side, fp32 or bf16
// activations, fp or int8 weights (per channel or per group along K), fp or
// int8 KV pools.
//
// ptt_mega_attn replaces paddle_tpu/ops/pallas/mega_decode.py::
// _mega_attn_kernel. Per lane b (q_len[b] new rows of a [b, chunk, h]
// block) it computes LN1 -> this step's Q, K, V (int8 weights dequantize
// element by element, q * s rounded to the activation type) -> with int8
// pools the new K / V rows quantized inline (scale = max(absmax, 1e-8) *
// fp32(1/127), q = clip(rint(x / scale)), IEEE division, ties to even: the
// serving write's quantizer) -> attention over the ctx_lens[b] tokens
// already in the paged pool (online softmax across pages; int8 pages
// dequantize in fp32 with their scale planes) and, causally, over the
// lane's own new rows (with int8 pools their quantize-dequantize image) ->
// the output projection -> residual + bo -> LN2. Every rounding of
// mega_attn_layer_reference is kept (the QKV product rounded before and
// after its bias, the attention output, the projection, the residual
// stream), so the kernel differs from it only in summation order.
//
// Translation: on the TPU the grid (lane, head, page) runs in order and the
// output GEMM accumulates across heads in a VMEM block. Here one block owns
// one (lane, head): it computes LN1 and its head's 3 * head_dim columns of
// the QKV product, walks the lane's pages in a loop, and multiplies its
// attention output by its head_dim rows of wo into an fp32 partial
// [chunk, h] in device memory. The last block of a lane to arrive (an
// arrival counter per lane, reset by that block) sums the partials in head
// order — deterministic, no float atomics — and writes the residual stream
// s and LN2(s) (or, without the fused epilogue, the rounded partial sum).
// Idle lanes (q_len 0) skip everything; rows past q_len are written as
// zeros in every output.
//
// ptt_mega_mlp replaces _mega_mlp_kernel: out = s_res + b2 +
// gelu_tanh(y2 @ w1 + b1) @ w2 with the [rows, ffn] hidden state rounded to
// the activation type and never written to device memory. On the TPU one
// resident output block accumulates the ffn tiles in order. Here a block
// owns (32 rows, 64 ffn columns): GEMM1 over h, bias + GELU in fp32, the
// hidden tile in shared memory, then GEMM2 into an fp32 partial [32, h] per
// ffn tile. For each (row tile, 64 output columns) the last block to arrive
// sums the ffn tiles' partials in ffn order and writes the epilogue.
//
// What bounds them on the H100: at GPT-125M serving (8 lanes x chunk 16,
// h 768, 12 heads of 64, ffn 3072, 128 MLP rows) the function needs one
// read of each weight (fp32 28.3 MB a layer, bf16 14.2 MB, int8 7.1 MB)
// and of the context pages: bytes, not operations (~0.5 GFLOP a layer). The
// design moves what it must and keeps the activations on chip: weight and
// activation tiles of 64 x 64 load in 16-byte chunks (int8 weights with
// their scale rows, dequantized on the way into shared memory), the next
// tile's loads in flight in registers while the current one multiplies.
// It is simple, not yet fast: every GEMM is fp32 FMA on the CUDA cores
// (register tiles of 4 x 4 or 2 x 4 a thread, no tensor cores), one tile
// of prefetch (no cp.async / TMA ring), each (lane, head) block re-reads
// its head's weight slice (8 lanes read wqkv and wo eight times, from L2),
// the page walk of a long context is one block's serial loop (the ragged
// kernel's design), and the partials cost device-memory traffic of their
// own: the attention side b * heads * chunk * h fp32 (4.7 MB written and
// read at the serving shape; the same buffer first holds each block's
// LN1 rows), the MLP side (ffn / 64) * rows * h fp32 (18.9 MB at 128
// rows).
#include "common.cuh"

#include <cstdint>

namespace {

using ptt::load_rows;
using ptt::store;
using ptt::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TK = 64;           // reduction indices per GEMM stage
constexpr int TN = 64;           // output columns per GEMM pass
constexpr int kPitch = TN + 4;   // float4-aligned rows of the GEMM tiles
constexpr int kMlpRows = 32;     // MLP rows per block
constexpr int kHeadBatch = 4;    // head partials a thread loads at once
constexpr int kTileBatch = 8;    // ffn-tile partials a thread loads at once
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// loads from L2 of values this kernel wrote (never through the read-only
// path)
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm of one element as the plain version spells it:
// ((x - mean) * rstd) * g + b in fp32, no contraction into FMAs
__device__ __forceinline__ float ln_elem(float x, float mean, float rstd,
                                         float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b);
}

// A weight [K, N]: elements of type T, or int8 with fp32 scales [K / gs, N]
// (s != nullptr). An int8 element dequantizes as q * s in fp32, rounded to
// T once. vec: rows and scale rows start on 16-byte boundaries, so a tile
// loads in 16-byte chunks.
template <typename T>
struct Weight {
  const void* w;
  const float* s;
  int K, N, gs, vec;
};

// One thread's share of a 64 x 64 weight tile in registers: fp32 4, bf16 2
// chunks of 16 bytes; int8 one chunk of 16 values and its 16 scales.
struct BFrag {
  uint4 raw[4];
  float4 sc[4];
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// Fetch W[k0 : k0 + TK, n0 : n0 + ncols] (rows past kend and columns past
// ncols as zeros): every load of the tile is issued before any is used
template <typename T>
__device__ __forceinline__ void fetch_b(BFrag& f, const Weight<T>& W, int k0,
                                        int kend, int n0, int ncols) {
  const int tid = threadIdx.x;
  if (W.s) {
    const int r = tid / 4, c = (tid % 4) * 16, k = k0 + r;
    const int8_t* w = static_cast<const int8_t*>(W.w) + (long)k * W.N + n0 + c;
    const float* s = W.s + (long)(k / W.gs) * W.N + n0 + c;
    const bool row = k < kend;
    if (W.vec) {
      const bool ok = row && c < ncols;
      f.raw[0] = ok ? ld16(w) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f.sc[q] = ok ? __ldg(reinterpret_cast<const float4*>(s) + q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      alignas(16) int8_t v[16];
      alignas(16) float sv[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const bool ok = row && c + e < ncols;
        v[e] = ok ? __ldg(w + e) : (int8_t)0;
        sv[e] = ok ? __ldg(s + e) : 0.f;
      }
      f.raw[0] = *reinterpret_cast<const uint4*>(v);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f.sc[q] = reinterpret_cast<const float4*>(sv)[q];
    }
    return;
  }
  constexpr int VEC = 16 / sizeof(T), CPR = TN / VEC;
  constexpr int PER = TK * CPR / kThreads;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = u * kThreads + tid;
    const int r = i / CPR, c = (i % CPR) * VEC, k = k0 + r;
    const T* w = static_cast<const T*>(W.w) + (long)k * W.N + n0 + c;
    if (W.vec) {
      f.raw[u] = (k < kend && c < ncols) ? ld16(w) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      alignas(16) T v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        T z;
        store(&z, 0.f);
        v[e] = (k < kend && c + e < ncols) ? __ldg(w + e) : z;
      }
      f.raw[u] = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Store a fetched weight tile as fp32 rows of Bs (pitch kPitch)
template <typename T>
__device__ __forceinline__ void put_b(float* Bs, const BFrag& f,
                                      const Weight<T>& W) {
  const int tid = threadIdx.x;
  if (W.s) {
    const int r = tid / 4, c = (tid % 4) * 16;
    float v[16];
    ptt::unpack(f.raw[0], v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      Bs[r * kPitch + c + 4 * q] = round_to<T>(v[4 * q] * f.sc[q].x);
      Bs[r * kPitch + c + 4 * q + 1] = round_to<T>(v[4 * q + 1] * f.sc[q].y);
      Bs[r * kPitch + c + 4 * q + 2] = round_to<T>(v[4 * q + 2] * f.sc[q].z);
      Bs[r * kPitch + c + 4 * q + 3] = round_to<T>(v[4 * q + 3] * f.sc[q].w);
    }
    return;
  }
  constexpr int VEC = 16 / sizeof(T), CPR = TN / VEC;
  constexpr int PER = TK * CPR / kThreads;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = u * kThreads + tid;
    const int r = i / CPR, c = (i % CPR) * VEC;
    float v[VEC];
    ptt::unpack(f.raw[u], v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) Bs[r * kPitch + c + e] = v[e];
  }
}

// One thread's share of an activation tile [rows, TK] of element type E in
// 16-byte chunks (NCH of them). kL2: the rows were written by this kernel
// (read through L2, never the read-only path).
template <typename E, int NCH, bool kL2>
__device__ __forceinline__ void fetch_a(uint4 (&raw)[NCH], const E* src,
                                        long ld, int nrows, int k0, int kend,
                                        bool vec) {
  constexpr int VEC = 16 / sizeof(E), CPR = TK / VEC;
#pragma unroll
  for (int u = 0; u < NCH; ++u) {
    const int i = u * kThreads + threadIdx.x;
    const int r = i / CPR, c = k0 + (i % CPR) * VEC;
    const E* p = src + r * ld + c;
    if (vec) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
      raw[u] = (r < nrows && c < kend) ? (kL2 ? __ldcg(q) : __ldg(q))
                                       : make_uint4(0u, 0u, 0u, 0u);
    } else {
      alignas(16) E v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        E z;
        store(&z, 0.f);
        v[e] = (r < nrows && c + e < kend) ? p[e] : z;
      }
      raw[u] = *reinterpret_cast<const uint4*>(v);
    }
  }
}

template <typename E, int NCH>
__device__ __forceinline__ void put_a(float* As, const uint4 (&raw)[NCH]) {
  constexpr int VEC = 16 / sizeof(E), CPR = TK / VEC;
#pragma unroll
  for (int u = 0; u < NCH; ++u) {
    const int i = u * kThreads + threadIdx.x;
    const int r = i / CPR, c = (i % CPR) * VEC;
    float v[VEC];
    ptt::unpack(raw[u], v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) As[r * kPitch + c + e] = v[e];
  }
}

// acc[i][j] += sum_k A[ty + 16 i][k] * B[k][tx * 4 + j] over one stage;
// threads whose first row is past `rows` skip the products
template <int RPT>
__device__ __forceinline__ void tile_fma(const float* As, int apitch,
                                         const float* Bs,
                                         float (&acc)[RPT][4], int rows) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (ty >= rows) return;
#pragma unroll 8
  for (int k = 0; k < TK; ++k) {
    const float4 bv =
        *reinterpret_cast<const float4*>(Bs + k * kPitch + tx * 4);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float av = As[(ty + 16 * i) * apitch + k];
      acc[i][0] = fmaf(av, bv.x, acc[i][0]);
      acc[i][1] = fmaf(av, bv.y, acc[i][1]);
      acc[i][2] = fmaf(av, bv.z, acc[i][2]);
      acc[i][3] = fmaf(av, bv.w, acc[i][3]);
    }
  }
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
  float* ws;                            // [b, nh, C, h] fp32 partials
  int* counters;                        // [b], zero on entry
  int C, h, nh, num_pages, ps, pps, gq, go, head_major, fuse;
  int vec_q, vec_o;                     // 16-byte weight tiles
  float eps, inv127, scale;
};

// dynamic shared memory (floats) of one attention block
__host__ __device__ inline int attn_rows(int C) {
  return C <= 16 ? 16 : (C <= 32 ? 32 : 64);
}
size_t attn_smem_floats(int C, int D, int ps) {
  const size_t cp = attn_rows(C), qp = D + 4;
  // key tiles: up to 64 rows of a page, or the chunk's new rows
  const size_t kt_page = ps < 64 ? ps : 64;
  const size_t kt = kt_page > (size_t)C ? kt_page : (size_t)C;
  const size_t stats = (4 * (size_t)C + 3) / 4 * 4;
  const size_t s_qkv = cp * kPitch + (size_t)TK * kPitch;
  const size_t s_attn = kt * (D + 1) + kt * D + (size_t)C * kPitch;
  size_t scratch = s_qkv > s_attn ? s_qkv : s_attn;
  return 2 * cp * qp + stats + scratch;
}

template <typename T, int D, int RPT>
__global__ void __launch_bounds__(kThreads) mega_attn_kernel(const AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last_flag;
  const int b = blockIdx.x, hh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int C = a.C, h = a.h, nh = a.nh;
  const int q_len = min(max(a.qlen[b], 0), C);
  const int ctx = max(a.ctx[b], 0);
  const bool kvq = a.ks != nullptr;
  const T* x = static_cast<const T*>(a.x) + (long)b * C * h;
  T* y2 = static_cast<T*>(a.y2) + (long)b * C * h;
  T* sout = a.s ? static_cast<T*>(a.s) + (long)b * C * h : nullptr;
  const long kv_row0 = (long)b * C * nh;   // row (b, 0) of the K/V outputs

  // rows past q_len of this head's K/V outputs: zeros
  for (int i = q_len * D + tid; i < C * D; i += kThreads) {
    const long o = (kv_row0 + (long)(i / D) * nh + hh) * D + i % D;
    if (kvq) {
      static_cast<int8_t*>(a.ko)[o] = 0;
      static_cast<int8_t*>(a.vo)[o] = 0;
    } else {
      store(static_cast<T*>(a.ko) + o, 0.f);
      store(static_cast<T*>(a.vo) + o, 0.f);
    }
  }
  if (kvq)
    for (int r = q_len + tid; r < C; r += kThreads) {
      a.kso[kv_row0 + (long)r * nh + hh] = 0.f;
      a.vso[kv_row0 + (long)r * nh + hh] = 0.f;
    }
  if (q_len == 0) {   // idle lane: no QKV, no pages, zero rows out
    if (hh == 0)
      for (int i = tid; i < C * h; i += kThreads) {
        store(y2 + i, 0.f);
        if (sout) store(sout + i, 0.f);
      }
    return;
  }

  constexpr int qp = D + 4;
  const int cp = attn_rows(C);
  float* Qs = smem;                    // [cp][qp] q rows
  float* Os = Qs + cp * qp;            // [cp][qp] K/V staging, then o
  float* Ms = Os + cp * qp;
  float* Ls = Ms + C;
  float* Alpha = Ls + C;
  int* Ncols = reinterpret_cast<int*>(Alpha + C);
  float* scratch = Ms + (4 * C + 3) / 4 * 4;

  // -- LN1 of the valid rows, one warp a row, rounded to T, into this
  // block's partial buffer (fp32 [C, h]; the output projection's partial
  // overwrites it later): the QKV product's A operand
  const T* g1 = static_cast<const T*>(a.ln1_g);
  const T* b1 = static_cast<const T*>(a.ln1_b);
  float* y1 = a.ws + ((long)b * nh + hh) * C * h;
  for (int r = warp; r < q_len; r += kWarps) {
    const T* xr = x + (long)r * h;
    float sum = 0.f;
    for (int c = lane; c < h; c += 32) sum += to_f(xr[c]);
    const float mean = warp_sum(sum) / h;
    float sq = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float d = to_f(xr[c]) - mean;
      sq += d * d;
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) / h + a.eps);
    for (int c = lane; c < h; c += 32)
      y1[(long)r * h + c] = round_to<T>(
          ln_elem(to_f(xr[c]), mean, rstd, to_f(g1[c]), to_f(b1[c])));
  }
  __syncthreads();

  // -- this head's Q, K and V columns: y1 [q_len, h] @ wqkv[:, cols], as
  // one sequence of (column slab, k) tiles; the next tile's loads are in
  // flight while the current one multiplies
  const int tx = tid % 16, ty = tid / 16;
  const Weight<T> Wq{a.wqkv, a.sqkv, h, 3 * nh * D, a.gq, a.vec_q};
  const T* bqkv = static_cast<const T*>(a.bqkv);
  float* As = scratch;                 // [cp][kPitch]
  float* Bs = As + cp * kPitch;        // [TK][kPitch]
  constexpr int kSlabs = D / TN;       // column slabs a component
  const int nk = (h + TK - 1) / TK;
  const int ntiles = 3 * kSlabs * nk;
  auto col_of = [&](int slab) {        // slab: component * kSlabs + j
    const int comp = slab / kSlabs, n0 = (slab % kSlabs) * TN;
    return a.head_major ? (hh * 3 + comp) * D + n0
                        : (comp * nh + hh) * D + n0;
  };
  uint4 araw[RPT];
  BFrag bfrag;
  fetch_a<float, RPT, true>(araw, y1, h, q_len, 0, h, true);
  fetch_b(bfrag, Wq, 0, h, col_of(0), TN);
  float acc[RPT][4] = {};
  for (int t = 0; t < ntiles; ++t) {
    const int slab = t / nk;
    __syncthreads();   // the previous tile's readers are done
    put_a<float, RPT>(As, araw);
    put_b(Bs, bfrag, Wq);
    __syncthreads();
    if (t + 1 < ntiles) {
      const int k1 = ((t + 1) % nk) * TK;
      fetch_a<float, RPT, true>(araw, y1, h, q_len, k1, h, true);
      fetch_b(bfrag, Wq, k1, h, col_of((t + 1) / nk), TN);
    }
    tile_fma<RPT>(As, kPitch, Bs, acc, q_len);
    if (t % nk != nk - 1) continue;
    // the slab is done: the product rounds to T, then its bias adds and
    // rounds again
    const int comp = slab / kSlabs, n0 = (slab % kSlabs) * TN;
    const int col0 = col_of(slab);
    float* dst = comp == 0 ? Qs : Os;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r < q_len)
          dst[r * qp + n0 + tx * 4 + j] = round_to<T>(
              round_to<T>(acc[i][j]) + to_f(bqkv[col0 + tx * 4 + j]));
        acc[i][j] = 0.f;
      }
    }
    if (n0 + TN < D) continue;
    if (comp == 0) continue;
    __syncthreads();
    // emit this component's rows (K: comp 1, V: comp 2), one warp a row
    for (int r = warp; r < q_len; r += kWarps) {
      const float* row = Os + r * qp;
      const long o = (kv_row0 + (long)r * nh + hh) * D;
      if (kvq) {
        float mx = 0.f;
        for (int d = lane; d < D; d += 32) mx = fmaxf(mx, fabsf(row[d]));
        const float sc = __fmul_rn(fmaxf(warp_max(mx), 1e-8f), a.inv127);
        int8_t* out = static_cast<int8_t*>(comp == 1 ? a.ko : a.vo);
        for (int d = lane; d < D; d += 32) {
          const int q = __float2int_rn(__fdiv_rn(row[d], sc));
          out[o + d] = (int8_t)min(max(q, -127), 127);
        }
        if (lane == 0)
          (comp == 1 ? a.kso : a.vso)[kv_row0 + (long)r * nh + hh] = sc;
      } else {
        T* out = static_cast<T*>(comp == 1 ? a.ko : a.vo);
        for (int d = lane; d < D; d += 32) store(out + o + d, row[d]);
      }
    }
    __syncthreads();
  }

  // -- attention: the pool's pages, then the lane's own new rows
  for (int i = tid; i < q_len * qp; i += kThreads) Os[i] = 0.f;
  for (int r = tid; r < q_len; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }
  const int kt_max = min(a.ps, 64);     // keys of a page per tile
  const int kt_rows = max(kt_max, C);   // ... or the new rows
  float* Ks = scratch;                  // [kt_rows][D + 1]
  float* Vs = Ks + kt_rows * (D + 1);   // [kt_rows][D]
  float* Ss = Vs + kt_rows * D;         // [C][kPitch]

  // one tile of `nt` keys: scores, online softmax over each row's first
  // ncols(r) keys, acc = acc * alpha + P @ V
  auto attend = [&](int nt, auto ncols_of) {
    for (int i = tid; i < q_len * nt; i += kThreads) {
      const float* qr = Qs + (i / nt) * qp;
      const float* kr = Ks + (i % nt) * (D + 1);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        s0 = fmaf(qr[c], kr[c], s0);
        s1 = fmaf(qr[c + 1], kr[c + 1], s1);
        s2 = fmaf(qr[c + 2], kr[c + 2], s2);
        s3 = fmaf(qr[c + 3], kr[c + 3], s3);
      }
      Ss[(i / nt) * kPitch + i % nt] = ((s0 + s1) + (s2 + s3)) * a.scale;
    }
    __syncthreads();
    for (int r = warp; r < q_len; r += kWarps) {
      const int ncols = ncols_of(r);
      if (ncols <= 0) {
        if (lane == 0) {
          Alpha[r] = 1.f;
          Ncols[r] = 0;
        }
        continue;
      }
      float* sr = Ss + r * kPitch;
      float mx = kNegInf;
      for (int j = lane; j < ncols; j += 32) mx = fmaxf(mx, sr[j]);
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < ncols; j += 32) {
        const float pj = expf(sr[j] - m_new);
        sr[j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Alpha[r] = alpha;
        Ncols[r] = ncols;
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + sum;
      }
    }
    __syncthreads();
    for (int i = tid; i < q_len * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int n = Ncols[r];
      const float* pr = Ss + r * kPitch;
      float a0 = 0.f, a1 = 0.f;
      int j = 0;
#pragma unroll 4
      for (; j + 1 < n; j += 2) {
        a0 = fmaf(pr[j], Vs[j * D + c], a0);
        a1 = fmaf(pr[j + 1], Vs[(j + 1) * D + c], a1);
      }
      if (j < n) a0 = fmaf(pr[j], Vs[j * D + c], a0);
      Os[r * qp + c] = Os[r * qp + c] * Alpha[r] + (a0 + a1);
    }
  };

  const long page_elems = (long)a.ps * nh * D;
  const int n_pages = min((ctx + a.ps - 1) / a.ps, a.pps);
  for (int p = 0; p < n_pages; ++p) {
    const int page =
        min(max(a.pt[(long)b * a.pps + p], 0), a.num_pages - 1);
    for (int t0 = 0; t0 < a.ps; t0 += kt_max) {
      const int base = p * a.ps + t0;
      if (base >= ctx) break;
      const int nt = min(min(kt_max, a.ps - t0), ctx - base);
      const long off0 = page * page_elems + ((long)t0 * nh + hh) * D;
      float* dst[2] = {Ks, Vs};
      const int pitch[2] = {D + 1, D};
      auto rows = [=](int r) { return (long)r * nh * D; };
      __syncthreads();   // the previous tile's readers are done
      if (kvq) {
        const int8_t* src[2] = {static_cast<const int8_t*>(a.kp) + off0,
                                static_cast<const int8_t*>(a.vp) + off0};
        const long s0 = ((long)page * a.ps + t0) * nh + hh;
        load_rows<int8_t, D, 8>(src, dst, pitch, rows, nt, nt,
                                [=](int t, int r) {
                                  return __ldg((t ? a.vs : a.ks) + s0 +
                                               (long)r * nh);
                                });
      } else {
        const T* src[2] = {static_cast<const T*>(a.kp) + off0,
                           static_cast<const T*>(a.vp) + off0};
        load_rows<T, D, 8>(src, dst, pitch, rows, nt, nt);
      }
      __syncthreads();
      attend(nt, [=](int) { return nt; });
    }
  }
  // the new rows: read back what this block emitted (its quantize-
  // dequantize image with int8 pools), causal within the chunk
  __syncthreads();
  for (int i = tid; i < q_len * D; i += kThreads) {
    const int j = i / D, d = i % D;
    const long row = kv_row0 + (long)j * nh + hh;
    float kv, vv;
    if (kvq) {
      kv = (float)__ldcg(static_cast<const signed char*>(a.ko) + row * D + d) *
           __ldcg(a.kso + row);
      vv = (float)__ldcg(static_cast<const signed char*>(a.vo) + row * D + d) *
           __ldcg(a.vso + row);
    } else {
      kv = ld_cg(static_cast<const T*>(a.ko) + row * D + d);
      vv = ld_cg(static_cast<const T*>(a.vo) + row * D + d);
    }
    Ks[j * (D + 1) + d] = kv;
    Vs[j * D + d] = vv;
  }
  __syncthreads();
  attend(q_len, [](int r) { return r + 1; });
  __syncthreads();
  for (int i = tid; i < q_len * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float l = Ls[r];
    Os[r * qp + c] = round_to<T>(l > 0.f ? Os[r * qp + c] / l : 0.f);
  }

  // -- this head's rows of the output projection: o [q_len, D] @
  // wo[hh D : (hh + 1) D, :] -> fp32 partial [q_len, h]
  const Weight<T> Wo{a.wo, a.so, nh * D, h, a.go, a.vec_o};
  float* wsb = y1;                     // the LN1 rows are spent
  constexpr int kKo = D / TK;          // k tiles a column slab
  const int nto = (h + TN - 1) / TN * kKo;
  fetch_b(bfrag, Wo, hh * D, (hh + 1) * D, 0, min(TN, h));
  float acc_o[RPT][4] = {};
  for (int t = 0; t < nto; ++t) {
    const int n0 = (t / kKo) * TN, k0 = (t % kKo) * TK;
    __syncthreads();
    put_b(scratch, bfrag, Wo);
    __syncthreads();
    if (t + 1 < nto) {
      const int n1 = (t + 1) / kKo * TN;
      fetch_b(bfrag, Wo, hh * D + (t + 1) % kKo * TK, (hh + 1) * D, n1,
              min(TN, h - n1));
    }
    tile_fma<RPT>(Os + k0, qp, scratch, acc_o, q_len);
    if (t % kKo != kKo - 1) continue;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (r < q_len && c < h) wsb[(long)r * h + c] = acc_o[i][j];
        acc_o[i][j] = 0.f;
      }
    }
  }

  // -- the lane's last block sums the heads' partials in head order
  __threadfence();
  __syncthreads();
  if (tid == 0) last_flag = atomicAdd(a.counters + b, 1) == nh - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  const T* bo = static_cast<const T*>(a.bo);
  const T* g2 = static_cast<const T*>(a.ln2_g);
  const T* b2 = static_cast<const T*>(a.ln2_b);
  const long plane = (long)C * h;
  const float* wsl = a.ws + (long)b * nh * plane;
  T* out1 = a.fuse ? sout : y2;   // the residual stream, or the partial
  // the head sum of 4 columns a thread, kHeadBatch partials in flight, in
  // head order; the projection rounds, then the residual stream
  const int h4 = h / 4;
  for (int i = tid; i < q_len * h4; i += kThreads) {
    const int r = i / h4, c = (i % h4) * 4;
    const float* src = wsl + (long)r * h + c;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < nh; k0 += kHeadBatch) {
      float4 part[kHeadBatch];
#pragma unroll
      for (int u = 0; u < kHeadBatch; ++u)
        part[u] = k0 + u < nh ? __ldcg(reinterpret_cast<const float4*>(
                                    src + (k0 + u) * plane))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kHeadBatch; ++u) {
        v[0] += part[u].x;
        v[1] += part[u].y;
        v[2] += part[u].z;
        v[3] += part[u].w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float m = round_to<T>(v[j]);   // the projection, rounded
      if (a.fuse)
        m = round_to<T>((to_f(x[(long)r * h + c + j]) + m) +
                        to_f(bo[c + j]));
      store(out1 + (long)r * h + c + j, m);
    }
  }
  for (int i = q_len * h + tid; i < C * h; i += kThreads) {
    store(y2 + i, 0.f);
    if (sout) store(sout + i, 0.f);
  }
  if (a.fuse) {
    __syncthreads();   // the residual stream rows are written
    // LN2 of the rounded residual stream, one warp a row
    for (int r = warp; r < q_len; r += kWarps) {
      const T* sr = sout + (long)r * h;
      T* yr = y2 + (long)r * h;
      float sum = 0.f;
#pragma unroll 4
      for (int c = lane; c < h; c += 32) sum += to_f(sr[c]);
      const float mean = warp_sum(sum) / h;
      float sq = 0.f;
#pragma unroll 4
      for (int c = lane; c < h; c += 32) {
        const float d = to_f(sr[c]) - mean;
        sq += d * d;
      }
      const float rstd = 1.f / sqrtf(warp_sum(sq) / h + a.eps);
#pragma unroll 4
      for (int c = lane; c < h; c += 32)
        store(yr + c, round_to<T>(ln_elem(to_f(sr[c]), mean, rstd,
                                          to_f(g2[c]), to_f(b2[c]))));
    }
  }
  if (tid == 0) a.counters[b] = 0;   // ready for the next launch
}

struct MlpArgs {
  const void* y2;      // [T, h] T
  const void* s_res;   // [T, h] T, or null without the epilogue
  const void* w1;      // [h, f] T or int8
  const float* s1;     // [h / g1, f] or null
  const void* b1;      // [f] T
  const void* w2;      // [f, h] T or int8
  const float* s2;     // [f / g2, h] or null
  const void* b2;      // [h] T
  void* out;           // [T, h] T
  float* ws;           // [ceil(f / 64), T, h] fp32 partials
  int* counters;       // [ceil(T / 32) * ceil(h / 64)], zero on entry
  int rows, h, f, g1, g2, fuse;
  int vec_a, vec1, vec2;                // 16-byte tiles of y2, w1, w2
};

constexpr float kK0 = 0.7978845608028654f;   // sqrt(2 / pi)
constexpr float kA = 0.044715f;

template <typename T>
__global__ void __launch_bounds__(kThreads) mega_mlp_kernel(const MlpArgs a) {
  __shared__ __align__(16) float As[kMlpRows * kPitch];   // y2 tile
  __shared__ __align__(16) float Bs[TK * kPitch];         // weight tile
  __shared__ __align__(16) float Gs[kMlpRows * kPitch];   // hidden tile
  __shared__ int last_flag;
  constexpr int RPT = kMlpRows / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int R = a.rows, h = a.h, f = a.f;
  const int f0 = blockIdx.x * TN, m0 = blockIdx.y * kMlpRows;
  const int nrows = min(kMlpRows, R - m0);
  const T* y2 = static_cast<const T*>(a.y2);

  // GEMM1: [32, h] @ w1[:, f0 : f0 + 64], the next k tile's loads in
  // flight while the current one multiplies
  const Weight<T> W1{a.w1, a.s1, h, f, a.g1, a.vec1};
  constexpr int kANch = kMlpRows * TK * (int)sizeof(T) / 16 / kThreads;
  const T* arow = y2 + (long)m0 * h;
  uint4 araw[kANch];
  BFrag bfrag;
  fetch_a<T, kANch, false>(araw, arow, h, nrows, 0, h, a.vec_a);
  fetch_b(bfrag, W1, 0, h, f0, min(TN, f - f0));
  float acc[RPT][4] = {};
  for (int k0 = 0; k0 < h; k0 += TK) {
    __syncthreads();
    put_a<T, kANch>(As, araw);
    put_b(Bs, bfrag, W1);
    __syncthreads();
    if (k0 + TK < h) {
      fetch_a<T, kANch, false>(araw, arow, h, nrows, k0 + TK, h, a.vec_a);
      fetch_b(bfrag, W1, k0 + TK, h, f0, min(TN, f - f0));
    }
    tile_fma<RPT>(As, kPitch, Bs, acc, nrows);
  }
  // bias + tanh-GELU in fp32 on the rounded product; the hidden rounds to T
  const T* b1 = static_cast<const T*>(a.b1);
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = f0 + tx * 4 + j;
      float g = 0.f;
      if (c < f) {
        const float u = round_to<T>(acc[i][j]) + to_f(b1[c]);
        g = round_to<T>(0.5f * u *
                        (1.f + tanhf(kK0 * (u + kA * u * u * u))));
      }
      Gs[(ty + 16 * i) * kPitch + tx * 4 + j] = g;
    }

  // GEMM2: hidden [32, 64] @ w2[f0 : f0 + 64, :], one 64-column slab at a
  // time, slabs in an order rotated by the ffn tile so that the slabs'
  // last arrivals spread over the blocks
  const Weight<T> W2{a.w2, a.s2, f, h, a.g2, a.vec2};
  const int nslabs = (h + TN - 1) / TN, nf = gridDim.x;
  const long plane = (long)R * h;
  const T* sres = static_cast<const T*>(a.s_res);
  const T* b2 = static_cast<const T*>(a.b2);
  T* out = static_cast<T*>(a.out);
  auto slab_n0 = [&](int si) {
    return (si + (int)blockIdx.x) % nslabs * TN;
  };
  fetch_b(bfrag, W2, f0, f, slab_n0(0), min(TN, h - slab_n0(0)));
  for (int si = 0; si < nslabs; ++si) {
    const int n0 = slab_n0(si), slab = n0 / TN;
    float acc2[RPT][4] = {};
    __syncthreads();
    put_b(Bs, bfrag, W2);
    __syncthreads();
    if (si + 1 < nslabs) {
      const int n1 = slab_n0(si + 1);
      fetch_b(bfrag, W2, f0, f, n1, min(TN, h - n1));
    }
    tile_fma<RPT>(Gs, kPitch, Bs, acc2, nrows);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + 16 * i;
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c < h)
          a.ws[blockIdx.x * plane + (long)(m0 + r) * h + c] = acc2[i][j];
      }
    }
    __threadfence();
    __syncthreads();
    int* counter = a.counters + blockIdx.y * nslabs + slab;
    if (tid == 0) last_flag = atomicAdd(counter, 1) == nf - 1;
    __syncthreads();
    if (!last_flag) continue;
    __threadfence();
    // the last block of this (row tile, slab) sums the ffn tiles in
    // order, 4 columns a thread, kTileBatch partials in flight
    for (int i = tid; i < kMlpRows * TN / 4; i += kThreads) {
      const int r = i / (TN / 4), c = n0 + (i % (TN / 4)) * 4;
      if (r >= nrows || c >= h) continue;
      const long e = (long)(m0 + r) * h + c;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t0 = 0; t0 < nf; t0 += kTileBatch) {
        float4 part[kTileBatch];
#pragma unroll
        for (int u = 0; u < kTileBatch; ++u)
          part[u] = t0 + u < nf ? __ldcg(reinterpret_cast<const float4*>(
                                      a.ws + (t0 + u) * plane + e))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < kTileBatch; ++u) {
          v[0] += part[u].x;
          v[1] += part[u].y;
          v[2] += part[u].z;
          v[3] += part[u].w;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float o = round_to<T>(v[j]);   // the second product, rounded
        if (a.fuse)
          o = round_to<T>((to_f(sres[e + j]) + o) + to_f(b2[c + j]));
        store(out + e + j, o);
      }
    }
    if (tid == 0) *counter = 0;   // ready for the next launch
  }
}

template <typename T, int D, int RPT>
int launch_attn(const AttnArgs& a, int b, int device, cudaStream_t st) {
  const int bytes = (int)(sizeof(float) * attn_smem_floats(a.C, D, a.ps));
  cudaError_t err =
      ptt::allow_smem<mega_attn_kernel<T, D, RPT>>(device, bytes);
  if (err != cudaSuccess) return (int)err;
  mega_attn_kernel<T, D, RPT><<<dim3(b, a.nh), kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_rows(const AttnArgs& a, int b, int device, cudaStream_t st) {
  switch (attn_rows(a.C)) {
    case 16: return launch_attn<T, D, 1>(a, b, device, st);
    case 32: return launch_attn<T, D, 2>(a, b, device, st);
    default: return launch_attn<T, D, 4>(a, b, device, st);
  }
}

// 1 when the rows of a matrix with n columns of esize-byte elements (and
// its fp32 scale rows, if any) start on 16-byte boundaries
int rows16(const void* p, int n, int esize, const void* s) {
  const bool ok = reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                  (long)n * esize % 16 == 0;
  return ok && (s == nullptr || reinterpret_cast<uintptr_t>(s) % 16 == 0);
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes one attention block uses (chunk C, head_dim D, page
// size ps).
int ptt_mega_attn_smem_bytes(int C, int D, int ps) {
  return (int)(sizeof(float) * attn_smem_floats(C, D, ps));
}

// Pointers as in AttnArgs (all contiguous; sqkv / so / ks / vs / kso / vso
// null for fp weights or fp pools; s null without the fused epilogue).
// gq, go: K rows per scale group of wqkv and wo. C <= 64, D 64 or 128,
// h a multiple of 4 (the partials are summed 4 columns at a time).
// dtype: 0 = fp32, 1 = bf16 (x, LN and bias vectors, y2, s, fp weights and
// fp pools).
int ptt_mega_attn(const void* x, const void* ln1_g, const void* ln1_b,
                  const void* ln2_g, const void* ln2_b, const void* wqkv,
                  const void* sqkv, const void* bqkv, const void* wo,
                  const void* so, const void* bo, const void* kp,
                  const void* vp, const void* ks, const void* vs,
                  const void* pt, const void* ctx, const void* qlen, void* y2,
                  void* s, void* ko, void* vo, void* kso, void* vso, void* ws,
                  void* counters, int b, int C, int h, int nh, int D,
                  int num_pages, int ps, int pps, int gq, int go,
                  int head_major, int fuse, float eps, float inv127,
                  float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || C > 64 || (D != 64 && D != 128) || h % 4 || gq < 1 ||
      go < 1 || (ks == nullptr) != (vs == nullptr) ||
      (fuse != 0) != (s != nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  AttnArgs a{x, ln1_g, ln1_b, ln2_g, ln2_b, wqkv,
             static_cast<const float*>(sqkv), bqkv, wo,
             static_cast<const float*>(so), bo, kp, vp,
             static_cast<const float*>(ks), static_cast<const float*>(vs),
             static_cast<const int*>(pt), static_cast<const int*>(ctx),
             static_cast<const int*>(qlen), y2, s, ko, vo,
             static_cast<float*>(kso), static_cast<float*>(vso),
             static_cast<float*>(ws), static_cast<int*>(counters), C, h, nh,
             num_pages, ps, pps, gq, go, head_major, fuse,
             rows16(wqkv, 3 * nh * D, sqkv ? 1 : esize, sqkv),
             rows16(wo, h, so ? 1 : esize, so), eps, inv127, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && D == 64) return dispatch_rows<float, 64>(a, b, device, st);
  if (dtype == 0) return dispatch_rows<float, 128>(a, b, device, st);
  if (dtype == 1 && D == 64) return dispatch_rows<bf16, 64>(a, b, device, st);
  if (dtype == 1) return dispatch_rows<bf16, 128>(a, b, device, st);
  return (int)cudaErrorInvalidValue;
}

// Pointers as in MlpArgs; g1, g2: K rows per scale group of w1 and w2; h a
// multiple of 4.
int ptt_mega_mlp(const void* y2, const void* s_res, const void* w1,
                 const void* s1, const void* b1, const void* w2,
                 const void* s2, const void* b2, void* out, void* ws,
                 void* counters, int rows, int h, int f, int g1, int g2,
                 int fuse, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || h % 4 || g1 < 1 || g2 < 1 ||
      (fuse != 0) != (s_res != nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  MlpArgs a{y2, s_res, w1, static_cast<const float*>(s1), b1, w2,
            static_cast<const float*>(s2), b2, out, static_cast<float*>(ws),
            static_cast<int*>(counters), rows, h, f, g1, g2, fuse,
            rows16(y2, h, esize, nullptr), rows16(w1, f, s1 ? 1 : esize, s1),
            rows16(w2, h, s2 ? 1 : esize, s2)};
  dim3 grid((f + TN - 1) / TN, (rows + kMlpRows - 1) / kMlpRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    mega_mlp_kernel<float><<<grid, kThreads, 0, st>>>(a);
  else if (dtype == 1)
    mega_mlp_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
