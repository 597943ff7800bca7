// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 on the CUDA cores.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (the
// causal / no-mask / no-varlen branch): blocked attention with the
// FlashAttention-2 online softmax, bottom-right causal alignment
// (row r sees columns <= r + sk - sq), GQA by reading kv head h / group,
// fully masked rows give out = 0 and lse = 1e30; p is rounded to v's type
// before p v, as the reference's p.astype(v.dtype). Unlike the Pallas
// kernel, whose blocks had to divide the sequence, this one masks its own
// ragged tails, so any sq and sk work.
//
// What bounds it on the H100: at the flagship training shape [8, 1024, 12,
// 128] causal in bf16, q, k, v and out are 100.7 MB, 0.030 ms at 3.35 TB/s,
// and the two products 25.8 GFLOP, 0.026 ms at 989 TFLOP/s: the two bounds
// are even, and a kernel that reads each tile once is held by the rate its
// products reach on the tensor cores. CUDA-core fp32 products could not
// pass 67 TFLOP/s.
//
// bf16: one block per (128-row q tile, b * hq); the grid runs the q tiles
// with the most keys first, so the last wave is short. K and V tiles of 64
// keys go through a 2-stage cp.async ring in shared memory; the next
// tile's copy is issued right after the one barrier a tile and overlaps
// this tile's products. Scores and the output accumulate in fp32
// fragments; the running max and sum of a row live in the 4 lanes that
// own it (__shfl_xor_sync, no score tile in shared memory); P is rounded
// to bf16 in registers and fed back as the A operand of P V (the
// accumulator layout is the A layout); one divide by l at the end
// (softmax_tile, store_rows). Masks run only on tiles that cross the
// causal diagonal or the key tail; rows that see no key of a tile skip it.
// - head_dim 128 (flash_fwd_wg_kernel): two warpgroups of 64 rows issue
//   wgmma m64n64k16 (Q and K from shared memory) and m64n128k16 (P from
//   registers, V read transposed from shared memory), over tiles in the
//   128-byte-swizzled layout; 128 registers (launch bounds: two blocks an
//   SM, so one block's softmax overlaps the other's products), no spills,
//   99,328 B of shared memory.
// - head_dim 32, 64, 80, 96 (flash_fwd_tc_kernel): 8 warps of 16 rows on
//   mma.sync m16n8k16, Q fragments in registers (ldmatrix, once), tiles at
//   a row pitch of d + 8 (free of ldmatrix bank conflicts); shared memory
//   (128 + 4 * 64) * (d + 8) * 2 bytes; ptxas -v: d 32: 128 registers,
//   30,720 B; d 64: 168, 55,296 B; d 80: 167, 67,584 B; d 96: 174, 79,872
//   B; no spills. (On the card wgmma ran slower than these at d 64 and 96;
//   d 80 and 96 do not fill the 128-byte swizzle atom.)
//
// fp32 (flash_fwd_kernel, head_dim 64, 128): tensor cores would make it
// TF32, so it stays on the CUDA cores, the kernel of the first port: one
// 128-thread block per (b * hq, 64-row q tile) keeps Q, one K tile, one V
// tile and the score tile in shared memory as fp32; each thread owns an
// 8 x 4 score tile and an 8 x (d / 16) output tile.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptt::load_rows;
using ptt::store;

constexpr float kNegInf = -1e30f;      // NEG_INF of the Pallas kernel
constexpr float kLseInvalid = 1e30f;   // LSE_INVALID of the Pallas kernel
constexpr int kBQ = 64;                // q rows per block
constexpr int kBK = 64;                // keys per tile
constexpr int kThreads = 128;          // 8 row groups x 16 column groups
constexpr int kTR = 8;                 // rows per thread
constexpr int kTC = 4;                 // score columns per thread
constexpr int kSS = kBK + 1;           // padded score-row stride

template <int D>
constexpr size_t smem_bytes() {
  // Qs, Ks: [64][D+1]; Vs: [64][D]; Ss: [64][65]; m, l, alpha: [64]
  return sizeof(float) *
         (2 * kBQ * (D + 1) + kBK * D + kBQ * kSS + 3 * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                 float scale, int causal) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* Ss = Vs + kBK * D;
  float* row_m = Ss + kBQ * kSS;
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const long q_row = (long)hq * D;     // [b, s, h, d] row strides
  const long kv_row = (long)hkv * D;
  const T* qb = q + (long)b * sq * q_row + (long)h * D;
  const T* kb = k + (long)b * sk * kv_row + (long)kvh * D;
  const T* vb = v + (long)b * sk * kv_row + (long)kvh * D;
  const int off = sk - sq;

  const auto q_off = [=](int r) { return (q0 + r) * q_row; };
  const auto kv_off = [=](int r) { return r * kv_row; };
  {
    const T* src[1] = {qb};
    float* dst[1] = {Qs};
    const int pitch[1] = {D + 1};
    load_rows<T, D, 4>(src, dst, pitch, q_off, kBQ, sq - q0);
  }
  if (tid < kBQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }
  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    // columns the block's last valid row may see (bottom-right aligned)
    const int last = min(q0 + kBQ, sq) - 1;
    const int visible = last + off + 1;
    n_tiles = min(n_tiles, visible > 0 ? (visible + kBK - 1) / kBK : 0);
  }

  float acc[kTR][DC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    {
      const T* src[2] = {kb + k0 * kv_row, vb + k0 * kv_row};
      float* dst[2] = {Ks, Vs};
      const int pitch[2] = {D + 1, D};
      load_rows<T, D, 4>(src, dst, pitch, kv_off, kBK, sk - k0);
    }
    __syncthreads();
    // scores: rows rg*8 + i, columns cg + 16*j
    float s[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < D; ++kk) {
      float a[kTR], bk[kTC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) a[i] = Qs[(rg * kTR + i) * (D + 1) + kk];
#pragma unroll
      for (int j = 0; j < kTC; ++j) bk[j] = Ks[(cg + 16 * j) * (D + 1) + kk];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = rg * kTR + i;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int c = cg + 16 * j;
        const int col = k0 + c;
        const bool ok = col < sk && (!causal || col <= q0 + r + off);
        Ss[r * kSS + c] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();
    // online softmax, one warp per row (16 rows per warp)
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float s0 = Ss[r * kSS + lane], s1 = Ss[r * kSS + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ss[r * kSS + lane] = p0;
      Ss[r * kSS + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V over this tile
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const float alpha = row_a[rg * kTR + i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float p[kTR], vv[DC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) p[i] = Ss[(rg * kTR + i) * kSS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[kk * D + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();
  // rows whose running max never left NEG_INF saw no key: zeros + LSE_INVALID
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = rg * kTR + i;
    const int row = q0 + r;
    if (row >= sq) continue;
    const float m = row_m[r], l = row_l[r];
    const bool invalid = m <= kNegInf * 0.5f || l == 0.f;
    const float inv = invalid ? 0.f : 1.f / l;
    T* o = out + (long)b * sq * q_row + (long)row * q_row + (long)h * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) store(o + cg + 16 * j, acc[i][j] * inv);
    if (cg == 0) lse[(long)bh * sq + row] = invalid ? kLseInvalid : m + logf(l);
  }
}

// ---- bf16: shared pieces ---------------------------------------------

constexpr int kBQ16 = 128;    // q rows per block (both bf16 kernels)
constexpr int kBK16 = 64;     // keys per ring stage
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One key tile of the online softmax for a warp's 16 rows (rows r0 + g and
// r0 + g + 8 of this lane): s holds the raw scores of keys k0 .. k0 + 63 in
// C-fragment layout. Scales them to log2 units, masks the causal diagonal
// and the key tail (masked: this tile crosses either), updates the running
// max m and this lane's share of the running sum l, rescales o, and leaves
// P rounded to bf16 in pf, the A fragments of P V.
template <int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4],
                                             float (&o)[NO][4],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&pf)[4][4],
                                             bool masked, int r0, int k0,
                                             int sk, int off, int causal,
                                             float scale_log2) {
  const int g = (threadIdx.x % 32) >> 2, t4 = threadIdx.x & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * scale_log2;
      if (masked) {
        const int row = r0 + g + (e >> 1) * 8;
        const int col = k0 + n * 8 + 2 * t4 + (e & 1);
        if (col >= sk || (causal && col > row + off)) x = kNegInf;
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[n][e] - m[e >> 1]);
      s[n][e] = p;
      l[e >> 1] += p;  // fp32 p, as the reference's row sum
    }
  ptt::c_to_a(pf, s);
}

// The warp's 16 rows of out (bf16) and lse after the last tile: one
// divide by l; rows whose running max never left NEG_INF saw no key and
// get zeros and LSE_INVALID.
template <int D>
__device__ __forceinline__ void store_rows(float (&o)[D / 8][4],
                                           float (&m)[2], float (&l)[2],
                                           bf16* out, float* lse, int r0,
                                           int sq, long q_row, long row_base,
                                           long lse_base) {
  const int g = (threadIdx.x % 32) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + g + 8 * i;
    if (row >= sq) continue;
    const bool invalid = m[i] <= kNegInf * 0.5f || l[i] == 0.f;
    const float inv = invalid ? 0.f : 1.f / l[i];
    bf16* dst = out + row_base + (long)row * q_row + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          ptt::pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (t4 == 0)
      lse[lse_base + row] =
          invalid ? kLseInvalid : (m[i] + log2f(l[i])) * kLn2;
  }
}

// Key tiles the block walks: up to the columns its last valid row may see
// (bottom-right aligned) under causal masking.
__device__ __forceinline__ int key_tiles(int q0, int sq, int sk, int causal) {
  int n = (sk + kBK16 - 1) / kBK16;
  if (causal) {
    const int visible = min(q0 + kBQ16, sq) + sk - sq;
    n = min(n, visible > 0 ? (visible + kBK16 - 1) / kBK16 : 0);
  }
  return n;
}

// ---- bf16 on mma.sync (head_dim 32, 64, 80, 96) ------------------------

constexpr int kTcThreads = 256;  // 8 warps of 16 q rows

template <int D>
constexpr size_t tc_smem_bytes() {
  // Q [128][D+8], then 2 stages of K [64][D+8] and V [64][D+8], bf16
  return sizeof(bf16) * (kBQ16 + 4 * kBK16) * (D + 8);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                    float scale_log2, int causal) {
  static_assert(std::is_same_v<T, bf16>, "the tensor-core path is bf16");
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int P = D + 8;   // shared row pitch, bf16 elements
  constexpr int KS = D / 16;  // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + kBQ16 * P;  // stage s: K at ring + 2s*64*P, V after it

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ16;  // most keys first
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long q_row = (long)hq * D;  // [b, s, h, d] row strides
  const long kv_row = (long)hkv * D;
  const bf16* qb = q + (long)b * sq * q_row + (long)h * D;
  const bf16* kb = k + (long)b * sk * kv_row + (long)kvh * D;
  const bf16* vb = v + (long)b * sk * kv_row + (long)kvh * D;
  const int off = sk - sq;
  const int r0 = q0 + warp * 16;  // the warp's first row
  const int n_tiles = key_tiles(q0, sq, sk, causal);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const auto load_kv = [&](int t) {
    bf16* Ks = ring + (t & 1) * 2 * kBK16 * P;
    const int k0 = t * kBK16;
    ptt::cp_tile<D, kBK16, kTcThreads>(Ks, kb + k0 * kv_row, kv_row,
                                       sk - k0, kb);
    ptt::cp_tile<D, kBK16, kTcThreads>(Ks + kBK16 * P, vb + k0 * kv_row,
                                       kv_row, sk - k0, vb);
    ptt::cp_async_commit();
  };

  if (n_tiles > 0) {
    ptt::cp_tile<D, kBQ16, kTcThreads>(Qs, qb + q0 * q_row, q_row, sq - q0,
                                       qb);
    load_kv(0);  // one group: Q and the first K / V tile
  }
  uint32_t qf[KS][4];  // the warp's Q fragments, loaded once
  for (int t = 0; t < n_tiles; ++t) {
    ptt::cp_async_wait<0>();
    // tile t (and at t = 0 the Q tile) has landed, and every warp is done
    // with tile t - 1, whose stage the next copy reuses
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1);
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ptt::ldsm_x4(qf[ks], Qs + (warp * 16 + ptt::a_row(lane)) * P +
                                 ks * 16 + ptt::a_col(lane));
    }
    const int k0 = t * kBK16;
    const bf16* Ks = ring + (t & 1) * 2 * kBK16 * P;
    const bf16* Vs = Ks + kBK16 * P;
    // a warp whose last row sees no key of this tile skips it
    if (causal && k0 > r0 + 15 + off) continue;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kf[4];
        ptt::ldsm_x4(kf, Ks + (j * 16 + ptt::b_row(lane)) * P + ks * 16 +
                             ptt::b_col(lane));
        ptt::mma_bf16(s[2 * j], qf[ks], kf[0], kf[1]);
        ptt::mma_bf16(s[2 * j + 1], qf[ks], kf[2], kf[3]);
      }
    }
    uint32_t pf[4][4];
    softmax_tile(s, o, m, l, pf,
                 (causal && k0 + kBK16 - 1 > r0 + off) || k0 + kBK16 > sk,
                 r0, k0, sk, off, causal, scale_log2);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t vf[4];
        ptt::ldsm_x4_t(vf, Vs + (kk * 16 + ptt::a_row(lane)) * P + j * 16 +
                               ptt::a_col(lane));
        ptt::mma_bf16(o[2 * j], pf[kk], vf[0], vf[1]);
        ptt::mma_bf16(o[2 * j + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }
  store_rows<D>(o, m, l, out, lse, r0, sq, q_row,
                (long)b * sq * q_row + (long)h * D, (long)bh * sq);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, int b, int hq, int hkv, int sq, int sk, float scale,
              int causal, int device, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<D>();
  cudaError_t err = ptt::allow_smem<flash_fwd_tc_kernel<bf16, D>>(
      device, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * hq, (sq + kBQ16 - 1) / kBQ16);
  flash_fwd_tc_kernel<bf16, D><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), hq, hkv, sq, sk, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

// ---- bf16 on wgmma (head_dim 128) -------------------------------------

constexpr int kWgThreads = 256;  // 2 warpgroups of 64 q rows

template <int D>
constexpr size_t wg_smem_bytes() {
  // Q [128][D], then 2 stages of K [64][D] and V [64][D], bf16, swizzled,
  // and 1,024 bytes to align the swizzle atoms
  return sizeof(bf16) * (kBQ16 + 4 * kBK16) * D + 1024;
}

// Rows [0, R) of D bf16 (row r at src + r * stride) into a tile in the
// 128-byte-swizzled layout of wgmma: atoms of 8 rows x 64 columns (1,024
// bytes, row r % 8 at (r % 8) * 128), atom (column block c / 8, row block
// r / 8) at ((c / 8) * R / 8 + r / 8) * 1,024 bytes, and the 16-byte chunk
// c of row r at chunk position (c % 8) ^ (r % 8) of its row (so the 8 rows
// of a chunk column fall in 8 bank quads). Rows >= valid are zero-filled.
template <int D, int R>
__device__ __forceinline__ void cp_tile_sw128(bf16* dst, const bf16* src,
                                              long stride, int valid,
                                              const bf16* base) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < R * C; i += kWgThreads) {
    const int r = i / C, c = i % C;
    const bool ok = r < valid;
    const int at = ((c / 8) * (R / 8) + r / 8) * 512 + (r % 8) * 64 +
                   ((c % 8) ^ (r % 8)) * 8;
    ptt::cp_async16(dst + at, ok ? src + r * stride + c * 8 : base, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_fwd_wg_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                    float scale_log2, int causal) {
  static_assert(std::is_same_v<T, bf16>, "the warpgroup path is bf16");
  static_assert(D % 64 == 0, "the 128-byte swizzle needs d % 64 == 0");
  constexpr int KS = D / 16;  // k-steps of Q K^T
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (ptt::smem_addr(smem_raw) & 1023)) & 1023));
  bf16* ring = Qs + kBQ16 * D;  // stage s: K at ring + 2s*64*D, V after it

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ16;  // most keys first
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const long q_row = (long)hq * D;  // [b, s, h, d] row strides
  const long kv_row = (long)hkv * D;
  const bf16* qb = q + (long)b * sq * q_row + (long)h * D;
  const bf16* kb = k + (long)b * sk * kv_row + (long)kvh * D;
  const bf16* vb = v + (long)b * sk * kv_row + (long)kvh * D;
  const int off = sk - sq;
  const int rg = q0 + 64 * wg;    // the warpgroup's first row
  const int r0 = rg + 16 * warp;  // this warp's first row
  const int n_tiles = key_tiles(q0, sq, sk, causal);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const auto load_kv = [&](int t) {
    bf16* Ks = ring + (t & 1) * 2 * kBK16 * D;
    const int k0 = t * kBK16;
    cp_tile_sw128<D, kBK16>(Ks, kb + k0 * kv_row, kv_row, sk - k0, kb);
    cp_tile_sw128<D, kBK16>(Ks + kBK16 * D, vb + k0 * kv_row, kv_row,
                            sk - k0, vb);
    ptt::cp_async_commit();
  };

  if (n_tiles > 0) {
    cp_tile_sw128<D, kBQ16>(Qs, qb + q0 * q_row, q_row, sq - q0, qb);
    load_kv(0);  // one group: Q and the first K / V tile
  }
  const bf16* Qw = Qs + 8 * wg * 512;  // the warpgroup's 8 row blocks
  for (int t = 0; t < n_tiles; ++t) {
    ptt::cp_async_wait<0>();
    ptt::fence_proxy_async();  // the copies are visible to wgmma's reads
    // tile t (and at t = 0 the Q tile) has landed, and every warp is done
    // with tile t - 1, whose stage the next copy reuses
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1);
    const int k0 = t * kBK16;
    const bf16* Ks = ring + (t & 1) * 2 * kBK16 * D;
    const bf16* Vs = Ks + kBK16 * D;
    // a warpgroup whose last row sees no key of this tile skips it
    if (causal && k0 > rg + 63 + off) continue;
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    ptt::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // column block ks / 4 (R / 8 atoms each), 32 bytes a k-step within
      // it; 8-row blocks 1,024 bytes apart
      const int col = (ks % 4) * 16;
      ptt::wgmma_ss_n64(
          s, ptt::gmma_desc_sw128(Qw + (ks / 4) * 16 * 512 + col, 16, 1024),
          ptt::gmma_desc_sw128(Ks + (ks / 4) * 8 * 512 + col, 16, 1024));
    }
    ptt::wgmma_commit();
    ptt::wgmma_wait<0>();
    ptt::fence_operands(s);
    uint32_t pf[4][4];
    softmax_tile(s, o, m, l, pf,
                 (causal && k0 + kBK16 - 1 > r0 + off) || k0 + kBK16 > sk,
                 r0, k0, sk, off, causal, scale_log2);
    ptt::wgmma_fence();
    // V as the transposed (MN-major) B: key blocks 2 kk, 2 kk + 1 (1,024
    // bytes apart), column blocks 8 atoms apart
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ptt::wgmma_rs_n128_t(o, pf[kk],
                           ptt::gmma_desc_sw128(Vs + 2 * kk * 512,
                                                (kBK16 / 8) * 1024, 1024));
    ptt::wgmma_commit();
    ptt::wgmma_wait<0>();
    ptt::fence_operands(o);
  }
  store_rows<D>(o, m, l, out, lse, r0, sq, q_row,
                (long)b * sq * q_row + (long)h * D, (long)bh * sq);
}

template <int D>
int launch_wg(const void* q, const void* k, const void* v, void* out,
              void* lse, int b, int hq, int hkv, int sq, int sk, float scale,
              int causal, int device, cudaStream_t stream) {
  constexpr size_t bytes = wg_smem_bytes<D>();
  cudaError_t err = ptt::allow_smem<flash_fwd_wg_kernel<bf16, D>>(
      device, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * hq, (sq + kBQ16 - 1) / kBQ16);
  flash_fwd_wg_kernel<bf16, D><<<grid, kWgThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), hq, hkv, sq, sk, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int hq, int hkv, int sq, int sk, float scale, int causal,
           int device, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = ptt::allow_smem<flash_fwd_kernel<T, D>>(device,
                                                            (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * hq, (sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), hq, hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared-memory bytes one block uses at head_dim d and dtype
// (0 = fp32, 1 = bf16); 0: not built.
int ptt_flash_smem_bytes(int d, int dtype) {
  if (dtype == 0)
    return d == 64 ? (int)smem_bytes<64>()
                   : d == 128 ? (int)smem_bytes<128>() : 0;
  switch (d) {
    case 32: return (int)tc_smem_bytes<32>();
    case 64: return (int)tc_smem_bytes<64>();
    case 80: return (int)tc_smem_bytes<80>();
    case 96: return (int)tc_smem_bytes<96>();
    case 128: return (int)wg_smem_bytes<128>();
  }
  return 0;
}

// q [b, sq, hq, d], k/v [b, sk, hkv, d] contiguous; out like q; lse
// [b*hq, sq] fp32. dtype 0 = fp32 (d 64 or 128, CUDA cores), 1 = bf16
// (d 32, 64, 80 or 96 on mma.sync, d 128 on wgmma).
int ptt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int b, int hq, int hkv, int sq, int sk, int d,
                  float scale, int causal, int dtype, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_ARGS q, k, v, out, lse, b, hq, hkv, sq, sk, scale, causal, \
                 device, s
  if (dtype == 0 && d == 64) return launch<float, 64>(PTT_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(PTT_ARGS);
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_tc<32>(PTT_ARGS);
      case 64: return launch_tc<64>(PTT_ARGS);
      case 80: return launch_tc<80>(PTT_ARGS);
      case 96: return launch_tc<96>(PTT_ARGS);
      case 128: return launch_wg<128>(PTT_ARGS);
    }
  }
#undef PTT_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
