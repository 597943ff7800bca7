// Flash attention forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (the
// causal / no-mask / no-varlen branch): blocked attention with the
// FlashAttention-2 online softmax, bottom-right causal alignment
// (row r sees columns <= r + sk - sq), GQA by reading kv head h / group,
// fully masked rows give out = 0 and lse = 1e30. Unlike the Pallas kernel,
// whose blocks had to divide the sequence, this one masks its own ragged
// tail, so any sq and sk work.
//
// What bounds it on the H100: at GPT-125M's [4, 512, 12, 64] the inputs
// are 6 MB, 2 us at 3.35 TB/s, and the causal work is ~1.6 GFLOP, 24 us at
// the fp32 CUDA-core peak (67 TFLOP/s) or 1.6 us on bf16 tensor cores —
// so the bound is operations. This first kernel is simple and right, not
// fast: one 128-thread block per (b*hq, 64-row q tile) walks the k tiles up
// to the causal bound, keeps Q, one K tile, one V tile and the score tile
// in shared memory as fp32, and each thread owns an 8 x 4 register tile of
// scores and an 8 x (D/16) register tile of the output accumulator. The
// products run on CUDA cores, so it cannot reach the tensor-core bound;
// mma/wgmma, TMA and a pipelined K/V ring are later work.
#include "common.cuh"

namespace {

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

// Dynamic shared-memory bytes one block uses at head_dim d (0: unsupported).
int ptt_flash_smem_bytes(int d) {
  return d == 64 ? (int)smem_bytes<64>() : d == 128 ? (int)smem_bytes<128>()
                                                     : 0;
}

// q [b, sq, hq, d], k/v [b, sk, hkv, d] contiguous; out like q; lse
// [b*hq, sq] fp32. dtype: 0 = fp32, 1 = bf16. d: 64 or 128.
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
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(PTT_ARGS);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(PTT_ARGS);
#undef PTT_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
