// Flash attention backward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_bwd_fused_kernel (the
// causal / no-mask / no-varlen branch of flash_bwd_impl): dq, dk and dv from
// the forward's lse and delta = rowsum(do * out), recomputing
//   s = scale * q k^T   (bottom-right causal: row + sk - sq >= col)
//   p = exp(s - lse),  dv += p^T do,  dp = do v^T,  ds = p * (dp - delta),
//   dk += scale * ds^T q,  dq += scale * ds k,
// with the Pallas kernel's casts: p is rounded to do's type before p^T do,
// ds to q's type before both of its products. Rows whose lse is 1e30 (they
// saw no key in the forward) get p = 0 and so no gradient.
//
// Design. The TPU kernel keeps a full-sequence fp32 dq accumulator resident
// in VMEM while its sequential grid walks the k blocks; blocks on the GPU
// run in parallel and in no order, so nothing can carry over between them.
// Here one 256-thread block per (batch, kv head, 64-key block) holds K_j and
// V_j in shared memory, walks the q heads of its GQA group and, for each,
// the 64-row q blocks from the first one the causal mask lets see the key
// block; dk and dv accumulate in fp32 registers across all of them (so GQA
// group sums happen in fp32 inside the block, and dk, dv are written once,
// in kv heads). dq is summed across key blocks with fp32 atomicAdd into a
// zeroed [b, sq, hq, d] buffer: the order of those adds changes from run to
// run, so dq is not bit-deterministic (dk and dv are). Ragged tails are
// masked in the kernel, so any sq and sk work.
//
// What bounds it on the H100: at gpt3-760m's [8, 1024, 12, 128] causal the
// four products are ~64 GFLOP, about 0.96 ms at the fp32 CUDA-core peak and
// 0.065 ms on bf16 tensor cores; the inputs and outputs are ~100 MB (bf16),
// 0.03 ms. So the bound is operations. This first kernel runs its products
// on CUDA cores out of fp32 shared-memory tiles (4 x 4 score tiles and
// 4 x D/16 accumulator tiles per thread); mma/wgmma, TMA and a second,
// deterministic dq pass are later work.
#include "common.cuh"

namespace {

using ptt::load_rows;
using ptt::store;

constexpr int kBQ = 64;          // q rows per inner step
constexpr int kBK = 64;          // keys per block
constexpr int kThreads = 256;    // 16 row groups x 16 column groups
constexpr int kTR = 4;           // score rows (and dk/dv rows) per thread
constexpr int kTC = 4;           // score columns per thread
constexpr int kPS = kBK + 1;     // padded row stride of the P and dS tiles

template <int D>
constexpr size_t smem_bytes() {
  // Ks, Vs: [64][D+1]; Qs, dOs: [64][D+1]; Ps, dSs: [64][65]; lse, delta: [64]
  return sizeof(float) *
         (2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBQ * kPS + 2 * kBQ);
}

// x rounded to T and back: the Pallas kernel's `.astype` before a product
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                 int sq, int sk, float scale, int causal) {
  constexpr int DC = D / 16;  // accumulator columns per thread
  constexpr int P = D + 1;    // padded row stride of the q/k/v/do tiles
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * P;
  float* Qs = Vs + kBK * P;
  float* dOs = Qs + kBQ * P;
  float* Ps = dOs + kBQ * P;
  float* dSs = Ps + kBQ * kPS;
  float* lse_s = dSs + kBQ * kPS;
  float* delta_s = lse_s + kBQ;

  const int b = blockIdx.x / hkv, kvh = blockIdx.x % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long q_row = (long)hq * D;  // [b, s, h, d] row strides
  const long kv_row = (long)hkv * D;
  const int off = sk - sq;

  {
    const T* src[2] = {k + ((long)b * sk + k0) * kv_row + (long)kvh * D,
                       v + ((long)b * sk + k0) * kv_row + (long)kvh * D};
    float* dst[2] = {Ks, Vs};
    const int pitch[2] = {P, P};
    load_rows<T, D, 2>(src, dst, pitch, [=](int r) { return r * kv_row; },
                       kBK, sk - k0);
  }

  float dk_acc[kTR][DC], dv_acc[kTR][DC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // first q block with a row that sees key k0: row >= k0 - off
  const int n_qb = (sq + kBQ - 1) / kBQ;
  const int lower = causal ? max(k0 - off, 0) / kBQ : 0;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long bh = (long)b * hq + h;
    const T* qb = q + (long)b * sq * q_row + (long)h * D;
    const T* dob = dout + (long)b * sq * q_row + (long)h * D;
    for (int qi = lower; qi < n_qb; ++qi) {
      const int q0 = qi * kBQ;
      __syncthreads();  // the previous step's readers of Qs/dOs/Ps/dSs are done
      {
        const T* src[2] = {qb + q0 * q_row, dob + q0 * q_row};
        float* dst[2] = {Qs, dOs};
        const int pitch[2] = {P, P};
        load_rows<T, D, 2>(src, dst, pitch,
                           [=](int r) { return r * q_row; }, kBQ, sq - q0);
      }
      if (tid < kBQ) {
        const bool ok = q0 + tid < sq;
        lse_s[tid] = ok ? lse[bh * sq + q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta[bh * sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s = q k^T and dp = do v^T: rows ty + 16 i, columns tx + 16 j
      float s[kTR][kTC], dp[kTR][kTC];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int kk = 0; kk < D; ++kk) {
        float a[kTR], o[kTR], kb[kTC], vb[kTC];
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          a[i] = Qs[(ty + 16 * i) * P + kk];
          o[i] = dOs[(ty + 16 * i) * P + kk];
        }
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          kb[j] = Ks[(tx + 16 * j) * P + kk];
          vb[j] = Vs[(tx + 16 * j) * P + kk];
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTC; ++j) {
            s[i][j] = fmaf(a[i], kb[j], s[i][j]);
            dp[i][j] = fmaf(o[i], vb[j], dp[i][j]);
          }
      }
      // p = exp(s - lse) where the key is visible (else 0); ds = p (dp - delta)
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int r = ty + 16 * i;
        const int row = q0 + r;
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          const int c = tx + 16 * j;
          const int col = k0 + c;
          const bool ok = row < sq && col < sk && (!causal || col <= row + off);
          const float p = ok ? expf(scale * s[i][j] - lse_s[r]) : 0.f;
          Ps[r * kPS + c] = round_to(p, T());
          dSs[r * kPS + c] = round_to(p * (dp[i][j] - delta_s[r]), T());
        }
      }
      __syncthreads();

      // dv += p^T do and dk += ds^T q: key rows ty + 16 i, columns tx + 16 j
      for (int r = 0; r < kBQ; ++r) {
        float pc[kTR], ds[kTR], o[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          pc[i] = Ps[r * kPS + ty + 16 * i];
          ds[i] = dSs[r * kPS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          o[j] = dOs[r * P + tx + 16 * j];
          qv[j] = Qs[r * P + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            dv_acc[i][j] = fmaf(pc[i], o[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], qv[j], dk_acc[i][j]);
          }
      }

      // this key block's share of dq = scale * ds k, added into fp32 dq
      float dq_acc[kTR][DC];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) dq_acc[i][j] = 0.f;
      for (int c = 0; c < kBK; ++c) {
        float ds[kTR], kv[DC];
#pragma unroll
        for (int i = 0; i < kTR; ++i) ds[i] = dSs[(ty + 16 * i) * kPS + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) kv[j] = Ks[c * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j)
            dq_acc[i][j] = fmaf(ds[i], kv[j], dq_acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= sq) continue;
        float* dst = dq + ((long)b * sq + row) * q_row + (long)h * D;
#pragma unroll
        for (int j = 0; j < DC; ++j)
          atomicAdd(dst + tx + 16 * j, scale * dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    const long base = ((long)b * sk + key) * kv_row + (long)kvh * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      store(dk + base + tx + 16 * j, scale * dk_acc[i][j]);
      store(dv + base + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int b, int hq, int hkv, int sq, int sk, float scale, int causal,
           int device, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = ptt::allow_smem<flash_bwd_kernel<T, D>>(device,
                                                            (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * hkv, (sk + kBK - 1) / kBK);
  flash_bwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), hq,
      hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared-memory bytes one block uses at head_dim d (0: unsupported).
int ptt_flash_bwd_smem_bytes(int d) {
  return d == 64 ? (int)smem_bytes<64>() : d == 128 ? (int)smem_bytes<128>()
                                                     : 0;
}

// q, dout [b, sq, hq, d] and k, v [b, sk, hkv, d] contiguous; lse, delta
// [b*hq, sq] fp32; dq [b, sq, hq, d] fp32 and ZEROED (the kernel adds into
// it); dk, dv like k. dtype: 0 = fp32, 1 = bf16. d: 64 or 128.
int ptt_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, void* dk, void* dv, int b, int hq, int hkv,
                  int sq, int sk, int d, float scale, int causal, int dtype,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_ARGS q, k, v, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq, sk, \
                 scale, causal, device, s
  if (dtype == 0 && d == 64) return launch<float, 64>(PTT_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(PTT_ARGS);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(PTT_ARGS);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(PTT_ARGS);
#undef PTT_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
