// Fused LayerNorm and tanh-GELU, forward and backward, for Hopper (sm_90a),
// fp32 or bf16 activations with parameters of the same type.
//
// Replaces paddle_tpu/ops/pallas/fused_mlp.py::_ln_fwd_kernel,
// ::_ln_bwd_kernel, ::_gelu_fwd_kernel and ::_gelu_bwd_kernel, one C entry
// each, and computes what they compute:
// - LN forward: s = x (+ r) in fp32; mean = mean(s); var = mean((s -
//   mean)^2) (the two-pass formula, not E[s^2] - mean^2); rstd =
//   rsqrt(var + eps); y = (s - mean) * rstd * g + b in fp32, cast once.
//   With the residual, s is written rounded to x's type, while the
//   statistics and y come from the unrounded fp32 s, as in the Pallas
//   kernel; the backward then reads the rounded s.
// - LN backward: xhat = (s - mean) * rstd, dxhat = dy * g, dx = rstd *
//   (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) (+ dso, in fp32),
//   and per band of rows fp32 partials of dgamma = sum(dy * xhat) and
//   dbeta = sum(dy). The wrapper sums the bands outside the kernel, where
//   the reference sums its per-block partials in XLA: deterministic, no
//   atomics.
// - GELU forward: u = x (+ bias) in fp32, y = 0.5 u (1 + tanh(K0 (u + A
//   u^3))) cast once. GELU backward recomputes u and the tanh from the
//   saved GEMM output (nothing else is saved) and gives dx = dy * gelu'(u)
//   and, with a bias, per-band fp32 partials of dbias = sum(dx32).
// Unlike the Pallas kernels, which need rows to split into whole blocks
// and h to be a multiple of 128, these take any rows and any h up to
// kMaxH: every chunk masks the ragged end of its row.
//
// What bounds them on the H100: bytes, all four. At the flagship shapes
// (LN [8192, 1536], GELU [8192, 6144], bf16) an element costs one tanh and
// about 20 FLOPs at most, a few microseconds of CUDA-core time against
// 15-90 us of memory traffic at 3.35 TB/s. So the design reads each input
// element once and writes each output element once, with 16-byte vector
// loads and stores where the rows allow them:
// - LayerNorm keeps a whole row in registers (a block of 32-512 threads
//   per row, each holding up to kLnElems elements in 16-byte chunks),
//   reduces the row's sums across the block
//   with warp shuffles and one shared-memory exchange, and writes y (and s)
//   from the same registers: no second read of the row. The backward walks
//   a band of rows per block and keeps its columns' dgamma / dbeta sums in
//   registers across the band, so only one fp32 partial row per band goes
//   out.
// - GELU is elementwise: a block of kGeluThreads threads owns a strip of
//   kGeluThreads 16-byte columns and walks a band of rows, kGeluUnroll rows
//   at a time (their loads issued together), with the strip's bias in
//   registers and, in the backward, its dbias sums.
// Not yet near the bound where the LN backward's partials add bytes (one
// fp32 row per band of ~16 rows) and where blocks of few threads leave the
// card's memory pipes shallow; a persistent, pipelined version is later
// work.
#include "common.cuh"

#include <cstdint>

namespace {

using ptt::to_f;

constexpr float kK0 = 0.7978845608028654f;  // sqrt(2 / pi), _K0
constexpr float kA = 0.044715f;             // _A
constexpr int kLnElems = 16;     // row elements an LN thread holds
constexpr int kLnThreads = 512;  // most threads of an LN block (128 registers)
constexpr int kMaxH = kLnElems * kLnThreads;  // widest row: 8192
constexpr int kGeluThreads = 128;
constexpr int kGeluUnroll = 4;

// one 16-byte vector of T as fp32 values
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Elements [e0, e0 + V) of a row of h elements, as fp32; zero past h. One
// 16-byte load when `vec` (16-byte aligned rows, h % V == 0).
template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* row, int e0, int h,
                                           bool vec, float (&f)[V]) {
  if (vec) {
    ptt::unpack(__ldg(reinterpret_cast<const uint4*>(row + e0)), f);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = e0 + i < h ? to_f(row[e0 + i]) : 0.f;
  }
}

// Store elements [e0, e0 + V) of a row of h elements, rounded to T once.
template <typename T, int V>
__device__ __forceinline__ void store_chunk(T* row, int e0, int h, bool vec,
                                            const float (&f)[V]) {
  if (vec) {
    *reinterpret_cast<uint4*>(row + e0) = pack(f);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (e0 + i < h) store1(row + e0 + i, f[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* row, int e0, int h,
                                          const float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (e0 + i < h) row[e0 + i] = f[i];
}

// Sum each of v[0..N) over the block (a multiple of 32 threads); every
// thread gets the sums. red: 32 * N floats of shared memory. The sums are
// taken in one fixed order, so a row's result does not depend on timing.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * 32 + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float t = 0.f;
    for (int w = 0; w < nw; ++w) t += red[i * 32 + w];
    v[i] = t;
  }
}

struct LnFwdArgs {
  const void* x;    // [rows, h] T
  const void* r;    // [rows, h] T or null
  const void* g;    // [h] T
  const void* b;    // [h] T
  void* y;          // [rows, h] T
  void* s;          // [rows, h] T (with r)
  float* mean;      // [rows]
  float* rstd;      // [rows]
  int rows, h;
  float eps;
  int vec;
};

// one block per row; thread t holds chunks t, t + blockDim, ... of it
template <typename T, bool kRes>
__global__ void __launch_bounds__(kLnThreads) ln_fwd_kernel(LnFwdArgs p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kLnFwdPer = kLnElems / V;
  __shared__ float red[32];
  const int h = p.h;
  const bool vec = p.vec;
  const size_t base = (size_t)blockIdx.x * h;
  const T* x = static_cast<const T*>(p.x) + base;
  float v[kLnFwdPer][V];
  float sum[1] = {0.f};
#pragma unroll
  for (int j = 0; j < kLnFwdPer; ++j) {
    const int e0 = (threadIdx.x + j * blockDim.x) * V;
    if (e0 < h) {
      load_chunk<T, V>(x, e0, h, vec, v[j]);
      if constexpr (kRes) {
        float rr[V];
        load_chunk<T, V>(static_cast<const T*>(p.r) + base, e0, h, vec, rr);
#pragma unroll
        for (int i = 0; i < V; ++i) v[j][i] += rr[i];
        store_chunk<T, V>(static_cast<T*>(p.s) + base, e0, h, vec, v[j]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) sum[0] += v[j][i];  // zero past h
    }
  }
  block_sum(sum, red);
  const float mean = sum[0] / (float)h;
  float sq[1] = {0.f};
#pragma unroll
  for (int j = 0; j < kLnFwdPer; ++j) {
    const int e0 = (threadIdx.x + j * blockDim.x) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (e0 + i < h) {
        const float c = v[j][i] - mean;
        sq[0] += c * c;
      }
    }
  }
  block_sum(sq, red);
  const float rstd = rsqrtf(sq[0] / (float)h + p.eps);
#pragma unroll
  for (int j = 0; j < kLnFwdPer; ++j) {
    const int e0 = (threadIdx.x + j * blockDim.x) * V;
    if (e0 < h) {
      float g[V], b[V], out[V];
      load_chunk<T, V>(static_cast<const T*>(p.g), e0, h, vec, g);
      load_chunk<T, V>(static_cast<const T*>(p.b), e0, h, vec, b);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = (v[j][i] - mean) * rstd * g[i] + b[i];
      store_chunk<T, V>(static_cast<T*>(p.y) + base, e0, h, vec, out);
    }
  }
  if (threadIdx.x == 0) {
    p.mean[blockIdx.x] = mean;
    p.rstd[blockIdx.x] = rstd;
  }
}

struct LnBwdArgs {
  const void* dy;     // [rows, h] T
  const void* dso;    // [rows, h] T or null
  const void* s;      // [rows, h] T: the LN input (rounded s with a residual)
  const float* mean;  // [rows]
  const float* rstd;  // [rows]
  const void* g;      // [h] T
  void* dx;           // [rows, h] T
  float* dg_part;     // [bands, h]
  float* db_part;     // [bands, h]
  int rows, h, band, vec;
};

// one block per band of `band` rows; a row at a time in registers
template <typename T, bool kDso>
__global__ void __launch_bounds__(kLnThreads) ln_bwd_kernel(LnBwdArgs p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kLnBwdPer = kLnElems / V;
  __shared__ float red[64];
  const int h = p.h;
  const bool vec = p.vec;
  float g[kLnBwdPer][V], dg[kLnBwdPer][V], db[kLnBwdPer][V];
#pragma unroll
  for (int j = 0; j < kLnBwdPer; ++j) {
    const int e0 = (threadIdx.x + j * blockDim.x) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) g[j][i] = dg[j][i] = db[j][i] = 0.f;
    if (e0 < h) load_chunk<T, V>(static_cast<const T*>(p.g), e0, h, vec, g[j]);
  }
  const int r0 = blockIdx.x * p.band;
  const int r1 = min(p.rows, r0 + p.band);
  for (int row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * h;
    const float mu = p.mean[row], rs = p.rstd[row];
    float dy[kLnBwdPer][V], xh[kLnBwdPer][V];
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kLnBwdPer; ++j) {
      const int e0 = (threadIdx.x + j * blockDim.x) * V;
#pragma unroll
      for (int i = 0; i < V; ++i) dy[j][i] = xh[j][i] = 0.f;
      if (e0 < h) {
        load_chunk<T, V>(static_cast<const T*>(p.dy) + base, e0, h, vec, dy[j]);
        load_chunk<T, V>(static_cast<const T*>(p.s) + base, e0, h, vec, xh[j]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (e0 + i < h) {
          xh[j][i] = (xh[j][i] - mu) * rs;
          const float d = dy[j][i] * g[j][i];
          m[0] += d;
          m[1] += d * xh[j][i];
          dg[j][i] += dy[j][i] * xh[j][i];
          db[j][i] += dy[j][i];
        }
      }
    }
    block_sum(m, red);
    const float m1 = m[0] / (float)h, m2 = m[1] / (float)h;
#pragma unroll
    for (int j = 0; j < kLnBwdPer; ++j) {
      const int e0 = (threadIdx.x + j * blockDim.x) * V;
      if (e0 < h) {
        float out[V];
#pragma unroll
        for (int i = 0; i < V; ++i)
          out[i] = rs * (dy[j][i] * g[j][i] - m1 - xh[j][i] * m2);
        if constexpr (kDso) {
          float so[V];
          load_chunk<T, V>(static_cast<const T*>(p.dso) + base, e0, h, vec, so);
#pragma unroll
          for (int i = 0; i < V; ++i) out[i] += so[i];
        }
        store_chunk<T, V>(static_cast<T*>(p.dx) + base, e0, h, vec, out);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLnBwdPer; ++j) {
    const int e0 = (threadIdx.x + j * blockDim.x) * V;
    if (e0 < h) {
      store_f32(p.dg_part + (size_t)blockIdx.x * h, e0, h, dg[j]);
      store_f32(p.db_part + (size_t)blockIdx.x * h, e0, h, db[j]);
    }
  }
}

struct GeluArgs {
  const void* dy;    // [rows, n] T (backward)
  const void* x;     // [rows, n] T: the GEMM output
  const void* bias;  // [n] T or null
  void* out;         // [rows, n] T: y (forward) or dx (backward)
  float* db_part;    // [bands, n] (backward with a bias) or null
  int rows, n, band, vec;
};

__device__ __forceinline__ float gelu_f(float u) {
  const float t = tanhf(kK0 * (u + kA * u * u * u));
  return 0.5f * u * (1.f + t);
}

__device__ __forceinline__ float gelu_grad(float u) {
  const float u2 = u * u;
  const float t = tanhf(kK0 * (u + kA * u * u2));
  return 0.5f * (1.f + t) +
         0.5f * u * (1.f - t * t) * kK0 * (1.f + 3.f * kA * u2);
}

// block (strip, band): kGeluThreads chunks of columns x `band` rows
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kGeluThreads) gelu_kernel(GeluArgs p) {
  constexpr int V = 16 / sizeof(T);
  const int n = p.n;
  const bool vec = p.vec;
  const int e0 = (blockIdx.x * kGeluThreads + threadIdx.x) * V;
  if (e0 >= n) return;
  float bias[V], acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) bias[i] = acc[i] = 0.f;
  if (p.bias) load_chunk<T, V>(static_cast<const T*>(p.bias), e0, n, vec, bias);
  const int r0 = blockIdx.y * p.band;
  const int r1 = min(p.rows, r0 + p.band);
  const T* x = static_cast<const T*>(p.x);
  const T* dyp = static_cast<const T*>(p.dy);
  T* out = static_cast<T*>(p.out);
  for (int row = r0; row < r1; row += kGeluUnroll) {
    float u[kGeluUnroll][V], d[kGeluUnroll][kBwd ? V : 1];
#pragma unroll
    for (int k = 0; k < kGeluUnroll; ++k) {
      if (row + k < r1) {
        const size_t base = (size_t)(row + k) * n;
        load_chunk<T, V>(x + base, e0, n, vec, u[k]);
        if constexpr (kBwd) load_chunk<T, V>(dyp + base, e0, n, vec, d[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kGeluUnroll; ++k) {
      if (row + k < r1) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float uu = u[k][i] + bias[i];
          if constexpr (kBwd) {
            o[i] = d[k][i] * gelu_grad(uu);
            acc[i] += o[i];
          } else {
            o[i] = gelu_f(uu);
          }
        }
        store_chunk<T, V>(out + (size_t)(row + k) * n, e0, n, vec, o);
      }
    }
  }
  if (kBwd && p.db_part) store_f32(p.db_part + (size_t)blockIdx.y * n, e0, n, acc);
}

// threads of an LN block: enough 32-thread warps that each thread holds at
// most kLnElems elements of the row; 0 when the row is wider than kMaxH
int ln_threads(int h, int V) {
  if (h <= 0 || h > kMaxH) return 0;
  const int per = kLnElems / V;
  const int chunks = (h + V - 1) / V;
  const int t = ((chunks + per - 1) / per + 31) / 32 * 32;
  return t <= kLnThreads ? t : 0;
}

template <bool kBwd>
int gelu_launch(const void* dy, const void* x, const void* bias, void* out,
                void* db_part, int rows, int n, int band, int vec, int dtype,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || n <= 0 || band <= 0) return (int)cudaErrorInvalidValue;
  const GeluArgs p{dy, x, bias, out, static_cast<float*>(db_part), rows, n,
                   band, vec};
  const int V = dtype == 0 ? 4 : 8;
  const int bands = (rows + band - 1) / band;
  if (bands > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kGeluThreads * V - 1) / (kGeluThreads * V), bands);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gelu_kernel<float, kBwd><<<grid, kGeluThreads, 0, st>>>(p);
  else if (dtype == 1)
    gelu_kernel<__nv_bfloat16, kBwd><<<grid, kGeluThreads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, r (or null), g, b, y, s (or null, with r), mean, rstd [rows] fp32.
// vec: every row and vector 16-byte aligned and h a multiple of 16 bytes.
// dtype: 0 = fp32, 1 = bf16 (x, r, g, b, y, s).
int ptt_ln_fwd(const void* x, const void* r, const void* g, const void* b,
               void* y, void* s, void* mean, void* rstd, int rows, int h,
               float eps, int vec, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = ln_threads(h, dtype == 0 ? 4 : 8);
  if (!threads || rows <= 0 || (r == nullptr) != (s == nullptr))
    return (int)cudaErrorInvalidValue;
  const LnFwdArgs p{x, r, g, b, y, s, static_cast<float*>(mean),
                    static_cast<float*>(rstd), rows, h, eps, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool res = r != nullptr;
  if (dtype == 0 && !res) ln_fwd_kernel<float, false><<<rows, threads, 0, st>>>(p);
  else if (dtype == 0) ln_fwd_kernel<float, true><<<rows, threads, 0, st>>>(p);
  else if (dtype == 1 && !res)
    ln_fwd_kernel<__nv_bfloat16, false><<<rows, threads, 0, st>>>(p);
  else if (dtype == 1)
    ln_fwd_kernel<__nv_bfloat16, true><<<rows, threads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dy, dso (or null), s, mean, rstd, g, dx; dg_part and db_part [bands, h]
// fp32 with bands = ceil(rows / band).
int ptt_ln_bwd(const void* dy, const void* dso, const void* s,
               const void* mean, const void* rstd, const void* g, void* dx,
               void* dg_part, void* db_part, int rows, int h, int band,
               int vec, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = ln_threads(h, dtype == 0 ? 4 : 8);
  if (!threads || rows <= 0 || band <= 0) return (int)cudaErrorInvalidValue;
  const LnBwdArgs p{dy, dso, s, static_cast<const float*>(mean),
                    static_cast<const float*>(rstd), g, dx,
                    static_cast<float*>(dg_part), static_cast<float*>(db_part),
                    rows, h, band, vec};
  const int bands = (rows + band - 1) / band;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_dso = dso != nullptr;
  if (dtype == 0 && !has_dso)
    ln_bwd_kernel<float, false><<<bands, threads, 0, st>>>(p);
  else if (dtype == 0) ln_bwd_kernel<float, true><<<bands, threads, 0, st>>>(p);
  else if (dtype == 1 && !has_dso)
    ln_bwd_kernel<__nv_bfloat16, false><<<bands, threads, 0, st>>>(p);
  else if (dtype == 1)
    ln_bwd_kernel<__nv_bfloat16, true><<<bands, threads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x [rows, n], bias [n] or null, y [rows, n]
int ptt_gelu_fwd(const void* x, const void* bias, void* y, int rows, int n,
                 int band, int vec, int dtype, int device, void* stream) {
  return gelu_launch<false>(nullptr, x, bias, y, nullptr, rows, n, band, vec,
                            dtype, device, stream);
}

// dy, x [rows, n], bias [n] or null, dx [rows, n], db_part [bands, n] fp32
// (null without a bias)
int ptt_gelu_bwd(const void* dy, const void* x, const void* bias, void* dx,
                 void* db_part, int rows, int n, int band, int vec,
                 int dtype, int device, void* stream) {
  return gelu_launch<true>(dy, x, bias, dx, db_part, rows, n, band, vec,
                           dtype, device, stream);
}

}  // extern "C"
