// Fused LayerNorm and tanh-GELU, forward and backward, for Hopper (sm_90a),
// fp32, bf16 or fp16 activations with parameters of the same type.
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
//   u^3))) cast once, computed as the equal u sigma(2 K0 (u + A u^3)).
//   GELU backward recomputes u from the saved GEMM output (nothing else is
//   saved) and gives dx = dy * gelu'(u) and, with a bias, dbias =
//   sum(dx32) in fp32: per-band partial rows, added in band order by the
//   last block of each strip.
// Unlike the Pallas kernels, which need rows to split into whole blocks
// and h to be a multiple of 128, these take any rows and any h up to
// kMaxH: every chunk masks the ragged end of its row.
//
// What bounds them on the H100: bytes, all four. At the flagship shapes
// (LN [8192, 1536], GELU [8192, 6144], bf16) an element costs one
// exponential and about 20 FLOPs at most, a few microseconds of CUDA-core time against
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
// - GELU is elementwise and streams (redesigned to run at the card's
//   memory rate): a launch plan (ops/fused_mlp.py gelu_plan) cuts the rows
//   into blocks of kGeluThreads threads, each a strip of 16-byte column
//   chunks by a band of rows, small enough (two rows a thread) that the
//   card's block scheduler keeps every SM fed to the end: one persistent
//   wave of long bands is slower, its blocks ending unevenly (gelu_plans.py
//   times both).
//   Each thread walks its chunk down the band with up to kGeluFwdDepth /
//   kGeluBwdDepth rows' streamed loads in flight
//   (ld.global.nc.L1::no_allocate, st.global.cs), the next rows' loads
//   issued before a row's math. The math is u sigma(2z) with one ex2 and
//   one reciprocal on the MUFU pipe (see gelu_f) in place of libdevice's
//   tanhf. The bias and the dbias sums stay in registers; the band's dbias
//   is summed across the block in shared memory, the partial rows stay
//   under 0.5% of the backward's bytes (longer bands there), and the
//   strip's last block adds them up: no second launch.
// The LN kernels are not yet near the bound where the LN backward's
// partials add bytes (one fp32 row per band of ~16 rows); a persistent,
// pipelined version is later work.
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
constexpr int kGeluFwdDepth = 4;  // rows a forward thread has in flight
constexpr int kGeluBwdDepth = 2;  // backward: two inputs a row

using ptt::store;

// Elements [e0, e0 + V) of a row of h elements, as fp32; zero past h. One
// 16-byte load when `vec` (16-byte aligned rows, h % V == 0).
template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* row, int e0, int h,
                                           bool vec, float (&f)[V]) {
  if (vec) {
    ptt::unpack<T>(__ldg(reinterpret_cast<const uint4*>(row + e0)), f);
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
    *reinterpret_cast<uint4*>(row + e0) = ptt::pack<T>(f);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (e0 + i < h) store(row + e0 + i, f[i]);
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
  const void* bias;  // [n] T (kBias)
  void* out;         // [rows, n] T: y (forward) or dx (backward)
  float* db_part;    // [bands, n] fp32 (backward with a bias): workspace
  float* dbias;      // [n] fp32 (backward with a bias)
  int* counters;     // [strips], zero on entry and on exit
  int rows, n;
  int strip;         // 16-byte chunks of a row a block owns (a power of 2)
  int band;          // rows a block walks
};

// The tanh form's 0.5 u (1 + tanh z) is u sigma(2z) = u / (1 + e^(-2z)):
// one ex2 and one reciprocal on the MUFU pipe instead of libdevice's tanhf
// (a branch, an exponential, a reciprocal and a polynomial). The base-2
// exponent -2 log2(e) z = u (kC1 + kC2 u^2).
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kC1 = -2.f * kLog2e * kK0;
constexpr float kC2 = -2.f * kLog2e * kK0 * kA;
constexpr float kD1 = 2.f * kK0;
constexpr float kD2 = 3.f * kA;

// 2^x to ~2 ulp; +inf past 128, +0 below -126
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// 1 / x to ~1 ulp; 0 for inf, and for x >= 2^126 (a subnormal flushed)
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// u sigma(2z). Large negative u: e = inf, 1 / inf = 0, y = -0 (the tanh
// form's 0.5 u (1 - 1)); u = -inf gives -inf * 0 = NaN as it does there.
__device__ __forceinline__ float gelu_f(float u) {
  return u * rcp(1.f + ex2(u * fmaf(kC2, u * u, kC1)));
}

// gelu'(u) = s + 2 K0 u s (1 - s) (1 + 3 A u^2) with s = sigma(2z) and
// 1 - s = e s taken as a product, not a difference, so it keeps its
// relative precision where s -> 1. The exponent is clamped at 127: past
// it s flushes to exactly 0 (1 / 2^127 is subnormal) and the second term
// is u * 0 * ..., finite for finite u^2, as the tanh form's (1 - t^2) = 0
// gives; without the clamp e = inf and e * s = inf * 0 = NaN. NaN and
// +-inf give NaN, as there.
__device__ __forceinline__ float gelu_grad(float u) {
  const float u2 = u * u;
  const float e = ex2(fminf(u * fmaf(kC2, u2, kC1), 127.f));
  const float s = rcp(1.f + e);
  return fmaf(kD1 * u * s, (e * s) * fmaf(kD2, u2, 1.f), s);
}

// one 16-byte chunk, streamed: read once, not kept in L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}
// written once: evict first
__device__ __forceinline__ void st_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Elements [e0, e0 + V) of a row as raw bits: one streamed 16-byte load
// when kVec, else element by element, zero past n.
template <typename T, bool kVec>
__device__ __forceinline__ uint4 gelu_load(const T* row, int e0, int n) {
  if constexpr (kVec) {
    return ld_stream(row + e0);
  } else {
    constexpr int V = 16 / sizeof(T);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (e0 + i < n) e[i] = row[e0 + i];
    return v;
  }
}

template <typename T, bool kVec, int V>
__device__ __forceinline__ void gelu_store(T* row, int e0, int n,
                                           const float (&f)[V]) {
  if constexpr (kVec) {
    st_stream(row + e0, ptt::pack<T>(f));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (e0 + i < n) store(row + e0 + i, f[i]);
  }
}

// Block (strip, band) of kGeluThreads threads: thread t owns the 16-byte
// chunk blockIdx.x * strip + t % strip of every row and walks the band's
// rows t / strip, + lanes, + 2 lanes, ... (lanes = kGeluThreads / strip),
// with up to kDepth rows' loads in flight: the loads of row i + kDepth *
// lanes go out before row i's math. Its columns never change, so the bias
// and the dbias sums stay in registers; at the end the lanes' sums meet in
// shared memory, a thread a column adds them in lane order into the band's
// fp32 partial row, and the strip's last block adds the bands' rows in
// band order (deterministic: no float atomics).
template <typename T, bool kBwd, bool kBias, bool kVec>
__global__ void __launch_bounds__(kGeluThreads, 8) gelu_kernel(GeluArgs p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kDepth = kBwd ? kGeluBwdDepth : kGeluFwdDepth;
  const int n = p.n, strip = p.strip, lanes = kGeluThreads / strip;
  const int lane = (int)threadIdx.x / strip;
  const int e0 = ((int)blockIdx.x * strip + (int)threadIdx.x % strip) * V;
  const bool col = e0 < n;
  const int r0 = (int)blockIdx.y * p.band + lane;
  const int r1 = min(p.rows, ((int)blockIdx.y + 1) * p.band);
  const T* x = static_cast<const T*>(p.x);
  const T* dyp = static_cast<const T*>(p.dy);
  T* out = static_cast<T*>(p.out);
  float bias[V], acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) bias[i] = acc[i] = 0.f;
  if (kBias && col)
    ptt::unpack<T>(gelu_load<T, kVec>(static_cast<const T*>(p.bias), e0, n),
                   bias);
  uint4 xr[kDepth], dr[kBwd ? kDepth : 1];
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    xr[k] = dr[kBwd ? k : 0] = make_uint4(0u, 0u, 0u, 0u);
    const int row = r0 + k * lanes;
    if (col && row < r1) {
      xr[k] = gelu_load<T, kVec>(x + (size_t)row * n, e0, n);
      if constexpr (kBwd)
        dr[k] = gelu_load<T, kVec>(dyp + (size_t)row * n, e0, n);
    }
  }
  if (col) {
    for (int base = r0; base < r1; base += kDepth * lanes) {
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int row = base + k * lanes;
        if (row >= r1) break;
        float u[V], d[kBwd ? V : 1];
        ptt::unpack<T>(xr[k], u);
        if constexpr (kBwd) ptt::unpack<T>(dr[k], d);
        const int next = row + kDepth * lanes;
        if (next < r1) {
          xr[k] = gelu_load<T, kVec>(x + (size_t)next * n, e0, n);
          if constexpr (kBwd)
            dr[k] = gelu_load<T, kVec>(dyp + (size_t)next * n, e0, n);
        }
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float uu = kBias ? u[i] + bias[i] : u[i];
          if constexpr (kBwd) {
            o[i] = d[i] * gelu_grad(uu);
            if constexpr (kBias) acc[i] += o[i];
          } else {
            o[i] = gelu_f(uu);
          }
        }
        gelu_store<T, kVec>(out + (size_t)row * n, e0, n, o);
      }
    }
  }
  if constexpr (kBwd && kBias) {
    __shared__ float red[kGeluThreads * V];
    __shared__ bool last;
    const int w = strip * V;  // the strip's columns: at most kGeluThreads
    const int s = (int)threadIdx.x % strip;
#pragma unroll
    for (int i = 0; i < V; ++i) red[lane * w + s * V + i] = acc[i];
    __syncthreads();
    // one thread a column adds the lanes in lane order
    const int c = (int)blockIdx.x * w + (int)threadIdx.x;
    if ((int)threadIdx.x < w && c < n) {
      float t = 0.f;
      for (int l = 0; l < lanes; ++l) t += red[l * w + threadIdx.x];
      p.db_part[(size_t)blockIdx.y * n + c] = t;
      __threadfence();  // only the row's writers wait for their stores
    }
    // The strip's last block to finish sums its columns' partial rows into
    // dbias: threads of group g take bands g, g + groups, ... in order,
    // then the groups add up in order, so the sum does not depend on which
    // block came last. Loads go to L2 (__ldcg): other SMs wrote the rows.
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(p.counters + blockIdx.x, 1) == (int)gridDim.y - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    constexpr int Q = kVec ? 4 : 1;  // columns a load (float4 on kVec rows)
    const int cols = w / Q, groups = kGeluThreads / cols;
    const int q = (int)threadIdx.x % cols, g = (int)threadIdx.x / cols;
    const int c0 = (int)blockIdx.x * w + q * Q;
    float v[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) v[j] = 0.f;
    if (c0 < n) {
#pragma unroll 8
      for (int b = g; b < (int)gridDim.y; b += groups) {
        const float* row = p.db_part + (size_t)b * n + c0;
        if constexpr (kVec) {
          const float4 f = __ldcg(reinterpret_cast<const float4*>(row));
          v[0] += f.x;
          v[1] += f.y;
          v[2] += f.z;
          v[3] += f.w;
        } else {
          v[0] += __ldcg(row);
        }
      }
    }
    __syncthreads();  // red's readers above are done
#pragma unroll
    for (int j = 0; j < Q; ++j) red[(g * cols + q) * Q + j] = v[j];
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        float t = 0.f;
        for (int k = 0; k < groups; ++k) t += red[(k * cols + q) * Q + j];
        if (c0 + j < n) p.dbias[c0 + j] = t;
      }
    }
    if (threadIdx.x == 0) p.counters[blockIdx.x] = 0;  // for the next launch
  }
}

template <bool kBwd, typename T>
void (*gelu_kernel_of(bool bias, bool vec))(GeluArgs) {
  if (bias)
    return vec ? gelu_kernel<T, kBwd, true, true>
               : gelu_kernel<T, kBwd, true, false>;
  return vec ? gelu_kernel<T, kBwd, false, true>
             : gelu_kernel<T, kBwd, false, false>;
}

template <bool kBwd>
void (*gelu_kernel_for(bool bias, bool vec, int dtype))(GeluArgs) {
  if (dtype == 0) return gelu_kernel_of<kBwd, float>(bias, vec);
  if (dtype == 1) return gelu_kernel_of<kBwd, __nv_bfloat16>(bias, vec);
  if (dtype == 2) return gelu_kernel_of<kBwd, __half>(bias, vec);
  return nullptr;
}

template <bool kBwd>
int gelu_launch(const void* dy, const void* x, const void* bias, void* out,
                void* db_part, void* dbias, void* counters, int rows, int n,
                int strip, int band, int vec, int dtype, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = gelu_kernel_for<kBwd>(bias != nullptr, vec != 0, dtype);
  const bool pow2 = strip > 0 && (strip & (strip - 1)) == 0;
  if (!kernel || rows <= 0 || n <= 0 || band <= 0 || !pow2 ||
      strip > kGeluThreads / 8 ||
      (kBwd && bias && !(db_part && dbias && counters)))
    return (int)cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8;
  const int strips = ((n + V - 1) / V + strip - 1) / strip;
  const int bands = (rows + band - 1) / band;
  if (bands > 65535) return (int)cudaErrorInvalidValue;
  const GeluArgs p{dy, x, bias, out, static_cast<float*>(db_part),
                   static_cast<float*>(dbias), static_cast<int*>(counters),
                   rows, n, strip, band};
  kernel<<<dim3(strips, bands), kGeluThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
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

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, r (or null), g, b, y, s (or null, with r), mean, rstd [rows] fp32.
// vec: every row and vector 16-byte aligned and h a multiple of 16 bytes.
// dtype: 0 = fp32, 1 = bf16, 2 = fp16 (x, r, g, b, y, s).
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
  else if (dtype == 2 && !res)
    ln_fwd_kernel<__half, false><<<rows, threads, 0, st>>>(p);
  else if (dtype == 2)
    ln_fwd_kernel<__half, true><<<rows, threads, 0, st>>>(p);
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
  else if (dtype == 2 && !has_dso)
    ln_bwd_kernel<__half, false><<<bands, threads, 0, st>>>(p);
  else if (dtype == 2)
    ln_bwd_kernel<__half, true><<<bands, threads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x [rows, n], bias [n] or null, y [rows, n]. strip (a power of 2, at
// most kGeluThreads / 8 chunks), band: the launch plan (ops/fused_mlp.py
// gelu_plan); vec: every row and the bias 16-byte aligned and n a multiple
// of 16 bytes.
int ptt_gelu_fwd(const void* x, const void* bias, void* y, int rows, int n,
                 int strip, int band, int vec, int dtype, int device,
                 void* stream) {
  return gelu_launch<false>(nullptr, x, bias, y, nullptr, nullptr, nullptr,
                            rows, n, strip, band, vec, dtype, device, stream);
}

// dy, x [rows, n], bias [n] or null, dx [rows, n]; with a bias db_part
// [bands, n] fp32 workspace (bands = ceil(rows / band)), dbias [n] fp32
// and counters [strips] int32, zero (and left zero); null without
int ptt_gelu_bwd(const void* dy, const void* x, const void* bias, void* dx,
                 void* db_part, void* dbias, void* counters, int rows, int n,
                 int strip, int band, int vec, int dtype, int device,
                 void* stream) {
  return gelu_launch<true>(dy, x, bias, dx, db_part, dbias, counters, rows,
                           n, strip, band, vec, dtype, device, stream);
}

}  // extern "C"
