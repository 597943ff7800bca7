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
//   and dgamma = sum(dy * xhat), dbeta = sum(dy) in fp32, summed inside the
//   launch in a fixed order (deterministic, no float atomics), where the
//   reference sums its per-block partials in XLA.
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
// - The LN forward keeps a whole row in registers (a block of 32-512
//   threads per row, each holding up to kLnElems elements in 16-byte
//   chunks), reduces the row's sums across the block with warp shuffles and
//   one shared-memory exchange, and writes y (and s) from the same
//   registers: no second read of the row.
// - The LN backward (redesigned to stream at the card's memory rate) runs a
//   persistent grid, at most one block an SM, each block owning one
//   contiguous band of rows (ops/fused_mlp.py ln_bwd_plan). A block is
//   `groups` row groups of whole warps; a group takes the band's rows k, k
//   + groups, ... and its thread t holds 16-byte chunks t, t + threads, ...
//   of each (one chunk where a row fits 768 threads, two or, fp32 rows
//   past 4096, four). The next row's dy, s (and dso) are in flight in
//   registers, streamed (ld.global.nc.L1::no_allocate), while the current
//   row is reduced (warp shuffles, and across a group's warps a named
//   barrier of the group, never a block-wide one) and dx is stored
//   (st.global.cs). Each thread keeps its columns' dgamma / dbeta sums in
//   registers over all its rows; the groups' sums meet in shared memory
//   and are added in group order, the block writes one fp32 partial row,
//   and the partial rows are added in block order by a two-level tree of
//   last arrivals (sets of ~sqrt(blocks) blocks, then the sets), so no
//   block adds more than ~sqrt(blocks) rows and the launch ends with
//   dgamma and dbeta written: no second launch. A ring of the next rows
//   in shared memory (cp.async, three rows in flight) ran slower on the
//   H100 than one row ahead in registers (PERF.md, the LN backward).
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
#include "common.cuh"

#include <cstdint>

namespace {

using ptt::to_f;

constexpr float kK0 = 0.7978845608028654f;  // sqrt(2 / pi), _K0
constexpr float kA = 0.044715f;             // _A
constexpr int kLnElems = 16;     // row elements an LN thread holds
constexpr int kLnThreads = 512;  // most threads of an LN block (128 registers)
constexpr int kMaxH = kLnElems * kLnThreads;  // widest row: 8192
constexpr int kLnBwdThreads = 768;  // most threads of an LN backward block
                                     // at one chunk a thread (80 registers)
constexpr int kLnBwdWide = 512;     // at two or four chunks (128 registers)
constexpr int kLnBwdGroups = 15;    // row groups of more than one warp a
                                    // block: named barriers 1-15
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
__device__ __forceinline__ uint4 stream_load(const T* row, int e0, int n) {
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
__device__ __forceinline__ void stream_store(T* row, int e0, int n,
                                           const float (&f)[V]) {
  if constexpr (kVec) {
    st_stream(row + e0, ptt::pack<T>(f));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (e0 + i < n) store(row + e0 + i, f[i]);
  }
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
  float* dgamma;      // [h]
  float* dbeta;       // [h]
  float* part;        // [blocks + sets, 2, h]: each block's sums, then each
                      // set's (scratch)
  int* counters;      // [sets + 1]: zero on entry and on exit
  int rows, h;
  int threads;        // a row group's threads (whole warps)
  int band;           // rows a block owns
  int set;            // blocks a first-level set adds up
  int vec;
};

// Sum m over a row group of `warps` warps, group k of the block: warp
// shuffles (every lane gets the same sum: a butterfly adds the same pairs
// on both sides), then with more than one warp the warps' sums in warp
// order through shared memory after the group's own barrier (id 1 + k), no
// block-wide one. red is one of two buffers, alternated by row: a warp
// writes a buffer again only after the next row's barrier, which every
// reader of the buffer reaches after its reads.
__device__ __forceinline__ void group_sum(float (&m)[2], float (*red)[2],
                                          int k, int warps) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[i] += __shfl_xor_sync(0xffffffffu, m[i], off);
  if (warps == 1) return;
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5][0] = m[0];
    red[threadIdx.x >> 5][1] = m[1];
  }
  asm volatile("bar.sync %0, %1;" ::"r"(1 + k), "r"(32 * warps) : "memory");
  m[0] = m[1] = 0.f;
  for (int w = k * warps; w < (k + 1) * warps; ++w) {
    m[0] += red[w][0];
    m[1] += red[w][1];
  }
}

constexpr int kSumBatch = 8;  // partial rows a thread has in flight
                               // (ops/fused_mlp.py LN_BWD_BATCH)

// Over the [2, h] fp32 rows src[r * 2h], r < n: dgamma[c] = the sum in row
// order of their first halves, dbeta[c] of their second halves. The
// block's threads take a column each (four, float4, when h % 4 == 0),
// with up to kSumBatch rows' loads in flight, read from L2 (__ldcg: other
// blocks wrote the rows).
__device__ __forceinline__ void sum_rows(const float* src, int n, int h,
                                         float* dgamma, float* dbeta) {
  const size_t w = 2 * (size_t)h;
  if ((h & 3) == 0) {
    for (int c = 4 * (int)threadIdx.x; c < (int)w; c += 4 * (int)blockDim.x) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r0 = 0; r0 < n; r0 += kSumBatch) {
        float4 v[kSumBatch];
#pragma unroll
        for (int i = 0; i < kSumBatch; ++i)
          if (r0 + i < n)
            v[i] = __ldcg(reinterpret_cast<const float4*>(
                src + (r0 + i) * w + c));
#pragma unroll
        for (int i = 0; i < kSumBatch; ++i) {
          if (r0 + i < n) {
            a.x += v[i].x;
            a.y += v[i].y;
            a.z += v[i].z;
            a.w += v[i].w;
          }
        }
      }
      *reinterpret_cast<float4*>(c < h ? dgamma + c : dbeta + (c - h)) = a;
    }
  } else {
    for (int c = threadIdx.x; c < (int)w; c += blockDim.x) {
      float a = 0.f;
      for (int r0 = 0; r0 < n; r0 += kSumBatch) {
        float v[kSumBatch];
#pragma unroll
        for (int i = 0; i < kSumBatch; ++i)
          if (r0 + i < n) v[i] = __ldcg(src + (r0 + i) * w + c);
#pragma unroll
        for (int i = 0; i < kSumBatch; ++i)
          if (r0 + i < n) a += v[i];
      }
      *(c < h ? dgamma + c : dbeta + (c - h)) = a;
    }
  }
}

// One row's inputs as a thread holds them: its chunks t, t + threads, ...
// of dy, s (and dso) as raw 16-byte vectors, zero past h, and the row's
// mean and rstd.
template <typename T, bool kDso, int C>
struct LnRow {
  uint4 dy[C], s[C], so[kDso ? C : 1];
  float mu, rs;

  __device__ __forceinline__ void load(const LnBwdArgs& p, int row, int t,
                                       bool vec) {
    constexpr int V = 16 / sizeof(T);
    const size_t base = (size_t)row * p.h;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int e0 = (t + j * p.threads) * V;
      dy[j] = s[j] = so[kDso ? j : 0] = make_uint4(0u, 0u, 0u, 0u);
      if (e0 < p.h) {
        dy[j] = ld(static_cast<const T*>(p.dy) + base, e0, p.h, vec);
        s[j] = ld(static_cast<const T*>(p.s) + base, e0, p.h, vec);
        if constexpr (kDso)
          so[j] = ld(static_cast<const T*>(p.dso) + base, e0, p.h, vec);
      }
    }
    mu = __ldg(p.mean + row);
    rs = __ldg(p.rstd + row);
  }
  // streamed (read once, not kept in L1)
  __device__ __forceinline__ static uint4 ld(const T* row, int e0, int h,
                                             bool vec) {
    return vec ? stream_load<T, true>(row, e0, h)
               : stream_load<T, false>(row, e0, h);
  }
};

// Block b owns rows [b band, (b + 1) band); its group k (threads
// [k threads, (k + 1) threads)) takes rows k, k + groups, ... of the band,
// thread t of the group chunks t + j threads, j < C, of each row. With
// kAhead (one or two chunks a thread) the next row's loads go out before
// the current row's math; four chunks have no registers for two rows and
// read g from L1 each row. groups > 1: dynamic shared memory of groups x
// 2 h floats for the groups' column sums.
template <typename T, bool kDso, int C>
__global__ void __launch_bounds__(C == 1 ? kLnBwdThreads : kLnBwdWide, 1)
    ln_bwd_kernel(LnBwdArgs p) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool kAhead = C < 4;
  extern __shared__ float4 sums4[];
  __shared__ float red[2][32][2];
  __shared__ bool last;
  const int h = p.h, threads = p.threads;
  const bool vec = p.vec;
  const int groups = (int)blockDim.x / threads;
  const int k = (int)threadIdx.x / threads, t = (int)threadIdx.x % threads;
  uint4 g[kAhead ? C : 1];
  float dg[C][V], db[C][V];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int e0 = (t + j * threads) * V;
    if constexpr (kAhead) {
      g[j] = make_uint4(0u, 0u, 0u, 0u);
      if (e0 < h) g[j] = LnRow<T, kDso, C>::ld(static_cast<const T*>(p.g), e0, h, vec);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) dg[j][i] = db[j][i] = 0.f;
  }
  auto gload = [&](int j, int e0) -> uint4 {
    if constexpr (kAhead) return g[j];
    else return vec ? __ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(p.g) + e0))
                    : stream_load<T, false>(static_cast<const T*>(p.g), e0, h);
  };
  const int r1 = min(p.rows, ((int)blockIdx.x + 1) * p.band);
  int row = (int)blockIdx.x * p.band + k;
  LnRow<T, kDso, C> cur, nxt;
  if (kAhead && row < r1) cur.load(p, row, t, vec);
  int parity = 0;
  for (; row < r1; row += groups) {
    if constexpr (kAhead) {
      if (row + groups < r1) nxt.load(p, row + groups, t, vec);
    } else {
      cur.load(p, row, t, vec);
    }
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int e0 = (t + j * threads) * V;
      if (e0 < h) {
        float dy[V], x[V], gg[V];
        ptt::unpack<T>(cur.dy[j], dy);
        ptt::unpack<T>(cur.s[j], x);
        ptt::unpack<T>(gload(j, e0), gg);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (x[i] - cur.mu) * cur.rs;
          const float d = dy[i] * gg[i];
          m[0] += d;
          m[1] += d * xh;
          dg[j][i] += dy[i] * xh;
          db[j][i] += dy[i];
        }
      }
    }
    group_sum(m, red[parity], k, threads / 32);
    parity ^= 1;
    const float m1 = m[0] / (float)h, m2 = m[1] / (float)h;
    T* dx = static_cast<T*>(p.dx) + (size_t)row * h;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int e0 = (t + j * threads) * V;
      if (e0 < h) {
        float dy[V], x[V], gg[V], out[V];
        ptt::unpack<T>(cur.dy[j], dy);
        ptt::unpack<T>(cur.s[j], x);
        ptt::unpack<T>(gload(j, e0), gg);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (x[i] - cur.mu) * cur.rs;
          out[i] = cur.rs * (dy[i] * gg[i] - m1 - xh * m2);
        }
        if constexpr (kDso) {
          float so[V];
          ptt::unpack<T>(cur.so[j], so);
#pragma unroll
          for (int i = 0; i < V; ++i) out[i] += so[i];
        }
        if (vec)
          stream_store<T, true>(dx, e0, h, out);
        else
          stream_store<T, false>(dx, e0, h, out);
      }
    }
    if constexpr (kAhead) cur = nxt;
  }

  // the block's partial row: the groups' column sums added in group order
  const size_t w = 2 * (size_t)h;
  float* mine = p.part + blockIdx.x * w;
  if (groups == 1) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int e0 = (t + j * threads) * V;
      if (e0 < h) {
        store_f32(mine, e0, h, dg[j]);
        store_f32(mine + h, e0, h, db[j]);
      }
    }
  } else {
    // group k's sums at sums[k w, (k + 1) w) (a float4 per four columns:
    // a warp's stores hit every bank once), one barrier, then a column a
    // thread adds the groups in order
    float* sums = reinterpret_cast<float*>(sums4) + k * w;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int e0 = (t + j * threads) * V;
      if (e0 + V <= h && (h & 3) == 0) {
#pragma unroll
        for (int i = 0; i < V; i += 4) {
          *reinterpret_cast<float4*>(sums + e0 + i) = make_float4(
              dg[j][i], dg[j][i + 1], dg[j][i + 2], dg[j][i + 3]);
          *reinterpret_cast<float4*>(sums + h + e0 + i) = make_float4(
              db[j][i], db[j][i + 1], db[j][i + 2], db[j][i + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (e0 + i < h) {
            sums[e0 + i] = dg[j][i];
            sums[h + e0 + i] = db[j][i];
          }
        }
      }
    }
    __syncthreads();
    const float* all = reinterpret_cast<const float*>(sums4);
    for (int c = threadIdx.x; c < (int)w; c += blockDim.x) {
      float a = all[c];
      for (int q = 1; q < groups; ++q) a += all[q * w + c];
      mine[c] = a;
    }
  }
  // The last block of each set of `set` blocks adds the set's rows in block
  // order; the last set to finish adds the sets' rows in set order into
  // dgamma and dbeta. So the sums do not depend on which block came last,
  // and each counter is back to 0 for the next launch (CUDA-graph replays).
  __threadfence();
  __syncthreads();
  const int blocks = (int)gridDim.x, set = p.set;
  const int sets = (blocks + set - 1) / set, si = (int)blockIdx.x / set;
  const int b0 = si * set, nb = min(set, blocks - b0);
  if (threadIdx.x == 0) last = atomicAdd(p.counters + si, 1) == nb - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (sets == 1) {
    sum_rows(p.part + b0 * w, nb, h, p.dgamma, p.dbeta);
    if (threadIdx.x == 0) p.counters[si] = 0;
    return;
  }
  float* level2 = p.part + (blocks + si) * w;
  sum_rows(p.part + b0 * w, nb, h, level2, level2 + h);
  if (threadIdx.x == 0) p.counters[si] = 0;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.counters + sets, 1) == sets - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_rows(p.part + blocks * w, sets, h, p.dgamma, p.dbeta);
  if (threadIdx.x == 0) p.counters[sets] = 0;
}

template <typename T, bool kDso, int C>
int ln_bwd_launch(const LnBwdArgs& p, int blocks, int nt, int smem,
                  int device, cudaStream_t stream) {
  const cudaError_t err =
      ptt::allow_smem<ln_bwd_kernel<T, kDso, C>>(device, smem);
  if (err != cudaSuccess) return (int)err;
  ln_bwd_kernel<T, kDso, C><<<blocks, nt, smem, stream>>>(p);
  return (int)cudaGetLastError();
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
    ptt::unpack<T>(stream_load<T, kVec>(static_cast<const T*>(p.bias), e0, n),
                   bias);
  uint4 xr[kDepth], dr[kBwd ? kDepth : 1];
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    xr[k] = dr[kBwd ? k : 0] = make_uint4(0u, 0u, 0u, 0u);
    const int row = r0 + k * lanes;
    if (col && row < r1) {
      xr[k] = stream_load<T, kVec>(x + (size_t)row * n, e0, n);
      if constexpr (kBwd)
        dr[k] = stream_load<T, kVec>(dyp + (size_t)row * n, e0, n);
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
          xr[k] = stream_load<T, kVec>(x + (size_t)next * n, e0, n);
          if constexpr (kBwd)
            dr[k] = stream_load<T, kVec>(dyp + (size_t)next * n, e0, n);
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
        stream_store<T, kVec>(out + (size_t)row * n, e0, n, o);
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

// the LN backward launcher for T, dso and chunks a thread; four chunks
// only for fp32 (two cover every 16-bit row up to kMaxH)
using LnBwdLaunch = int (*)(const LnBwdArgs&, int, int, int, int,
                            cudaStream_t);
template <typename T>
LnBwdLaunch ln_bwd_launch_for(bool dso, int per) {
  if (per == 1)
    return dso ? ln_bwd_launch<T, true, 1> : ln_bwd_launch<T, false, 1>;
  if (per == 2)
    return dso ? ln_bwd_launch<T, true, 2> : ln_bwd_launch<T, false, 2>;
  if constexpr (std::is_same_v<T, float>) {
    if (per == 4)
      return dso ? ln_bwd_launch<T, true, 4> : ln_bwd_launch<T, false, 4>;
  }
  return nullptr;
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

// dy, dso (or null), s, mean, rstd, g, dx; dgamma and dbeta [h] fp32;
// part [blocks + sets, 2, h] fp32 scratch and counters [sets + 1] int32,
// zero (and left zero), with sets = ceil(blocks / set). per, threads,
// groups, band, blocks, set: the launch plan (ops/fused_mlp.py
// ln_bwd_plan); vec: every row and g 16-byte aligned and h a multiple of
// 16 bytes.
int ptt_ln_bwd(const void* dy, const void* dso, const void* s,
               const void* mean, const void* rstd, const void* g, void* dx,
               void* dgamma, void* dbeta, void* part, void* counters,
               int rows, int h, int per, int threads, int groups, int band,
               int blocks, int set, int vec, int dtype, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool has_dso = dso != nullptr;
  LnBwdLaunch launch = nullptr;
  if (dtype == 0) launch = ln_bwd_launch_for<float>(has_dso, per);
  if (dtype == 1) launch = ln_bwd_launch_for<__nv_bfloat16>(has_dso, per);
  if (dtype == 2) launch = ln_bwd_launch_for<__half>(has_dso, per);
  const int V = dtype == 0 ? 4 : 8;
  const int most = per == 1 ? kLnBwdThreads : kLnBwdWide;
  if (!launch || rows <= 0 || h <= 0 || h > kMaxH || threads <= 0 ||
      threads % 32 || groups <= 0 || threads * groups > most ||
      (threads > 32 && groups > kLnBwdGroups) ||
      (long)threads * per * V < h || band <= 0 || blocks <= 0 ||
      (long)blocks * band < rows || (long)(blocks - 1) * band >= rows ||
      set <= 0 || !(dgamma && dbeta && part && counters))
    return (int)cudaErrorInvalidValue;
  const LnBwdArgs p{dy, dso, s, static_cast<const float*>(mean),
                    static_cast<const float*>(rstd), g, dx,
                    static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                    static_cast<float*>(part), static_cast<int*>(counters),
                    rows, h, threads, band, set, vec};
  return launch(p, blocks, threads * groups, groups > 1 ? groups * 8 * h : 0,
                device, static_cast<cudaStream_t>(stream));
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
