// Ragged paged attention for Hopper (sm_90a), fp32 and bf16 K/V pools.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_ragged_kernel (its
// fp branch; the int8-KV branch is a later slice). Computes what that
// kernel computes, not how: for each (sequence b, kv head h) the
// R = chunk * group query rows (chunk-major, GQA group minor) attend that
// sequence's pages through its page-table row, with the per-row causal
// limit min(kv_len - q_len + row / group + 1, kv_len), an online softmax
// across pages and fp32 accumulation. A lane with q_len == 0 writes zeros;
// rows past q_len write zeros too (the Pallas kernel leaves garbage there,
// the jnp reference zeroes them; callers read valid rows only).
//
// Translation: the TPU grid's sequential page axis becomes a loop inside
// one block; the block reads its own page-table row and walks only
// ceil(kv_len / page_size) pages — pages past the context are skipped,
// not re-fetched. Entries are clipped to [0, num_pages) as the Pallas
// index map clips them.
//
// What bounds it on the H100: bytes. Each (b, h) pair must read kv_len *
// d K and V values once; at GPT-125M serving (max_batch 8, 12 heads,
// d 64, contexts up to 1024) that is up to 50 MB in fp32, ~15 us at
// 3.35 TB/s, while the products are a few MFLOP. The design reads each
// page once from device memory into shared memory (16-byte loads, a batch
// in flight per thread), keeps Q, the accumulator and the running max /
// sum of all R rows on chip for the whole walk, spreads the scores and
// the P @ V products of a page over all 256 threads (a decode lane's
// single row included), and writes each output row once. It is NOT yet
// near the bound: one block per (b, h) gives only 8 * 12 = 96 blocks for
// 132 SMs at max_batch 8, and each block walks its pages one after another
// with no load/compute overlap. Splitting the page walk across blocks
// (with a second combine pass) and a cp.async/TMA ring are later work.
#include "common.cuh"

namespace {

using ptt::load_rows;
using ptt::store;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Qs [R][D], Ks [ps][D+1], Vs [ps][D], Ss [R][ps], Acc [R][D],
// m, l, alpha [R], visible columns [R]
size_t smem_floats(int rows, int ps, int d) {
  return (size_t)rows * d + (size_t)ps * (d + 1) + (size_t)ps * d +
         (size_t)rows * ps + (size_t)rows * d + 4 * (size_t)rows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                         const T* __restrict__ vp,
                         const int* __restrict__ page_table,
                         const int* __restrict__ kv_lens,
                         const int* __restrict__ q_lens, T* __restrict__ out,
                         int chunk, int hq, int hkv, int num_pages, int ps,
                         int pps, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  const int rows = chunk * group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv_len = kv_lens[b];
  const int q_len = min(max(q_lens[b], 0), chunk);
  const int nvalid_rows = q_len * group;

  // row r <-> (query token r / group, q head h * group + r % group)
  auto row_off = [=](int r) {
    return (((long)b * chunk + r / group) * hq + h * group + r % group) * D;
  };
  for (int i = nvalid_rows * D + tid; i < rows * D; i += kThreads)
    store(out + row_off(i / D) + i % D, 0.f);
  if (nvalid_rows == 0) return;

  float* Qs = smem;
  float* Ks = Qs + rows * D;
  float* Vs = Ks + ps * (D + 1);
  float* Ss = Vs + ps * D;
  float* Acc = Ss + rows * ps;
  float* Ms = Acc + rows * D;
  float* Ls = Ms + rows;
  float* Alpha = Ls + rows;
  int* Ncols = reinterpret_cast<int*>(Alpha + rows);

  {
    const T* src[1] = {q};
    float* dst[1] = {Qs};
    const int pitch[1] = {D};
    load_rows<T, D, 4>(src, dst, pitch, row_off, nvalid_rows, nvalid_rows);
  }
  for (int i = tid; i < nvalid_rows * D; i += kThreads) Acc[i] = 0.f;
  for (int r = tid; r < nvalid_rows; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }
  const long page_elems = (long)ps * hkv * D;
  const long row_stride = (long)hkv * D;
  const int n_pages = (kv_len + ps - 1) / ps;
  for (int p = 0; p < n_pages; ++p) {
    const int page = min(max(page_table[(long)b * pps + p], 0), num_pages - 1);
    const T* src[2] = {kp + page * page_elems + (long)h * D,
                       vp + page * page_elems + (long)h * D};
    float* dst[2] = {Ks, Vs};
    const int pitch[2] = {D + 1, D};
    __syncthreads();  // the previous page's readers are done
    load_rows<T, D, 8>(src, dst, pitch,
                       [=](int r) { return r * row_stride; }, ps, ps);
    __syncthreads();
    // scores of every (row, key) pair, four independent partial sums
    for (int i = tid; i < nvalid_rows * ps; i += kThreads) {
      const float* qr = Qs + (i / ps) * D;
      const float* kr = Ks + (i % ps) * (D + 1);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        s0 = fmaf(qr[c], kr[c], s0);
        s1 = fmaf(qr[c + 1], kr[c + 1], s1);
        s2 = fmaf(qr[c + 2], kr[c + 2], s2);
        s3 = fmaf(qr[c + 3], kr[c + 3], s3);
      }
      Ss[i] = ((s0 + s1) + (s2 + s3)) * scale;
    }
    __syncthreads();
    // online softmax, one warp per row, over the page's columns below the
    // row's causal limit; P overwrites the scores
    for (int r = warp; r < nvalid_rows; r += kWarps) {
      const int limit = min(kv_len - q_len + r / group + 1, kv_len);
      const int ncols = min(max(limit - p * ps, 0), ps);
      if (ncols == 0) {
        if (lane == 0) {
          Alpha[r] = 1.f;
          Ncols[r] = 0;
        }
        continue;
      }
      float* sr = Ss + r * ps;
      float mx = kNegInf;
      for (int j = lane; j < ncols; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < ncols; j += 32) {
        const float pj = expf(sr[j] - m_new);
        sr[j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Alpha[r] = alpha;
        Ncols[r] = ncols;
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + sum;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V for every (row, column) output
    for (int i = tid; i < nvalid_rows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int n = Ncols[r];
      const float* pr = Ss + r * ps;
      float a0 = 0.f, a1 = 0.f;
      int j = 0;
#pragma unroll 4
      for (; j + 1 < n; j += 2) {
        a0 = fmaf(pr[j], Vs[j * D + c], a0);
        a1 = fmaf(pr[j + 1], Vs[(j + 1) * D + c], a1);
      }
      if (j < n) a0 = fmaf(pr[j], Vs[j * D + c], a0);
      Acc[i] = Acc[i] * Alpha[r] + (a0 + a1);
    }
  }
  __syncthreads();
  for (int i = tid; i < nvalid_rows * D; i += kThreads) {
    const float l = Ls[i / D];
    store(out + row_off(i / D) + i % D, l > 0.f ? Acc[i] / l : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* kv_lens, const void* q_lens, void* out, int b,
           int chunk, int hq, int hkv, int num_pages, int ps, int pps,
           float scale, int device, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(chunk * (hq / hkv), ps, D);
  cudaError_t err = ptt::allow_smem<ragged_paged_attn_kernel<T, D>>(
      device, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, hkv);
  ragged_paged_attn_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens),
      static_cast<T*>(out), chunk, hq, hkv, num_pages, ps, pps, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes one block needs (a launch past the 227 KB a block may
// use fails with the driver's error).
int ptt_ragged_smem_bytes(int rows, int ps, int d) {
  return (int)(sizeof(float) * smem_floats(rows, ps, d));
}

// q/out [b, chunk, hq, d]; pools [num_pages, ps, hkv, d]; page_table
// [b, pps] int32; kv_lens, q_lens [b] int32, all contiguous.
// dtype: 0 = fp32, 1 = bf16. d: 64 or 128.
int ptt_ragged_paged_attention(const void* q, const void* kp, const void* vp,
                               const void* pt, const void* kv_lens,
                               const void* q_lens, void* out, int b,
                               int chunk, int hq, int hkv, int num_pages,
                               int ps, int pps, int d, float scale,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_ARGS q, kp, vp, pt, kv_lens, q_lens, out, b, chunk, hq, hkv, \
                 num_pages, ps, pps, scale, device, s
  if (dtype == 0 && d == 64) return launch<float, 64>(PTT_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(PTT_ARGS);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(PTT_ARGS);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(PTT_ARGS);
#undef PTT_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
