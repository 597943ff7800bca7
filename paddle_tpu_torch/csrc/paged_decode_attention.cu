// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over its paged K/V context, fp32 and bf16 pools.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_decode_kernel (entry
// paged_attention, through _kernel_impl). Computes what that kernel
// computes, not how: for each (sequence b, kv head h) the group = hq / hkv
// query rows of that kv head attend positions [0, lengths[b]) of the
// sequence's pages read through its page-table row, with scale, an online
// softmax across pages and fp32 accumulation; one rounding to q's type at
// the end. lengths[b] <= 0 (an empty slot) writes zeros.
//
// Translation: the TPU grid's sequential page axis becomes a loop inside
// one block, and the block reads its own page-table row and lengths entry.
// Entries are clipped to [0, num_pages) as the Pallas index map clips them.
// Pages past ceil(length / page_size) are neither read nor computed (the
// TPU re-fetches the last valid page there and skips its compute), and the
// last page reads only its rows below the length. The TPU pads the GQA
// group to 8 rows for the MXU's sublane tile; here the group is not
// padded. The TPU carries a running normalized output; this kernel carries
// the unnormalized sum of p * v and the running sum l, and divides by l
// once after the last page (the same function).
//
// What bounds it on the H100: bytes. A block must read length * d K and V
// values of its kv head once; at GPT-125M's serving step (8 slots, 12
// heads of 64, contexts to 1024) that is up to 50 MB in fp32 against a few
// MFLOP. The design reads each page once from device memory into shared
// memory (16-byte loads, a batch in flight per thread), and spreads the
// page's work over all 256 threads even when the group is one row: each
// (row, key) score is split over up to 8 threads in different warps (a
// warp reads consecutive keys, so the K tile's odd pitch keeps its banks
// apart), summed in a fixed order; the P @ V products are split over key
// slices, each thread keeping its own partial accumulator in shared memory
// for the whole walk, and the slices are summed in order at the end. It is
// NOT near the bound: one block per (b, h) gives 8 * 12 = 96 blocks for
// 132 SMs at GPT-125M's max_batch 8, and each block walks its pages one
// after another with no load / compute overlap. Splitting the page walk
// across blocks (flash-decoding) is later work.
#include "common.cuh"

namespace {

using ptt::load_rows;
using ptt::store;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;  // threads one score may be split over

// largest power of two <= x, within [1, cap]
__host__ __device__ inline int pow2_floor(int x, int cap) {
  int p = 1;
  while (p * 2 <= x && p * 2 <= cap) p *= 2;
  return p;
}

// key slices of the P @ V products for `od` = group * d outputs
__host__ __device__ inline int key_slices(int od) {
  return od >= kThreads ? 1 : pow2_floor(kThreads / od, kThreads);
}

// Qs [G][D], Ks [ps][D+1], Vs [ps][D], Ss [G][ps], Part [kThreads],
// Acc [slices][G*D], m, l, alpha [G]
size_t smem_floats(int group, int ps, int d) {
  const size_t od = (size_t)group * d;
  return od + (size_t)ps * (d + 1) + (size_t)ps * d + (size_t)group * ps +
         kThreads + key_slices((int)od) * od + 3 * (size_t)group;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hq, int hkv, int num_pages, int ps, int pps,
                    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int od = group * D;  // this block's outputs: group rows of D
  // the group's query and output rows are contiguous in [b, hq, d]
  const long row0 = ((long)b * hq + (long)h * group) * D;
  T* o = out + row0;
  const int length = lengths[b];
  if (length <= 0) {
    for (int i = tid; i < od; i += kThreads) store(o + i, 0.f);
    return;
  }
  const int slices = key_slices(od);
  float* Qs = smem;
  float* Ks = Qs + od;
  float* Vs = Ks + ps * (D + 1);
  float* Ss = Vs + ps * D;
  float* Part = Ss + group * ps;
  float* Acc = Part + kThreads;
  float* Ms = Acc + slices * od;
  float* Ls = Ms + group;
  float* Alpha = Ls + group;

  {
    const T* src[1] = {q + row0};
    float* dst[1] = {Qs};
    const int pitch[1] = {D};
    load_rows<T, D, 1>(src, dst, pitch, [](int r) { return (long)r * D; },
                       group, group);
  }
  for (int i = tid; i < slices * od; i += kThreads) Acc[i] = 0.f;
  for (int r = tid; r < group; r += kThreads) {
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }
  const long page_elems = (long)ps * hkv * D;
  const long row_stride = (long)hkv * D;
  const int n_pages = min((length + ps - 1) / ps, pps);
  for (int p = 0; p < n_pages; ++p) {
    const int page = min(max(page_table[(long)b * pps + p], 0), num_pages - 1);
    const int nv = min(ps, length - p * ps);  // keys of this page in context
    const T* src[2] = {kp + page * page_elems + (long)h * D,
                       vp + page * page_elems + (long)h * D};
    float* dst[2] = {Ks, Vs};
    const int pitch[2] = {D + 1, D};
    __syncthreads();  // the previous page's readers are done
    load_rows<T, D, 8>(src, dst, pitch,
                       [=](int r) { return r * row_stride; }, nv, nv);
    __syncthreads();
    // scores of the (row, key) pairs, key fastest. `split` threads share a
    // pair, each a strided slice of D; thread = slice * np + pair, so the
    // slices of one pair sit in different warps and a warp reads
    // consecutive keys
    const int pairs = group * nv;
    const int split = pairs >= kThreads ? 1
                                        : pow2_floor(kThreads / pairs,
                                                     kMaxSplit);
    const int np = kThreads / split;
    const int sub = tid / np;
    for (int i = tid % np; i < pairs; i += np) {
      const float* qr = Qs + (i / nv) * D;
      const float* kr = Ks + (i % nv) * (D + 1);
      float s0 = 0.f, s1 = 0.f;
      for (int c = sub; c < D; c += 2 * split) {
        s0 = fmaf(qr[c], kr[c], s0);
        if (c + split < D) s1 = fmaf(qr[c + split], kr[c + split], s1);
      }
      if (split == 1)
        Ss[i] = (s0 + s1) * scale;
      else
        Part[sub * np + i] = s0 + s1;  // pairs <= np here
    }
    if (split > 1) {
      __syncthreads();
      for (int i = tid; i < pairs; i += kThreads) {
        float s = 0.f;
        for (int u = 0; u < split; ++u) s += Part[u * np + i];
        Ss[i] = s * scale;
      }
    }
    __syncthreads();
    // online softmax, one warp per row; P overwrites the scores
    for (int r = warp; r < group; r += kWarps) {
      float* sr = Ss + r * nv;
      float mx = kNegInf;
      for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nv; j += 32) {
        const float pj = expf(sr[j] - m_new);
        sr[j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Alpha[r] = alpha;
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + sum;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P @ V: output oi of key slice s sums keys
    // s, s + slices, ...; each thread owns its accumulators across pages
    for (int i = tid; i < slices * od; i += kThreads) {
      const int s = i / od, oi = i % od, r = oi / D, c = oi % D;
      const float* pr = Ss + r * nv;
      float a0 = 0.f, a1 = 0.f;
      int j = s;
      for (; j + slices < nv; j += 2 * slices) {
        a0 = fmaf(pr[j], Vs[j * D + c], a0);
        a1 = fmaf(pr[j + slices], Vs[(j + slices) * D + c], a1);
      }
      if (j < nv) a0 = fmaf(pr[j], Vs[j * D + c], a0);
      Acc[i] = Acc[i] * Alpha[r] + (a0 + a1);
    }
  }
  __syncthreads();
  for (int oi = tid; oi < od; oi += kThreads) {
    float a = 0.f;
    for (int s = 0; s < slices; ++s) a += Acc[s * od + oi];
    store(o + oi, a / Ls[oi / D]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* lengths, void* out, int b, int hq, int hkv,
           int num_pages, int ps, int pps, float scale, int device,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(hq / hkv, ps, D);
  cudaError_t err =
      ptt::allow_smem<paged_decode_kernel<T, D>>(device, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, hkv);
  paged_decode_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(pt),
      static_cast<const int*>(lengths), static_cast<T*>(out), hq, hkv,
      num_pages, ps, pps, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes one block needs for a GQA group of `group` rows (a
// launch past the 227 KB a block may use fails with the driver's error).
int ptt_paged_decode_smem_bytes(int group, int ps, int d) {
  return (int)(sizeof(float) * smem_floats(group, ps, d));
}

// q/out [b, hq, d]; pools [num_pages, ps, hkv, d] in q's type; page_table
// [b, pps] int32 (-1 unallocated); lengths [b] int32, all contiguous.
// dtype: 0 = fp32, 1 = bf16. d: 32, 64, 80, 96 or 128.
int ptt_paged_decode_attention(const void* q, const void* kp, const void* vp,
                               const void* pt, const void* lengths,
                               void* out, int b, int hq, int hkv,
                               int num_pages, int ps, int pps, int d,
                               float scale, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_ARGS q, kp, vp, pt, lengths, out, b, hq, hkv, num_pages, ps, pps, \
                 scale, device, s
#define PTT_D(DV)                                                      \
  if (d == DV) {                                                       \
    if (dtype == 0) return launch<float, DV>(PTT_ARGS);                \
    if (dtype == 1) return launch<__nv_bfloat16, DV>(PTT_ARGS);        \
  }
  PTT_D(32)
  PTT_D(64)
  PTT_D(80)
  PTT_D(96)
  PTT_D(128)
#undef PTT_D
#undef PTT_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
