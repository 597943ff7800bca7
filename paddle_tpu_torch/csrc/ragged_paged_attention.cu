// Ragged paged attention for Hopper (sm_90a): fp32, bf16 and fp16 K/V pools,
// and int8 pools with per-(page slot, kv head) fp32 scales.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_ragged_kernel (both
// its fp branch and its quant=True int8-KV branch). Computes what that
// kernel computes, not how: for each (sequence b, kv head h) the
// R = chunk * group query rows (chunk-major, GQA group minor) attend that
// sequence's pages through its page-table row, with the per-row causal
// limit min(kv_len - q_len + row / group + 1, kv_len), an online softmax
// across pages and fp32 accumulation. A lane with q_len == 0 writes zeros;
// rows past q_len write zeros too (the Pallas kernel leaves garbage there,
// the jnp reference zeroes them; callers read valid rows only). Page-table
// entries are clipped to [0, num_pages) as the Pallas index map clips
// them. int8 pages dequantize element by element (q * scale of the row's
// slot and head, fp32), as the jnp reference does; the Pallas int8 branch
// rounds them to q's dtype, this kernel keeps fp32.
//
// Translation: the TPU grid's sequential page axis becomes a split walk
// (paged_walk.cuh). The grid is (b, kv head, split), sized from shapes
// only: the page-table width over the pages a split walks, which
// ops/paged_attention.py walk_plan chooses so that a decode round (8 lanes,
// one query row each) fills the card. A block reads its own page-table
// entries and walks only the pages below its lane's context; a split that
// starts past it arrives at once. The causal limit bites only in the last
// split(s) of a lane. The last split of a (b, h) pair to arrive merges the
// splits' (acc, m, l) in split order and writes the rows (one split: the
// block writes them itself, nothing is stored between).
//
// What bounds it on the H100: bytes. Each (b, h) pair must read kv_len *
// d K and V values once; at GPT-125M serving (max_batch 8, 12 heads,
// d 64, contexts up to 1024) that is up to 50 MB in fp32, ~15 us at
// 3.35 TB/s, while the products are a few MFLOP. The design keeps three
// tiles of 32 keys in flight a block (cp.async), several blocks an SM,
// and the split partials small (fp32 rows of d + 2 values a split).
#include "paged_walk.cuh"

namespace {

using ptt::store;
using ptt::to_f;
namespace wk = ptt::walk;

struct RaggedArgs {
  const void *q, *kp, *vp;        // [b, C, hq, D] T; pools [P, ps, hkv, D]
  const float *ks, *vs;           // [P, ps, hkv] fp32, int8 pools only
  const int *pt, *kv_lens, *q_lens;
  void* out;                      // [b, C, hq, D] T
  float* part;                    // [b, hkv, splits, partial_floats(R, D)]
  int* counters;                  // [b * hkv], zero on entry
  int chunk, hq, hkv, num_pages, ps, pps, pages_per_split;
  float scale;
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(wk::kThreads)
ragged_split_kernel(const RaggedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z, Z = gridDim.z;
  const int tid = threadIdx.x;
  const int group = a.hq / a.hkv, R = a.chunk * group;
  const int kv_len = max(a.kv_lens[b], 0);
  const int q_len = min(max(a.q_lens[b], 0), a.chunk);
  const int nrows = q_len * group;
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);
  // row r <-> (query token r / group, q head h * group + r % group)
  auto row_off = [=](int r) {
    return (((long)b * a.chunk + r / group) * a.hq + h * group + r % group) *
           D;
  };
  if (z == 0)
    for (int i = nrows * D + tid; i < R * D; i += wk::kThreads)
      store(out + row_off(i / D) + i % D, 0.f);
  if (nrows == 0) return;   // every split of the pair returns here

  const int span = a.pages_per_split * a.ps;   // keys a split covers
  const int ctx_keys = min(kv_len, a.pps * a.ps);
  const int k0 = z * span, k1 = min(ctx_keys, k0 + span);
  const int nkeys = max(k1 - k0, 0);

  int* pg;
  const wk::Rows st = wk::carve<D>(smem, R, nrows, &pg);
  float* qs = st.q;
  unsigned char* ring = smem + wk::rows_bytes(R, D, a.pages_per_split);

  if (nkeys > 0) {
    for (int i = tid; i < nrows * D; i += wk::kThreads)
      qs[(i / D) * (D + 4) + i % D] = to_f(q[row_off(i / D) + i % D]);
    wk::reset<D>(st);
    const int tpp = (a.ps + wk::kKeys - 1) / wk::kKeys;   // tiles a page
    const int n = (nkeys / a.ps) * tpp +
                  (nkeys % a.ps + wk::kKeys - 1) / wk::kKeys;
    const int p0 = z * a.pages_per_split;
    wk::stage_pages(pg, a.pt + (long)b * a.pps, p0,
                    (nkeys + a.ps - 1) / a.ps, a.num_pages);
    __syncthreads();
    auto tile_of = [&](int i) {
      const int p = p0 + i / tpp, t0 = (i % tpp) * wk::kKeys;
      const int page = pg[i / tpp];
      const int key0 = p * a.ps + t0;
      return wk::TileAt{((long)page * a.ps + t0) * a.hkv + h,
                        min(min(wk::kKeys, a.ps - t0), k1 - key0), key0};
    };
    auto ncols_of = [&](int r, int key0) {
      return min(kv_len - q_len + r / group + 1, kv_len) - key0;
    };
    wk::walk<KV, D>(st, ring, static_cast<const KV*>(a.kp),
                    static_cast<const KV*>(a.vp), a.ks, a.vs, a.hkv, n,
                    tile_of, a.scale, ncols_of);
  }
  auto put = [&](int r, int c, float4 v) {
    T* o = out + row_off(r) + c;
    store(o, v.x);
    store(o + 1, v.y);
    store(o + 2, v.z);
    store(o + 3, v.w);
  };
  if (Z == 1) {   // the whole walk in this block
    if (nkeys == 0) {
      for (int i = tid; i < nrows * D; i += wk::kThreads)
        store(out + row_off(i / D) + i % D, 0.f);
    } else {
      wk::finish<D>(st, put);
    }
    return;
  }
  const long pf = wk::partial_floats(R, D);
  float* part0 = a.part + (long)(b * a.hkv + h) * Z * pf;
  if (nkeys > 0) wk::save<D>(st, part0 + z * pf, R);
  if (!wk::arrive(a.counters + b * a.hkv + h, Z)) return;
  wk::merge<D>(
      nrows, R, Z, [&](int s) { return part0 + s * pf; },
      [&](int s) { return s * span < ctx_keys; }, put);
}

template <typename T, typename KV, int D>
int launch(const RaggedArgs& a, int b, int splits, int device,
           cudaStream_t stream) {
  const int bytes =
      (int)wk::smem_bytes<KV, D>(a.chunk * (a.hq / a.hkv), a.pages_per_split);
  cudaError_t err =
      ptt::allow_smem<ragged_split_kernel<T, KV, D>>(device, bytes);
  if (err != cudaSuccess) return (int)err;
  ragged_split_kernel<T, KV, D>
      <<<dim3(b, a.hkv, splits), wk::kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared-memory bytes one block needs for R = chunk * group rows at head
// dim d walking `pages` pages a split; kv: 0 = fp32 pools, 1 = bf16, 2 =
// int8, 3 = fp16 (a launch past the 227 KB a block may use fails with CUDA's
// error).
int ptt_ragged_smem_bytes(int R, int d, int kv, int pages) {
#define PTT_D(DV)                                                      \
  if (d == DV)                                                         \
    return (int)(kv == 0   ? wk::smem_bytes<float, DV>(R, pages)           \
                 : kv == 2 ? wk::smem_bytes<int8_t, DV>(R, pages)          \
                           : wk::smem_bytes<__nv_bfloat16, DV>(R, pages));
  PTT_D(32)
  PTT_D(64)
  PTT_D(80)
  PTT_D(96)
  PTT_D(128)
#undef PTT_D
  return -1;
}

// q/out [b, chunk, hq, d]; pools [num_pages, ps, hkv, d] in q's type, or
// int8 with ks / vs the fp32 scale planes [num_pages, ps, hkv] (null for fp
// pools); page_table [b, pps] int32; kv_lens, q_lens [b] int32, all
// contiguous, q and the pools 16-byte aligned. part: splits > 1 partials
// [b, hkv, splits, R * (d + 2) rounded up to 4] fp32 (R = chunk * hq /
// hkv); counters [b * hkv] int32, zero on entry and left zero. The grid
// walks pages_per_split pages a split, splits = ceil(pps /
// pages_per_split). dtype (of q and out): 0 = fp32, 1 = bf16, 2 = fp16.
// d: 32, 64, 80, 96 or 128.
int ptt_ragged_paged_attention(const void* q, const void* kp, const void* vp,
                               const void* ks, const void* vs,
                               const void* pt, const void* kv_lens,
                               const void* q_lens, void* out, void* part,
                               void* counters, int b, int chunk, int hq,
                               int hkv, int num_pages, int ps, int pps,
                               int d, int pages_per_split, float scale,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((ks == nullptr) != (vs == nullptr) || pages_per_split < 1 ||
      hkv < 1 || hq % hkv)
    return (int)cudaErrorInvalidValue;
  const int splits = (pps + pages_per_split - 1) / pages_per_split;
  if (splits > 1 && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = ks != nullptr;
  const RaggedArgs a{q, kp, vp, static_cast<const float*>(ks),
                     static_cast<const float*>(vs),
                     static_cast<const int*>(pt),
                     static_cast<const int*>(kv_lens),
                     static_cast<const int*>(q_lens), out,
                     static_cast<float*>(part), static_cast<int*>(counters),
                     chunk, hq, hkv, num_pages, ps, pps, pages_per_split,
                     scale};
  using bf16 = __nv_bfloat16;
  using f16 = __half;
#define PTT_D(DV)                                                        \
  if (d == DV) {                                                         \
    if (!quant && dtype == 0)                                            \
      return launch<float, float, DV>(a, b, splits, device, s);          \
    if (!quant && dtype == 1)                                            \
      return launch<bf16, bf16, DV>(a, b, splits, device, s);            \
    if (!quant && dtype == 2)                                            \
      return launch<f16, f16, DV>(a, b, splits, device, s);              \
    if (quant && dtype == 0)                                             \
      return launch<float, int8_t, DV>(a, b, splits, device, s);         \
    if (quant && dtype == 1)                                             \
      return launch<bf16, int8_t, DV>(a, b, splits, device, s);          \
    if (quant && dtype == 2)                                             \
      return launch<f16, int8_t, DV>(a, b, splits, device, s);           \
  }
  PTT_D(32)
  PTT_D(64)
  PTT_D(80)
  PTT_D(96)
  PTT_D(128)
#undef PTT_D
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
