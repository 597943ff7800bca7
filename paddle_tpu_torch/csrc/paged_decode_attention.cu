// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over its paged K/V context, fp32, bf16 and fp16 pools.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_decode_kernel (entry
// paged_attention, through _kernel_impl). Computes what that kernel
// computes, not how: for each (sequence b, kv head h) the group = hq / hkv
// query rows of that kv head attend positions [0, lengths[b]) of the
// sequence's pages read through its page-table row, with scale, an online
// softmax across pages and fp32 accumulation; one rounding to q's type at
// the end. lengths[b] <= 0 (an empty slot) writes zeros and reads no page.
// Entries are clipped to [0, num_pages) as the Pallas index map clips them.
// Pages at or past ceil(length / page_size) are neither read nor computed
// (the TPU re-fetches the last valid page there and skips its compute), and
// the last page reads only its rows below the length. The TPU pads the GQA
// group to 8 rows for the MXU's sublane tile; here the group is not padded.
//
// Translation: the TPU grid's sequential page axis becomes a split walk
// (paged_walk.cuh, shared with the ragged and mega attention kernels). The
// grid is (b, kv head, split): a pair's pages are cut into splits of whole
// pages, sized from shapes only by ops/paged_attention.py walk_plan, so
// GPT-125M's 8 slots x 12 heads fill the card's 132 SMs several times over
// where one block a pair gave 96 blocks. A block walks its pages as tiles of
// 32 keys (a page below 32 keys is one tile) through a 3-stage cp.async
// ring, two tiles' copies in flight while one is attended; its rows are the
// GQA group (1 for MHA, 3 at 12/4, 8 at 16/2 and MQA 8/1), each seeing every
// key below the length. A split that starts past the length reads nothing
// and arrives at once. The last split of a pair to arrive merges the splits'
// (acc, m, l) in split order (one split: the block writes its rows itself),
// so a repeat is bitwise equal.
//
// What bounds it on the H100: bytes. A pair must read length * d K and V
// values once; at GPT-125M's serving step (8 slots, 12 heads of 64, contexts
// to 1024) that is up to 50 MB in fp32 against a few MFLOP.
#include "paged_walk.cuh"

namespace {

using ptt::store;
using ptt::to_f;
namespace wk = ptt::walk;

struct DecodeArgs {
  const void *q, *kp, *vp;        // [b, hq, D] T; pools [P, ps, hkv, D] T
  const int *pt, *lengths;        // [b, pps], [b]
  void* out;                      // [b, hq, D] T
  float* part;                    // [b, hkv, splits, partial_floats(G, D)]
  int* counters;                  // [b * hkv], zero on entry
  int hq, hkv, num_pages, ps, pps, pages_per_split;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(wk::kThreads)
paged_decode_split_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z, Z = gridDim.z;
  const int tid = threadIdx.x;
  const int R = a.hq / a.hkv;   // the GQA group: one query row each
  // the group's query and output rows are contiguous in [b, hq, D]
  const long row0 = ((long)b * a.hq + (long)h * R) * D;
  const T* q = static_cast<const T*>(a.q) + row0;
  T* out = static_cast<T*>(a.out) + row0;
  const int length = a.lengths[b];
  if (length <= 0) {   // an empty slot: zeros, no page read, no arrival
    if (z == 0)
      for (int i = tid; i < R * D; i += wk::kThreads) store(out + i, 0.f);
    return;
  }
  const int span = a.pages_per_split * a.ps;   // keys a split covers
  const int ctx_keys = min(length, a.pps * a.ps);
  const int k0 = z * span, k1 = min(ctx_keys, k0 + span);
  const int nkeys = max(k1 - k0, 0);

  int* pg;
  const wk::Rows st = wk::carve<D>(smem, R, R, &pg);
  float* qs = st.q;
  unsigned char* ring = smem + wk::rows_bytes(R, D, a.pages_per_split);

  if (nkeys > 0) {
    for (int i = tid; i < R * D; i += wk::kThreads)
      qs[(i / D) * (D + 4) + i % D] = to_f(q[i]);
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
      const int key0 = p * a.ps + t0;
      return wk::TileAt{((long)pg[i / tpp] * a.ps + t0) * a.hkv + h,
                        min(min(wk::kKeys, a.ps - t0), k1 - key0), key0};
    };
    // every row sees every key below the length (no causal offset)
    auto ncols_of = [&](int, int key0) { return length - key0; };
    wk::walk<T, D>(st, ring, static_cast<const T*>(a.kp),
                   static_cast<const T*>(a.vp), nullptr, nullptr, a.hkv, n,
                   tile_of, a.scale, ncols_of);
  }
  auto put = [&](int r, int c, float4 v) {
    T* o = out + r * D + c;
    store(o, v.x);
    store(o + 1, v.y);
    store(o + 2, v.z);
    store(o + 3, v.w);
  };
  if (Z == 1) {   // the whole walk in this block (length > 0: keys seen)
    wk::finish<D>(st, put);
    return;
  }
  const long pf = wk::partial_floats(R, D);
  float* part0 = a.part + (long)(b * a.hkv + h) * Z * pf;
  if (nkeys > 0) wk::save<D>(st, part0 + z * pf, R);
  // a split past the length owns no page but still arrives
  if (!wk::arrive(a.counters + b * a.hkv + h, Z)) return;
  wk::merge<D>(
      R, R, Z, [&](int s) { return part0 + s * pf; },
      [&](int s) { return s * span < ctx_keys; }, put);
}

template <typename T, int D>
int launch(const DecodeArgs& a, int b, int splits, int device,
           cudaStream_t stream) {
  const int bytes =
      (int)wk::smem_bytes<T, D>(a.hq / a.hkv, a.pages_per_split);
  cudaError_t err =
      ptt::allow_smem<paged_decode_split_kernel<T, D>>(device, bytes);
  if (err != cudaSuccess) return (int)err;
  paged_decode_split_kernel<T, D>
      <<<dim3(b, a.hkv, splits), wk::kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q/out [b, hq, d]; pools [num_pages, ps, hkv, d] in q's type; page_table
// [b, pps] int32 (-1 unallocated); lengths [b] int32, all contiguous, q
// and the pools 16-byte aligned. part: splits > 1 partials [b, hkv, splits,
// group * (d + 2) rounded up to 4] fp32 (group = hq / hkv); counters
// [b * hkv] int32, zero on entry and left zero. The grid walks
// pages_per_split pages a split, splits = ceil(pps / pages_per_split).
// dtype: 0 = fp32, 1 = bf16, 2 = fp16. d: 32, 64, 80, 96 or 128.
int ptt_paged_decode_attention(const void* q, const void* kp, const void* vp,
                               const void* pt, const void* lengths,
                               void* out, void* part, void* counters, int b,
                               int hq, int hkv, int num_pages, int ps,
                               int pps, int d, int pages_per_split,
                               float scale, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (pages_per_split < 1 || hkv < 1 || hq % hkv || pps < 1 || ps < 1)
    return (int)cudaErrorInvalidValue;
  const int splits = (pps + pages_per_split - 1) / pages_per_split;
  if (splits > 1 && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DecodeArgs a{q, kp, vp, static_cast<const int*>(pt),
                     static_cast<const int*>(lengths), out,
                     static_cast<float*>(part), static_cast<int*>(counters),
                     hq, hkv, num_pages, ps, pps, pages_per_split, scale};
#define PTT_D(DV)                                                      \
  if (d == DV) {                                                       \
    if (dtype == 0) return launch<float, DV>(a, b, splits, device, s); \
    if (dtype == 1)                                                    \
      return launch<__nv_bfloat16, DV>(a, b, splits, device, s);       \
    if (dtype == 2) return launch<__half, DV>(a, b, splits, device, s); \
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
