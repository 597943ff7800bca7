// Split page walks over the paged KV pools (flash-decoding), shared by the
// ragged paged attention kernel (ragged_paged_attention.cu), the paged
// decode kernel (paged_decode_attention.cu) and the mega attention layer
// (mega_decode.cu).
//
// A (lane, kv head) pair's context is cut into splits of whole pages, one
// block each, so a decode round of 8 lanes fills the card's 132 SMs instead
// of 96 of them. A block walks its pages as tiles of kKeys keys through a
// ring of kStages tiles in shared memory filled by cp.async, so two tiles'
// loads are in flight while one is attended. Each tile: the scores of every
// valid row (four threads a dot product, one 4-value group of each 16
// columns a thread, one K load shared by 4 rows), the online softmax over
// the keys each row may see, acc = acc * alpha + P V (one V load shared by
// 4 rows, key slices on neighbouring lanes summed by shuffles). int8 tiles dequantize element by element, q * scale in fp32,
// as the plain versions' gather does. A split leaves (acc, m, l) of its rows
// in device memory; the last split of the pair to arrive (an arrival
// counter, reset by that block) merges them in split order, so a result
// never depends on which block finished first and repeats are bitwise
// equal: no float atomics, no second launch.
#pragma once

#include "common.cuh"

namespace ptt {
namespace walk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;     // keys a tile
constexpr int kStages = 3;    // tiles of the ring
constexpr int kRows4 = 4;     // query rows a thread's products share
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// four consecutive elements (16-, 8- or 4-byte aligned) as fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// bf16 or fp16
template <typename T>
__device__ __forceinline__ float4 ld4(const T* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack2<T>(u.x), b = unpack2<T>(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// One ring stage: kKeys K rows, kKeys V rows (D elements and 16 bytes of
// pad each, so the 8 rows a warp reads at once spread over the banks),
// then for int8 pools the K and V scales of those rows.
template <typename KV, int D>
struct Tile {
  static constexpr bool kQuant = std::is_same_v<KV, int8_t>;
  static constexpr int kRowBytes = D * (int)sizeof(KV) + 16;
  static constexpr int kPitch = kRowBytes / (int)sizeof(KV);  // elements
  static constexpr int kChunks = D * (int)sizeof(KV) / 16;    // 16-byte
  static constexpr int kBytes = 2 * kKeys * kRowBytes + (kQuant ? 8 * kKeys : 0);
  static_assert(D % 16 == 0, "head_dim in steps of 16");
};

// Where a split's tile i lies: its first pool row ((page * ps + t0) * hkv
// + head, D elements a row; key j at row0 + j * hkv), its keys and the
// absolute index of its first key in the lane's context.
struct TileAt {
  long row0;
  int nt, key0;
};

// Copies a tile into a ring stage (the caller commits the group).
template <typename KV, int D>
__device__ __forceinline__ void issue(unsigned char* st, const KV* kp,
                                      const KV* vp, const float* ks,
                                      const float* vs, const TileAt& t,
                                      int hkv) {
  using Tl = Tile<KV, D>;
  const int per = t.nt * Tl::kChunks;
  for (int i = threadIdx.x; i < 2 * per; i += kThreads) {
    const int kv = i >= per, rem = i - kv * per;
    const int j = rem / Tl::kChunks, c = rem % Tl::kChunks;
    const KV* src = (kv ? vp : kp) + (t.row0 + (long)j * hkv) * D +
                    c * (16 / (int)sizeof(KV));
    cp_async16(st + (kv * kKeys + j) * Tl::kRowBytes + c * 16, src, true);
  }
  if constexpr (Tl::kQuant) {
    float* sc = reinterpret_cast<float*>(st + 2 * kKeys * Tl::kRowBytes);
    for (int i = threadIdx.x; i < 2 * t.nt; i += kThreads) {
      const int kv = i >= t.nt, j = i - kv * t.nt;
      cp_async4(sc + kv * kKeys + j, (kv ? vs : ks) + t.row0 + (long)j * hkv,
                true);
    }
  }
}

// The walk's per-row state in shared memory.
struct Rows {
  float* q;       // [R][D + 4] queries, fp32
  float* acc;     // [R][D] unnormalised outputs
  float* s;       // [R][kKeys + 1] scores, then probabilities
  float *m, *l, *alpha;
  int* ncols;     // [R] keys of the current tile a row sees
  int nrows;      // valid rows
};

// Shared memory of a walking block for R rows at head dim D walking
// `pages` pages a split: the rows' state (q [R][D + 4], acc [R][D], scores
// [R][kKeys + 1], m, l, alpha and ncols [R]), the split's page ids, then
// the ring of kStages tiles of KV.
__host__ __device__ inline size_t rows_bytes(int R, int D, int pages) {
  return ((size_t)R * (2 * D + 4 + kKeys + 1 + 4) * 4 + 4 * (size_t)pages +
          15) / 16 * 16;
}
template <typename KV, int D>
size_t smem_bytes(int R, int pages) {
  return rows_bytes(R, D, pages) + (size_t)kStages * Tile<KV, D>::kBytes;
}

// The rows' state of R rows (nrows valid) laid out at smem as rows_bytes
// says; pg: where the split's page ids go.
template <int D>
__device__ __forceinline__ Rows carve(unsigned char* smem, int R, int nrows,
                                      int** pg) {
  float* q = reinterpret_cast<float*>(smem);
  Rows st{q, q + R * (D + 4), q + R * (D + 4) + R * D,
          nullptr, nullptr, nullptr, nullptr, nrows};
  st.m = st.s + R * (kKeys + 1);
  st.l = st.m + R;
  st.alpha = st.l + R;
  st.ncols = reinterpret_cast<int*>(st.alpha + R);
  *pg = st.ncols + R;
  return st;
}

template <int D>
__device__ __forceinline__ void reset(const Rows& st) {
  for (int i = threadIdx.x; i < st.nrows * D; i += kThreads) st.acc[i] = 0.f;
  for (int r = threadIdx.x; r < st.nrows; r += kThreads) {
    st.m[r] = kNegInf;
    st.l[r] = 0.f;
  }
}

// One tile of nt <= kKeys keys, K rows at k and V rows at v (pitch
// elements apart; ksc / vsc their scales for int8): every valid row's
// scores, the online softmax over the tile's first ncols_of(r) keys (clamped
// to [0, nt]), acc = acc * alpha + P V, a thread's products over kRG rows.
// Starts after a barrier the caller placed; ends with the P V writes (the
// next tile's caller syncs first).
template <typename KV, int D, int kRG, typename NCols>
__device__ __forceinline__ void attend(const Rows& st, const KV* k,
                                       const KV* v, int pitch,
                                       const float* ksc, const float* vsc,
                                       int nt, float scale, NCols ncols_of) {
  constexpr bool kQuant = std::is_same_v<KV, int8_t>;
  constexpr int kSp = kKeys + 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // scores: lanes 4i .. 4i + 3 share the dot products of one key with a
  // group of kRG rows (one K load feeds kRG rows)
  const int groups = (st.nrows + kRG - 1) / kRG;
  const int dots = groups * nt * 4;
  for (int base = warp * 32; base < dots; base += kThreads) {
    const int w = base + lane, part = w & 3;
    const bool ok = w < dots;
    const int dot = ok ? w >> 2 : 0, r0 = (dot / nt) * kRG, j = dot % nt;
    float acc[kRG] = {};
    if (ok) {
      const KV* kr = k + (long)j * pitch;
      const float sk = kQuant ? ksc[j] : 1.f;
#pragma unroll
      for (int g = 0; g < D / 16; ++g) {
        const int c = 4 * (part + 4 * g);
        float4 kv = ld4(kr + c);
        if constexpr (kQuant) {
          kv.x *= sk;
          kv.y *= sk;
          kv.z *= sk;
          kv.w *= sk;
        }
#pragma unroll
        for (int i = 0; i < kRG; ++i) {
          if (r0 + i >= st.nrows) break;
          const float4 qv = ld4(st.q + (r0 + i) * (D + 4) + c);
          acc[i] = fmaf(qv.x, kv.x, acc[i]);
          acc[i] = fmaf(qv.y, kv.y, acc[i]);
          acc[i] = fmaf(qv.z, kv.z, acc[i]);
          acc[i] = fmaf(qv.w, kv.w, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRG; ++i) {
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
      if (ok && part == 0 && r0 + i < st.nrows)
        st.s[(r0 + i) * kSp + j] = acc[i] * scale;
    }
  }
  __syncthreads();
  // online softmax, one warp a row
  for (int r = warp; r < st.nrows; r += kWarps) {
    const int n = min(max(ncols_of(r), 0), nt);
    if (n == 0) {
      if (lane == 0) {
        st.alpha[r] = 1.f;
        st.ncols[r] = 0;
      }
      continue;
    }
    float* sr = st.s + r * kSp;
    const float mx = warp_max(lane < n ? sr[lane] : kNegInf);
    const float m_old = st.m[r], m_new = fmaxf(m_old, mx);
    float p = 0.f;
    if (lane < n) {
      p = expf(sr[lane] - m_new);
      sr[lane] = p;
    }
    const float sum = warp_sum(p);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      st.alpha[r] = alpha;
      st.ncols[r] = n;
      st.m[r] = m_new;
      st.l[r] = st.l[r] * alpha + sum;
    }
  }
  __syncthreads();
  // acc = acc * alpha + P V: (kRG rows, 4 columns) items (one V load feeds
  // kRG rows), ks key slices of one item on neighbouring lanes (as many as
  // fill the block, at most 32)
  constexpr int C4 = D / 4;
  const int items = groups * C4;
  int ks = 1;
  while (ks < 32 && items * ks * 2 <= kThreads) ks *= 2;
  const int total = items * ks;
  for (int base = warp * 32; base < total; base += kThreads) {
    const int w = base + lane, sl = w & (ks - 1);
    const bool ok = w < total;
    const int item = ok ? w / ks : 0, r0 = (item / C4) * kRG;
    const int c = 4 * (item % C4);
    int n[kRG];
    int nmax = 0;
#pragma unroll
    for (int i = 0; i < kRG; ++i) {
      n[i] = ok && r0 + i < st.nrows ? st.ncols[r0 + i] : 0;
      nmax = max(nmax, n[i]);
    }
    float4 a[kRG];
#pragma unroll
    for (int i = 0; i < kRG; ++i) a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int j = sl; j < nmax; j += ks) {
      float4 vv = ld4(v + (long)j * pitch + c);
      if constexpr (kQuant) {
        const float sv = vsc[j];
        vv.x *= sv;
        vv.y *= sv;
        vv.z *= sv;
        vv.w *= sv;
      }
#pragma unroll
      for (int i = 0; i < kRG; ++i) {
        // a row's probabilities past its own keys are not read
        const float pj = j < n[i] ? st.s[(r0 + i) * kSp + j] : 0.f;
        a[i].x = fmaf(pj, vv.x, a[i].x);
        a[i].y = fmaf(pj, vv.y, a[i].y);
        a[i].z = fmaf(pj, vv.z, a[i].z);
        a[i].w = fmaf(pj, vv.w, a[i].w);
      }
    }
#pragma unroll
    for (int i = 0; i < kRG; ++i) {
      for (int o = 1; o < ks; o *= 2) {
        a[i].x += __shfl_xor_sync(0xffffffffu, a[i].x, o);
        a[i].y += __shfl_xor_sync(0xffffffffu, a[i].y, o);
        a[i].z += __shfl_xor_sync(0xffffffffu, a[i].z, o);
        a[i].w += __shfl_xor_sync(0xffffffffu, a[i].w, o);
      }
      if (ok && sl == 0 && r0 + i < st.nrows) {
        float* ar = st.acc + (r0 + i) * D + c;
        const float al = st.alpha[r0 + i];
        ar[0] = ar[0] * al + a[i].x;
        ar[1] = ar[1] * al + a[i].y;
        ar[2] = ar[2] * al + a[i].z;
        ar[3] = ar[3] * al + a[i].w;
      }
    }
  }
}

// Walks n tiles (tile_of(i) -> TileAt) through the ring at `ring`, each
// attended with ncols_of(r, key0) visible keys. The caller has reset the
// rows and placed no barrier since; returns after a barrier, the ring idle.
template <typename KV, int D, typename TileOf, typename NCols>
__device__ void walk(const Rows& st, unsigned char* ring, const KV* kp,
                     const KV* vp, const float* ks, const float* vs, int hkv,
                     int n, TileOf tile_of, float scale, NCols ncols_of) {
  using Tl = Tile<KV, D>;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) issue<KV, D>(ring + i * Tl::kBytes, kp, vp, ks, vs, tile_of(i),
                            hkv);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i is in; the readers of tile i - 1 are done
    const int nx = i + kStages - 1;
    if (nx < n)
      issue<KV, D>(ring + (nx % kStages) * Tl::kBytes, kp, vp, ks, vs,
                   tile_of(nx), hkv);
    cp_async_commit();
    const TileAt t = tile_of(i);
    const unsigned char* st_ = ring + (i % kStages) * Tl::kBytes;
    const float* sc =
        reinterpret_cast<const float*>(st_ + 2 * kKeys * Tl::kRowBytes);
    const KV* kt = reinterpret_cast<const KV*>(st_);
    const KV* vt = reinterpret_cast<const KV*>(st_ + kKeys * Tl::kRowBytes);
    auto ncols = [&](int r) { return ncols_of(r, t.key0); };
    if (st.nrows >= kRows4)   // 4 rows a thread's products, else 1
      attend<KV, D, kRows4>(st, kt, vt, Tl::kPitch, sc, sc + kKeys, t.nt,
                            scale, ncols);
    else
      attend<KV, D, 1>(st, kt, vt, Tl::kPitch, sc, sc + kKeys, t.nt, scale,
                       ncols);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Copies the split's page-table entries [p0, p0 + n) into shared memory,
// clipped to [0, num_pages) as the Pallas index map clips them, so no tile
// waits on a page-table load before its copies are issued. The caller
// syncs before the walk reads them.
__device__ __forceinline__ void stage_pages(int* pg, const int* ptrow, int p0,
                                            int n, int num_pages) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    pg[i] = min(max(ptrow[p0 + i], 0), num_pages - 1);
}

// Floats one split leaves for R rows: acc [R][D], then m [R], l [R],
// rounded up to 16 bytes.
__host__ __device__ inline long partial_floats(int R, int D) {
  return ((long)R * (D + 2) + 3) / 4 * 4;
}

// Stores this split's (acc, m, l) of the valid rows at part.
template <int D>
__device__ __forceinline__ void save(const Rows& st, float* part, int R) {
  for (int i = threadIdx.x; i < st.nrows * D; i += kThreads)
    part[(i / D) * D + i % D] = st.acc[i];
  for (int r = threadIdx.x; r < st.nrows; r += kThreads) {
    part[(long)R * D + r] = st.m[r];
    part[(long)R * D + R + r] = st.l[r];
  }
}

// Arrival of a split at its pair's counter; true in the last to arrive
// (which resets the counter and may then read every split's partial).
__device__ __forceinline__ bool arrive(int* counter, int expected) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Merges the partials of splits [0, splits) in split order (part_of(s):
// the split's partial; has(s): whether it walked any key) and hands each
// valid row's normalised outputs, 4 columns at a time, to
// out(r, c, float4); a row that saw no key gets zeros.
template <int D, typename PartOf, typename Has, typename Out>
__device__ __forceinline__ void merge(int nrows, int R, int splits,
                                      PartOf part_of, Has has, Out out) {
  constexpr int C4 = D / 4;
  for (int item = threadIdx.x; item < nrows * C4; item += kThreads) {
    const int r = item / C4, c = 4 * (item % C4);
    float mx = kNegInf;
#pragma unroll 4
    for (int s = 0; s < splits; ++s)
      if (has(s)) mx = fmaxf(mx, __ldcg(part_of(s) + (long)R * D + r));
    float l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      if (!has(s)) continue;
      const float* p = part_of(s);
      const float ls = __ldcg(p + (long)R * D + R + r);
      const float ms = __ldcg(p + (long)R * D + r);
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + r * D + c));
      // a split that held no key of the row (l 0) adds nothing
      const float w = ls > 0.f ? expf(ms - mx) : 0.f;
      l += ls * w;
      a.x += v.x * w;
      a.y += v.y * w;
      a.z += v.z * w;
      a.w += v.w * w;
    }
    out(r, c, l > 0.f ? make_float4(a.x / l, a.y / l, a.z / l, a.w / l)
                      : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

// The same for a block that walked every key itself (one split).
template <int D, typename Out>
__device__ __forceinline__ void finish(const Rows& st, Out out) {
  constexpr int C4 = D / 4;
  for (int item = threadIdx.x; item < st.nrows * C4; item += kThreads) {
    const int r = item / C4, c = 4 * (item % C4);
    const float l = st.l[r];
    const float* a = st.acc + r * D + c;
    out(r, c, l > 0.f ? make_float4(a[0] / l, a[1] / l, a[2] / l, a[3] / l)
                      : make_float4(0.f, 0.f, 0.f, 0.f));
  }
}

}  // namespace walk
}  // namespace ptt
