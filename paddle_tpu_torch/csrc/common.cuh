// Helpers shared by the port's kernels: fp32 / bf16 element access, a
// batched 16-byte tile loader (fp32, bf16 or int8 rows, the last scaled per
// row), the weight-only GEMMs' 16-element weight chunk and dequantization,
// and the host-side shared-memory cap.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace ptt {

constexpr int kMaxDevices = 64;

// Lets `Kernel` launch with `bytes` of dynamic shared memory on `device`.
// The driver is asked only when a launch needs more than any earlier one on
// that device; a request past what a block may use returns its error.
template <auto Kernel>
cudaError_t allow_smem(int device, int bytes) {
  static std::mutex mu;
  static int granted[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices)
    return cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  std::lock_guard<std::mutex> lock(mu);
  if (bytes <= granted[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted[device] = bytes;
  return err;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// A quantized weight element q * s rounded to the activation type T, as the
// reference's kernels widen both to x.dtype and multiply there (bf16: both
// widen exactly, the product of two 8-bit significands is exact in fp32,
// then one rounding).
template <typename T>
__device__ __forceinline__ float deq(int q, float s);
template <>
__device__ __forceinline__ float deq<float>(int q, float s) {
  return (float)q * s;
}
template <>
__device__ __forceinline__ float deq<__nv_bfloat16>(int q, float s) {
  const float sb = __bfloat162float(__float2bfloat16(s));
  return __bfloat162float(__float2bfloat16((float)q * sb));
}

// 16 consecutive elements of one weight row (W: int8, bf16 or fp32) held in
// sizeof(W) 16-byte registers.
template <typename W>
struct Row16 {
  uint4 v[sizeof(W)];
  __device__ __forceinline__ W operator[](int i) const {
    return reinterpret_cast<const W*>(v)[i];
  }
};

// Loads row[col, col + 16) into c; elements at or past n, or all of them
// when !ok, read as zero bits. vec: the row's 16-byte vectors are aligned
// and each lies wholly inside or outside n (n * sizeof(W) % 16 == 0).
template <typename W>
__device__ __forceinline__ void load_row16(Row16<W>& c, const W* row,
                                           int col, int n, bool ok,
                                           bool vec) {
  constexpr int kPer = 16 / sizeof(W);  // elements per 16-byte vector
  if (vec) {
#pragma unroll
    for (int i = 0; i < (int)sizeof(W); ++i)
      c.v[i] = (ok && col + i * kPer < n)
                   ? __ldg(reinterpret_cast<const uint4*>(row + col) + i)
                   : make_uint4(0u, 0u, 0u, 0u);
    return;
  }
#pragma unroll
  for (int i = 0; i < (int)sizeof(W); ++i) c.v[i] = make_uint4(0u, 0u, 0u, 0u);
  W* e = reinterpret_cast<W*>(c.v);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (ok && col + i < n) e[i] = __ldg(row + col + i);
}

// one 16-byte vector: 4 fp32 or 8 bf16 values
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// 16 int8 values
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[16]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = (float)b[i];
}

// No per-row scale: load_rows stores the values as they are.
struct NoScale {};

// Copy rows [0, nrows) of NT tiles — row r of tile t at src[t] + off(r),
// D contiguous elements — into shared memory as fp32 (row pitch pitch[t]).
// Rows >= valid are zero-filled. With a Scale callable, row r of tile t is
// multiplied by scale(t, r) in fp32 (int8 rows dequantize on the way in).
// Each thread keeps kBatch 16-byte loads per tile (and their scales) in
// flight before it stores any, so a page costs about one memory latency
// instead of one per element. Rows must be 16-byte aligned.
template <typename T, int D, int kBatch, int NT, typename RowOff,
          typename Scale = NoScale>
__device__ __forceinline__ void load_rows(const T* const (&src)[NT],
                                          float* const (&dst)[NT],
                                          const int (&pitch)[NT], RowOff off,
                                          int nrows, int valid,
                                          Scale scale = Scale{}) {
  constexpr bool kScaled = !std::is_same_v<Scale, NoScale>;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RV = D / VEC;  // vectors per row
  const int nvec = nrows * RV;
  for (int base = 0; base < nvec; base += blockDim.x * kBatch) {
    uint4 reg[NT][kBatch];
    float sc[NT][kScaled ? kBatch : 1];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      const int r = i / RV, c = (i % RV) * VEC;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        reg[t][u] = (i < nvec && r < valid)
                        ? __ldg(reinterpret_cast<const uint4*>(
                              src[t] + off(r) + c))
                        : make_uint4(0u, 0u, 0u, 0u);
        if constexpr (kScaled)
          sc[t][u] = (i < nvec && r < valid) ? scale(t, r) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      if (i >= nvec) break;
      const int r = i / RV, c = (i % RV) * VEC;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float f[VEC];
        unpack(reg[t][u], f);
        if constexpr (kScaled) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[e] *= sc[t][u];
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[t][r * pitch[t] + c + e] = f[e];
      }
    }
  }
}

}  // namespace ptt
