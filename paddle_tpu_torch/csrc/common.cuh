// Helpers shared by the port's attention kernels: fp32 / bf16 element
// access, a batched 16-byte tile loader and the host-side shared-memory cap.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <mutex>

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

// Copy rows [0, nrows) of NT tiles — row r of tile t at src[t] + off(r),
// D contiguous elements — into shared memory as fp32 (row pitch pitch[t]).
// Rows >= valid are zero-filled. Each thread keeps kBatch 16-byte loads per
// tile in flight before it stores any, so a page costs about one memory
// latency instead of one per element. Rows must be 16-byte aligned.
template <typename T, int D, int kBatch, int NT, typename RowOff>
__device__ __forceinline__ void load_rows(const T* const (&src)[NT],
                                          float* const (&dst)[NT],
                                          const int (&pitch)[NT], RowOff off,
                                          int nrows, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RV = D / VEC;  // vectors per row
  const int nvec = nrows * RV;
  for (int base = 0; base < nvec; base += blockDim.x * kBatch) {
    uint4 reg[NT][kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x + threadIdx.x;
      const int r = i / RV, c = (i % RV) * VEC;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        reg[t][u] = (i < nvec && r < valid)
                        ? __ldg(reinterpret_cast<const uint4*>(
                              src[t] + off(r) + c))
                        : make_uint4(0u, 0u, 0u, 0u);
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
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[t][r * pitch[t] + c + e] = f[e];
      }
    }
  }
}

}  // namespace ptt
