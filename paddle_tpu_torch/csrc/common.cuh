// Helpers shared by the port's kernels: fp32 / bf16 element access, a
// batched 16-byte tile loader (fp32, bf16 or int8 rows, the last scaled per
// row), the weight-only GEMMs' 16-element weight chunk and dequantization,
// the host-side shared-memory cap, and the tensor-core building blocks
// (cp.async copies, ldmatrix, mma.sync m16n8k16 and wgmma m64nNk16, bf16
// -> fp32, a vector fp32 reduction).
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

// ---- tensor cores: cp.async, ldmatrix and mma.sync (sm_80 and later) ----
//
// Fragment layouts of mma.sync.m16n8k16 (row.col, bf16 in, fp32 out), for
// lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A 16 x 16, four 32-bit registers of two bf16 each:
//     a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B 16 x 8: b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9; col g);
//   C 16 x 8 fp32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same).
// Two C tiles side by side (cols 0-7 and 8-15), rounded to bf16 pairwise,
// are the A fragment of a 16 x 16 tile: {c0c1, c2c3} of the first and of
// the second. ldmatrix.x4 loads four 8 x 8 bf16 matrices, matrix i from the
// row addresses of lanes 8i .. 8i+7; lane 4g + t receives row g, cols 2t,
// 2t+1 of each (with .trans: col g, rows 2t, 2t+1). The *_lane helpers
// give the row and column a lane addresses for the three operand shapes.
// Shared tiles are kept at a row pitch of D + 8 bf16: consecutive rows
// shift by 16 bytes (4 banks), so the 8 rows of an ldmatrix matrix fall in
// 8 different bank quads.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; !ok zero-fills (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared; !ok zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, R) of D bf16 each, row r at src + r * stride, into a shared tile
// of pitch D + 8; rows >= valid are zero-filled (base: any valid address,
// passed for the rows that are not read). All NT threads of the block take
// part; the caller commits the group.
template <int D, int R, int NT>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, long stride,
                                        int valid, const __nv_bfloat16* base) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = (i % C) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + 8) + c, ok ? src + r * stride + c : base, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The row / column (element offsets inside a 16-row, 16-col window) that
// this lane addresses for ldmatrix.x4:
// - A from a row-major [row][k] tile (a0..a3), or, with .trans, the B
//   fragments of two 8-col tiles from a row-major [k][n] tile (b0 b1 of
//   cols 0-7, then b0 b1 of cols 8-15): row lane % 16, col (lane / 16) * 8;
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
// - the B fragments of two 8-col tiles from a row-major [n][k] tile (b0 b1
//   of n 0-7, then of n 8-15), or, with .trans, A from a [k][row] tile:
//   row (lane % 8) + 8 * (lane / 16), col 8 * ((lane / 8) % 2).
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_col(int lane) {
  return ((lane >> 3) & 1) * 8;
}

// p[0] += x, p[1] += y as one vector reduction in global memory (sm_90;
// p 8-byte aligned); the order of concurrent adds is not fixed.
__device__ __forceinline__ void red_add2(float* p, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(x),
               "f"(y)
               : "memory");
}

// d += a * b on the tensor cores: bf16 products summed in fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the low half: one register of a fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of a 16-row tile whose 8-col C tiles are c[0 .. 2K):
// a[kk] covers cols 16 kk .. 16 kk + 15, each value rounded to bf16.
template <int K>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[K][4],
                                       float (&c)[2 * K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// ---- warpgroup MMA (sm_90a): wgmma.mma_async, fp32 += bf16 x bf16 ----
//
// A warpgroup (4 warps, 128 threads) computes a 64 x N tile. Its fp32
// accumulator, per warp (rows 16 w .. 16 w + 15) and per 8-column chunk j,
// is an mma.sync C fragment: d[j][0..3] = (row g, cols 8j + 2t, +1), (row
// g + 8, same cols); an A operand in registers is an mma.sync A fragment
// of the warp's 16 rows. Shared-memory operands are read through matrix
// descriptors (gmma_desc_sw128). The accumulators are written
// asynchronously: wgmma_fence() before the first product that reads
// registers written by other instructions, then wgmma_commit(),
// wgmma_wait<0>() and fence_operands() on the accumulators before they
// are read.

// Descriptor of a shared-memory operand in the 128-byte-swizzled layout
// (atoms of 8 rows x 128 bytes, 1,024-byte aligned) starting at p. A
// K-major operand: sbo the bytes between 8-row atoms along M-N (lbo is
// not read while a k-step lies in one atom). An MN-major operand: lbo the
// bytes between atoms along M-N, sbo between 8-row groups along K.
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* p,
                                                    uint32_t lbo,
                                                    uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders the generic-proxy writes (cp.async, stores) to shared memory
// before the async-proxy reads of wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins the accumulator registers after wgmma_wait (the compiler cannot
// see the asynchronous write).
template <int J>
__device__ __forceinline__ void fence_operands(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (64 x 64) += A (64 x 16, K-major) * B (16 x 64, K-major, i.e. [n][k])
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128) += A (registers: the warp's 16 x 16 A fragment) * B (16 x
// 128 in shared memory, MN-major, i.e. [k][n] with n contiguous)
__device__ __forceinline__ void wgmma_rs_n128_t(float (&d)[16][4],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace ptt
