// Flash attention backward for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 on the CUDA cores.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_bwd_fused_kernel (the
// causal / no-mask / no-varlen branch of flash_bwd_impl): dq, dk and dv from
// the forward's lse and delta = rowsum(do * out), recomputing
//   s = scale * q k^T   (bottom-right causal: row + sk - sq >= col)
//   p = exp(s - lse),  dv += p^T do,  dp = do v^T,  ds = p * (dp - delta),
//   dk += scale * ds^T q,  dq += scale * ds k,
// with the Pallas kernel's casts: p is rounded to do's type before p^T do,
// ds to q's type before both of its products. Rows whose lse is 1e30 (they
// saw no key in the forward) get p = 0 and so no gradient.
//
// Design. The TPU kernel keeps a full-sequence fp32 dq accumulator resident
// in VMEM while its sequential grid walks the k blocks; blocks on the GPU
// run in parallel and in no order, so nothing can carry over between them.
// Here one block per (batch, kv head, key block) holds K_j and V_j in
// shared memory, walks the q heads of its GQA group and, for each, the q
// blocks from the first one the causal mask lets see the key block; dk and
// dv accumulate in fp32 registers across all of them (so GQA group sums
// happen in fp32 inside the block, and dk, dv are written once, in kv
// heads). dq is summed across key blocks with fp32 atomicAdd into a zeroed
// [b, sq, hq, d] buffer: the order of those adds changes from run to run,
// so dq is not bit-deterministic (dk and dv are). Ragged tails are masked
// in the kernel, so any sq and sk work.
//
// What bounds it on the H100: operations. At gpt3-760m's [8, 1024, 12, 128]
// causal the products are 64.5 GFLOP as chip_smoke.py counts them, 0.065
// ms at 989 TFLOP/s bf16 (0.96 ms at the fp32 CUDA-core peak); the inputs
// and outputs are ~100 MB in bf16, 0.03 ms.
//
// bf16 (flash_bwd_tc_kernel, head_dim 32, 64, 80, 96, 128): 256 threads, a
// key block of 128, and each of the 8 warps owns 16 keys. The block walks
// (q head, 64-row q block) items through a 2-stage cp.async ring (Q, dO,
// lse, delta), so the next item's copy overlaps this one's products. All
// five products run on mma.sync m16n8k16 with fp32 accumulators: a warp
// computes S^T = K Q^T and dP^T = V dO^T for its 16 keys (K, V fragments
// by ldmatrix, Q, dO as B fragments), so P^T and dS^T come out in the
// accumulator layout, which is the A layout of dV += P^T dO and dK +=
// dS^T Q: both stay in registers, rounded to bf16. dS^T goes to shared
// memory once (pitch 72), and after a barrier the 8 warps split dQ's
// 64 x d tile (4 row tiles x 2 column halves), read dS and K by
// ldmatrix.trans, and add their fp32 fragments into dq with vector
// reductions (red.global.add.v2.f32: half the instructions of scalar
// atomics, and faster on the card). Two barriers
// an item: the next item's copy is issued after the first, once every
// warp is done with the stage it reuses. A warp whose keys no row of the
// item sees skips its products. Shared memory:
// (2 * 128 + 4 * 64) * (d + 8) * 2 + 128 * 72 * 2 + 1,024 bytes; ptxas -v
// (sm_90a): d 32: 199 registers, 60,416 B; d 64: 244, 93,184 B; d 80:
// 244, 109,568 B; d 96: 252, 125,952 B; d 128: 255, 158,720 B; no spills
// (the registers hold one block an SM).
//
// fp32 (flash_bwd_kernel, head_dim 64, 128): tensor cores would make it
// TF32, so it stays on the CUDA cores, the kernel of the training slice:
// one 256-thread block per (batch, kv head, 64-key block) with fp32 tiles
// in shared memory (4 x 4 score tiles and 4 x d/16 accumulator tiles a
// thread).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptt::load_rows;
using ptt::store;

constexpr int kBQ = 64;          // q rows per inner step
constexpr int kBK = 64;          // keys per block
constexpr int kThreads = 256;    // 16 row groups x 16 column groups
constexpr int kTR = 4;           // score rows (and dk/dv rows) per thread
constexpr int kTC = 4;           // score columns per thread
constexpr int kPS = kBK + 1;     // padded row stride of the P and dS tiles

template <int D>
constexpr size_t smem_bytes() {
  // Ks, Vs: [64][D+1]; Qs, dOs: [64][D+1]; Ps, dSs: [64][65]; lse, delta: [64]
  return sizeof(float) *
         (2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBQ * kPS + 2 * kBQ);
}

// x rounded to T and back: the Pallas kernel's `.astype` before a product
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                 int sq, int sk, float scale, int causal) {
  constexpr int DC = D / 16;  // accumulator columns per thread
  constexpr int P = D + 1;    // padded row stride of the q/k/v/do tiles
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * P;
  float* Qs = Vs + kBK * P;
  float* dOs = Qs + kBQ * P;
  float* Ps = dOs + kBQ * P;
  float* dSs = Ps + kBQ * kPS;
  float* lse_s = dSs + kBQ * kPS;
  float* delta_s = lse_s + kBQ;

  const int b = blockIdx.x / hkv, kvh = blockIdx.x % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long q_row = (long)hq * D;  // [b, s, h, d] row strides
  const long kv_row = (long)hkv * D;
  const int off = sk - sq;

  {
    const T* src[2] = {k + ((long)b * sk + k0) * kv_row + (long)kvh * D,
                       v + ((long)b * sk + k0) * kv_row + (long)kvh * D};
    float* dst[2] = {Ks, Vs};
    const int pitch[2] = {P, P};
    load_rows<T, D, 2>(src, dst, pitch, [=](int r) { return r * kv_row; },
                       kBK, sk - k0);
  }

  float dk_acc[kTR][DC], dv_acc[kTR][DC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // first q block with a row that sees key k0: row >= k0 - off
  const int n_qb = (sq + kBQ - 1) / kBQ;
  const int lower = causal ? max(k0 - off, 0) / kBQ : 0;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const long bh = (long)b * hq + h;
    const T* qb = q + (long)b * sq * q_row + (long)h * D;
    const T* dob = dout + (long)b * sq * q_row + (long)h * D;
    for (int qi = lower; qi < n_qb; ++qi) {
      const int q0 = qi * kBQ;
      __syncthreads();  // the previous step's readers of Qs/dOs/Ps/dSs are done
      {
        const T* src[2] = {qb + q0 * q_row, dob + q0 * q_row};
        float* dst[2] = {Qs, dOs};
        const int pitch[2] = {P, P};
        load_rows<T, D, 2>(src, dst, pitch,
                           [=](int r) { return r * q_row; }, kBQ, sq - q0);
      }
      if (tid < kBQ) {
        const bool ok = q0 + tid < sq;
        lse_s[tid] = ok ? lse[bh * sq + q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta[bh * sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s = q k^T and dp = do v^T: rows ty + 16 i, columns tx + 16 j
      float s[kTR][kTC], dp[kTR][kTC];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int kk = 0; kk < D; ++kk) {
        float a[kTR], o[kTR], kb[kTC], vb[kTC];
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          a[i] = Qs[(ty + 16 * i) * P + kk];
          o[i] = dOs[(ty + 16 * i) * P + kk];
        }
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          kb[j] = Ks[(tx + 16 * j) * P + kk];
          vb[j] = Vs[(tx + 16 * j) * P + kk];
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < kTC; ++j) {
            s[i][j] = fmaf(a[i], kb[j], s[i][j]);
            dp[i][j] = fmaf(o[i], vb[j], dp[i][j]);
          }
      }
      // p = exp(s - lse) where the key is visible (else 0); ds = p (dp - delta)
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int r = ty + 16 * i;
        const int row = q0 + r;
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          const int c = tx + 16 * j;
          const int col = k0 + c;
          const bool ok = row < sq && col < sk && (!causal || col <= row + off);
          const float p = ok ? expf(scale * s[i][j] - lse_s[r]) : 0.f;
          Ps[r * kPS + c] = round_to(p, T());
          dSs[r * kPS + c] = round_to(p * (dp[i][j] - delta_s[r]), T());
        }
      }
      __syncthreads();

      // dv += p^T do and dk += ds^T q: key rows ty + 16 i, columns tx + 16 j
      for (int r = 0; r < kBQ; ++r) {
        float pc[kTR], ds[kTR], o[DC], qv[DC];
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          pc[i] = Ps[r * kPS + ty + 16 * i];
          ds[i] = dSs[r * kPS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          o[j] = dOs[r * P + tx + 16 * j];
          qv[j] = Qs[r * P + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            dv_acc[i][j] = fmaf(pc[i], o[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], qv[j], dk_acc[i][j]);
          }
      }

      // this key block's share of dq = scale * ds k, added into fp32 dq
      float dq_acc[kTR][DC];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) dq_acc[i][j] = 0.f;
      for (int c = 0; c < kBK; ++c) {
        float ds[kTR], kv[DC];
#pragma unroll
        for (int i = 0; i < kTR; ++i) ds[i] = dSs[(ty + 16 * i) * kPS + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) kv[j] = Ks[c * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j)
            dq_acc[i][j] = fmaf(ds[i], kv[j], dq_acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= sq) continue;
        float* dst = dq + ((long)b * sq + row) * q_row + (long)h * D;
#pragma unroll
        for (int j = 0; j < DC; ++j)
          atomicAdd(dst + tx + 16 * j, scale * dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    const long base = ((long)b * sk + key) * kv_row + (long)kvh * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      store(dk + base + tx + 16 * j, scale * dk_acc[i][j]);
      store(dv + base + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

// ---- bf16 on the tensor cores ----------------------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBK = 16 * kTcWarps;  // keys per block, 16 a warp
constexpr int kTcBQ = 64;             // q rows per item
constexpr int kTcSP = kTcBQ + 8;      // pitch of the dS^T tile
constexpr int kRowTiles = kTcBQ / 16;             // dQ: 16-row tiles
constexpr int kColSplit = kTcWarps / kRowTiles;   // dQ: column parts
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {
  // K, V [128][D+8]; 2 stages of Q, dO [64][D+8]; dS^T [128][72] (bf16);
  // 2 stages of lse, delta [64] (fp32)
  return sizeof(bf16) * ((2 * kTcBK + 4 * kTcBQ) * (D + 8) + kTcBK * kTcSP) +
         sizeof(float) * 4 * kTcBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                    int sq, int sk, float scale, int causal) {
  static_assert(std::is_same_v<T, bf16>, "the tensor-core path is bf16");
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  static_assert((D / 8) % kColSplit == 0, "dQ columns split evenly");
  constexpr int P = D + 8;          // shared row pitch, bf16 elements
  constexpr int KS = D / 16;        // k-steps over d
  constexpr int NQ = kTcBQ / 8;     // 8-row C tiles of S^T over q
  constexpr int ND = D / 8;         // 8-col C tiles over d
  constexpr int NW = ND / kColSplit;  // dQ C tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTcBK * P;
  bf16* ring = Vs + kTcBK * P;  // stage s: Q at ring + 2s*64*P, dO after
  bf16* dSs = ring + 4 * kTcBQ * P;
  float* stats = reinterpret_cast<float*>(dSs + kTcBK * kTcSP);
  // stage s: lse at stats + 2s*64, delta after it

  const int b = blockIdx.x / hkv, kvh = blockIdx.x % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * kTcBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = k0 + warp * 16;  // the warp's first key
  const long q_row = (long)hq * D;  // [b, s, h, d] row strides
  const long kv_row = (long)hkv * D;
  const int off = sk - sq;
  const float sl2 = scale * kLog2e;

  // first q block with a row that sees key k0: row >= k0 - off
  const int n_qb = (sq + kTcBQ - 1) / kTcBQ;
  const int lower = causal ? max(k0 - off, 0) / kTcBQ : 0;
  const int per_head = max(n_qb - lower, 0);
  const int items = group * per_head;

  const auto issue = [&](int it) {
    const int h = kvh * group + it / per_head;
    const int q0 = (lower + it % per_head) * kTcBQ;
    const long bh = (long)b * hq + h;
    bf16* Qs = ring + (it & 1) * 2 * kTcBQ * P;
    const long row0 = ((long)b * sq + q0) * q_row + (long)h * D;
    ptt::cp_tile<D, kTcBQ, kTcThreads>(Qs, q + row0, q_row, sq - q0, q);
    ptt::cp_tile<D, kTcBQ, kTcThreads>(Qs + kTcBQ * P, dout + row0, q_row,
                                       sq - q0, dout);
    float* st = stats + (it & 1) * 2 * kTcBQ;
    for (int i = threadIdx.x; i < 2 * kTcBQ; i += kTcThreads) {
      const int r = i % kTcBQ;
      const float* src = (i < kTcBQ ? lse : delta);
      const bool ok = q0 + r < sq;
      ptt::cp_async4(st + i, ok ? src + bh * sq + q0 + r : src, ok);
    }
    ptt::cp_async_commit();
  };

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (items > 0) {
    const long kv0 = ((long)b * sk + k0) * kv_row + (long)kvh * D;
    ptt::cp_tile<D, kTcBK, kTcThreads>(Ks, k + kv0, kv_row, sk - k0, k);
    ptt::cp_tile<D, kTcBK, kTcThreads>(Vs, v + kv0, kv_row, sk - k0, v);
    issue(0);  // one group: K, V and item 0
  }
  for (int it = 0; it < items; ++it) {
    ptt::cp_async_wait<0>();
    // item it (and K, V) has landed, and every warp is done with item
    // it - 1: its stage (reused by the next copy) and its dS^T tile
    __syncthreads();
    if (it + 1 < items) issue(it + 1);
    const int h = kvh * group + it / per_head;
    const int q0 = (lower + it % per_head) * kTcBQ;
    const bf16* Qs = ring + (it & 1) * 2 * kTcBQ * P;
    const bf16* dOs = Qs + kTcBQ * P;
    const float* lse_s = stats + (it & 1) * 2 * kTcBQ;
    const float* delta_s = lse_s + kTcBQ;

    // the warp's keys are seen by some row of the item (the last row sees
    // the most keys) and lie before sk
    if (kw < sk && (!causal || kw <= q0 + kTcBQ - 1 + off)) {
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4], vf[4];
        ptt::ldsm_x4(kf, Ks + (warp * 16 + ptt::a_row(lane)) * P + ks * 16 +
                             ptt::a_col(lane));
        ptt::ldsm_x4(vf, Vs + (warp * 16 + ptt::a_row(lane)) * P + ks * 16 +
                             ptt::a_col(lane));
#pragma unroll
        for (int j = 0; j < NQ / 2; ++j) {
          uint32_t qf[4], of[4];
          const int at = (j * 16 + ptt::b_row(lane)) * P + ks * 16 +
                         ptt::b_col(lane);
          ptt::ldsm_x4(qf, Qs + at);
          ptt::ldsm_x4(of, dOs + at);
          ptt::mma_bf16(s[2 * j], kf, qf[0], qf[1]);
          ptt::mma_bf16(s[2 * j + 1], kf, qf[2], qf[3]);
          ptt::mma_bf16(dp[2 * j], vf, of[0], of[1]);
          ptt::mma_bf16(dp[2 * j + 1], vf, of[2], of[3]);
        }
      }
      // p^T = exp(s - lse) where the key is visible (else 0), in fp32;
      // ds^T = p^T (dp^T - delta)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + g + (e >> 1) * 8;
          const int c = n * 8 + 2 * t4 + (e & 1);
          const int row = q0 + c;
          const bool ok =
              key < sk && row < sq && (!causal || key <= row + off);
          const float p =
              ok ? exp2f(s[n][e] * sl2 - lse_s[c] * kLog2e) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_s[c]);
        }
      uint32_t pf[NQ / 2][4], dsf[NQ / 2][4];  // rounded to bf16
      ptt::c_to_a(pf, s);
      ptt::c_to_a(dsf, dp);
      // dS^T to shared memory for dQ: rows are keys, columns q rows
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        bf16* d0 = dSs + (warp * 16 + g) * kTcSP + n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(d0) = ptt::pack_bf16(dp[n][0], dp[n][1]);
        *reinterpret_cast<uint32_t*>(d0 + 8 * kTcSP) =
            ptt::pack_bf16(dp[n][2], dp[n][3]);
      }
      // dV += P^T dO, dK += dS^T Q: k-steps over the item's q rows
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          uint32_t of[4], qf[4];
          const int at = (kk * 16 + ptt::a_row(lane)) * P + j * 16 +
                         ptt::a_col(lane);
          ptt::ldsm_x4_t(of, dOs + at);
          ptt::ldsm_x4_t(qf, Qs + at);
          ptt::mma_bf16(dv_acc[2 * j], pf[kk], of[0], of[1]);
          ptt::mma_bf16(dv_acc[2 * j + 1], pf[kk], of[2], of[3]);
          ptt::mma_bf16(dk_acc[2 * j], dsf[kk], qf[0], qf[1]);
          ptt::mma_bf16(dk_acc[2 * j + 1], dsf[kk], qf[2], qf[3]);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        bf16* d0 = dSs + (warp * 16 + g) * kTcSP + n * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(d0) = 0u;
        *reinterpret_cast<uint32_t*>(d0 + 8 * kTcSP) = 0u;
      }
    }
    __syncthreads();  // dS^T of every warp is in shared memory

    // dQ[q0 + 16 mt .., cols of part cp] += scale * dS K over the 128 keys
    {
      const int mt = warp % kRowTiles, cp = warp / kRowTiles;
      float acc[NW][4];
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < kTcBK / 32; ++k2) {
        uint32_t a0[4], a1[4];  // dS, keys 32 k2 .. +15 and +16 .. +31
        const bf16* ds0 = dSs + (k2 * 32 + ptt::b_row(lane)) * kTcSP +
                          mt * 16 + ptt::b_col(lane);
        ptt::ldsm_x4_t(a0, ds0);
        ptt::ldsm_x4_t(a1, ds0 + 16 * kTcSP);
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          uint32_t kf[4];  // K, keys 32 k2 + lane, cols of C tile n
          ptt::ldsm_x4_t(kf, Ks + (k2 * 32 + lane) * P + (cp * NW + n) * 8);
          ptt::mma_bf16(acc[n], a0, kf[0], kf[1]);
          ptt::mma_bf16(acc[n], a1, kf[2], kf[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + mt * 16 + g + 8 * i;
        if (row >= sq) continue;
        float* dst = dq + ((long)b * sq + row) * q_row + (long)h * D +
                     cp * NW * 8 + 2 * t4;
#pragma unroll
        for (int n = 0; n < NW; ++n)
          ptt::red_add2(dst + n * 8, scale * acc[n][2 * i],
                        scale * acc[n][2 * i + 1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + g + 8 * i;
    if (key >= sk) continue;
    const long base =
        ((long)b * sk + key) * kv_row + (long)kvh * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + n * 8) = ptt::pack_bf16(
          scale * dk_acc[n][2 * i], scale * dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + n * 8) =
          ptt::pack_bf16(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int b, int hq, int hkv, int sq, int sk, float scale,
              int causal, int device, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<D>();
  cudaError_t err = ptt::allow_smem<flash_bwd_tc_kernel<bf16, D>>(
      device, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * hkv, (sk + kTcBK - 1) / kTcBK);
  flash_bwd_tc_kernel<bf16, D><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      hq, hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int b, int hq, int hkv, int sq, int sk, float scale, int causal,
           int device, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = ptt::allow_smem<flash_bwd_kernel<T, D>>(device,
                                                            (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * hkv, (sk + kBK - 1) / kBK);
  flash_bwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), hq,
      hkv, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared-memory bytes one block uses at head_dim d and dtype
// (0 = fp32, 1 = bf16); 0: not built.
int ptt_flash_bwd_smem_bytes(int d, int dtype) {
  if (dtype == 0)
    return d == 64 ? (int)smem_bytes<64>()
                   : d == 128 ? (int)smem_bytes<128>() : 0;
  switch (d) {
    case 32: return (int)tc_smem_bytes<32>();
    case 64: return (int)tc_smem_bytes<64>();
    case 80: return (int)tc_smem_bytes<80>();
    case 96: return (int)tc_smem_bytes<96>();
    case 128: return (int)tc_smem_bytes<128>();
  }
  return 0;
}

// q, dout [b, sq, hq, d] and k, v [b, sk, hkv, d] contiguous; lse, delta
// [b*hq, sq] fp32; dq [b, sq, hq, d] fp32 and ZEROED (the kernel adds into
// it); dk, dv like k. dtype 0 = fp32 (d 64 or 128, CUDA cores), 1 = bf16
// (d 32, 64, 80, 96 or 128, tensor cores).
int ptt_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, void* dk, void* dv, int b, int hq, int hkv,
                  int sq, int sk, int d, float scale, int causal, int dtype,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_ARGS q, k, v, dout, lse, delta, dq, dk, dv, b, hq, hkv, sq, sk, \
                 scale, causal, device, s
  if (dtype == 0 && d == 64) return launch<float, 64>(PTT_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(PTT_ARGS);
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_tc<32>(PTT_ARGS);
      case 64: return launch_tc<64>(PTT_ARGS);
      case 80: return launch_tc<80>(PTT_ARGS);
      case 96: return launch_tc<96>(PTT_ARGS);
      case 128: return launch_tc<128>(PTT_ARGS);
    }
  }
#undef PTT_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
