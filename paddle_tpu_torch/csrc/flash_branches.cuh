// The optional branches of the flash attention kernels (forward and
// backward), as the reference's Pallas kernels take them:
// - an additive fp32 mask [1|b, 1|hq, 1|sq, sk], read with a stride of 0
//   on each broadcast dim and added to the scores after the causal mask;
// - per-sequence lengths (q_len; kv_len), int32 [2, b]: keys at kv_len and
//   beyond are masked, causal attention aligns bottom-right per sequence
//   (row r sees keys <= r + kv_len - q_len), rows at q_len and beyond are
//   zero with lse = 1e30 (forward) and get no gradient (backward).
#pragma once

namespace ptt {

struct FlashBranches {
  const float* mask;        // nullptr: no mask
  long long sb, sh, sr;     // its batch / head / row strides (0: broadcast)
  const int* lens;          // nullptr: full lengths; else [2, nb]
  int nb;                   // batch size (the row stride of lens)
};

// What one sequence of a block sees: its valid q rows and keys (clamped to
// the padded lengths) and the causal offset (row r sees keys <= r + off).
// The kernels take each branch under a template flag (MASK, LENS): without
// LENS the view is the padded lengths, known to the compiler, so the
// instantiation without either flag is the kernel without the branches.
struct SeqView {
  int q_valid, k_valid, off;
};

template <bool LENS>
__device__ __forceinline__ SeqView seq_view(const FlashBranches& br, int b,
                                            int sq, int sk) {
  if (!LENS) return {sq, sk, sk - sq};
  const int ql = br.lens[b], kl = br.lens[br.nb + b];
  return {min(max(ql, 0), sq), min(max(kl, 0), sk), kl - ql};
}

// The mask's [sq or 1, sk] plane of batch b, head h (row stride br.sr);
// nullptr without MASK.
template <bool MASK>
__device__ __forceinline__ const float* mask_plane(const FlashBranches& br,
                                                   int b, int h) {
  return MASK ? br.mask + b * br.sb + h * br.sh : nullptr;
}

}  // namespace ptt
