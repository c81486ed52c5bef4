// K4: non-causal full attention for T == S <= 1024, with the f32 logsumexp.
//
// Replaces the TPU kernel _full_attention_kernel
// (tdc_video_tpu/ops/flash_attention.py:104, pallas_call in _flash_full at
// :169). The JAX package reaches it through _flash_gqa (:377) for short
// non-causal attention outside the NHD rule, and in the backward of the tower
// attention, where _flash_full_nhd's VJP (:337-358) recomputes the output and
// the lse that K5 and K6 need.
//
// It computes K2's math with the lse switched on, so it is the same
// template (flash_fwd.cuh, non-causal) built as its own library with its own
// entry point and launch counter. The TPU kernel's whole-[S, S] score in VMEM
// and its frames-per-grid-step batching are VMEM and grid-overhead devices;
// here one block takes one (frame, head, 64-row query tile) and streams 64-key
// tiles with an online softmax, reading the [B, N, H, D] projections in place.
// D = 72 (SigLIP) is zero-padded to 80, as in K3.
//
// Bound on the H100: at the DINOv2-giant tower shape of the tower-trainable
// step (8 frames x 730 tokens x 24 heads x 64) one call is 8 * 24 * 730^2 *
// 64 * 4 = 2.6e10 FLOP against ~4.5 MB of q/k/v/o/lse: compute-bound.
#include "flash_fwd.cuh"

extern "C" int tdc_full_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int is_f32, int B, int T, int S, int Hq,
                                      int Hkv, int D, int kv_len, const long long* strides,
                                      int causal, float scale, void* stream) {
  if (causal || lse == nullptr || T != S) return static_cast<int>(cudaErrorInvalidValue);
  const tdc::FwdParams p =
      tdc::make_params(q, k, v, o, lse, B, T, S, Hq, Hkv, D, kv_len, strides, scale);
  return static_cast<int>(tdc::dispatch<false>(p, is_f32, static_cast<cudaStream_t>(stream)));
}
