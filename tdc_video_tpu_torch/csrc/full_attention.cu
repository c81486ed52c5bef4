// K4: non-causal full attention for T == S <= 1024, with the f32 logsumexp.
//
// Replaces the TPU kernel _full_attention_kernel
// (tdc_video_tpu/ops/flash_attention.py:104, pallas_call in _flash_full at
// :169). The JAX package reaches it through _flash_gqa (:377) for short
// non-causal attention outside the NHD rule, and in the backward of the tower
// attention, where _flash_full_nhd's VJP (:337-358) recomputes the output and
// the lse that K5 and K6 need.
//
// It computes K2's math with the lse switched on. The TPU kernel's whole-[S, S]
// score in VMEM and its frames-per-grid-step batching are VMEM and
// grid-overhead devices; here each work item takes one (frame, head, query
// tile) and streams K/V tiles with an online softmax, reading the
// [B, N, H, D] projections in place.
//
// bf16 design (sm_90a): the forward template of flash_fwd_sm90.cuh, as K2
// and K3 run it, non-causal, with the f32 lse [B, Hq, T] written per query
// row (rows past T never): DP = 64 for DINOv2, DP = 80 for SigLIP's D = 72
// (TMA zero-fills columns 72-79 of the packed projections and O is stored
// to the 72 real columns), in the instances K2 and K3 run (fwd90::Tuned: a
// persistent grid of three consumer warpgroups; 128-key tiles at DP = 64).
// Query head h reads KV head h / (Hq / Hkv), so the
// non-causal T == S <= 1024 GQA calls of _gqa_fwd run here too. Built as its
// own library with its own entry point and launch counter. bf16 D <= 32
// keeps the mma.sync body (flash_fwd.cuh); f32 the scalar one.
//
// Bound on the H100: at the DINOv2-giant tower shape of the tower-trainable
// step (8 frames x 730 tokens x 24 heads x 64) one call is 8 * 24 * 730^2 *
// 64 * 4 = 2.6e10 FLOP against ~4.5 MB of q/k/v/o/lse: compute-bound
// (0.0265 ms at the bf16 peak); what holds it back is K2's (full_attention_nhd.cu).
#include "flash_fwd_sm90.cuh"

extern "C" int tdc_full_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, int is_f32, int B, int T, int S, int Hq,
                                      int Hkv, int D, int kv_len, const long long* strides,
                                      int causal, float scale, void* stream) {
  if (causal || lse == nullptr || T != S) return static_cast<int>(cudaErrorInvalidValue);
  const tdc::FwdParams p =
      tdc::make_params(q, k, v, o, lse, B, T, S, Hq, Hkv, D, kv_len, strides, scale);
  return static_cast<int>(tdc::dispatch_sm90<false, true>(p, is_f32, static_cast<cudaStream_t>(stream)));
}
