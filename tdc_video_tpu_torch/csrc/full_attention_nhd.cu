// K2: non-causal full attention over the packed [B, N, H*D] layout (DINOv2).
//
// Replaces the TPU kernel _full_attention_nhd_kernel
// (tdc_video_tpu/ops/flash_attention.py:198, pallas_call in _flash_full_nhd_fwd
// at :292), the head-blocked branch taken when hb*D <= 256 (:287).
//
// Bound on the H100: at the DINOv2-giant shape (16 frames x 730 tokens x 24
// heads x 64) one call is 16 * 24 * 730^2 * 64 * 4 = 5.2e10 FLOP against
// ~9 MB of q/k/v/o, so it is compute-bound per frame at ~730^2 scores per
// head.
//
// The TPU kernel's lane blocking of heads (hb heads per 128 lanes) is a VMEM
// layout device; here each block takes one head and reads it in place
// through the head stride. Ragged tiles (730 is not a multiple of 64) mask
// columns >= N and never load V rows >= N. No lse is written, as on the TPU.
//
// What the simple design leaves on the table: the same as K1 (mma.sync, not
// wgmma; two cp.async buffers, not a TMA ring), and with N = 730 the last of
// twelve 64-key tiles and of twelve 64-row query tiles is 59% padding.
#include "flash_fwd.cuh"

extern "C" int tdc_full_attention_nhd_fwd(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int is_f32, int B, int T, int S, int Hq,
                                          int Hkv, int D, int kv_len, const long long* strides,
                                          int causal, float scale, void* stream) {
  if (causal || lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const tdc::FwdParams p =
      tdc::make_params(q, k, v, o, nullptr, B, T, S, Hq, Hkv, D, kv_len, strides, scale);
  return static_cast<int>(tdc::dispatch<false>(p, is_f32, static_cast<cudaStream_t>(stream)));
}
