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
// layout device; here each work item takes one head and reads it in place
// through the head stride. No lse is written, as on the TPU.
//
// bf16 design (sm_90a): the forward template of flash_fwd_sm90.cuh that K1
// and K3 run, non-causal, at DP = 64: K2 and K3 are one kernel body at DP 64
// and 80, with their own entry points, libraries and launch counters. The
// tensor maps read the packed [B, N, H * 64] projections in place; keys past
// N are zero-filled by TMA, so their scores are 0, not -inf: the last K/V
// tile (keys 640-767 at N = 730) is the one tile that is masked, and query
// rows past N are never stored. DP = 64's instance (fwd90::Tuned) is tuned
// for the towers' short sequences: a persistent grid, one block per SM
// walking (frame, head, 192 query rows) items, so that the next item's Q
// and first K/V tiles load while this one finishes; three consumer
// warpgroups given 160 registers each by setmaxnreg (the producer
// warpgroup keeps 24), which fits 128-key tiles: 6 a frame instead of 12,
// half the barriers, rescales and stage hand-backs. What it leaves: at
// N = 730 the last query and key tiles are mostly padding (5% more products
// than the 730^2 the bound counts); at D = 64 the softmax's exponentials, at
// the SFU's 16 a clock an SM, take as long as the products at the tensor
// cores' peak, so only a perfect overlap of the two would reach the bound;
// O is stored from registers. bf16 D <= 32 keeps the mma.sync body
// (flash_fwd.cuh); f32 the scalar one.
#include "flash_fwd_sm90.cuh"

extern "C" int tdc_full_attention_nhd_fwd(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int is_f32, int B, int T, int S, int Hq,
                                          int Hkv, int D, int kv_len, const long long* strides,
                                          int causal, float scale, void* stream) {
  if (causal || lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const tdc::FwdParams p =
      tdc::make_params(q, k, v, o, nullptr, B, T, S, Hq, Hkv, D, kv_len, strides, scale);
  return static_cast<int>(tdc::dispatch_sm90<false, false>(p, is_f32, static_cast<cudaStream_t>(stream)));
}
