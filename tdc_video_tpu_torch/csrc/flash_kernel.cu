// K1: causal GQA attention for LM prefill.
//
// Replaces the TPU kernel _flash_kernel (tdc_video_tpu/ops/flash_attention.py:38,
// pallas_call in _flash_gqa at :389), reached from flash_attention (:725) for
// causal calls and for non-causal calls outside the ViT-tower shapes.
//
// Bound on the H100: at the TDC-Llama3.2-3B prefill (q [1, T~1.4k, 24, 128],
// k/v [1, S = T + 16, 8, 128] bf16) the causal half of the score matrix is
// ~24 * T^2 / 2 dot products of length 128, twice (QK^T and PV): about
// 2 * 24 * 1.0e6 * 128 * 2 = 1.2e10 FLOP per layer against ~3 MB of q/k/v/o,
// so it is compute-bound by three orders of magnitude (bf16 ridge ~295
// FLOP/byte): 0.0125 ms at the bf16 peak. At the stage-2 training shape (T =
// S = 8192) one call is 4.1e11 FLOP, 0.417 ms at the peak.
//
// bf16 design (sm_90a, flash_fwd_sm90.cuh) at D = 128 (and any D in 33..128):
// wgmma for both products (S = Q K^T from shared memory, O += P V with P in
// registers), where the mma.sync body issues m16n8k16 per warp from
// ldmatrix fragments; a producer warp keeps up to four 64-key K/V tiles
// in flight by TMA, straight from the strided q/k/v and the per-layer view of
// the stacked KV cache, instead of cp.async double buffering with a
// __syncthreads per tile; the mask is evaluated on the diagonal tile and the
// ragged kv_len tile only; exp2 by ex2.approx; S of the next tile and P V of
// this one are in flight while the softmax runs. One block (two consumer
// warpgroups, 128 query rows) per SM. What it leaves: the three query heads
// of a GQA group each stream their KV head from L2 (they are neighbouring
// blocks); the two warpgroups are not scheduled to alternate softmax and
// products; O is stored from registers. The serving grid (12 query tiles x 24
// heads at T = 1416) is about 2.2 waves of 132 SMs, longest causal tiles
// first. bf16 D <= 32 keeps the mma.sync body (flash_fwd.cuh); f32 the scalar
// one.
#include "flash_fwd_sm90.cuh"

extern "C" int tdc_flash_kernel_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int is_f32, int B, int T, int S, int Hq,
                                    int Hkv, int D, int kv_len, const long long* strides,
                                    int causal, float scale, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);  // K1 always writes it
  const tdc::FwdParams p =
      tdc::make_params(q, k, v, o, lse, B, T, S, Hq, Hkv, D, kv_len, strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = causal ? tdc::dispatch_sm90<true, true>(p, is_f32, st)
                               : tdc::dispatch_sm90<false, true>(p, is_f32, st);
  return static_cast<int>(e);
}
