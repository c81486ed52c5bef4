// K3: non-causal full attention over the packed [B, N, H*D] layout (SigLIP).
//
// Replaces the TPU kernel _full_attention_nhd_seqq_kernel
// (tdc_video_tpu/ops/flash_attention.py:242, pallas_call in _flash_full_nhd_fwd
// at :310), the branch for head dims whose minimal 128-lane head block is too
// wide (hb*D > 256), which blocks q over tokens and loops over heads.
//
// Bound on the H100: at the SigLIP-so400m shape (16 frames x 729 tokens x 16
// heads x 72) one call is 16 * 16 * 729^2 * 72 * 4 = 3.9e10 FLOP against
// ~7 MB of q/k/v/o, so it is compute-bound per frame at ~729^2
// scores per head: 0.0396 ms at the bf16 peak.
//
// bf16 design (sm_90a, flash_fwd_sm90.cuh, non-causal, no lse; the same
// kernel body as K2 and K4): D = 72 runs as 80, five 16-wide panels with
// 32-byte swizzle. The tensor maps read the packed [B, N, H * D] projections
// in place with the head dims' true extent (72), so TMA zero-fills columns
// 72-79 of every box and never reads the next head's columns; O is stored
// to the 72 real columns only. Keys past 729 are zero-filled too, but their
// scores are 0, not -inf: the last 64-key tile (keys 704-767) is the one
// tile that is masked. DP = 80's instance (fwd90::Tuned) runs a persistent
// grid, one block per SM walking (frame, head, 192 query rows) items with
// three consumer warpgroups, the 64-key K/V tiles streaming through a
// 4-stage TMA ring across items; both products are wgmma. Query blocking over
// tokens, which the TPU needed to fit VMEM, is what every item here does
// anyway. What it leaves: 10% of the products multiply the zero padding of
// D; the last query tile of a frame (576-767) is a fifth padding; O is
// stored from registers; 128-key tiles, which help at DP = 64, ran slower
// here. bf16 D <= 32 keeps the mma.sync body (flash_fwd.cuh); f32 the
// scalar one.
#include "flash_fwd_sm90.cuh"

extern "C" int tdc_full_attention_nhd_seqq_fwd(const void* q, const void* k, const void* v,
                                               void* o, float* lse, int is_f32, int B, int T,
                                               int S, int Hq, int Hkv, int D, int kv_len,
                                               const long long* strides, int causal,
                                               float scale, void* stream) {
  if (causal || lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const tdc::FwdParams p =
      tdc::make_params(q, k, v, o, nullptr, B, T, S, Hq, Hkv, D, kv_len, strides, scale);
  return static_cast<int>(tdc::dispatch_sm90<false, false>(p, is_f32, static_cast<cudaStream_t>(stream)));
}
