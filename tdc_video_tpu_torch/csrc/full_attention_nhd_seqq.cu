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
// scores per head.
//
// D = 72 is neither a power of two nor a multiple of 16: the template
// zero-pads it to 80 in shared memory (five bf16 mma K-steps) and stores only
// the 72 real columns. Query blocking over tokens, which the TPU needed to
// fit VMEM, is what every block here does anyway (64-row query tiles).
//
// What the simple design leaves on the table: as K2, plus 10% of the mma
// work spent on the zero padding of D.
#include "flash_fwd.cuh"

extern "C" int tdc_full_attention_nhd_seqq_fwd(const void* q, const void* k, const void* v,
                                               void* o, float* lse, int is_f32, int B, int T,
                                               int S, int Hq, int Hkv, int D, int kv_len,
                                               const long long* strides, int causal,
                                               float scale, void* stream) {
  if (causal || lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const tdc::FwdParams p =
      tdc::make_params(q, k, v, o, nullptr, B, T, S, Hq, Hkv, D, kv_len, strides, scale);
  return static_cast<int>(tdc::dispatch<false>(p, is_f32, static_cast<cudaStream_t>(stream)));
}
