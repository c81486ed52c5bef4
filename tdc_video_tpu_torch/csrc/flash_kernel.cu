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
// FLOP/byte).
//
// What the simple design leaves on the table: mma.sync m16n8k16 from
// registers, issued by each warp alone, instead of wgmma over a 64-row
// warpgroup tile (Hopper's full tensor-core rate needs wgmma); cp.async with
// two K/V buffers instead of a deeper TMA ring with a producer warp; each
// query head of a GQA group stages its KV head again (from L2) instead of
// three heads sharing one tile; the diagonal KV tile is computed whole and
// masked. With 243 registers a thread (D = 128) two blocks fit an SM.
#include "flash_fwd.cuh"

extern "C" int tdc_flash_kernel_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int is_f32, int B, int T, int S, int Hq,
                                    int Hkv, int D, int kv_len, const long long* strides,
                                    int causal, float scale, void* stream) {
  const tdc::FwdParams p =
      tdc::make_params(q, k, v, o, lse, B, T, S, Hq, Hkv, D, kv_len, strides, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      causal ? tdc::dispatch<true>(p, is_f32, st) : tdc::dispatch<false>(p, is_f32, st);
  return static_cast<int>(e);
}
