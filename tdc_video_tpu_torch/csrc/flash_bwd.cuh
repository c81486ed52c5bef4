// Backward attention shared by K5 (dQ) and K6 (dK, dV).
//
// Both recompute the probabilities from the forward's residuals instead of
// storing them (flash-attention backward):
//
//   S = scale * Q K^T              f32 dot of input-dtype operands
//   P = exp(S - lse)               masked: col < kv_len, and col <= row +
//                                  q_offset when CAUSAL (top-left aligned at
//                                  q_offset = 0), and row < T
//   dP = dO V^T                    f32
//   dS = P * (dP - delta)          delta = rowsum(dO * O) in f32, computed by
//                                  the caller as the JAX package does
//   dQ = scale * dS K              dS rounded to the input dtype first
//   dK = scale * dS^T Q            summed over the query heads of a GQA group
//   dV = P^T dO                    P rounded to the input dtype first
//
// Operands are read in place through strides: q, dO [B, T, Hq, D], k, v
// [B, S, Hkv, D] (the last dim contiguous); lse and delta are [B, Hq, T] f32.
// Query rows >= T and keys >= kv_len are zero-filled when staged and masked
// out of P, so they never contribute, and a zero dO row gives an exactly zero
// dQ row (dP = 0 and delta = 0 there).
//
// The bf16 kernels are written for sm_90a (sm90.cuh): TMA loads into a ring
// of shared-memory stages completed on mbarriers, one producer warpgroup and
// two consumer warpgroups, and wgmma with f32 accumulators. They keep the
// identity between the accumulator fragment of a 64-row wgmma tile and the
// A-operand registers of the next product, so P and dS go from one product
// into the next without leaving registers. The f32 kernels are scalar FMA
// loops of the same math, used for exact checks.
#pragma once

#include "flash_fwd.cuh"

namespace tdc {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Hq, T]
  const float* delta;  // [B, Hq, T]
  void* dq;            // [B, T, Hq, D] (K5)
  void* dk;            // [B, S, Hkv, D] (K6)
  void* dv;
  int B, T, S, Hq, Hkv, D, kv_len;
  int q_offset;  // causal only: query i is row i + q_offset of the sequence
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale;
};

// strides: q, k, v, dO, dQ, dK, dV (batch, token, head), in elements.
inline BwdParams make_bwd_params(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq, void* dk,
                                 void* dv, int B, int T, int S, int Hq, int Hkv, int D,
                                 int kv_len, const long long* st, int q_offset, float scale) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.T = T;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.kv_len = kv_len;
  p.q_offset = q_offset;
  long long* dst[21] = {&p.q_sb,  &p.q_st,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,  &p.v_sb,
                        &p.v_ss,  &p.v_sh,  &p.do_sb, &p.do_st, &p.do_sh, &p.dq_sb, &p.dq_st,
                        &p.dq_sh, &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 21; ++i) *dst[i] = st[i];
  p.scale = scale;
  return p;
}

// The checks every backward entry point makes before it launches; bf16
// operands move in 16-byte chunks and outputs are stored as bf16 pairs.
inline cudaError_t check_bwd(const BwdParams& p, int is_f32) {
  if (p.B <= 0 || p.T <= 0 || p.Hq <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.kv_len <= 0 ||
      p.kv_len > p.S || p.B > 65535 || p.Hq > 65535 || p.D <= 0 || p.D > 128 ||
      p.lse == nullptr || p.delta == nullptr || p.q_offset < 0 ||
      (p.q_offset > 0 && p.q_offset + p.T > p.S)) {
    return cudaErrorInvalidValue;
  }
  if (is_f32) return cudaSuccess;
  const long long st[12] = {p.q_sb, p.q_st, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
                            p.v_sb, p.v_ss, p.v_sh, p.do_sb, p.do_st, p.do_sh};
  for (long long s : st)
    if (s % 8 != 0) return cudaErrorInvalidValue;
  const void* ptrs[4] = {p.q, p.k, p.v, p.dout};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorMisalignedAddress;
  if (p.D % 8 != 0 || p.dq_st % 2 != 0 || p.dk_ss % 2 != 0 || p.dv_ss % 2 != 0)
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

inline cudaError_t launch_bwd(void (*kernel)(const BwdParams), dim3 grid, size_t smem,
                              const BwdParams& p, cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tdc
