// K5: dQ of attention by recomputation.
//
// Replaces the TPU kernel _flash_dq_kernel (tdc_video_tpu/ops/flash_attention.py:433,
// pallas_call in _flash_gqa_bwd at :582), the first half of the custom VJP of
// _flash_core (:644-670). It runs in the LM backward (causal GQA, D = 128) and,
// when the towers train, in the tower backward (non-causal, D = 64 and 72).
//
// One block per (batch, query head, 64-row query tile); each of its four
// warps owns 16 query rows and walks the KV axis in 64-key tiles up to the
// top-left causal bound, like the forward. Per tile, in registers:
// S = Q K^T, P = exp(scale S - lse) masked, dP = dO V^T, dS = P (dP - delta),
// and dQ += dS K, where dS is rounded to bf16 in place into the A-operand
// fragments of the last product. Q and dO stay in shared memory and are
// re-read with ldmatrix each tile (that keeps the four f32 tiles S, dP and
// the dQ accumulator under the register limit at D = 128); K and V are
// double-buffered with cp.async.
//
// Bound on the H100: at the stage-2 LM shape (T = S = 8192, 24 query heads,
// D = 128, causal) one call is 3 products over the causal half, 6 * 24 *
// 8192^2 / 2 * 128 = 6.2e11 FLOP against ~0.19 GB of operands and dQ:
// compute-bound.
//
// What the simple design leaves on the table: mma.sync from registers, not
// wgmma; S and dP are recomputed here and again in K6 (a fused dQ/dK/dV
// kernel with atomics would compute them once); each query head of a GQA
// group streams its KV head again (from L2).
#include "flash_bwd.cuh"

namespace tdc {

template <int DP>
constexpr size_t dq_smem_bf16() {
  return (size_t)(2 * BM + 4 * BN) * (DP + 8) * sizeof(bf16);  // Q, dO, K[2], V[2]
}

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS) flash_dq_bf16_kernel(const BwdParams p) {
  constexpr int LD = DP + 8;
  constexpr int NK = DP / 16;  // k-steps over the head dim
  constexpr int NO = DP / 8;   // 8-wide column tiles of dQ
  constexpr int NS = BN / 8;   // 8-wide column tiles of S and dP
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + BM * LD;
  bf16* Ks = Ds + BM * LD;
  bf16* Vs = Ks + 2 * BN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the longest causal tiles start first
  const int b = blockIdx.z, h = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int hk = h / (p.Hq / p.Hkv);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dg = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  int n_tiles = (p.kv_len + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, min(q0 + BM - 1, p.T - 1) / BN + 1);

  load_tile<BM, DP>(Qs, qg, p.q_st, q0, p.T, p.D, tid);
  load_tile<BM, DP>(Ds, dg, p.do_st, q0, p.T, p.D, tid);
  load_tile<BN, DP>(Ks, kg, p.k_ss, 0, p.kv_len, p.D, tid);
  load_tile<BN, DP>(Vs, vg, p.v_ss, 0, p.kv_len, p.D, tid);
  cp_async_commit();

  // fragment coordinates: rows g and g + 8 of the warp's 16, columns 2 t4
  // and 2 t4 + 1 of every 8-wide tile
  const int g = lane >> 2, t4 = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale * LOG2E;
  float lse_log2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = ((long long)b * p.Hq + h) * p.T + rows[r];
    lse_log2[r] = rows[r] < p.T ? p.lse[i] * LOG2E : 0.f;
    dlt[r] = rows[r] < p.T ? p.delta[i] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int nb = (buf ^ 1) * BN * LD;
      load_tile<BN, DP>(Ks + nb, kg, p.k_ss, (j + 1) * BN, p.kv_len, p.D, tid);
      load_tile<BN, DP>(Vs + nb, vg, p.v_ss, (j + 1) * BN, p.kv_len, p.D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested has landed
    __syncthreads();
    const bf16* Kb = Ks + buf * BN * LD;
    const bf16* Vb = Vs + buf * BN * LD;

    // S = Q K^T and dP = dO V^T: A from the staged Q / dO rows, B from the
    // K / V rows (ldmatrix without transpose is the col-major B operand)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t qa[4], da[4];
      const int a_off = (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(qa, smem_u32(Qs + a_off));
      ldmatrix_x4(da, smem_u32(Ds + a_off));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        const int b_off = (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, smem_u32(Kb + b_off));
        mma_bf16(s[n], qa, kb[0], kb[1]);
        mma_bf16(s[n + 1], qa, kb[2], kb[3]);
        ldmatrix_x4(vb, smem_u32(Vb + b_off));
        mma_bf16(dp[n], da, vb[0], vb[1]);
        mma_bf16(dp[n + 1], da, vb[2], vb[3]);
      }
    }

    // dS = P (dP - delta), rounded to bf16 into the A-operand fragments of
    // dS K (k-step kk = column tiles 2 kk and 2 kk + 1)
    const int k0 = j * BN;
    uint32_t dsf[BN / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t4 + (e & 1), row = rows[e >> 1];
        const bool vis = col < p.kv_len && row < p.T && (!CAUSAL || col <= row);
        const float pr = vis ? exp2f(fmaf(s[n][e], scale_log2, -lse_log2[e >> 1])) : 0.f;
        ds[e] = pr * (dp[n][e] - dlt[e >> 1]);
      }
      dsf[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K: ldmatrix.trans of K's [key, d] rows is the B operand
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, smem_u32(Kb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       (n + (lane >> 4)) * 8));
        mma_bf16(acc[n], dsf[kk], kb[0], kb[1]);
        mma_bf16(acc[n + 1], dsf[kk], kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.T) continue;
    bf16* drow = dqg + (long long)rows[r] * p.dq_st;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < p.D)  // D is a multiple of 8: col + 1 < D too
        *reinterpret_cast<uint32_t*>(drow + col) =
            pack_bf16(p.scale * acc[n][2 * r], p.scale * acc[n][2 * r + 1]);
    }
  }
}

// f32: each pair of lanes owns one query row; each lane takes half of the
// tile's keys for S, P, dP and dS, and half of the head dims for dQ.
template <int DP>
constexpr size_t dq_smem_f32() {
  return (size_t)(2 * BM * DP + 2 * BN * DP + BM * BN) * sizeof(float);  // Q, dO, K, V, dS
}

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS) flash_dq_f32_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ds = Qs + BM * DP;
  float* Ks = Ds + BM * DP;
  float* Vs = Ks + BN * DP;
  float* Ss = Vs + BN * DP;  // dS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BM * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP, row = q0 + r;
    const bool in = row < p.T && c < p.D;
    Qs[i] = in ? qg[(long long)row * p.q_st + c] : 0.f;
    Ds[i] = in ? dg[(long long)row * p.do_st + c] : 0.f;
  }
  const int r_loc = warp * 16 + (lane >> 1), half = lane & 1;
  const int row = q0 + r_loc;
  const long long li = ((long long)b * p.Hq + h) * p.T + row;
  const float lse = row < p.T ? p.lse[li] : 0.f;
  const float dlt = row < p.T ? p.delta[li] : 0.f;
  int n_tiles = (p.kv_len + BN - 1) / BN;
  if (CAUSAL) n_tiles = min(n_tiles, min(q0 + BM - 1, p.T - 1) / BN + 1);
  constexpr int HD = DP / 2;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // all warps are done with the previous K/V tile
    for (int i = tid; i < BN * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP, key = k0 + r;
      const bool in = key < p.kv_len && c < p.D;
      Ks[i] = in ? kg[(long long)key * p.k_ss + c] : 0.f;
      Vs[i] = in ? vg[(long long)key * p.v_ss + c] : 0.f;
    }
    __syncthreads();
    for (int c = half * (BN / 2); c < (half + 1) * (BN / 2); ++c) {
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < DP; ++d) {
        s = fmaf(Qs[r_loc * DP + d], Ks[c * DP + d], s);
        dp = fmaf(Ds[r_loc * DP + d], Vs[c * DP + d], dp);
      }
      const int col = k0 + c;
      const bool vis = col < p.kv_len && row < p.T && (!CAUSAL || col <= row);
      const float pr = vis ? expf(s * p.scale - lse) : 0.f;
      Ss[r_loc * BN + c] = pr * (dp - dlt);
    }
    __syncwarp();
    for (int c = 0; c < BN; ++c) {
      const float ds = Ss[r_loc * BN + c];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, Ks[c * DP + half * HD + d], acc[d]);
    }
  }

  if (row < p.T) {
    float* drow = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh + (long long)row * p.dq_st;
#pragma unroll
    for (int d = 0; d < HD; ++d)
      if (half * HD + d < p.D) drow[half * HD + d] = p.scale * acc[d];
  }
}

template <int DP, bool CAUSAL>
cudaError_t launch_dq(const BwdParams& p, int is_f32, cudaStream_t stream) {
  const dim3 grid((p.T + BM - 1) / BM, p.Hq, p.B);
  if (is_f32) return launch_bwd(flash_dq_f32_kernel<DP, CAUSAL>, grid, dq_smem_f32<DP>(), p, stream);
  return launch_bwd(flash_dq_bf16_kernel<DP, CAUSAL>, grid, dq_smem_bf16<DP>(), p, stream);
}

template <bool CAUSAL>
cudaError_t dispatch_dq(const BwdParams& p, int is_f32, cudaStream_t stream) {
  if (p.D <= 16) return launch_dq<16, CAUSAL>(p, is_f32, stream);
  if (p.D <= 32) return launch_dq<32, CAUSAL>(p, is_f32, stream);
  if (p.D <= 64) return launch_dq<64, CAUSAL>(p, is_f32, stream);
  if (p.D <= 80) return launch_dq<80, CAUSAL>(p, is_f32, stream);
  return launch_dq<128, CAUSAL>(p, is_f32, stream);
}

}  // namespace tdc

extern "C" int tdc_flash_dq_kernel_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dq, void* dk, void* dv, int is_f32, int B, int T,
                                       int S, int Hq, int Hkv, int D, int kv_len,
                                       const long long* strides, int causal, float scale,
                                       void* stream) {
  const tdc::BwdParams p = tdc::make_bwd_params(q, k, v, dout, lse, delta, dq, dk, dv, B, T, S,
                                                Hq, Hkv, D, kv_len, strides, scale);
  cudaError_t e = tdc::check_bwd(p, is_f32);
  if (e == cudaSuccess && (dq == nullptr || (!is_f32 && reinterpret_cast<uintptr_t>(dq) % 4 != 0)))
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = causal ? tdc::dispatch_dq<true>(p, is_f32, st) : tdc::dispatch_dq<false>(p, is_f32, st);
  return static_cast<int>(e);
}
