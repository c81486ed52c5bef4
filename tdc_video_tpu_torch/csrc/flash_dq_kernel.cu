// K5: dQ of attention by recomputation.
//
// Replaces the TPU kernel _flash_dq_kernel (tdc_video_tpu/ops/flash_attention.py:433,
// pallas_call in _flash_gqa_bwd at :582), the first half of the custom VJP of
// _flash_core (:644-670). It runs in the LM backward (causal GQA, D = 128) and,
// when the towers train, in the tower backward (non-causal, D = 64 and 72).
//
// Bound on the H100: at the stage-2 LM shape (T = S = 8192, 24 query heads,
// D = 128, causal) one call is 3 products over the causal half, 6 * 24 *
// 8192^2 / 2 * 128 = 6.2e11 FLOP against ~0.19 GB of operands and dQ:
// bound by operations (0.63 ms at the bf16 peak).
//
// bf16 design (sm_90a): one block of three warpgroups per (query head, 128
// query rows, batch), heads fastest and the longest causal query tiles first:
//   * warpgroup 2 is the producer (setmaxnreg 40): one thread issues TMA
//     loads of the block's Q and dO rows (resident) and of 64-key K/V tiles
//     into a 3-stage ring, completed on mbarriers;
//   * warpgroups 0 and 1 own 64 query rows each (setmaxnreg 232). Per K/V
//     tile, in two halves of 32 keys: S = Q K^T and dP = dO V^T as wgmma
//     with both operands in shared memory (K-major), P = exp2(scale log2(e)
//     S - log2(e) lse) masked while dP is still in flight, dS = P (dP -
//     delta) rounded to bf16 straight into the A registers of dQ += dS K, a
//     wgmma whose B is the same K tile read MN-major; then each warp hands
//     the stage back to the producer.
// What it does about the limits of the mma.sync kernel it replaces: every
// product is a wgmma (no ldmatrix; only dS passes through registers); 64 f32
// registers of dQ and 16 each of a half tile's S and dP a thread fit with no
// spill (whole 64-key tiles spill at D = 128); the producer keeps up to
// three tiles in flight while both consumers compute, and no
// __syncthreads() ties the warps together (each stage has a full and an
// empty mbarrier); Q and dO stay in shared memory for wgmma instead of
// being reloaded into registers each tile. Each query head still streams its
// group's K/V tiles, from L2 (the heads of a group are neighbouring blocks).
#include "flash_bwd.cuh"
#include "sm90.cuh"

namespace tdc {

namespace k5 {
constexpr int QROWS = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int KROWS = 64;   // keys per K/V tile
constexpr int NST = 3;      // K/V ring stages
constexpr int NTHR = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2

template <int DP>
constexpr size_t smem_bytes() {  // Q, dO, K[NST], V[NST], 2 NST + 1 mbarriers, alignment slack
  return (size_t)(2 * QROWS + 2 * NST * KROWS) * DP * 2 + 8 * (2 * NST + 1) + 1024;
}
}  // namespace k5

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(k5::NTHR, 1)
    flash_dq_bf16_kernel(const BwdParams p, const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv) {
  using namespace sm90;
  using k5::KROWS;
  using k5::NST;
  using k5::QROWS;
  constexpr int PW = sm90::panel_width<DP>;
  constexpr uint32_t TQ = QROWS * DP * 2, TK = KROWS * DP * 2;  // tile bytes
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sD = base + TQ, sK = base + 2 * TQ, sV = sK + NST * TK;
  const uint32_t bars = sV + NST * TK;  // full[NST], empty[NST], Q/dO
  const uint32_t qbar = bars + 16 * NST;

  const int b = blockIdx.z, h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QROWS;  // the longest causal tiles start first
  const int hk = h / (p.Hq / p.Hkv);
  int n_tiles = (p.kv_len + KROWS - 1) / KROWS;
  if (CAUSAL) n_tiles = min(n_tiles, min(q0 + QROWS - 1, p.T - 1) / KROWS + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NST + s), 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qbar, 2 * TQ);
      tma_load_tile<QROWS, DP, PW>(sQ, &tq, qbar, h, q0, b);
      tma_load_tile<QROWS, DP, PW>(sD, &tdo, qbar, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NST;
        mbar_wait(bars + 8 * (NST + s), ((j / NST) & 1) ^ 1);
        mbar_arrive_expect_tx(bars + 8 * s, 2 * TK);
        tma_load_tile<KROWS, DP, PW>(sK + s * TK, &tk, bars + 8 * s, hk, j * KROWS, b);
        tma_load_tile<KROWS, DP, PW>(sV + s * TK, &tv, bars + 8 * s, hk, j * KROWS, b);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r_wg = q0 + wg * 64;  // this warpgroup's first query row
    // accumulator rows of this thread (sm90.cuh: the wgmma layout)
    const int rows[2] = {r_wg + warp * 16 + lane / 4, r_wg + warp * 16 + lane / 4 + 8};
    const float scale_log2 = p.scale * LOG2E;
    float lse_log2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = ((long long)b * p.Hq + h) * p.T + rows[r];
      lse_log2[r] = rows[r] < p.T ? p.lse[i] * LOG2E : 0.f;
      dlt[r] = rows[r] < p.T ? p.delta[i] : 0.f;
    }
    // K/V tiles this warpgroup's rows see (it still releases every stage)
    int n_mine = r_wg < p.T ? n_tiles : 0;
    if (CAUSAL) n_mine = min(n_mine, (r_wg + 63) / KROWS + 1);
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    mbar_wait(qbar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % NST;
      mbar_wait(bars + 8 * s, (j / NST) & 1);
      if (j < n_mine) {
        const uint32_t kt = opaque(sK + s * TK), vt = opaque(sV + s * TK);
        const uint32_t qt = opaque(sQ), dt = opaque(sD);
        const int k0 = j * KROWS;
        // masked only where the tile crosses the diagonal, kv_len or T
        const bool mask = k0 + KROWS > p.kv_len || r_wg + 64 > p.T || (CAUSAL && k0 + KROWS - 1 > r_wg);
        // two halves of 32 keys: S and dP of a half take 16 registers each
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float sc[16], dp[16];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)
            wgmma_ss_n32(sc, desc_k<QROWS, PW>(qt, wg * 64, kk), desc_k<KROWS, PW>(kt, half * 32, kk), kk);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)
            wgmma_ss_n32(dp, desc_k<QROWS, PW>(dt, wg * 64, kk), desc_k<KROWS, PW>(vt, half * 32, kk), kk);
          wgmma_commit();
          // P while dP is in flight
          wgmma_wait<1>();
          fence_regs(sc);
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int col = k0 + half * 32 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
            const int row = rows[(i >> 1) & 1];
            const float pr = exp2_approx(fmaf(sc[i], scale_log2, -lse_log2[(i >> 1) & 1]));
            sc[i] = mask && !(col < p.kv_len && row < p.T && (!CAUSAL || col <= row)) ? 0.f : pr;
          }
          wgmma_wait<0>();
          fence_regs(dp);
          // dS = P (dP - delta), rounded to bf16 into the A registers of dS K
          uint32_t dsf[2][4];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int i = 8 * kk + 2 * x, r = x & 1;
              dsf[kk][x] = pack_bf16(sc[i] * (dp[i] - dlt[r]), sc[i + 1] * (dp[i + 1] - dlt[r]));
            }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 2; ++kk)
            wgmma_rs<DP>(acc, dsf[kk], desc_mn<KROWS, PW>(kt, half * 2 + kk), 1);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (NST + s));  // this warp is done with the stage
    }

    bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.T) continue;
      bf16* drow = dqg + (long long)rows[r] * p.dq_st;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * (lane % 4);
        if (col < p.D)  // D is a multiple of 8: col + 1 < D too
          *reinterpret_cast<uint32_t*>(drow + col) =
              pack_bf16(p.scale * acc[4 * n + 2 * r], p.scale * acc[4 * n + 2 * r + 1]);
      }
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
cudaError_t launch_dq_bf16(const BwdParams& p, cudaStream_t stream) {
  constexpr int PW = sm90::panel_width<DP>;
  const int n_qt = (p.T + k5::QROWS - 1) / k5::QROWS;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t e = sm90::make_map(&tq, p.q, p.B, p.T, p.Hq, p.D, p.q_sb, p.q_st, p.q_sh, PW, k5::QROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tdo, p.dout, p.B, p.T, p.Hq, p.D, p.do_sb, p.do_st, p.do_sh, PW, k5::QROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tk, p.k, p.B, p.kv_len, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, PW, k5::KROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tv, p.v, p.B, p.kv_len, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, PW, k5::KROWS);
  if (e != cudaSuccess) return e;
  auto kernel = flash_dq_bf16_kernel<DP, CAUSAL>;
  const size_t smem = k5::smem_bytes<DP>();
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(p.Hq, n_qt, p.B), k5::NTHR, smem, stream>>>(p, tq, tdo, tk, tv);
  return cudaGetLastError();
}

template <int DP, bool CAUSAL>
cudaError_t launch_dq_f32(const BwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.T + BM - 1) / BM, p.Hq, p.B);
  return launch_bwd(flash_dq_f32_kernel<DP, CAUSAL>, grid, dq_smem_f32<DP>(), p, stream);
}

// Head dims are zero-padded up to the next instantiated width: 64, 80 or 128
// for bf16 (wgmma's N and the panels' widths), 16, 32, 64, 80 or 128 for f32.
template <bool CAUSAL>
cudaError_t dispatch_dq(const BwdParams& p, int is_f32, cudaStream_t stream) {
  if (!is_f32) {
    if (p.D <= 64) return launch_dq_bf16<64, CAUSAL>(p, stream);
    if (p.D <= 80) return launch_dq_bf16<80, CAUSAL>(p, stream);
    return launch_dq_bf16<128, CAUSAL>(p, stream);
  }
  if (p.D <= 16) return launch_dq_f32<16, CAUSAL>(p, stream);
  if (p.D <= 32) return launch_dq_f32<32, CAUSAL>(p, stream);
  if (p.D <= 64) return launch_dq_f32<64, CAUSAL>(p, stream);
  if (p.D <= 80) return launch_dq_f32<80, CAUSAL>(p, stream);
  return launch_dq_f32<128, CAUSAL>(p, stream);
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
