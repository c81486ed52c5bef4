// Forward attention for sm_90a: the bf16 body of K1 (flash_kernel.cu) and K3
// (full_attention_nhd_seqq.cu) at padded head dims DP = 64, 80 and 128.
//
// It computes what flash_fwd.cuh states (f32 scores of bf16 operands scaled
// after the dot; key j visible to query i iff j < kv_len and, when CAUSAL,
// j <= i, top-left aligned even when S > T; P rounded to bf16 before PV and
// summed unrounded; O = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)))
// over the same strided operands, q [B, T, Hq, D] and k/v [B, S, Hkv, D]
// read in place through 4-D TMA tensor maps (sm90.cuh make_map).
//
// One block of 288 threads per (query head, 128 query rows, batch), heads
// fastest, so that the query heads of a GQA group are neighbouring blocks and
// read their KV head's tiles from L2, and the longest causal query tiles
// first:
//   * warp 8 is the producer: one thread loads the block's Q rows once and
//     64-key K and V tiles into an NST-stage ring by TMA, completed on
//     mbarriers (a full and an empty barrier per stage);
//   * warpgroups 0 and 1 own 64 query rows each. Per K/V tile: S = Q K^T as
//     wgmma with both operands in shared memory (K-major); the online softmax
//     in registers (row max and sum over the quad of threads that share a
//     row, exp2 by ex2.approx with the scale folded into log2(e)); P rounded
//     to bf16 straight into the A registers of O += P V, a wgmma whose B is
//     the V tile read MN-major. Only a warpgroup's last tile (the causal
//     diagonal, or the tile that holds kv_len) is masked; the mask is a
//     template parameter, so no branch lies between a wgmma and its wait.
//   * Within a warpgroup, S of tile j and P V of tile j - 1 are issued
//     together and the softmax of tile j runs while P V is in flight; O is
//     rescaled and P of tile j packed once that product has landed, and the
//     stage of tile j - 1 is handed back.
// Register budget: ptxas gives each thread at most 168 registers, the
// budget of 384 threads (whole warpgroups) rather than of 288. A consumer
// thread holds O (DP / 2 f32), S or P of one 64-key tile (32 f32) and the
// bf16 P of the tile in flight (16): 112 registers at DP = 128, 151 in all,
// no spill. 128-key tiles (S 64 registers, P 32) spilled at DP = 128 and
// ran slower.
#pragma once

#include "flash_fwd.cuh"
#include "sm90.cuh"

namespace tdc {

namespace fwd90 {
constexpr int QROWS = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int KROWS = 64;   // keys per K/V tile
constexpr int NST = 4;      // K/V ring stages
constexpr int NTHR = 288;   // consumer warpgroups 0 and 1, producer warp 8

template <int DP>
constexpr size_t smem_bytes() {  // Q, K[NST], V[NST], 2 NST + 1 mbarriers, alignment slack
  return (size_t)(QROWS + 2 * NST * KROWS) * DP * 2 + 8 * (2 * NST + 1) + 1024;
}

// One consumer warpgroup: 64 query rows, their O accumulator, S (then P) of
// the current tile, the bf16 P of the tile whose P V is in flight, and the
// online softmax state. Every method is inlined, so the arrays stay in
// registers.
template <int DP, bool CAUSAL>
struct Consumer {
  static constexpr int PW = sm90::panel_width<DP>;
  static constexpr int NP = KROWS / 16;           // k-steps of P V
  static constexpr uint32_t TK = KROWS * DP * 2;  // K or V tile bytes
  uint32_t sQ, sK, sV, bars;
  int wg, lane, r_wg, kv_len, rows[2];
  float scale_log2;
  float o[DP / 2], sc[32];
  float m_r[2], l_r[2];  // running max of the raw scores; this thread's share of the row sum
  uint32_t pa[NP][4];

  __device__ __forceinline__ void wait_full(int j) const {
    sm90::mbar_wait(bars + 8 * (j % NST), (j / NST) & 1);
  }
  __device__ __forceinline__ void release(int j) const {  // this warp is done with tile j's stage
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bars + 8 * (NST + j % NST));
  }
  // S = Q K^T of tile j, issued and committed
  __device__ __forceinline__ void issue_s(int j) {
    const uint32_t qt = sm90::opaque(sQ), kt = sm90::opaque(sK + (j % NST) * TK);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      sm90::wgmma_ss_n64(sc, sm90::desc_k<QROWS, PW>(qt, wg * 64, kk),
                         sm90::desc_k<KROWS, PW>(kt, 0, kk), kk);
    sm90::wgmma_commit();
  }
  // O += P V of tile j, issued and committed
  __device__ __forceinline__ void issue_pv(int j) {
    const uint32_t vt = sm90::opaque(sV + (j % NST) * TK);
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) sm90::wgmma_rs<DP>(o, pa[kk], sm90::desc_mn<KROWS, PW>(vt, kk), 1);
    sm90::wgmma_commit();
  }
  // online softmax of tile j's scores: sc becomes P (f32), and alpha the
  // factor by which O must be rescaled
  template <bool MASK>
  __device__ __forceinline__ void softmax(int j, float (&alpha)[2]) {
    if (MASK) {
      const int k0 = j * KROWS;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
        sc[i] = col < kv_len && (!CAUSAL || col <= rows[(i >> 1) & 1]) ? sc[i] : -INFINITY;
      }
    }
    float mx[2] = {m_r[0], m_r[1]}, mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mb[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;  // no key visible yet
      alpha[r] = sm90::exp2_approx(m_r[r] * scale_log2 - mb[r]);
      m_r[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = sm90::exp2_approx(fmaf(sc[i], scale_log2, -mb[(i >> 1) & 1]));
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
  }
  // P rounded to bf16 into the A registers of P V (sm90.cuh: the layouts)
  __device__ __forceinline__ void p_to_a() {
#pragma unroll
    for (int kk = 0; kk < NP; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
  }
  // tile 0: S, softmax, P
  template <bool MASK>
  __device__ __forceinline__ void first() {
    float alpha[2];
    wait_full(0);
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    softmax<MASK>(0, alpha);  // O is still zero
    p_to_a();
  }
  // tile j >= 1: S of tile j and P V of tile j - 1 in flight together
  template <bool MASK>
  __device__ __forceinline__ void step(int j) {
    float alpha[2];
    wait_full(j);
    sm90::wgmma_fence();
    issue_s(j);
    issue_pv(j - 1);
    sm90::wgmma_wait<1>();  // S has landed
    sm90::fence_regs(sc);
    softmax<MASK>(j, alpha);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(pa);  // read by the P V just completed: live until here
    release(j - 1);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    p_to_a();
  }
  // P V of the last tile j
  __device__ __forceinline__ void last(int j) {
    sm90::wgmma_fence();
    issue_pv(j);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(pa);
    release(j);
  }
};
}  // namespace fwd90

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(fwd90::NTHR, 1)
    flash_fwd_bf16_sm90_kernel(const FwdParams p, const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv) {
  using namespace sm90;
  using fwd90::KROWS;
  using fwd90::NST;
  using fwd90::QROWS;
  constexpr int PW = sm90::panel_width<DP>;
  constexpr uint32_t TQ = QROWS * DP * 2, TK = KROWS * DP * 2;  // tile bytes
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + TQ, sV = sK + NST * TK;
  const uint32_t bars = sV + NST * TK;  // full[NST], empty[NST], Q
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

  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qbar, TQ);
      tma_load_tile<QROWS, DP, PW>(sQ, &tq, qbar, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NST;
        mbar_wait(bars + 8 * (NST + s), ((j / NST) & 1) ^ 1);
        mbar_arrive_expect_tx(bars + 8 * s, 2 * TK);
        tma_load_tile<KROWS, DP, PW>(sK + s * TK, &tk, bars + 8 * s, hk, j * KROWS, b);
        tma_load_tile<KROWS, DP, PW>(sV + s * TK, &tv, bars + 8 * s, hk, j * KROWS, b);
      }
    }
    return;
  }

  fwd90::Consumer<DP, CAUSAL> c;
  const int t = threadIdx.x % 128, warp = t / 32;
  c.sQ = sQ;
  c.sK = sK;
  c.sV = sV;
  c.bars = bars;
  c.wg = threadIdx.x / 128;
  c.lane = t % 32;
  c.r_wg = q0 + c.wg * 64;  // this warpgroup's first query row
  // accumulator rows of this thread (sm90.cuh: the wgmma layout)
  c.rows[0] = c.r_wg + warp * 16 + c.lane / 4;
  c.rows[1] = c.rows[0] + 8;
  c.kv_len = p.kv_len;
  c.scale_log2 = p.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) c.o[i] = 0.f;
  c.m_r[0] = c.m_r[1] = -INFINITY;
  c.l_r[0] = c.l_r[1] = 0.f;

  // K/V tiles this warpgroup's rows see (it still hands back every stage);
  // r_wg is a multiple of KROWS, so tile r_wg / KROWS holds its diagonal.
  // Only the last of them can need the mask: the diagonal or kv_len.
  int n_mine = c.r_wg < p.T ? n_tiles : 0;
  if (CAUSAL) n_mine = min(n_mine, c.r_wg / KROWS + 1);
  const int k_last = (n_mine - 1) * KROWS;
  const bool mask_last = k_last + KROWS > p.kv_len || (CAUSAL && k_last + KROWS - 1 > c.r_wg);
  mbar_wait(qbar, 0);
  if (n_mine > 0) {
    if (n_mine == 1 && mask_last) c.template first<true>();
    else c.template first<false>();
    const int n_plain = mask_last ? n_mine - 1 : n_mine;
    for (int j = 1; j < n_plain; ++j) c.template step<false>(j);
    if (mask_last && n_mine > 1) c.template step<true>(n_mine - 1);
    c.last(n_mine - 1);
  }
  for (int j = n_mine; j < n_tiles; ++j) {  // tiles past this warpgroup's diagonal
    c.wait_full(j);
    c.release(j);
  }

  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = c.l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    if (c.rows[r] >= p.T) continue;
    bf16* orow = og + (long long)c.rows[r] * p.o_st;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * (c.lane % 4);
      if (col < p.D)  // D is a multiple of 8: col + 1 < D too
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(c.o[4 * n + 2 * r] / l, c.o[4 * n + 2 * r + 1] / l);
    }
    if (p.lse != nullptr && c.lane % 4 == 0)
      p.lse[((long long)b * p.Hq + h) * p.T + c.rows[r]] = c.m_r[r] * p.scale + logf(l);
  }
}

template <int DP, bool CAUSAL>
cudaError_t launch_fwd_sm90(const FwdParams& p, cudaStream_t stream) {
  constexpr int PW = sm90::panel_width<DP>;
  const int n_qt = (p.T + fwd90::QROWS - 1) / fwd90::QROWS;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t e = sm90::make_map(&tq, p.q, p.B, p.T, p.Hq, p.D, p.q_sb, p.q_st, p.q_sh, PW, fwd90::QROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tk, p.k, p.B, p.kv_len, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, PW, fwd90::KROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tv, p.v, p.B, p.kv_len, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, PW, fwd90::KROWS);
  if (e != cudaSuccess) return e;
  auto kernel = flash_fwd_bf16_sm90_kernel<DP, CAUSAL>;
  const size_t smem = fwd90::smem_bytes<DP>();
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(p.Hq, n_qt, p.B), fwd90::NTHR, smem, stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

// bf16 head dims up to 32 keep the mma.sync body of flash_fwd.cuh; wider ones
// are zero-padded to 64, 80 or 128 (wgmma's N and the panels' widths). f32
// calls take the scalar kernel.
template <bool CAUSAL>
cudaError_t dispatch_sm90(const FwdParams& p, int is_f32, cudaStream_t stream) {
  const cudaError_t e = check_fwd(p, is_f32);
  if (e != cudaSuccess) return e;
  if (is_f32) return dispatch_dp<CAUSAL, true>(p, stream);
  if (p.D <= 16) return launch<16, CAUSAL, false>(p, stream);
  if (p.D <= 32) return launch<32, CAUSAL, false>(p, stream);
  if (p.D <= 64) return launch_fwd_sm90<64, CAUSAL>(p, stream);
  if (p.D <= 80) return launch_fwd_sm90<80, CAUSAL>(p, stream);
  return launch_fwd_sm90<128, CAUSAL>(p, stream);
}

}  // namespace tdc
