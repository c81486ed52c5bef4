// Forward attention for sm_90a: the bf16 body of all four forward kernels,
// K1 (flash_kernel.cu), K2 (full_attention_nhd.cu), K3
// (full_attention_nhd_seqq.cu) and K4 (full_attention.cu), at padded head
// dims DP = 64, 80 and 128.
//
// It computes what flash_fwd.cuh states (f32 scores of bf16 operands scaled
// after the dot; key j visible to query i iff j < kv_len and, when CAUSAL,
// j <= i, top-left aligned even when S > T; P rounded to bf16 before PV and
// summed unrounded; O = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)),
// written when LSE) over the same strided operands, q [B, T, Hq, D] and k/v
// [B, S, Hkv, D] read in place through 4-D TMA tensor maps (sm90.cuh
// make_map).
//
// A work item is (query head, NWG * 64 query rows, batch), heads fastest, so
// that the query heads of a GQA group are neighbouring items and read their
// KV head's tiles from L2, and the longest causal query tiles first. A block
// is NWG consumer warpgroups and a producer:
//   * one producer thread loads the item's Q rows once and K and V tiles
//     (KROWS keys) into an NST-stage ring by TMA, completed on mbarriers (a
//     full and an empty barrier per stage);
//   * each consumer warpgroup owns 64 query rows. Per K/V tile: S = Q K^T as
//     wgmma with both operands in shared memory (K-major); the online
//     softmax in registers (row max and sum over the quad of threads that
//     share a row, exp2 by ex2.approx with the scale folded into log2(e)); P
//     rounded to bf16 straight into the A registers of O += P V, a wgmma
//     whose B is the V tile read MN-major. Only a warpgroup's last tile (the
//     causal diagonal, or the tile that holds kv_len) is masked; the mask is
//     a template parameter, so no branch lies between a wgmma and its wait.
//   * Within a warpgroup, S of tile j and P V of tile j - 1 are issued
//     together and the softmax of tile j runs while P V is in flight; O is
//     rescaled and P of tile j packed once that product has landed, and the
//     stage of tile j - 1 is handed back.
// fwd90::Cfg sets the instance's shape and fwd90::Tuned picks one by DP and
// causality (fwd90::Tuned: which, and why two schedules). The ring has 4
// stages throughout.
// Register budget: ptxas allocates by the warps on one SM sub-partition:
// 168 registers a thread at 9 warps (2 consumer warpgroups and the producer
// warp), 128 at 13 (3 and a warp), 96 at 17 or at two blocks of 9 (both
// spilled, so one block per SM). A consumer thread holds O (DP / 2 f32), S
// or P of one tile (KROWS / 2 f32) and the bf16 P of the tile in flight
// (KROWS / 4): 128-key tiles fit at DP = 64 only with setmaxnreg's 160 (the
// producer warpgroup drops to 24); they spilled at DP = 128.
#pragma once

#include "flash_fwd.cuh"
#include "sm90.cuh"

namespace tdc {

namespace fwd90 {
// One instance's shape: keys per K/V tile (64 or 128), consumer warpgroups
// (64 query rows each), whether the grid is persistent (one block per SM
// that walks the work items, with two Q buffers so that the next item's Q
// and first K/V tiles load while this item's last tiles and epilogue run),
// and PREG: 0, a producer warp; else a producer warpgroup that hands
// registers to the consumers by setmaxnreg (24 for it, PREG for each
// consumer thread; ptxas then allocates the consumers' code within PREG).
// Every instance has a 4-stage K/V ring and one block per SM.
template <int KROWS_, int NWG_, bool PERSIST_, int PREG_ = 0>
struct Cfg {
  static constexpr int KROWS = KROWS_, NWG = NWG_, PREG = PREG_;
  static constexpr int NST = 4;  // K/V ring stages
  static constexpr bool PERSIST = PERSIST_;
  static constexpr int QROWS = 64 * NWG;                      // query rows per work item
  static constexpr int NTHR = 128 * NWG + (PREG ? 128 : 32);  // consumer warpgroups, then the producer
  static_assert(PREG == 0 || (PREG % 8 == 0 && 128 * (NWG * PREG + 24) <= 65536), "register file");
  static constexpr int NQB = PERSIST ? 2 : 1;  // Q buffers
};

// The instance each padded head dim runs, chosen by DP and causality alone
// (not by length). Causal calls (K1), and non-causal ones at DP = 128, keep
// two warpgroups of 64 query rows on 64-key tiles, a block per query tile:
// the hardware hands blocks out as SMs free up, which balances K1's causal
// items (1 to T / 64 key tiles each); the persistent grid's fixed
// round-robin share of them ran 11% slower at T = 8192.
// Non-causal calls at DP = 64 and 80 (K2, K3, K4, and K1's non-causal calls
// at those widths) take three consumer warpgroups (192 query rows, a third
// less K/V traffic per query and more warps to hide the softmax behind the
// products) on a persistent grid, whose items are all the same length, so
// that a block's ring fill and drain are paid once and not for each of its
// short (12-tile) items; at DP = 64, 128-key tiles (half the per-tile
// barriers, rescales and hand-backs; S 64 registers, P 32, O 32) with the
// consumers at 160 registers by setmaxnreg. scripts/torch_fwd_sm90_probe.py
// times these options at K1's and the towers' shapes; PERF.md has the
// readings.
template <int DP, bool CAUSAL>
struct Tuned {
  using type = Cfg<64, 2, false>;
};
template <>
struct Tuned<64, false> {
  using type = Cfg<128, 3, true, 160>;
};
template <>
struct Tuned<80, false> {
  using type = Cfg<64, 3, true>;
};

template <int DP, class C>
constexpr size_t smem_bytes() {  // Q[NQB], K[NST], V[NST], mbarriers, alignment slack
  return (size_t)(C::NQB * C::QROWS + 2 * C::NST * C::KROWS) * DP * 2 +
         8 * (2 * C::NST + 2 * C::NQB) + 1024;
}

// One consumer warpgroup: 64 query rows, their O accumulator, S (then P) of
// the current tile, the bf16 P of the tile whose P V is in flight, and the
// online softmax state. Tile j of a work item sits in ring stage
// (g0 + j) % NST, g0 being the tiles of the block's earlier items. Every
// method is inlined, so the arrays stay in registers.
template <int DP, bool CAUSAL, class C>
struct Consumer {
  static constexpr int KROWS = C::KROWS, NST = C::NST;
  static constexpr int PW = sm90::panel_width<DP>;
  static constexpr int NP = KROWS / 16;           // k-steps of P V
  static constexpr uint32_t TK = KROWS * DP * 2;  // K or V tile bytes
  uint32_t sQ, sK, sV, bars;
  int g0, wg, lane, r_wg, kv_len, rows[2];
  float scale_log2;
  float o[DP / 2], sc[KROWS / 2];
  float m_r[2], l_r[2];  // running max of the raw scores; this thread's share of the row sum
  uint32_t pa[NP][4];

  __device__ __forceinline__ void wait_full(int j) const {
    sm90::mbar_wait(bars + 8 * ((g0 + j) % NST), ((g0 + j) / NST) & 1);
  }
  __device__ __forceinline__ void release(int j) const {  // this warp is done with tile j's stage
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bars + 8 * (NST + (g0 + j) % NST));
  }
  // S = Q K^T of tile j, issued and committed
  __device__ __forceinline__ void issue_s(int j) {
    const uint32_t qt = sm90::opaque(sQ), kt = sm90::opaque(sK + ((g0 + j) % NST) * TK);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      sm90::wgmma_ss<KROWS>(sc, sm90::desc_k<C::QROWS, PW>(qt, wg * 64, kk),
                            sm90::desc_k<KROWS, PW>(kt, 0, kk), kk);
    sm90::wgmma_commit();
  }
  // O += P V of tile j, issued and committed
  __device__ __forceinline__ void issue_pv(int j) {
    const uint32_t vt = sm90::opaque(sV + ((g0 + j) % NST) * TK);
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
      for (int i = 0; i < KROWS / 2; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
        sc[i] = col < kv_len && (!CAUSAL || col <= rows[(i >> 1) & 1]) ? sc[i] : -INFINITY;
      }
    }
    float mx[2] = {m_r[0], m_r[1]}, mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < KROWS / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mb[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;  // no key visible yet
      alpha[r] = sm90::exp2_approx(m_r[r] * scale_log2 - mb[r]);
      m_r[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < KROWS / 2; ++i) {
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

// Work item w of a persistent grid: heads fastest, then query tiles (the
// longest causal tiles first), then the batch, as the blocks of a
// non-persistent grid are numbered.
struct Item {
  int h, q0, b;
};
template <class C>
__device__ __forceinline__ Item item(const FwdParams& p, int w, int n_qt) {
  if (!C::PERSIST) return {(int)blockIdx.x, (int)(gridDim.y - 1 - blockIdx.y) * C::QROWS, (int)blockIdx.z};
  const int t = w / p.Hq;
  return {w - t * p.Hq, (n_qt - 1 - t % n_qt) * C::QROWS, t / n_qt};
}

// K/V tiles of the work item whose first query row is q0: with CAUSAL, up to
// the tile that holds its last row's diagonal element.
template <bool CAUSAL, class C>
__device__ __forceinline__ int item_tiles(const FwdParams& p, int q0) {
  int n = (p.kv_len + C::KROWS - 1) / C::KROWS;
  if (CAUSAL) n = min(n, min(q0 + C::QROWS - 1, p.T - 1) / C::KROWS + 1);
  return n;
}
}  // namespace fwd90

template <int DP, bool CAUSAL, bool LSE, class C>
__global__ void __launch_bounds__(C::NTHR, 1)
    flash_fwd_bf16_sm90_kernel(const FwdParams p, const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv) {
  using namespace sm90;
  constexpr int KROWS = C::KROWS, NST = C::NST, QROWS = C::QROWS, NQB = C::NQB;
  constexpr int NCONS = 128 * C::NWG;  // consumer threads
  constexpr int PW = sm90::panel_width<DP>;
  constexpr uint32_t TQ = QROWS * DP * 2, TK = KROWS * DP * 2;  // tile bytes
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + NQB * TQ, sV = sK + NST * TK;
  const uint32_t bars = sV + NST * TK;  // full[NST], empty[NST], Q full[NQB], Q empty[NQB]
  const uint32_t qfull = bars + 16 * NST, qempty = qfull + 8 * NQB;

  const int n_qt = (p.T + QROWS - 1) / QROWS;
  const int n_items = C::PERSIST ? p.Hq * n_qt * p.B : 1;
  const int w0 = C::PERSIST ? blockIdx.x : 0, dw = C::PERSIST ? gridDim.x : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NST + s), NCONS / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < NQB; ++s) {
      mbar_init(qfull + 8 * s, 1);
      mbar_init(qempty + 8 * s, NCONS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    if constexpr (C::PREG != 0) setmaxnreg_dec<24>();
    if (threadIdx.x == NCONS) {
      int g = 0;  // tiles loaded so far, over all items
      for (int w = w0, it = 0; w < n_items; w += dw, ++it) {
        const fwd90::Item x = fwd90::item<C>(p, w, n_qt);
        const int hk = x.h / (p.Hq / p.Hkv), n_tiles = fwd90::item_tiles<CAUSAL, C>(p, x.q0);
        const int qs = it % NQB;
        if (C::PERSIST) mbar_wait(qempty + 8 * qs, ((it / NQB) & 1) ^ 1);
        mbar_arrive_expect_tx(qfull + 8 * qs, TQ);
        tma_load_tile<QROWS, DP, PW>(sQ + qs * TQ, &tq, qfull + 8 * qs, x.h, x.q0, x.b);
        for (int j = 0; j < n_tiles; ++j, ++g) {
          const int s = g % NST;
          mbar_wait(bars + 8 * (NST + s), ((g / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(bars + 8 * s, 2 * TK);
          tma_load_tile<KROWS, DP, PW>(sK + s * TK, &tk, bars + 8 * s, hk, j * KROWS, x.b);
          tma_load_tile<KROWS, DP, PW>(sV + s * TK, &tv, bars + 8 * s, hk, j * KROWS, x.b);
        }
      }
    }
    return;
  }

  if constexpr (C::PREG != 0) setmaxnreg_inc<C::PREG ? C::PREG : 24>();
  fwd90::Consumer<DP, CAUSAL, C> c;
  const int t = threadIdx.x % 128, warp = t / 32;
  c.sK = sK;
  c.sV = sV;
  c.bars = bars;
  c.g0 = 0;
  c.wg = threadIdx.x / 128;
  c.lane = t % 32;
  c.kv_len = p.kv_len;
  c.scale_log2 = p.scale * LOG2E;
  for (int w = w0, it = 0; w < n_items; w += dw, ++it) {
    const fwd90::Item x = fwd90::item<C>(p, w, n_qt);
    const int n_tiles = fwd90::item_tiles<CAUSAL, C>(p, x.q0);
    const int qs = it % NQB;
    c.sQ = sQ + qs * TQ;
    c.r_wg = x.q0 + c.wg * 64;  // this warpgroup's first query row
    // accumulator rows of this thread (sm90.cuh: the wgmma layout)
    c.rows[0] = c.r_wg + warp * 16 + c.lane / 4;
    c.rows[1] = c.rows[0] + 8;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) c.o[i] = 0.f;
    c.m_r[0] = c.m_r[1] = -INFINITY;
    c.l_r[0] = c.l_r[1] = 0.f;

    // K/V tiles this warpgroup's rows see (it still hands back every stage):
    // with CAUSAL, up to the tile of its last row's diagonal, which also
    // holds its first row's (r_wg is a multiple of 64, tiles are 64 or 128
    // keys). Only the last of them can need the mask: the diagonal or kv_len.
    int n_mine = c.r_wg < p.T ? n_tiles : 0;
    if (CAUSAL) n_mine = min(n_mine, (c.r_wg + 63) / KROWS + 1);
    const int k_last = (n_mine - 1) * KROWS;
    const bool mask_last = k_last + KROWS > p.kv_len || (CAUSAL && k_last + KROWS - 1 > c.r_wg);
    mbar_wait(qfull + 8 * qs, (it / NQB) & 1);
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
    if (C::PERSIST) {  // every wgmma that reads this Q buffer has completed
      __syncwarp();
      if (c.lane == 0) mbar_arrive(qempty + 8 * qs);
    }
    c.g0 += n_tiles;

    bf16* og = static_cast<bf16*>(p.o) + x.b * p.o_sb + x.h * p.o_sh;
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
      if (LSE && c.lane % 4 == 0)
        p.lse[((long long)x.b * p.Hq + x.h) * p.T + c.rows[r]] = c.m_r[r] * p.scale + logf(l);
    }
  }
}

template <int DP, bool CAUSAL, bool LSE, class C = typename fwd90::Tuned<DP, CAUSAL>::type>
cudaError_t launch_fwd_sm90(const FwdParams& p, cudaStream_t stream) {
  constexpr int PW = sm90::panel_width<DP>;
  const int n_qt = (p.T + C::QROWS - 1) / C::QROWS;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t e = sm90::make_map(&tq, p.q, p.B, p.T, p.Hq, p.D, p.q_sb, p.q_st, p.q_sh, PW, C::QROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tk, p.k, p.B, p.kv_len, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, PW, C::KROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tv, p.v, p.B, p.kv_len, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, PW, C::KROWS);
  if (e != cudaSuccess) return e;
  if (LSE != (p.lse != nullptr)) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16_sm90_kernel<DP, CAUSAL, LSE, C>;
  const size_t smem = fwd90::smem_bytes<DP, C>();
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.Hq, n_qt, p.B);
  if (C::PERSIST) {  // one block per SM, each walking its share of the items
    int dev = 0, n_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const long long n_items = (long long)p.Hq * n_qt * p.B;
    if (n_items > INT32_MAX) return cudaErrorInvalidValue;
    grid = dim3((unsigned)(n_items < n_sm ? n_items : n_sm));
  }
  kernel<<<grid, C::NTHR, smem, stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

// bf16 head dims up to 32 keep the mma.sync body of flash_fwd.cuh; wider ones
// are zero-padded to 64, 80 or 128 (wgmma's N and the panels' widths). f32
// calls take the scalar kernel. LSE: whether the caller passes an lse (each
// entry point always or never does, so each builds one instance per DP).
template <bool CAUSAL, bool LSE>
cudaError_t dispatch_sm90(const FwdParams& p, int is_f32, cudaStream_t stream) {
  const cudaError_t e = check_fwd(p, is_f32);
  if (e != cudaSuccess) return e;
  if (is_f32) return dispatch_f32<CAUSAL>(p, stream);
  if (p.D <= 16) return launch<16, CAUSAL, false>(p, stream);
  if (p.D <= 32) return launch<32, CAUSAL, false>(p, stream);
  if (p.D <= 64) return launch_fwd_sm90<64, CAUSAL, LSE>(p, stream);
  if (p.D <= 80) return launch_fwd_sm90<80, CAUSAL, LSE>(p, stream);
  return launch_fwd_sm90<128, CAUSAL, LSE>(p, stream);
}

}  // namespace tdc
