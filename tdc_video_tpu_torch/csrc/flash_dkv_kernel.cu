// K6: dK and dV of attention by recomputation, with the GQA group sum.
//
// Replaces the TPU kernel _flash_dkv_kernel (tdc_video_tpu/ops/flash_attention.py:489,
// pallas_call in _flash_gqa_bwd at :611), the second half of the custom VJP
// of _flash_core (:644-670), together with the f32 sum of its per-query-head
// partials over each GQA group that the JAX package does outside the kernel
// (:638-640).
//
// Bound on the H100: at the stage-2 LM shape (T = S = 8192, 24 query heads,
// D = 128, causal) one call is 4 products over the causal half, 8 * 24 *
// 8192^2 / 2 * 128 = 8.2e11 FLOP against ~0.17 GB of operands, dK and dV:
// bound by operations (0.83 ms at the bf16 peak).
//
// bf16 design (sm_90a): one block of three warpgroups per (KV head, 64 keys,
// batch), key tile 0 (the most causal work) first. Everything is computed
// transposed, keys as rows, so that P^T and dS^T come out of their products
// in the layout of the A registers of the next ones:
//   * warpgroup 2 is the producer (setmaxnreg 40): one thread loads the
//     block's K and V rows by TMA (resident), then streams 64-row Q and dO
//     tiles, with their rows' lse and delta, into a 3-stage ring over the
//     group's query heads and, for each, over the query tiles from the last
//     down to the causal diagonal (so that neighbouring blocks share them in
//     L2). Stages complete on mbarriers;
//   * warpgroup 0 accumulates dV: S^T = K Q^T (wgmma, both operands in
//     shared memory, K-major), P^T = exp(scale S^T - lse) masked, handed to
//     warpgroup 1 through shared memory in f32, and rounded to bf16 into the
//     A registers of dV += P^T dO (B = the dO tile read MN-major);
//   * warpgroup 1 accumulates dK: dP^T = V dO^T while warpgroup 0 computes
//     S^T, then dS^T = P^T (dP^T - delta) with warpgroup 0's P^T, rounded
//     into the A registers of dK += dS^T Q (B = the Q tile, MN-major).
// Each warpgroup holds one 64 x D f32 accumulator (64 registers a thread at
// D = 128) across all query heads of the group, so the group sum needs no
// partial buffer and no atomics, and the result does not depend on timing.
// What the design does about the limits of the mma.sync kernel it replaces:
// every product is a wgmma, two per warpgroup and query tile; splitting dV
// and dK between the warpgroups keeps one accumulator, one 64 x 64 f32 tile
// and its bf16 copy a thread, within the registers (two accumulators and
// two tiles a warpgroup do not fit, and make ptxas spill and serialize the
// wgmma); the producer keeps up to three tiles in flight and no
// __syncthreads() ties the warps to the loads; the mask is evaluated only on
// tiles that cross the diagonal, T or kv_len. A causal query offset
// (sequence parallelism) moves the diagonal by q_offset keys: the first
// query tile a key tile meets is the one that holds query k0 - q_offset, and
// a key tile past the last query's diagonal meets none and writes zeros, so
// a rank's partial dK and dV may be summed. What it leaves: every block
// streams its group's Q and dO tiles (32 KB each at D = 128) from L2 for
// only 64 keys; a cluster of blocks sharing each tile by TMA multicast would
// cut that traffic.
#include "flash_bwd.cuh"
#include "sm90.cuh"

namespace tdc {

namespace k6 {
constexpr int KROWS = 64;  // keys per block
constexpr int QROWS = 64;  // query rows per streamed tile
constexpr int NST = 3;     // Q/dO ring stages
constexpr int NTHR = 384;  // warpgroup 0 (dV), 1 (dK), producer warpgroup 2
// lse and delta of a query tile: QROWS + 4 values from the 16-byte boundary
// at or before the tile's first row, in a 384-byte slot
constexpr int STAT_BOX = QROWS + 4;
constexpr int STAT_SLOT = 96;  // floats
constexpr int PX = 128 * 32 * 4;  // P^T exchange per stage: 32 f32 a thread of warpgroup 0

template <int DP>
constexpr size_t smem_bytes() {
  // K, V, Q[NST], dO[NST], P^T[NST], lse and delta [NST][2] slots, 3 NST + 1
  // mbarriers, alignment slack
  return (size_t)(2 * KROWS + 2 * NST * QROWS) * DP * 2 + NST * PX + NST * 2 * STAT_SLOT * 4 +
         8 * (3 * NST + 1) + 1024;
}
}  // namespace k6

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(k6::NTHR, 1)
    flash_dkv_bf16_kernel(const BwdParams p, const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tlse,
                          const __grid_constant__ CUtensorMap tdelta) {
  using namespace sm90;
  using k6::KROWS;
  using k6::NST;
  using k6::QROWS;
  constexpr int PW = panel_width<DP>;
  constexpr uint32_t TK = KROWS * DP * 2, TQ = QROWS * DP * 2;  // tile bytes
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + TK, sQ = base + 2 * TK, sD = sQ + NST * TQ;
  const uint32_t sP = sD + NST * TQ;            // [NST][8][128] float4
  const uint32_t sStat = sP + NST * k6::PX;     // [NST][lse, delta] slots of STAT_SLOT f32
  float4* pbuf = reinterpret_cast<float4*>(smem + (sP - raw));
  const float* stat = reinterpret_cast<const float*>(smem + (sStat - raw));
  const uint32_t bars = sStat + NST * 2 * k6::STAT_SLOT * 4;  // full, empty, P^T [NST]; K/V
  const uint32_t kvbar = bars + 24 * NST;

  const int b = blockIdx.z, hk = blockIdx.x, k0 = blockIdx.y * KROWS;
  const int group = p.Hq / p.Hkv;
  const int n_qt = (p.T + QROWS - 1) / QROWS;
  // earlier query tiles see no key here (with CAUSAL: query i sees key k0
  // iff i + q_offset >= k0)
  const int i0 = CAUSAL ? min(max(k0 - p.q_offset, 0) / QROWS, n_qt) : 0;
  const int n_q = n_qt - i0;
  // iteration it: query head hk * group + it / n_q, query tile n_qt - 1 - it % n_q.
  // The tiles run from the last down to the diagonal, so that the blocks in
  // flight (neighbouring key tiles) read the same Q and dO tiles at about the
  // same time, from L2
  const int n_iter = group * n_q;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (NST + s), 8);      // one arrival per consumer warp
      mbar_init(bars + 8 * (2 * NST + s), 4);  // one per warp of warpgroup 0
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(kvbar, 2 * TK);
      tma_load_tile<KROWS, DP, PW>(sK, &tk, kvbar, hk, k0, b);
      tma_load_tile<KROWS, DP, PW>(sV, &tv, kvbar, hk, k0, b);
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % NST;
        const int h = hk * group + it / n_q, q0 = (n_qt - 1 - it % n_q) * QROWS;
        mbar_wait(bars + 8 * (NST + s), ((it / NST) & 1) ^ 1);
        mbar_arrive_expect_tx(bars + 8 * s, 2 * TQ + 2 * k6::STAT_BOX * 4);
        tma_load_tile<QROWS, DP, PW>(sQ + s * TQ, &tq, bars + 8 * s, h, q0, b);
        tma_load_tile<QROWS, DP, PW>(sD + s * TQ, &tdo, bars + 8 * s, h, q0, b);
        // from the 16-byte boundary at or before the tile's first row; rows
        // past T read the next head's values (or zeros past the end), and
        // those queries are masked
        const int row = ((b * p.Hq + h) * p.T + q0) & ~3;
        tma_load_1d(sStat + s * 2 * k6::STAT_SLOT * 4, &tlse, bars + 8 * s, row);
        tma_load_1d(sStat + (s * 2 + 1) * k6::STAT_SLOT * 4, &tdelta, bars + 8 * s, row);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // accumulator rows (keys) of this thread (sm90.cuh: the wgmma layout)
    const int keys[2] = {k0 + warp * 16 + lane / 4, k0 + warp * 16 + lane / 4 + 8};
    float acc[DP / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    mbar_wait(kvbar, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % NST;
      const uint32_t parity = (it / NST) & 1;
      const int h = hk * group + it / n_q, q0 = (n_qt - 1 - it % n_q) * QROWS;
      const uint32_t qt = opaque(sQ + s * TQ), dt = opaque(sD + s * TQ);
      const float* st_row = stat + s * 2 * k6::STAT_SLOT + (((b * p.Hq + h) * p.T + q0) & 3);
      const bool mask = q0 + QROWS > p.T || k0 + KROWS > p.kv_len ||
                        (CAUSAL && q0 + p.q_offset < k0 + KROWS - 1);
      float x[32];  // S^T, then P^T (warpgroup 0); dP^T, then dS^T (warpgroup 1)
      uint32_t a[4][4];
      mbar_wait(bars + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(x, desc_k<KROWS, PW>(opaque(wg == 0 ? sK : sV), 0, kk),
                     desc_k<QROWS, PW>(wg == 0 ? qt : dt, 0, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      // accumulator column i is query q0 + c0 + (i / 4) * 8 + (i & 1)
      const int c0 = 2 * (lane % 4);
      float4* px = pbuf + s * 8 * 128 + t;  // this thread's P^T, 8 float4 strided by 128
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = c0 + (i / 4) * 8 + (i & 1), key = keys[(i >> 1) & 1];
          float pr = exp2_approx(fmaf(x[i], p.scale, -st_row[c]) * LOG2E);
          if (mask && !(key < p.kv_len && q0 + c < p.T && (!CAUSAL || key <= q0 + c + p.q_offset)))
            pr = 0.f;
          x[i] = pr;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) px[j * 128] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (2 * NST + s));  // P^T of this warp is written
      } else {
        mbar_wait(bars + 8 * (2 * NST + s), parity);
        const float* dl = st_row + k6::STAT_SLOT;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 pr = px[j * 128];
          const float v[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, c = c0 + j * 8 + (e & 1);
            x[i] = v[e] * (x[i] - dl[c]);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int y = 0; y < 4; ++y) a[kk][y] = pack_bf16(x[8 * kk + 2 * y], x[8 * kk + 2 * y + 1]);
      // dV += P^T dO, or dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP>(acc, a[kk], desc_mn<QROWS, PW>(wg == 0 ? dt : qt, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (NST + s));  // this warp is done with the stage
    }

    // warpgroup 0 writes dV, warpgroup 1 dK (times the scale)
    bf16* og = static_cast<bf16*>(wg == 0 ? p.dv : p.dk) + b * (wg == 0 ? p.dv_sb : p.dk_sb) +
               hk * (wg == 0 ? p.dv_sh : p.dk_sh);
    const long long o_ss = wg == 0 ? p.dv_ss : p.dk_ss;
    const float osc = wg == 0 ? 1.f : p.scale;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] >= p.kv_len) continue;
      bf16* orow = og + (long long)keys[r] * o_ss;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * (lane % 4);
        if (col < p.D)  // D is a multiple of 8: col + 1 < D too
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(osc * acc[4 * n + 2 * r], osc * acc[4 * n + 2 * r + 1]);
      }
    }
  }
}

// f32: each pair of lanes owns one key; each lane takes half of a query tile
// for P^T and dS^T, and half of the head dims for dK and dV.
template <int DP>
constexpr size_t dkv_smem_f32() {
  // K, V, Q, dO tiles, P^T and dS^T, lse and delta
  return (size_t)(2 * BN * DP + 2 * BM * DP + 2 * BN * BM + 2 * BM) * sizeof(float);
}

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS) flash_dkv_f32_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BN * DP;
  float* Qs = Vs + BN * DP;
  float* Ds = Qs + BM * DP;
  float* Ps = Ds + BM * DP;
  float* Ss = Ps + BN * BM;  // dS^T
  float* Ls = Ss + BN * BM;
  float* Dl = Ls + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BN;
  const int group = p.Hq / p.Hkv;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  for (int i = tid; i < BN * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP, key = k0 + r;
    const bool in = key < p.kv_len && c < p.D;
    Ks[i] = in ? kg[(long long)key * p.k_ss + c] : 0.f;
    Vs[i] = in ? vg[(long long)key * p.v_ss + c] : 0.f;
  }
  const int r_loc = warp * 16 + (lane >> 1), half = lane & 1;
  const int key = k0 + r_loc;
  const int n_qt = (p.T + BM - 1) / BM;
  const int i0 = CAUSAL ? min(max(k0 - p.q_offset, 0) / BM, n_qt) : 0;
  constexpr int HD = DP / 2;
  float dk[HD], dv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dk[d] = dv[d] = 0.f;

  for (int j = 0; j < group; ++j) {
    const int h = hk * group + j;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dg = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long rs = ((long long)b * p.Hq + h) * p.T;
    for (int i = i0; i < n_qt; ++i) {
      const int q0 = i * BM;
      __syncthreads();  // all warps are done with the previous query tile
      for (int x = tid; x < BM * DP; x += NTHREADS) {
        const int r = x / DP, c = x % DP, row = q0 + r;
        const bool in = row < p.T && c < p.D;
        Qs[x] = in ? qg[(long long)row * p.q_st + c] : 0.f;
        Ds[x] = in ? dg[(long long)row * p.do_st + c] : 0.f;
      }
      if (tid < BM) {
        Ls[tid] = q0 + tid < p.T ? p.lse[rs + q0 + tid] : 0.f;
        Dl[tid] = q0 + tid < p.T ? p.delta[rs + q0 + tid] : 0.f;
      }
      __syncthreads();
      for (int c = half * (BM / 2); c < (half + 1) * (BM / 2); ++c) {
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < DP; ++d) {
          s = fmaf(Ks[r_loc * DP + d], Qs[c * DP + d], s);
          dp = fmaf(Vs[r_loc * DP + d], Ds[c * DP + d], dp);
        }
        const int row = q0 + c;
        const bool vis = key < p.kv_len && row < p.T && (!CAUSAL || key <= row + p.q_offset);
        const float pr = vis ? expf(s * p.scale - Ls[c]) : 0.f;
        Ps[r_loc * BM + c] = pr;
        Ss[r_loc * BM + c] = pr * (dp - Dl[c]);
      }
      __syncwarp();
      for (int c = 0; c < BM; ++c) {
        const float pr = Ps[r_loc * BM + c], ds = Ss[r_loc * BM + c];
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          dv[d] = fmaf(pr, Ds[c * DP + half * HD + d], dv[d]);
          dk[d] = fmaf(ds, Qs[c * DP + half * HD + d], dk[d]);
        }
      }
    }
  }

  if (key < p.kv_len) {
    float* krow = static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh + (long long)key * p.dk_ss;
    float* vrow = static_cast<float*>(p.dv) + b * p.dv_sb + hk * p.dv_sh + (long long)key * p.dv_ss;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      if (half * HD + d < p.D) {
        krow[half * HD + d] = p.scale * dk[d];
        vrow[half * HD + d] = dv[d];
      }
    }
  }
}

template <int DP, bool CAUSAL>
cudaError_t launch_dkv_bf16(const BwdParams& p, cudaStream_t stream) {
  constexpr int PW = sm90::panel_width<DP>;
  const int n_kt = (p.kv_len + k6::KROWS - 1) / k6::KROWS;
  if (n_kt > 65535 || (long long)p.B * p.Hq * p.T >= (1ll << 31)) return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv, tlse, tdelta;
  cudaError_t e = sm90::make_map(&tq, p.q, p.B, p.T, p.Hq, p.D, p.q_sb, p.q_st, p.q_sh, PW, k6::QROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tdo, p.dout, p.B, p.T, p.Hq, p.D, p.do_sb, p.do_st, p.do_sh, PW, k6::QROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tk, p.k, p.B, p.kv_len, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, PW, k6::KROWS);
  if (e == cudaSuccess)
    e = sm90::make_map(&tv, p.v, p.B, p.kv_len, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, PW, k6::KROWS);
  const long long n_rows = (long long)p.B * p.Hq * p.T;  // lse and delta, flat
  if (e == cudaSuccess) e = sm90::make_map_f32(&tlse, p.lse, n_rows, k6::STAT_BOX);
  if (e == cudaSuccess) e = sm90::make_map_f32(&tdelta, p.delta, n_rows, k6::STAT_BOX);
  if (e != cudaSuccess) return e;
  auto kernel = flash_dkv_bf16_kernel<DP, CAUSAL>;
  const size_t smem = k6::smem_bytes<DP>();
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(p.Hkv, n_kt, p.B), k6::NTHR, smem, stream>>>(p, tq, tdo, tk, tv, tlse, tdelta);
  return cudaGetLastError();
}

template <int DP, bool CAUSAL>
cudaError_t launch_dkv_f32(const BwdParams& p, cudaStream_t stream) {
  const dim3 grid((p.kv_len + BN - 1) / BN, p.Hkv, p.B);
  return launch_bwd(flash_dkv_f32_kernel<DP, CAUSAL>, grid, dkv_smem_f32<DP>(), p, stream);
}

// Head dims are zero-padded as in dispatch_dq.
template <bool CAUSAL>
cudaError_t dispatch_dkv(const BwdParams& p, int is_f32, cudaStream_t stream) {
  if (!is_f32) {
    if (p.D <= 64) return launch_dkv_bf16<64, CAUSAL>(p, stream);
    if (p.D <= 80) return launch_dkv_bf16<80, CAUSAL>(p, stream);
    return launch_dkv_bf16<128, CAUSAL>(p, stream);
  }
  if (p.D <= 16) return launch_dkv_f32<16, CAUSAL>(p, stream);
  if (p.D <= 32) return launch_dkv_f32<32, CAUSAL>(p, stream);
  if (p.D <= 64) return launch_dkv_f32<64, CAUSAL>(p, stream);
  if (p.D <= 80) return launch_dkv_f32<80, CAUSAL>(p, stream);
  return launch_dkv_f32<128, CAUSAL>(p, stream);
}

}  // namespace tdc

extern "C" int tdc_flash_dkv_kernel_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dq, void* dk, void* dv, int is_f32, int B, int T,
                                        int S, int Hq, int Hkv, int D, int kv_len,
                                        const long long* strides, int causal, int q_offset,
                                        float scale, void* stream) {
  const tdc::BwdParams p = tdc::make_bwd_params(q, k, v, dout, lse, delta, dq, dk, dv, B, T, S,
                                                Hq, Hkv, D, kv_len, strides,
                                                causal ? q_offset : 0, scale);
  cudaError_t e = tdc::check_bwd(p, is_f32);
  if (e == cudaSuccess && (dk == nullptr || dv == nullptr ||
                           (!is_f32 && (reinterpret_cast<uintptr_t>(dk) % 4 != 0 ||
                                        reinterpret_cast<uintptr_t>(dv) % 4 != 0))))
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = causal ? tdc::dispatch_dkv<true>(p, is_f32, st) : tdc::dispatch_dkv<false>(p, is_f32, st);
  return static_cast<int>(e);
}
