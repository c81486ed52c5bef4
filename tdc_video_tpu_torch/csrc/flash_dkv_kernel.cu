// K6: dK and dV of attention by recomputation, with the GQA group sum.
//
// Replaces the TPU kernel _flash_dkv_kernel (tdc_video_tpu/ops/flash_attention.py:489,
// pallas_call in _flash_gqa_bwd at :611), the second half of the custom VJP
// of _flash_core (:644-670), together with the f32 sum of its per-query-head
// partials over each GQA group that the JAX package does outside the kernel
// (:638-640).
//
// One block per (batch, KV head, 64-key tile); each of its four warps owns 16
// keys. The block loops over the group's query heads and, for each, over the
// query tiles from the causal diagonal down, with Q, dO, lse and delta
// double-buffered (cp.async). Everything is computed transposed, keys as
// rows: S^T = K Q^T, P^T = exp(scale S^T - lse) masked, dV += P^T dO,
// dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q. So P^T and dS^T come
// out of their products in the accumulator layout that is the A operand of
// the next (rounded to bf16 in place), and Q and dO serve as B operands both
// ways: ldmatrix for the transposed-B products S^T and dP^T, ldmatrix.trans for
// P^T dO and dS^T Q. The dK and dV accumulators stay in registers across all
// query heads of the group, so the group sum costs no f32 partial buffer in
// device memory and no atomics.
//
// Bound on the H100: at the stage-2 LM shape (T = S = 8192, 24 query heads,
// D = 128, causal) one call is 4 products over the causal half, 8 * 24 *
// 8192^2 / 2 * 128 = 8.2e11 FLOP against ~0.17 GB of operands, dK and dV:
// compute-bound.
//
// What the simple design leaves on the table: mma.sync, not wgmma; two f32
// accumulators of 16 x D per warp cap the tile at 64 keys; S and dP are
// recomputed here and in K5.
#include "flash_bwd.cuh"

namespace tdc {

template <int DP>
constexpr size_t dkv_smem_bf16() {
  // K, V, Q[2], dO[2] tiles, then lse and delta [2][BM] f32
  return (size_t)(2 * BN + 4 * BM) * (DP + 8) * sizeof(bf16) + 4 * BM * sizeof(float);
}

// lse (scaled to log2) and delta of query rows [q0, q0 + BM) into shared
// memory, zero past T; plain loads (the rows need no 16-byte alignment).
__device__ __forceinline__ void load_row_stats(float* ls, float* dl, const float* lse,
                                               const float* delta, int q0, int T, int tid) {
  if (tid < BM) {
    ls[tid] = q0 + tid < T ? lse[q0 + tid] * LOG2E : 0.f;
  } else if (tid < 2 * BM) {
    const int i = tid - BM;
    dl[i] = q0 + i < T ? delta[q0 + i] : 0.f;
  }
}

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS) flash_dkv_bf16_kernel(const BwdParams p) {
  constexpr int LD = DP + 8;
  constexpr int NK = DP / 16;  // k-steps over the head dim
  constexpr int NO = DP / 8;   // 8-wide column tiles of dK and dV
  constexpr int NS = BM / 8;   // 8-wide column (query) tiles of S^T and dP^T
  static_assert(BM == BN, "the causal start tile assumes square tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BN * LD;
  bf16* Qs = Vs + BN * LD;   // 2 buffers
  bf16* Ds = Qs + 2 * BM * LD;  // 2 buffers
  float* Ls = reinterpret_cast<float*>(Ds + 2 * BM * LD);  // [2][BM]
  float* Dl = Ls + 2 * BM;                                 // [2][BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // key tile 0 has the most causal work and starts first
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BN;
  const int group = p.Hq / p.Hkv;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int n_qt = (p.T + BM - 1) / BM;
  const int i0 = CAUSAL ? min(k0 / BM, n_qt) : 0;  // earlier query tiles see no key here
  const int n_q = n_qt - i0;
  const int n_iter = group * n_q;

  load_tile<BN, DP>(Ks, kg, p.k_ss, k0, p.kv_len, p.D, tid);
  load_tile<BN, DP>(Vs, vg, p.v_ss, k0, p.kv_len, p.D, tid);
  cp_async_commit();

  // iteration it: query head hk * group + it / n_q, query tile i0 + it % n_q
  auto stage = [&](int it, int buf) {
    const int h = hk * group + it / n_q, q0 = (i0 + it % n_q) * BM;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* dg = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    load_tile<BM, DP>(Qs + buf * BM * LD, qg, p.q_st, q0, p.T, p.D, tid);
    load_tile<BM, DP>(Ds + buf * BM * LD, dg, p.do_st, q0, p.T, p.D, tid);
    const long long rs = ((long long)b * p.Hq + h) * p.T;
    load_row_stats(Ls + buf * BM, Dl + buf * BM, p.lse + rs, p.delta + rs, q0, p.T, tid);
  };
  if (n_iter > 0) stage(0, 0);
  cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float scale_log2 = p.scale * LOG2E;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  const int a_off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;  // + kk * 16

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iter) stage(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tiles just requested has landed
    __syncthreads();
    const bf16* Qb = Qs + buf * BM * LD;
    const bf16* Db = Ds + buf * BM * LD;
    const float* Lb = Ls + buf * BM;
    const float* Dlb = Dl + buf * BM;
    const int q0 = (i0 + it % n_q) * BM;

    // S^T = K Q^T: A from the warp's K rows, B from Q's [query, d] rows
    float st[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ka[4];
      ldmatrix_x4(ka, smem_u32(Ks + a_off + kk * 16));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t qb[4];
        ldmatrix_x4(qb, smem_u32(Qb + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                                 ((lane >> 3) & 1) * 8));
        mma_bf16(st[n], ka, qb[0], qb[1]);
        mma_bf16(st[n + 1], ka, qb[2], qb[3]);
      }
    }
    // P^T, masked; element (key keys[e >> 1], query q0 + n * 8 + 2 t4 + (e & 1))
    uint32_t pf[BM / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t4 + (e & 1), key = keys[e >> 1];
        const bool vis = key < p.kv_len && q0 + ql < p.T && (!CAUSAL || key <= q0 + ql);
        st[n][e] = vis ? exp2f(fmaf(st[n][e], scale_log2, -Lb[ql])) : 0.f;
      }
      pf[n >> 1][(n & 1) * 2] = pack_bf16(st[n][0], st[n][1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(st[n][2], st[n][3]);
    }
    // dV += P^T dO: ldmatrix.trans of dO's [query, d] rows is the B operand
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t db[4];
        ldmatrix_x4_trans(db, smem_u32(Db + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       (n + (lane >> 4)) * 8));
        mma_bf16(dv[n], pf[kk], db[0], db[1]);
        mma_bf16(dv[n + 1], pf[kk], db[2], db[3]);
      }
    }
    // dP^T = V dO^T
    float dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t va[4];
      ldmatrix_x4(va, smem_u32(Vs + a_off + kk * 16));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t db[4];
        ldmatrix_x4(db, smem_u32(Db + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                                 ((lane >> 3) & 1) * 8));
        mma_bf16(dpt[n], va, db[0], db[1]);
        mma_bf16(dpt[n + 1], va, db[2], db[3]);
      }
    }
    // dS^T = P^T (dP^T - delta), rounded to bf16 as the A operand of dS^T Q
    uint32_t dsf[BM / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = st[n][e] * (dpt[n][e] - Dlb[n * 8 + 2 * t4 + (e & 1)]);
      dsf[n >> 1][(n & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dK += dS^T Q: ldmatrix.trans of Q's [query, d] rows is the B operand
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t qb[4];
        ldmatrix_x4_trans(qb, smem_u32(Qb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       (n + (lane >> 4)) * 8));
        mma_bf16(dk[n], dsf[kk], qb[0], qb[1]);
        mma_bf16(dk[n + 1], dsf[kk], qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.kv_len) continue;
    bf16* krow = dkg + (long long)keys[r] * p.dk_ss;
    bf16* vrow = dvg + (long long)keys[r] * p.dv_ss;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < p.D) {  // D is a multiple of 8: col + 1 < D too
        *reinterpret_cast<uint32_t*>(krow + col) =
            pack_bf16(p.scale * dk[n][2 * r], p.scale * dk[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(vrow + col) = pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
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
  const int i0 = CAUSAL ? min(k0 / BM, n_qt) : 0;
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
        const bool vis = key < p.kv_len && row < p.T && (!CAUSAL || key <= row);
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
cudaError_t launch_dkv(const BwdParams& p, int is_f32, cudaStream_t stream) {
  const dim3 grid((p.kv_len + BN - 1) / BN, p.Hkv, p.B);
  if (is_f32) return launch_bwd(flash_dkv_f32_kernel<DP, CAUSAL>, grid, dkv_smem_f32<DP>(), p, stream);
  return launch_bwd(flash_dkv_bf16_kernel<DP, CAUSAL>, grid, dkv_smem_bf16<DP>(), p, stream);
}

template <bool CAUSAL>
cudaError_t dispatch_dkv(const BwdParams& p, int is_f32, cudaStream_t stream) {
  if (p.D <= 16) return launch_dkv<16, CAUSAL>(p, is_f32, stream);
  if (p.D <= 32) return launch_dkv<32, CAUSAL>(p, is_f32, stream);
  if (p.D <= 64) return launch_dkv<64, CAUSAL>(p, is_f32, stream);
  if (p.D <= 80) return launch_dkv<80, CAUSAL>(p, is_f32, stream);
  return launch_dkv<128, CAUSAL>(p, is_f32, stream);
}

}  // namespace tdc

extern "C" int tdc_flash_dkv_kernel_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dq, void* dk, void* dv, int is_f32, int B, int T,
                                        int S, int Hq, int Hkv, int D, int kv_len,
                                        const long long* strides, int causal, float scale,
                                        void* stream) {
  const tdc::BwdParams p = tdc::make_bwd_params(q, k, v, dout, lse, delta, dq, dk, dv, B, T, S,
                                                Hq, Hkv, D, kv_len, strides, scale);
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
