// Forward attention shared by the port's four forward kernels (K1-K4).
//
// One block computes one (batch, query head, 64-row query tile). Its four
// warps own 16 query rows each. The block walks the KV axis in tiles of 64
// keys and keeps the running row max and row sum in f32 (online softmax).
// The bf16 body of all four at head dims above 32 is the sm_90a template of
// flash_fwd_sm90.cuh instead, with the same semantics and checks.
//
// Semantics (what every TPU kernel it replaces computes):
//   * scores are f32 dot products of input-dtype operands; the scale
//     multiplies the f32 score after the dot;
//   * key j is visible to query i iff j < kv_len and, when CAUSAL,
//     j <= i + q_offset. With q_offset = 0 the causal alignment is top-left
//     even when S > T (a prefill into a longer KV cache); q_offset > 0 puts
//     the queries at rows q_offset.. of a longer sequence (a rank's block
//     under sequence parallelism, q_offset + T <= S). KV tiles above the
//     diagonal are never read;
//   * P is rounded to the input dtype before the PV product; the row sum
//     uses the unrounded f32 P;
//   * O = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)).
//
// Operands are read in place through explicit strides: q [B, T, Hq, D],
// k/v [B, S, Hkv, D], o [B, T, Hq, D], the last dim contiguous. Query head h
// reads KV head h / (Hq / Hkv). The packed [B, N, H*D] projection layout of
// the ViT towers is the same memory. Keys at or past kv_len are never
// loaded (their rows are zero-filled), and head dims past D are zero-padded
// up to DP, a multiple of 16, which is the K-step of a bf16 mma.
//
// Two instances of that structure:
//   * bf16 at D <= 32 (K1-K4): Q, K and V tiles go global -> shared memory by
//     cp.async (16 bytes a thread, K/V double-buffered so the next tile's
//     load overlaps this tile's math), shared -> registers by ldmatrix, and
//     through the tensor cores with mma.sync m16n8k16 (f32 accumulate). S, P
//     and the O accumulator never leave registers: the S accumulator's
//     fragment layout is the A-operand layout of the PV product, so P is
//     rounded and packed in place. Shared-memory rows are padded by 16 bytes
//     so that ldmatrix reads are free of bank conflicts.
//   * f32: a scalar FMA version of the same loop with tiles in shared memory,
//     so that an f32 call computes in full f32 (used by the checks).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdc {

constexpr int BM = 64;  // query rows per block, 16 per warp
constexpr int BN = 64;  // keys per KV tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Hq, T] f32, or null
  int B, T, S, Hq, Hkv, D, kv_len;
  int q_offset;  // causal only: query i is row i + q_offset of the sequence (K1; 0 elsewhere)
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  float scale;
};

// Number of KV tiles query tile q0 reads: with CAUSAL, up to the tile that
// holds its last row's diagonal element (key row + q_offset).
template <bool CAUSAL>
__device__ __forceinline__ int kv_tiles(const FwdParams& p, int q0) {
  int n = (p.kv_len + BN - 1) / BN;
  if (CAUSAL) n = min(n, (min(q0 + BM - 1, p.T - 1) + p.q_offset) / BN + 1);
  return n;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync with register-resident S, P and O
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte async copy; with pred false the destination is zero-filled and
// nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) of a row-major operand with row stride `stride` into
// shared memory rows of DP + 8 elements; rows >= n_rows and columns >= D
// are zero-filled.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long stride, int r0,
                                          int n_rows, int D, int tid) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  constexpr int LD = DP + 8;
  static_assert(ROWS * CH % NTHREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NTHREADS; ++it) {
    const int i = tid + it * NTHREADS;
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = r0 + r < n_rows && c < D;
    cp_async16(smem_u32(s + r * LD + c), in ? g + (long long)(r0 + r) * stride + c : g, in);
  }
}

template <int DP>
constexpr size_t smem_bytes_bf16() {
  return (size_t)(BM + 4 * BN) * (DP + 8) * sizeof(bf16);  // Q, K[2], V[2]
}

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_bf16_kernel(const FwdParams p) {
  constexpr int LD = DP + 8;
  constexpr int NK = DP / 16;  // k-steps of the QK^T product
  constexpr int NO = DP / 8;   // 8-wide column tiles of O
  constexpr int NS = BN / 8;   // 8-wide column tiles of S
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * LD;
  bf16* Vs = Ks + 2 * BN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the longest causal tiles start first
  const int b = blockIdx.z, h = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int hk = h / (p.Hq / p.Hkv);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int n_tiles = kv_tiles<CAUSAL>(p, q0);

  load_tile<BM, DP>(Qs, qg, p.q_st, q0, p.T, p.D, tid);
  load_tile<BN, DP>(Ks, kg, p.k_ss, 0, p.kv_len, p.D, tid);
  load_tile<BN, DP>(Vs, vg, p.v_ss, 0, p.kv_len, p.D, tid);
  cp_async_commit();

  // mma fragment coordinates: this thread holds rows g and g + 8 of its
  // warp's 16, columns 2 * t4 and 2 * t4 + 1 of every 8-wide tile
  const int g = lane >> 2, t4 = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  uint32_t qf[NK][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // l_r: this thread's columns

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
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                     (lane >> 4) * 8));
    }

    // S = Q K^T: ldmatrix (no transpose) of K's [key, d] rows is the
    // col-major B operand; one x4 load covers two 8-key tiles
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(Kb + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                                 ((lane >> 3) & 1) * 8));
        mma_bf16(s[n], qf[kk], kb[0], kb[1]);
        mma_bf16(s[n + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax (row max over the 4 threads of a quad)
    const int k0 = j * BN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t4 + (e & 1);
        const bool vis = col < p.kv_len && (!CAUSAL || col <= rows[e >> 1] + p.q_offset);
        s[n][e] = vis ? s[n][e] * p.scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      mb[r] = m_new == -INFINITY ? 0.f : m_new * LOG2E;  // no key visible yet
      alpha[r] = exp2f(m_r[r] * LOG2E - mb[r]);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
    // P = exp(S - m): summed unrounded, rounded to bf16 into the A-operand
    // fragments of the PV product (k-step kk = S tiles 2kk and 2kk + 1)
    uint32_t pf[BN / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = exp2f(fmaf(s[n][e], LOG2E, -mb[e >> 1]));
        l_r[e >> 1] += pv[e];
      }
      pf[n >> 1][(n & 1) * 2] = pack_bf16(pv[0], pv[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: ldmatrix.trans of V's [key, d] rows is the B operand; one x4
    // load covers two 8-wide d tiles
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                       (n + (lane >> 4)) * 8));
        mma_bf16(o[n], pf[kk], vb[0], vb[1]);
        mma_bf16(o[n + 1], pf[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = rows[r];
    if (row >= p.T) continue;
    bf16* orow = og + (long long)row * p.o_st;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < p.D)  // D is a multiple of 8: col + 1 < D too
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(o[n][2 * r] / l, o[n][2 * r + 1] / l);
    }
    if (p.lse != nullptr && t4 == 0) p.lse[((long long)b * p.Hq + h) * p.T + row] = m_r[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMA version of the same loop
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t smem_bytes_f32() {
  return (size_t)(2 * BM * DP + 2 * BN * DP + BM * BN) * sizeof(float);  // Q, O, K, V, S
}

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_f32_kernel(const FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Os = Qs + BM * DP;
  float* Ks = Os + BM * DP;
  float* Vs = Ks + BN * DP;
  float* Ss = Vs + BN * DP;  // scores, then P

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BM * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP, row = q0 + r;
    Qs[i] = (row < p.T && c < p.D) ? qg[(long long)row * p.q_st + c] : 0.f;
    Os[i] = 0.f;
  }
  // each pair of lanes owns one query row; each lane half its key columns
  // and half its head dims
  const int r_loc = warp * 16 + (lane >> 1), half = lane & 1;
  const int row_g = q0 + r_loc;
  float m_i = NEG_INF, l_i = 0.f;
  const int n_tiles = kv_tiles<CAUSAL>(p, q0);

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

    const int c0 = half * (BN / 2);
    float mx = NEG_INF;
    for (int c = c0; c < c0 + BN / 2; ++c) {
      float s = 0.f;
      for (int d = 0; d < DP; ++d) s = fmaf(Qs[r_loc * DP + d], Ks[c * DP + d], s);
      const int col = k0 + c;
      const bool vis = col < p.kv_len && (!CAUSAL || col <= row_g + p.q_offset);
      s = vis ? s * p.scale : NEG_INF;
      Ss[r_loc * BN + c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float rs = 0.f;
    for (int c = c0; c < c0 + BN / 2; ++c) {
      const float s = Ss[r_loc * BN + c];
      const float pf = s > 0.5f * NEG_INF ? expf(s - m_new) : 0.f;
      Ss[r_loc * BN + c] = pf;
      rs += pf;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_i = l_i * alpha + rs;
    m_i = m_new;
    __syncwarp();
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2); ++d) {
      float acc = Os[r_loc * DP + d] * alpha;
      for (int c = 0; c < BN; ++c) acc = fmaf(Ss[r_loc * BN + c], Vs[c * DP + d], acc);
      Os[r_loc * DP + d] = acc;
    }
  }

  if (row_g < p.T) {
    const float l = fmaxf(l_i, 1e-30f);
    for (int d = half * (DP / 2); d < (half + 1) * (DP / 2); ++d)
      if (d < p.D) og[(long long)row_g * p.o_st + d] = Os[r_loc * DP + d] / l;
    if (p.lse != nullptr && half == 0) p.lse[((long long)b * p.Hq + h) * p.T + row_g] = m_i + logf(l);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int DP, bool CAUSAL, bool F32>
cudaError_t launch(const FwdParams& p, cudaStream_t stream) {
  void (*kernel)(const FwdParams);
  size_t smem;
  if constexpr (F32) {
    kernel = flash_fwd_f32_kernel<DP, CAUSAL>;
    smem = smem_bytes_f32<DP>();
  } else {
    kernel = flash_fwd_bf16_kernel<DP, CAUSAL>;
    smem = smem_bytes_bf16<DP>();
  }
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.T + BM - 1) / BM, p.Hq, p.B);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// f32 head dims are zero-padded up to the next instantiated width.
template <bool CAUSAL>
cudaError_t dispatch_f32(const FwdParams& p, cudaStream_t stream) {
  if (p.D <= 16) return launch<16, CAUSAL, true>(p, stream);
  if (p.D <= 32) return launch<32, CAUSAL, true>(p, stream);
  if (p.D <= 64) return launch<64, CAUSAL, true>(p, stream);
  if (p.D <= 80) return launch<80, CAUSAL, true>(p, stream);
  if (p.D <= 128) return launch<128, CAUSAL, true>(p, stream);
  return cudaErrorInvalidValue;
}

// The checks every forward entry point makes before it launches.
inline cudaError_t check_fwd(const FwdParams& p, int is_f32) {
  if (p.B <= 0 || p.T <= 0 || p.Hq <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.kv_len <= 0 ||
      p.kv_len > p.S || p.B > 65535 || p.Hq > 65535 || p.D <= 0 || p.D > 128 ||
      p.q_offset < 0 || (p.q_offset > 0 && p.q_offset + p.T > p.S)) {
    return cudaErrorInvalidValue;
  }
  if (is_f32) return cudaSuccess;
  // bf16 operands move in 16-byte chunks (cp.async, TMA): 8-element aligned
  // rows and head dims
  const long long st[9] = {p.q_sb, p.q_st, p.q_sh, p.k_sb, p.k_ss, p.k_sh, p.v_sb, p.v_ss, p.v_sh};
  for (long long s : st)
    if (s % 8 != 0) return cudaErrorInvalidValue;
  if (p.D % 8 != 0 || reinterpret_cast<uintptr_t>(p.q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.k) % 16 != 0 || reinterpret_cast<uintptr_t>(p.v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.o) % 16 != 0 || p.o_st % 8 != 0) {
    return cudaErrorMisalignedAddress;
  }
  return cudaSuccess;
}

// strides: q (b, t, h), k (b, s, h), v (b, s, h), o (b, t, h), in elements.
inline FwdParams make_params(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int T, int S, int Hq, int Hkv, int D, int kv_len,
                             const long long* st, float scale) {
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.B = B;
  p.T = T;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.kv_len = kv_len;
  p.q_offset = 0;
  p.q_sb = st[0];
  p.q_st = st[1];
  p.q_sh = st[2];
  p.k_sb = st[3];
  p.k_ss = st[4];
  p.k_sh = st[5];
  p.v_sb = st[6];
  p.v_ss = st[7];
  p.v_sh = st[8];
  p.o_sb = st[9];
  p.o_st = st[10];
  p.o_sh = st[11];
  p.scale = scale;
  return p;
}

}  // namespace tdc

// Every library carries its own copy: each is loaded on its own.
extern "C" const char* tdc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
