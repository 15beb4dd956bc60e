// Tensor-core bodies of the bf16 flash-attention kernels: K1-bf16
// (forward) and K2-bf16 (backward dq and dk/dv), included by
// flash_attention_fwd.cu and flash_attention_bwd.cu, whose bf16 C entries
// launch them.  The fp32 forward and backward run 3xTF32 tensor-core
// kernels of the same shape (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// Replaces the bf16 instances of `_flash_fwd_pallas` and
// `_flash_bwd_pallas` (its dq and dkv passes) of
// paddle_tpu/ops/pallas_kernels.py, with their rounding points:
//   forward  p is rounded to bf16 before p . v (`p.astype(vb.dtype)`);
//            the normaliser l sums the unrounded p;
//   dq       ds is rounded to bf16 before ds . k;
//   dk/dv    p and ds are rounded to bf16 before p^T . dO and ds^T . q;
//            dp and the ds formula use the unrounded fp32 p.
// Every product is bf16 x bf16 with fp32 accumulation; o, dq, dk, dv are
// rounded to bf16 once, as they are stored; lse and di stay fp32.
//
// What bounds it: at the training slice (B*H = 64, S = 512, D = 64,
// causal) the forward does 2.15 GFLOP, dq 3.2 and dk/dv 4.3 against
// 5.0-7.6 us of bf16 bytes at 3.35 TB/s; at 989 TFLOP/s the flops take
// 2-4 us.  So the kernels are bound by bytes and by the tensor cores'
// rate together, and the design keeps both fed:
//   * tiles stay bf16 in shared memory, staged by 16-byte cp.async (zero
//     fill past S) into a double buffer, so the next streamed tile (K/V
//     in the forward and the dq kernel, q/dO/lse/di in the dk/dv kernel)
//     loads while this one computes;
//   * rows are padded by 8 elements (16 bytes), so the 8 row addresses of
//     every ldmatrix phase fall in distinct bank groups;
//   * all products are warp-level mma.sync.m16n8k16 (bf16 in, fp32
//     accumulators), fed by ldmatrix (ldmatrix.trans where the operand is
//     stored k-major: V in p . v, K in ds . k, dO and q in the dk/dv
//     products).  mma.sync rather than wgmma: each warp owns 16 rows of
//     the block's 64-row tile, so p and ds are formed in the accumulator
//     registers and their bf16 rounding is, register for register, the A
//     operand of the next product (the m16n8 accumulator layout of two
//     neighbouring n-tiles is the m16k16 A layout), with no trip through
//     shared memory; wgmma's A-from-registers needs a warpgroup layout
//     and an async fence per product, later work;
//   * the dk/dv kernel computes s^T = k . q^T and dp^T = v . dO^T, so p^T
//     and ds^T are formed with kv rows in the accumulator rows, which is
//     again the A layout of p^T . dO and ds^T . q;
//   * 4 warps (128 threads) a block; one block per (b*h, 64-row tile),
//     or 32-row tile at D = 256, where the warps work in pairs, each
//     owning half of the accumulator's columns (a 16 x 256 fp32
//     accumulator would be 128 registers a thread;
//     flash_attention_common.cuh, tile_rows).
// Determinism is kept: q-stationary dq and kv-stationary dk/dv, each
// gradient row owned by one warp of one block, no atomics, reductions in
// a fixed order.  Causal tiles above the diagonal are skipped, and the
// blocks with the most tiles to visit have the lowest block index.  The
// ldmatrix / mma.sync / cp.async primitives are those of tc_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_attention_common.cuh"
#include "tc_common.cuh"

namespace paddle_flash {
namespace tc {

using namespace paddle_tc;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <int D>
__host__ __device__ constexpr int tile_elems() {
  return tile_rows<D>() * (D + kSkew);
}

// The A operand of rows r0 .. r0+15, columns c0 .. c0+15 of a tile stored
// row-major; with ldsm4_t the same addresses give the two B operands of
// k rows r0 .. r0+15 of a k-major tile, columns (n) c0 .. c0+7 in r[0..1]
// and c0+8 .. c0+15 in r[2..3].
template <int D>
__device__ __forceinline__ uint32_t frag_addr(const bf16* tile, int r0,
                                              int c0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(tile + (r0 + (lane & 15)) * (D + kSkew) + c0 +
                  (lane >> 4) * 8);
}

// The B operands of n rows n0 .. n0+15 of an n-major tile (a row holds k
// contiguous), k columns k0 .. k0+15: n-tile n0 in r[0..1], n0+8 in
// r[2..3].
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const bf16* tile,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
  ldsm4(r, smem_u32(tile + (n0 + (lane & 7) + (mi >> 1) * 8) * (D + kSkew) +
                    k0 + (mi & 1) * 8));
}

// An accumulator block of two neighbouring n-tiles, rounded to bf16: the
// A operand of the 16 columns they cover
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Stage rows row0 .. row0 + tile_rows<D>() - 1 of head (b, h) of `t` into
// `dst` (rows of D + kSkew bf16) with cp.async; rows at or past S are
// zero.  The caller commits the group.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const PaddleT4& t,
                                           int b, int h, int row0, int S) {
  constexpr int NV = D / 8;  // 16-byte chunks per row
  constexpr int RT = tile_rows<D>();
  const bf16* base = static_cast<const bf16*>(t.ptr) + (long long)b * t.sb +
                     (long long)h * t.sh;
  static_assert(RT * NV % kThreads == 0, "whole passes over the tile");
#pragma unroll
  for (int it = 0; it < RT * NV / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / NV;
    const int c = idx - r * NV;
    const int s = row0 + r;
    const bool valid = s < S;
    cp_async16(dst + r * (D + kSkew) + c * 8,
               valid ? base + (long long)s * t.ss + c * 8 : base, valid);
  }
}

// Stage RT entries of a [B * H, S] fp32 row statistic; zero past S.
template <int RT>
__device__ __forceinline__ void stage_rowstat(float* dst, const float* src,
                                              int bh, int row0, int S) {
  for (int r = threadIdx.x; r < RT; r += kThreads) {
    const int s = row0 + r;
    const bool valid = s < S;
    cp_async4(dst + r, valid ? src + (long long)bh * S + s : src, valid);
  }
}

// Store a warp's 16 x W fp32 accumulator (rows row0 + g and row0 + g + 8
// of head (b, h) of `t`, n-tile n at columns col0 + 8n + 2t), each row
// divided by its div, as bf16; rows at or past S are skipped.
template <int W>
__device__ __forceinline__ void store_acc(const PaddleT4& t, int b, int h,
                                          int row0, int S, int col0,
                                          const float (&acc)[W / 8][4],
                                          float div0, float div1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  bf16* base = static_cast<bf16*>(t.ptr) + (long long)b * t.sb +
               (long long)h * t.sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row0 + g + 8 * half;
    if (s >= S) continue;
    const float div = half ? div1 : div0;
    uint32_t* row =
        reinterpret_cast<uint32_t*>(base + (long long)s * t.ss + col0);
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      row[4 * n + tq] =
          pack_bf16(acc[n][2 * half] / div, acc[n][2 * half + 1] / div);
  }
}

template <int D>
constexpr int fwd_smem_bytes() {
  return 5 * tile_elems<D>() * (int)sizeof(bf16);  // Q, 2 x (K, V)
}

// K1-bf16: block (b*h, q tile); warp w owns q rows 16w .. 16w+15 (at D =
// 256, rows 16(w / 2) .. and half of o's columns: col_splits)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const PaddleFlashFwdArgs a) {
  constexpr int TE = tile_elems<D>();
  constexpr int RT = tile_rows<D>();
  constexpr int CS = col_splits<D>();
  constexpr int NJ = RT / 8;      // key n-tiles of a kv tile
  constexpr int KS = D / 16;      // k-steps over D
  constexpr int ND = D / CS / 8;  // n-tiles of this warp's o columns
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Ks = Qs + TE;      // [2][TE]
  bf16* Vs = Ks + 2 * TE;  // [2][TE]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * RT;
  const int warp = threadIdx.x >> 5;
  const int rw = 16 * (warp / CS);       // this warp's first tile row
  const int dc = (warp % CS) * (D / CS);  // and first o column
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = q0 + rw + g;  // this thread's rows r0, r0 + 8

  int n_kv = (a.S + RT - 1) / RT;
  if (a.causal) n_kv = min(n_kv, qt + 1);

  stage_tile<D>(Qs, a.q, b, h, q0, a.S);
  stage_tile<D>(Ks, a.k, b, h, 0, a.S);
  stage_tile<D>(Vs, a.v, b, h, 0, a.S);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  uint32_t qf[KS][4];

  for (int kt = 0; kt < n_kv; ++kt) {
    const int buf = kt & 1;
    const int k0 = kt * RT;
    if (kt + 1 < n_kv) {
      stage_tile<D>(Ks + (buf ^ 1) * TE, a.k, b, h, k0 + RT, a.S);
      stage_tile<D>(Vs + (buf ^ 1) * TE, a.v, b, h, k0 + RT, a.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * TE;
    const bf16* Vb = Vs + buf * TE;
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm4(qf[ks], frag_addr<D>(Qs, rw, 16 * ks));
    }

    // s = q . k^T: 16 rows x RT keys, n-tile j at keys k0 + 8j
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t kb[4];
        load_b_nk<D>(kb, Kb, 16 * np, 16 * ks);
        mma(s[2 * np], qf[ks], kb[0], kb[1]);
        mma(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // scale, mask, and fold the tile into each row's online softmax
    const bool masked = (a.causal && kt == qt) || k0 + RT > a.S;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[j][e] * a.scale;
        if (masked) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const int qi = r0 + 8 * (e >> 1);
          if (key >= a.S || (a.causal && key > qi)) v = kNegInf;
        }
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += round(p) . v: 16-key steps, V read k-major
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t vb[4];
        ldsm4_t(vb, frag_addr<D>(Vb, 16 * kk, dc + 16 * dn));
        mma(o[2 * dn], pa, vb[0], vb[1]);
        mma(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }

  float lf[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lf[i] = fmaxf(l[i], kTiny);
  }
  store_acc<D / CS>(a.o, b, h, q0 + rw, a.S, dc, o, lf[0], lf[1]);
  if (tq == 0 && dc == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = r0 + 8 * i;
      if (qi < a.S) a.lse[(long long)bh * a.S + qi] = m[i] + logf(lf[i]);
    }
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  return 6 * tile_elems<D>() * (int)sizeof(bf16);  // Q, dO, 2 x (K, V)
}

// K2-bf16 dq: block (b*h, q tile); warp w owns q rows 16w .. 16w+15 (at
// D = 256, rows 16(w / 2) .. and half of dq's columns: col_splits)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc_kernel(const PaddleFlashBwdArgs a) {
  constexpr int TE = tile_elems<D>();
  constexpr int RT = tile_rows<D>();
  constexpr int CS = col_splits<D>();
  constexpr int NJ = RT / 8;      // key n-tiles of a kv tile
  constexpr int KS = D / 16;
  constexpr int ND = D / CS / 8;  // n-tiles of this warp's dq columns
  extern __shared__ uint4 smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dOs = Qs + TE;
  bf16* Ks = dOs + TE;     // [2][TE]
  bf16* Vs = Ks + 2 * TE;  // [2][TE]

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * RT;
  const int warp = threadIdx.x >> 5;
  const int rw = 16 * (warp / CS);       // this warp's first tile row
  const int dc = (warp % CS) * (D / CS);  // and first dq column
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = q0 + rw + g;

  int n_kv = (a.S + RT - 1) / RT;
  if (a.causal) n_kv = min(n_kv, qt + 1);

  stage_tile<D>(Qs, a.q, b, h, q0, a.S);
  stage_tile<D>(dOs, a.dout, b, h, q0, a.S);
  stage_tile<D>(Ks, a.k, b, h, 0, a.S);
  stage_tile<D>(Vs, a.v, b, h, 0, a.S);
  cp_async_commit();

  float lse[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    lse[i] = qi < a.S ? a.lse[(long long)bh * a.S + qi] : 0.f;
    di[i] = qi < a.S ? a.di[(long long)bh * a.S + qi] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int buf = kt & 1;
    const int k0 = kt * RT;
    if (kt + 1 < n_kv) {
      stage_tile<D>(Ks + (buf ^ 1) * TE, a.k, b, h, k0 + RT, a.S);
      stage_tile<D>(Vs + (buf ^ 1) * TE, a.v, b, h, k0 + RT, a.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * TE;
    const bf16* Vb = Vs + buf * TE;

    // s = q . k^T and dp = dO . v^T: 16 rows x RT keys each
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], oa[4];
      ldsm4(qa, frag_addr<D>(Qs, rw, 16 * ks));
      ldsm4(oa, frag_addr<D>(dOs, rw, 16 * ks));
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t kb[4], vb[4];
        load_b_nk<D>(kb, Kb, 16 * np, 16 * ks);
        load_b_nk<D>(vb, Vb, 16 * np, 16 * ks);
        mma(s[2 * np], qa, kb[0], kb[1]);
        mma(s[2 * np + 1], qa, kb[2], kb[3]);
        mma(dp[2 * np], oa, vb[0], vb[1]);
        mma(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }

    // p = exp(s - lse), ds = p (dp - di) scale, in fp32
    const bool masked = (a.causal && kt == qt) || k0 + RT > a.S;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float v = s[j][e] * a.scale;
        if (masked) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          if (key >= a.S || (a.causal && key > r0 + 8 * i)) v = kNegInf;
        }
        const float p = expf(v - lse[i]);
        s[j][e] = p * (dp[j][e] - di[i]) * a.scale;
      }
    }

    // dq += round(ds) . k: 16-key steps, K read k-major
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        uint32_t kb[4];
        ldsm4_t(kb, frag_addr<D>(Kb, 16 * kk, dc + 16 * dn));
        mma(dq[2 * dn], da, kb[0], kb[1]);
        mma(dq[2 * dn + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();
  }
  store_acc<D / CS>(a.dq, b, h, q0 + rw, a.S, dc, dq, 1.f, 1.f);
}

template <int D>
constexpr int dkv_smem_bytes() {
  // K, V, 2 x (Q, dO); 2 x (lse, di)
  return 6 * tile_elems<D>() * (int)sizeof(bf16) +
         4 * tile_rows<D>() * (int)sizeof(float);
}

// K2-bf16 dk/dv: block (b*h, kv tile); warp w owns kv rows 16w .. 16w+15
// (at D = 256, rows 16(w / 2) .. and half of dk's and dv's columns:
// col_splits).  The q tile is taken 32 queries at a time, to bound the live
// accumulators (dk, dv, s^T, dp^T) at D = 128.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tc_kernel(const PaddleFlashBwdArgs a) {
  constexpr int TE = tile_elems<D>();
  constexpr int RT = tile_rows<D>();
  constexpr int CS = col_splits<D>();
  constexpr int KS = D / 16;
  constexpr int ND = D / CS / 8;  // n-tiles of this warp's dk/dv columns
  extern __shared__ uint4 smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + TE;
  bf16* Qs = Vs + TE;       // [2][TE]
  bf16* dOs = Qs + 2 * TE;  // [2][TE]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TE);  // [2][RT]
  float* di_s = lse_s + 2 * RT;                           // [2][RT]

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // the first kv tiles see the most q tiles
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = kt * RT;
  const int warp = threadIdx.x >> 5;
  const int rw = 16 * (warp / CS);       // this warp's first kv row
  const int dc = (warp % CS) * (D / CS);  // and first dk/dv column
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int c0 = k0 + rw + g;  // this thread's kv rows c0, c0 + 8

  const int nq = (a.S + RT - 1) / RT;
  const int qt0 = a.causal ? kt : 0;

  stage_tile<D>(Ks, a.k, b, h, k0, a.S);
  stage_tile<D>(Vs, a.v, b, h, k0, a.S);
  stage_tile<D>(Qs, a.q, b, h, qt0 * RT, a.S);
  stage_tile<D>(dOs, a.dout, b, h, qt0 * RT, a.S);
  stage_rowstat<RT>(lse_s, a.lse, bh, qt0 * RT, a.S);
  stage_rowstat<RT>(di_s, a.di, bh, qt0 * RT, a.S);
  cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int buf = (qt - qt0) & 1;
    const int q0 = qt * RT;
    if (qt + 1 < nq) {
      const int nb = buf ^ 1;
      stage_tile<D>(Qs + nb * TE, a.q, b, h, q0 + RT, a.S);
      stage_tile<D>(dOs + nb * TE, a.dout, b, h, q0 + RT, a.S);
      stage_rowstat<RT>(lse_s + nb * RT, a.lse, bh, q0 + RT, a.S);
      stage_rowstat<RT>(di_s + nb * RT, a.di, bh, q0 + RT, a.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qb = Qs + buf * TE;
    const bf16* dOb = dOs + buf * TE;
    const float* lse_b = lse_s + buf * RT;
    const float* di_b = di_s + buf * RT;
    const bool masked = (a.causal && qt == kt) || q0 + RT > a.S;

#pragma unroll
    for (int half = 0; half < RT / 32; ++half) {
      const int qc = 32 * half;  // first query column of this half
      // s^T = k . q^T and dp^T = v . dO^T: 16 kv rows x 32 queries
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        ldsm4(ka, frag_addr<D>(Ks, rw, 16 * ks));
        ldsm4(va, frag_addr<D>(Vs, rw, 16 * ks));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t qb[4], ob[4];
          load_b_nk<D>(qb, Qb, qc + 16 * np, 16 * ks);
          load_b_nk<D>(ob, dOb, qc + 16 * np, 16 * ks);
          mma(st[2 * np], ka, qb[0], qb[1]);
          mma(st[2 * np + 1], ka, qb[2], qb[3]);
          mma(dpt[2 * np], va, ob[0], ob[1]);
          mma(dpt[2 * np + 1], va, ob[2], ob[3]);
        }
      }

      // p^T = exp(s^T - lse), ds^T = p^T (dp^T - di) scale; queries past
      // S contribute nothing
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = qc + 8 * j + 2 * tq + (e & 1);
          const int qi = q0 + col;
          float v = st[j][e] * a.scale;
          float p = 0.f;
          if (!masked) {
            p = expf(v - lse_b[col]);
          } else if (qi < a.S) {
            if (a.causal && c0 + 8 * (e >> 1) > qi) v = kNegInf;
            p = expf(v - lse_b[col]);
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - di_b[col]) * a.scale;
        }
      }

      // dv += round(p^T) . dO, dk += round(ds^T) . q: 16-query steps,
      // dO and q read k-major
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < ND / 2; ++dn) {
          uint32_t ob[4], qb[4];
          ldsm4_t(ob, frag_addr<D>(dOb, qc + 16 * kk, dc + 16 * dn));
          ldsm4_t(qb, frag_addr<D>(Qb, qc + 16 * kk, dc + 16 * dn));
          mma(dv[2 * dn], pa, ob[0], ob[1]);
          mma(dv[2 * dn + 1], pa, ob[2], ob[3]);
          mma(dk[2 * dn], da, qb[0], qb[1]);
          mma(dk[2 * dn + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();
  }
  store_acc<D / CS>(a.dk, b, h, k0 + rw, a.S, dc, dk, 1.f, 1.f);
  store_acc<D / CS>(a.dv, b, h, k0 + rw, a.S, dc, dv, 1.f, 1.f);
}

}  // namespace tc
}  // namespace paddle_flash
