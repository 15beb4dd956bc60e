// Flash-attention backward (K2), fp32 and bf16, for Hopper (sm_90a): the
// dq kernel and the dk/dv kernel.  This file holds the fp32 kernels, on
// the TF32 tensor cores at fp32 accuracy (3xTF32); the bf16 entries launch
// the bf16 tensor-core kernels of flash_attention_tc.cuh.
//
// Replaces the TPU kernel `_flash_bwd_pallas` of
// paddle_tpu/ops/pallas_kernels.py: its dq pass (q-stationary, K/V
// streamed) and its dkv pass (kv-stationary, q/dO streamed), each an
// instance of the tiled-contraction core.  With s = (q . k) * scale under
// the forward's finite -1e30 mask, and the forward's row lse,
//   p  = exp(s - lse)            (0 where masked)
//   dp = dO . v
//   ds = p * (dp - di) * scale   di = rowsum(dO * o) - dlse, from the caller
//   dq = sum_k ds k,  dk = sum_q ds q,  dv = sum_q p dO.
// Kv tiles above the causal diagonal are skipped in both kernels.  There
// is no rounding point but fp32's: p and ds stay fp32, as the TPU kernel's
// fp32 instance keeps them.
//
// What bounds it: per live (query, key) pair the dq kernel does three
// D-long products (s, dp, ds . k) and the dkv kernel four (s, dp, p . dO,
// ds . q); at the training slice that is 3.2 and 4.3 GFLOP against 42 and
// 51 MB moved, far above the ridge point: the multiply rate bounds them.
// The SIMT units top out at 67 TFLOP/s; the TF32 tensor cores give 495,
// and fp32 accuracy on them costs three products (3xTF32, tc_common.cuh:
// each operand split into TF32 big and small parts, small.big, big.small
// and big.big accumulated in fp32), so the fp32-accurate ceiling is 165
// TFLOP/s.  The design follows the bf16 kernels (flash_attention_tc.cuh):
//   * one block of 4 warps per (b*h, 64-row tile), warp w owning rows
//     16w .. 16w+15; every product is mma.sync.m16n8k8 tf32 x 3, each of
//     the three passes run over 8 independent accumulators before the
//     next;
//   * the stationary tiles (q and dO for dq, k and v for dk/dv) are
//     staged once and split in place into big and small tiles; the
//     streamed tiles stay raw fp32 and are split as their fragments load,
//     with the three-instruction split, unclamped, and so is ds: a block
//     whose gradients then hold a NaN (an infinite or near-FLT_MAX
//     operand, or a NaN input) runs again with the clamped split
//     (tc_common.cuh);
//   * p and ds are formed in the accumulators and are, register for
//     register, the A operand of the next product: the m16n8 accumulator
//     holds (row g, columns 2t, 2t + 1), the m16n8k8 A fragment wants
//     (row g, columns t, t + 4), so a0..a3 take (2t, 2t, 2t + 1, 2t + 1)
//     of rows (g, g + 8) and the matching B fragment reads k rows 2t and
//     2t + 1 instead of t and t + 4: a fixed permutation of the k order,
//     no shuffles;
//   * rows are D + 4 floats: the A and B fragment loads (row g, column t;
//     or row 2t, column g) fall in 32 distinct banks;
//   * shared memory: 6 tiles, 104 KB at D = 64 (two blocks an SM) and
//     203 KB at D = 128; at D = 256 the tiles are 32 rows, 195 KB, and
//     the warps work in pairs, each owning half of the gradient's
//     columns and both forming the pair's s and dp
//     (flash_attention_common.cuh, tile_rows).  So the streamed tiles are single-buffered; the
//     dq kernel reloads V as soon as dp is done (it loads during s, p, ds
//     and ds . k) and K after ds . k (it loads during the next dp), and
//     the second resident block covers the dk/dv kernel's loads.
// What holds it back now: the split's instructions (three per streamed
// element a fragment loads), the single-buffered streams, and mma.sync
// rather than wgmma.  The gradients accumulate over up to S / 64 tiles
// on one accumulator, whose sums drift with that count; at S = 4096 they
// stay inside the 1e-4 scaled tolerance of the card tests, so this kernel
// does not promote its partials as K6 and K1 do.
// Every gradient row is owned by one warp of one block (q-stationary dq,
// kv-stationary dk/dv): no atomics, fixed reduction orders, and a result
// that depends only on its inputs.
//
// bf16 (the TPU kernels' bf16 instance under AMP): flash_attention_tc.cuh's
// `flash_bwd_dq_tc_kernel` and `flash_bwd_dkv_tc_kernel`.

#include "flash_attention_f32.cuh"
#include "flash_attention_tc.cuh"

namespace paddle_flash {
namespace {

template <int D>
constexpr int dq_smem_bytes() {
  return 6 * f32_tile<D>() * (int)sizeof(float);  // split Q, dO; K, V
}

template <int D>
constexpr int dkv_smem_bytes() {
  // split K, V; Q, dO; lse, di
  return (6 * f32_tile<D>() + 2 * tile_rows<D>()) * (int)sizeof(float);
}

// One pass of K2 fp32 dq over a block's kv tiles, streamed fragments and
// ds split with kClamp; stages everything it reads and returns with no
// copy in flight
template <int D, bool kClamp>
__device__ __forceinline__ void dq_pass(
    const PaddleFlashBwdArgs& a, float* smem,
    float (&dq)[D / col_splits<D>() / 8][4]) {
  constexpr int TE = f32_tile<D>();
  constexpr int RT = tile_rows<D>();
  constexpr int CS = col_splits<D>();
  constexpr int NJ = RT / 8;      // key n-tiles of a kv tile
  constexpr int KS = D / 8;       // k-steps over D
  constexpr int ND = D / CS / 8;  // n-tiles of this warp's dq columns
  float* Qb = smem;
  float* Qsm = Qb + TE;
  float* Ob = Qsm + TE;
  float* Osm = Ob + TE;
  float* Kt = Osm + TE;
  float* Vt = Kt + TE;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * RT;
  const int warp = threadIdx.x >> 5;
  const int rw = 16 * (warp / CS);       // this warp's first tile row
  const int dc = (warp % CS) * (D / CS);  // and first dq column
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int r0 = q0 + rw + (lane >> 2);  // rows r0, r0 + 8

  int n_kv = (a.S + RT - 1) / RT;
  if (a.causal) n_kv = min(n_kv, qt + 1);

  stage_f32<D>(Qb, a.q, b, h, q0, a.S);
  stage_f32<D>(Ob, a.dout, b, h, q0, a.S);
  stage_f32<D>(Vt, a.v, b, h, 0, a.S);
  cp_async_commit();
  stage_f32<D>(Kt, a.k, b, h, 0, a.S);
  cp_async_commit();

  float lse[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + 8 * i;
    lse[i] = qi < a.S ? a.lse[(long long)bh * a.S + qi] : 0.f;
    di[i] = qi < a.S ? a.di[(long long)bh * a.S + qi] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  cp_async_wait<1>();  // Q, dO and V(0); K(0) may be in flight
  __syncthreads();
  split_tile<D>(Qb, Qsm);
  split_tile<D>(Ob, Osm);
  __syncthreads();

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * RT;
    // dp = dO . v^T: 16 rows x RT keys, n-tile j at keys k0 + 8j
    float dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      SplitA oa;
      SplitB vb[NJ];
      load_a_split<D>(oa, Ob, Osm, rw, 8 * ks);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        load_b_nk_split<D, kClamp>(vb[j], Vt, 8 * j, 8 * ks);
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_3xtf32(dp[j], oa, vb[j], pass);
    }
    cp_async_wait<0>();  // K(kt) has landed ...
    __syncthreads();     // ... for every thread, and every warp is done with V
    if (kt + 1 < n_kv) {
      stage_f32<D>(Vt, a.v, b, h, k0 + RT, a.S);
      cp_async_commit();
    }

    // s = q . k^T
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      SplitA qa;
      SplitB kb[NJ];
      load_a_split<D>(qa, Qb, Qsm, rw, 8 * ks);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        load_b_nk_split<D, kClamp>(kb[j], Kt, 8 * j, 8 * ks);
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_3xtf32(s[j], qa, kb[j], pass);
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

    // dq += ds . k: 8-key steps, K read k-major in the permuted order
#pragma unroll
    for (int kk = 0; kk < NJ; ++kk) {
      SplitA da;
      acc_to_a_split<kClamp>(da, s[kk]);
#pragma unroll
      for (int d0 = 0; d0 < ND; d0 += 4) {
        SplitB kb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          load_b_kn_split<D, kClamp>(kb[u], Kt, 8 * kk, dc + 8 * (d0 + u));
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_3xtf32(dq[d0 + u], da, kb[u], pass);
      }
    }
    if (kt + 1 < n_kv) {
      __syncthreads();  // every warp is done with K
      stage_f32<D>(Kt, a.k, b, h, k0 + RT, a.S);
      cp_async_commit();
      cp_async_wait<1>();  // V(kt + 1) has landed; K(kt + 1) may not have
      __syncthreads();
    }
  }
}

// K2 fp32 dq: block (b*h, q tile); warp w owns q rows 16w .. 16w+15 (at
// D = 256, rows 16(w / 2) .. and half of dq's columns: col_splits).  The
// unclamped pass first; a block whose dq holds a NaN runs again clamped.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_kernel(const PaddleFlashBwdArgs a) {
  constexpr int CS = col_splits<D>();
  extern __shared__ float4 smem_f32[];
  float* smem = reinterpret_cast<float*>(smem_f32);
  float dq[D / CS / 8][4];
  dq_pass<D, false>(a, smem, dq);
  if (__syncthreads_or(any_nan(dq))) dq_pass<D, true>(a, smem, dq);
  const int b = blockIdx.x / a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * tile_rows<D>();
  const int warp = threadIdx.x >> 5;
  store_acc_f32<D / CS>(a.dq, b, blockIdx.x - b * a.H, q0 + 16 * (warp / CS),
                        a.S, (warp % CS) * (D / CS), dq);
}

// One pass of K2 fp32 dk/dv over a block's q tiles, streamed fragments
// and ds^T split with kClamp; stages everything it reads and returns with
// no copy in flight.  The q tile is taken 32 queries at a time, to bound
// the live accumulators (dk, dv, s^T, dp^T) at D = 128 (and at D = 256,
// whose warps hold 128 of dk's and dv's columns each).
template <int D, bool kClamp>
__device__ __forceinline__ void dkv_pass(
    const PaddleFlashBwdArgs& a, float* smem,
    float (&dk)[D / col_splits<D>() / 8][4],
    float (&dv)[D / col_splits<D>() / 8][4]) {
  constexpr int TE = f32_tile<D>();
  constexpr int RT = tile_rows<D>();
  constexpr int CS = col_splits<D>();
  constexpr int KS = D / 8;
  constexpr int ND = D / CS / 8;  // n-tiles of this warp's dk/dv columns
  float* Kb = smem;
  float* Ksm = Kb + TE;
  float* Vb = Ksm + TE;
  float* Vsm = Vb + TE;
  float* Qt = Vsm + TE;
  float* Ot = Qt + TE;
  float* lse_s = Ot + TE;
  float* di_s = lse_s + RT;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // the first kv tiles see the most q tiles
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = kt * RT;
  const int warp = threadIdx.x >> 5;
  const int rw = 16 * (warp / CS);       // this warp's first kv row
  const int dc = (warp % CS) * (D / CS);  // and first dk/dv column
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int c0 = k0 + rw + (lane >> 2);  // kv rows c0, c0 + 8

  const int nq = (a.S + RT - 1) / RT;
  const int qt0 = a.causal ? kt : 0;

  stage_f32<D>(Kb, a.k, b, h, k0, a.S);
  stage_f32<D>(Vb, a.v, b, h, k0, a.S);
  stage_f32<D>(Qt, a.q, b, h, qt0 * RT, a.S);
  stage_f32<D>(Ot, a.dout, b, h, qt0 * RT, a.S);
  tc::stage_rowstat<RT>(lse_s, a.lse, bh, qt0 * RT, a.S);
  tc::stage_rowstat<RT>(di_s, a.di, bh, qt0 * RT, a.S);
  cp_async_commit();

#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  cp_async_wait<0>();
  __syncthreads();
  split_tile<D>(Kb, Ksm);
  split_tile<D>(Vb, Vsm);
  __syncthreads();

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * RT;
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
        SplitA ka, va;
        load_a_split<D>(ka, Kb, Ksm, rw, 8 * ks);
        load_a_split<D>(va, Vb, Vsm, rw, 8 * ks);
        SplitB qb[4], ob[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          load_b_nk_split<D, kClamp>(qb[j], Qt, qc + 8 * j, 8 * ks);
          load_b_nk_split<D, kClamp>(ob[j], Ot, qc + 8 * j, 8 * ks);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma_3xtf32(st[j], ka, qb[j], pass);
            mma_3xtf32(dpt[j], va, ob[j], pass);
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
            p = expf(v - lse_s[col]);
          } else if (qi < a.S) {
            if (a.causal && c0 + 8 * (e >> 1) > qi) v = kNegInf;
            p = expf(v - lse_s[col]);
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - di_s[col]) * a.scale;
        }
      }

      // dv += p^T . dO, dk += ds^T . q: 8-query steps, dO and q read
      // k-major in the permuted order
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        SplitA pa, da;
        acc_to_a_split<false>(pa, st[kk]);  // p <= 1 or NaN
        acc_to_a_split<kClamp>(da, dpt[kk]);
#pragma unroll
        for (int d0 = 0; d0 < ND; d0 += 2) {
          SplitB ob[2], qb[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            load_b_kn_split<D, kClamp>(ob[u], Ot, qc + 8 * kk,
                                       dc + 8 * (d0 + u));
            load_b_kn_split<D, kClamp>(qb[u], Qt, qc + 8 * kk,
                                       dc + 8 * (d0 + u));
          }
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              mma_3xtf32(dv[d0 + u], pa, ob[u], pass);
              mma_3xtf32(dk[d0 + u], da, qb[u], pass);
            }
        }
      }
    }
    if (qt + 1 < nq) {
      __syncthreads();  // every warp is done with this q tile
      const int qn = q0 + RT;
      stage_f32<D>(Qt, a.q, b, h, qn, a.S);
      stage_f32<D>(Ot, a.dout, b, h, qn, a.S);
      tc::stage_rowstat<RT>(lse_s, a.lse, bh, qn, a.S);
      tc::stage_rowstat<RT>(di_s, a.di, bh, qn, a.S);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
  }
}

// K2 fp32 dk/dv: block (b*h, kv tile); warp w owns kv rows 16w .. 16w+15
// (at D = 256, rows 16(w / 2) .. and half of dk's and dv's columns:
// col_splits).  The unclamped pass first; a block whose dk or dv holds a
// NaN runs again clamped.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkv_kernel(const PaddleFlashBwdArgs a) {
  constexpr int CS = col_splits<D>();
  extern __shared__ float4 smem_f32[];
  float* smem = reinterpret_cast<float*>(smem_f32);
  float dk[D / CS / 8][4], dv[D / CS / 8][4];
  dkv_pass<D, false>(a, smem, dk, dv);
  if (__syncthreads_or(any_nan(dk) || any_nan(dv)))
    dkv_pass<D, true>(a, smem, dk, dv);
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x - b * a.H;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * tile_rows<D>() + 16 * (warp / CS);
  const int dc = (warp % CS) * (D / CS);
  store_acc_f32<D / CS>(a.dk, b, h, r0, a.S, dc, dk);
  store_acc_f32<D / CS>(a.dv, b, h, r0, a.S, dc, dv);
}

// Launch an fp32 kernel with the most shared memory per SM, so that two
// D = 64 blocks fit on one
template <int D, typename Kernel>
cudaError_t launch_f32(Kernel kernel, int smem, const PaddleFlashBwdArgs& a,
                       cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return launch_tiles(kernel, kF32Threads, smem, a, st, tile_rows<D>());
}

template <int D>
cudaError_t launch_dq_f32_d(const PaddleFlashBwdArgs& a, cudaStream_t st) {
  return launch_f32<D>(flash_bwd_dq_kernel<D>, dq_smem_bytes<D>(), a, st);
}

template <int D>
cudaError_t launch_dkv_f32_d(const PaddleFlashBwdArgs& a, cudaStream_t st) {
  return launch_f32<D>(flash_bwd_dkv_kernel<D>, dkv_smem_bytes<D>(), a, st);
}

template <int D>
cudaError_t launch_dq_bf16_d(const PaddleFlashBwdArgs& a, cudaStream_t st) {
  return launch_tiles(tc::flash_bwd_dq_tc_kernel<D>, tc::kThreads,
                      tc::dq_smem_bytes<D>(), a, st, tile_rows<D>());
}

template <int D>
cudaError_t launch_dkv_bf16_d(const PaddleFlashBwdArgs& a, cudaStream_t st) {
  return launch_tiles(tc::flash_bwd_dkv_tc_kernel<D>, tc::kThreads,
                      tc::dkv_smem_bytes<D>(), a, st, tile_rows<D>());
}

// the switch over the instantiated head dims of one launcher
#define PADDLE_FLASH_DISPATCH(LAUNCH)                    \
  switch (a->D) {                                        \
    case 64: return LAUNCH<64>(*a, st);                  \
    case 128: return LAUNCH<128>(*a, st);                \
    case 256: return LAUNCH<256>(*a, st);                \
    default: return cudaErrorInvalidValue;               \
  }

cudaError_t launch_dq_f32(const PaddleFlashBwdArgs* a, cudaStream_t st) {
  PADDLE_FLASH_DISPATCH(launch_dq_f32_d)
}

cudaError_t launch_dkv_f32(const PaddleFlashBwdArgs* a, cudaStream_t st) {
  PADDLE_FLASH_DISPATCH(launch_dkv_f32_d)
}

cudaError_t launch_dq_bf16(const PaddleFlashBwdArgs* a, cudaStream_t st) {
  PADDLE_FLASH_DISPATCH(launch_dq_bf16_d)
}

cudaError_t launch_dkv_bf16(const PaddleFlashBwdArgs* a, cudaStream_t st) {
  PADDLE_FLASH_DISPATCH(launch_dkv_bf16_d)
}

#undef PADDLE_FLASH_DISPATCH

}  // namespace
}  // namespace paddle_flash

// Pointers are device pointers, each [B, S, H, D] view 16-byte aligned
// with D contiguous and strides that are multiples of 16 bytes; D is 64,
// 128 or 256.  Each entry launches one kernel on `st`, does not synchronise,
// and returns the launch's cudaError_t (cudaSuccess = 0).
extern "C" cudaError_t paddle_flash_bwd_dq_f32(const PaddleFlashBwdArgs* a,
                                               cudaStream_t st) {
  return paddle_flash::launch_dq_f32(a, st);
}

extern "C" cudaError_t paddle_flash_bwd_dkv_f32(const PaddleFlashBwdArgs* a,
                                                cudaStream_t st) {
  return paddle_flash::launch_dkv_f32(a, st);
}

extern "C" cudaError_t paddle_flash_bwd_dq_bf16(const PaddleFlashBwdArgs* a,
                                                cudaStream_t st) {
  return paddle_flash::launch_dq_bf16(a, st);
}

extern "C" cudaError_t paddle_flash_bwd_dkv_bf16(const PaddleFlashBwdArgs* a,
                                                 cudaStream_t st) {
  return paddle_flash::launch_dkv_bf16(a, st);
}
