// Flash-attention forward (K1), fp32 and bf16, for Hopper (sm_90a).  This
// file holds the fp32 kernel, on the TF32 tensor cores at fp32 accuracy
// (3xTF32); the bf16 entry launches the bf16 tensor-core kernel of
// flash_attention_tc.cuh.
//
// Replaces the TPU kernel `_flash_fwd_pallas` of
// paddle_tpu/ops/pallas_kernels.py (an instance of its tiled-contraction
// core, reached through `flash_attention`): q, k, v [B, S, H, D] ->
// o [B, S, H, D] and the row logsumexp lse [B * H, S], with
//   s   = (q . k) * scale, masked to the finite -1e30 where key > query
//         (causal) or key >= S (the ragged tail of the last tile);
//   o   = sum_k softmax_k(s) v_k, by an online softmax over kv tiles;
//   lse = m + log(max(l, 1e-20)), m the row max and l the normaliser.
// Kv tiles wholly above the causal diagonal are skipped.  There is no
// rounding point but fp32's: p stays fp32, as the TPU kernel's fp32
// instance keeps it.
//
// What bounds it: the two products take 4 * D flops per live (query, key)
// pair — at the training slice (B*H = 64, S = 512, D = 64, causal) 2.15
// GFLOP against 33.7 MB of q/k/v/o/lse, far above the ridge point: the
// multiply rate bounds it.  The SIMT units top out at 67 TFLOP/s; the
// TF32 tensor cores give 495, and fp32 accuracy on them costs three
// products (3xTF32, tc_common.cuh), so the fp32-accurate ceiling is 165
// TFLOP/s.  The design is fp32 K2's dq kernel (flash_attention_bwd.cu)
// with the forward's two products:
//   * one block of 4 warps per (b*h, 64-row q tile), warp w owning rows
//     16w .. 16w+15; causal tiles are scheduled longest first (the last q
//     tiles, which see the most kv tiles, have the lowest block index);
//   * the q tile is staged once by cp.async and split in place into big
//     and small tiles (flash_attention_f32.cuh); the K and V tiles stay
//     raw fp32, double-buffered (the next tile's cp.async runs under this
//     tile's products), and are split as their fragments load — with the
//     three-instruction split, unclamped: a block whose o then holds a
//     NaN (an infinite or near-FLT_MAX k or v, or a NaN input) runs again
//     with the clamped split (tc_common.cuh), so such values cost a
//     second pass of their own blocks and nothing elsewhere;
//   * s = q . k^T per tile is mma.sync.m16n8k8 tf32 in three passes
//     (small.big, big.small, big.big), each over 8 independent
//     accumulators; the online softmax runs in the accumulators;
//   * p is split in registers and fed as the A operand of p . V through
//     K2's fixed k permutation (the m16n8 accumulator holds columns 2t,
//     2t + 1; the A fragment wants t, t + 4: V's B fragment reads k rows
//     2t and 2t + 1 instead), with no shared-memory round trip;
//   * each tile's p . V sums into a zeroed per-tile accumulator, folded
//     into the running o as o * alpha + tile, one IEEE fp32 rounding: the
//     tensor cores' fp32 sums do not round to nearest, so a running o
//     summed across S / 64 tiles inside them would drift with S (fp32 K6
//     promotes its chunks for the same reason);
//   * shared memory: the split q tile and two K/V stages, six tiles of 64
//     rows of D + 4 floats — 104 KB at D = 64 (two blocks an SM) and 198
//     KB at D = 128 (one); at D = 256 the tiles are 32 rows, 195 KB, and
//     the warps work in pairs, each owning half of o's columns and both
//     forming the pair's s (flash_attention_common.cuh, tile_rows).
// What holds it back: the split's instructions (three per streamed
// element a fragment loads, each element split once per warp), mma.sync
// rather than wgmma, and the per-tile fold's second accumulator.
// No atomics, and each thread reduces in a fixed order, so a result
// depends only on its inputs.
//
// bf16 (paddle_flash_fwd_bf16, the TPU kernel's bf16 instance under
// AMP): flash_attention_tc.cuh's `flash_fwd_tc_kernel`, on the bf16
// tensor cores.

#include "flash_attention_f32.cuh"
#include "flash_attention_tc.cuh"

namespace paddle_flash {
namespace {

template <int D>
constexpr int fwd_smem_bytes() {
  return 6 * f32_tile<D>() * (int)sizeof(float);  // split Q; 2 x (K, V)
}

// One pass of K1 fp32 over a block's kv tiles, streamed fragments split
// with kClamp: o (unnormalised), and each row's max m and this thread's
// share of its sum l, for rows r0 and r0 + 8.  Stages everything it reads;
// returns with no copy in flight.
template <int D, bool kClamp>
__device__ __forceinline__ void fwd_pass(
    const PaddleFlashFwdArgs& a, float* smem, int b, int h, int qt,
    float (&o)[D / col_splits<D>() / 8][4], float (&m)[2], float (&l)[2]) {
  constexpr int TE = f32_tile<D>();
  constexpr int RT = tile_rows<D>();
  constexpr int CS = col_splits<D>();
  constexpr int NJ = RT / 8;       // key n-tiles of a kv tile
  constexpr int KS = D / 8;        // k-steps over D
  constexpr int ND = D / CS / 8;   // n-tiles of this warp's o columns
  // n-tiles of o per pass of p . V: all of them at D = 64; at D >= 128 two
  // passes, p split again for the second (bounds the live accumulators)
  constexpr int NC = ND < 8 ? ND : 8;
  float* Qb = smem;
  float* Qsm = Qb + TE;
  float* Ks = Qsm + TE;     // [2][TE]
  float* Vs = Ks + 2 * TE;  // [2][TE]
  const int q0 = qt * RT;
  const int warp = threadIdx.x >> 5;
  const int rw = 16 * (warp / CS);       // this warp's first tile row
  const int dc = (warp % CS) * (D / CS);  // and first o column
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int r0 = q0 + rw + (lane >> 2);  // rows r0, r0 + 8

  int n_kv = (a.S + RT - 1) / RT;
  if (a.causal) n_kv = min(n_kv, qt + 1);

  stage_f32<D>(Qb, a.q, b, h, q0, a.S);
  stage_f32<D>(Ks, a.k, b, h, 0, a.S);
  stage_f32<D>(Vs, a.v, b, h, 0, a.S);
  cp_async_commit();

#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int buf = kt & 1;
    const int k0 = kt * RT;
    if (kt + 1 < n_kv) {
      stage_f32<D>(Ks + (buf ^ 1) * TE, a.k, b, h, k0 + RT, a.S);
      stage_f32<D>(Vs + (buf ^ 1) * TE, a.v, b, h, k0 + RT, a.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {  // q has landed with the first K/V stage
      split_tile<D>(Qb, Qsm);
      __syncthreads();
    }
    const float* Kt = Ks + buf * TE;
    const float* Vt = Vs + buf * TE;

    // s = q . k^T: 16 rows x RT keys, n-tile j at keys k0 + 8j
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

    // o = o * alpha + p . v, the tile's product summed apart: 8-key steps,
    // V read k-major in the permuted order (p <= 1 or NaN: the unclamped
    // split takes it)
#pragma unroll
    for (int c0 = 0; c0 < ND; c0 += NC) {
      float pv[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
        pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        SplitA pa;
        acc_to_a_split<false>(pa, s[kk]);
#pragma unroll
        for (int d0 = 0; d0 < NC; d0 += 4) {
          SplitB vb[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            load_b_kn_split<D, kClamp>(vb[u], Vt, 8 * kk,
                                       dc + 8 * (c0 + d0 + u));
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int u = 0; u < 4; ++u) mma_3xtf32(pv[d0 + u], pa, vb[u], pass);
        }
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        o[c0 + n][0] = fmaf(o[c0 + n][0], alpha[0], pv[n][0]);
        o[c0 + n][1] = fmaf(o[c0 + n][1], alpha[0], pv[n][1]);
        o[c0 + n][2] = fmaf(o[c0 + n][2], alpha[1], pv[n][2]);
        o[c0 + n][3] = fmaf(o[c0 + n][3], alpha[1], pv[n][3]);
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
}

// K1 fp32: block (b*h, q tile); warp w owns q rows 16w .. 16w+15 (at D =
// 256, rows 16(w / 2) .. and half of o's columns: col_splits).  The
// unclamped pass first; a block whose o holds a NaN runs again clamped.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_kernel(const PaddleFlashFwdArgs a) {
  constexpr int CS = col_splits<D>();
  constexpr int ND = D / CS / 8;
  extern __shared__ float4 smem_f32[];
  float* smem = reinterpret_cast<float*>(smem_f32);
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * tile_rows<D>();
  const int warp = threadIdx.x >> 5;
  const int rw = 16 * (warp / CS);
  const int lane = threadIdx.x & 31;
  const int r0 = q0 + rw + (lane >> 2);  // rows r0, r0 + 8

  float o[ND][4], m[2], l[2];
  fwd_pass<D, false>(a, smem, b, h, qt, o, m, l);
  if (__syncthreads_or(any_nan(o)))
    fwd_pass<D, true>(a, smem, b, h, qt, o, m, l);

  float lf[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    lf[i] = fmaxf(l[i], kTiny);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    o[n][0] /= lf[0];
    o[n][1] /= lf[0];
    o[n][2] /= lf[1];
    o[n][3] /= lf[1];
  }
  store_acc_f32<D / CS>(a.o, b, h, q0 + rw, a.S, (warp % CS) * (D / CS), o);
  if ((lane & 3) == 0 && warp % CS == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = r0 + 8 * i;
      if (qi < a.S) a.lse[(long long)bh * a.S + qi] = m[i] + logf(lf[i]);
    }
  }
}

// Launch with the most shared memory per SM, so that two D = 64 blocks
// fit on one
template <int D>
cudaError_t launch_f32_d(const PaddleFlashFwdArgs& a, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return launch_tiles(flash_fwd_kernel<D>, kF32Threads, fwd_smem_bytes<D>(),
                      a, st, tile_rows<D>());
}

template <int D>
cudaError_t launch_bf16_d(const PaddleFlashFwdArgs& a, cudaStream_t st) {
  return launch_tiles(tc::flash_fwd_tc_kernel<D>, tc::kThreads,
                      tc::fwd_smem_bytes<D>(), a, st, tile_rows<D>());
}

cudaError_t launch_f32(const PaddleFlashFwdArgs* a, cudaStream_t st) {
  switch (a->D) {
    case 64: return launch_f32_d<64>(*a, st);
    case 128: return launch_f32_d<128>(*a, st);
    case 256: return launch_f32_d<256>(*a, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(const PaddleFlashFwdArgs* a, cudaStream_t st) {
  switch (a->D) {
    case 64: return launch_bf16_d<64>(*a, st);
    case 128: return launch_bf16_d<128>(*a, st);
    case 256: return launch_bf16_d<256>(*a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace paddle_flash

// Pointers are device pointers, each [B, S, H, D] view 16-byte aligned
// with D contiguous and strides that are multiples of 16 bytes; D is 64,
// 128 or 256.  Launches on `st`, does not synchronise, and returns the
// launch's cudaError_t (cudaSuccess = 0).
extern "C" cudaError_t paddle_flash_fwd_f32(const PaddleFlashFwdArgs* a,
                                            cudaStream_t st) {
  return paddle_flash::launch_f32(a, st);
}

extern "C" cudaError_t paddle_flash_fwd_bf16(const PaddleFlashFwdArgs* a,
                                             cudaStream_t st) {
  return paddle_flash::launch_bf16(a, st);
}
