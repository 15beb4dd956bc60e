// Flash-attention forward (K1), fp32 and bf16, for Hopper (sm_90a).  This
// file holds the fp32 kernel, on the SIMT units; the bf16 entry launches
// the tensor-core kernel of flash_attention_tc.cuh.
//
// Replaces the TPU kernel `_flash_fwd_pallas` of
// paddle_tpu/ops/pallas_kernels.py (an instance of its tiled-contraction
// core, reached through `flash_attention`): q, k, v [B, S, H, D] ->
// o [B, S, H, D] and the row logsumexp lse [B * H, S], with
//   s   = (q . k) * scale, masked to the finite -1e30 where key > query
//         (causal) or key >= S (the ragged tail of the last tile);
//   o   = sum_k softmax_k(s) v_k, by an online softmax over kv tiles;
//   lse = m + log(max(l, 1e-20)), m the row max and l the normaliser.
// Kv tiles wholly above the causal diagonal are skipped.
//
// What bounds it: at the training slice (B*H = 64, S = 512, D = 64,
// causal) the two products take 4 * D flops per live (query, key) pair,
// 2.15 GFLOP against 33.7 MB of q/k/v/o/lse, ~64 flops per byte, above
// the fp32 ridge point (67 TFLOP/s over 3.35 TB/s = 20): the kernel is
// bound by fp32 FMA throughput, and the design keeps the FMA units fed
// from registers and shared memory:
//   * one 256-thread block per (b*h, 64-row q tile); the q tile stays in
//     shared memory, 64-row K and V tiles are staged through shared
//     memory one after the other;
//   * each thread computes a 4 x 4 block of the 64 x 64 score tile from
//     float4 shared-memory reads (8 loads per 64 FMAs) and keeps 4 rows x
//     D/16 columns of the output accumulator in registers; the online
//     softmax state (m, l) of its 4 rows lives in registers, reduced
//     across the 16 threads of a row by warp shuffles;
//   * the probabilities go through shared memory once per tile for the
//     P . V product (float4 reads again);
//   * causal blocks are scheduled longest first (the last q tiles, which
//     see the most kv tiles, have the lowest block index).
// No atomics, and each thread reduces in a fixed order, so a result
// depends only on its inputs.  fp32 on the SIMT units throughout; TF32
// tensor cores are later work.
//
// bf16 (paddle_flash_fwd_bf16, the TPU kernel's bf16 instance under
// AMP): flash_attention_tc.cuh's `flash_fwd_tc_kernel`, on the bf16
// tensor cores.

#include "flash_attention_common.cuh"
#include "flash_attention_tc.cuh"

namespace paddle_flash {
namespace {

template <int D>
constexpr int fwd_smem_bytes() {
  return (3 * kTile * (D + kPad) + kTile * kPRow) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const PaddleFlashFwdArgs a) {
  constexpr int R = D + kPad;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * R;
  float* Vs = Ks + kTile * R;
  float* Ps = Vs + kTile * R;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(Qs, a.q, b, h, q0, a.S);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (a.S + kTile - 1) / kTile;
  if (a.causal) n_kv = min(n_kv, qt + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V and P reads are done
    load_tile<D>(Ks, a.k, b, h, k0, a.S);
    load_tile<D>(Vs, a.v, b, h, k0, a.S);
    __syncthreads();

    // s = q . k for rows ty*4 + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(Ks + (tx + 16 * j) * R + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = ld4(Qs + (ty * 4 + i) * R + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv, kv[j], s[i][j]);
      }
    }

    // mask, then fold the tile into the online softmax of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float v = s[i][j] * a.scale;
        if (kj >= a.S || (a.causal && kj > qi)) v = kNegInf;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty * 4 + i) * kPRow + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P . V for rows ty*4 + i, columns g*64 + tx*4 .. +3
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ld4(Ps + (ty * 4 + i) * kPRow + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < D / 64; ++g) {
          const float4 vv = ld4(Vs + (kk + u) * R + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(pv[i], u);
            acc[i][g * 4 + 0] = fmaf(p, vv.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(p, vv.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(p, vv.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(p, vv.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

  float lf[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lf[i] = fmaxf(l[i], kTiny);
  store_rows<D>(a.o, b, h, q0, a.S, ty, tx, acc, lf);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if (qi < a.S) a.lse[(long long)bh * a.S + qi] = m[i] + logf(lf[i]);
    }
  }
}

cudaError_t launch_f32(const PaddleFlashFwdArgs* a, cudaStream_t st) {
  switch (a->D) {
    case 64:
      return launch_tiles(flash_fwd_kernel<64>, kThreads,
                          fwd_smem_bytes<64>(), *a, st);
    case 128:
      return launch_tiles(flash_fwd_kernel<128>, kThreads,
                          fwd_smem_bytes<128>(), *a, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(const PaddleFlashFwdArgs* a, cudaStream_t st) {
  switch (a->D) {
    case 64:
      return launch_tiles(tc::flash_fwd_tc_kernel<64>, tc::kThreads,
                          tc::fwd_smem_bytes<64>(), *a, st);
    case 128:
      return launch_tiles(tc::flash_fwd_tc_kernel<128>, tc::kThreads,
                          tc::fwd_smem_bytes<128>(), *a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace paddle_flash

// Pointers are device pointers, each [B, S, H, D] view 16-byte aligned
// with D contiguous and strides that are multiples of 16 bytes; D is 64
// or 128.  Launches on `st`, does not synchronise, and returns the
// launch's cudaError_t (cudaSuccess = 0).
extern "C" cudaError_t paddle_flash_fwd_f32(const PaddleFlashFwdArgs* a,
                                            cudaStream_t st) {
  return paddle_flash::launch_f32(a, st);
}

extern "C" cudaError_t paddle_flash_fwd_bf16(const PaddleFlashFwdArgs* a,
                                             cudaStream_t st) {
  return paddle_flash::launch_bf16(a, st);
}
