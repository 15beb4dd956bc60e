// Flash-attention backward (K2), fp32 and bf16, for Hopper (sm_90a): the
// dq kernel and the dk/dv kernel.  This file holds the fp32 kernels, on
// the SIMT units; the bf16 entries launch the tensor-core kernels of
// flash_attention_tc.cuh.
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
// Kv tiles above the causal diagonal are skipped in both kernels.
//
// What bounds it: per live (query, key) pair the dq kernel does three
// D-long products (s, dp, ds . k) and the dkv kernel four (s, dp, p . dO,
// ds . q); at the training slice that is 3.2 and 4.3 GFLOP against 42 and
// 51 MB moved, both far above the fp32 ridge point: fp32 FMA throughput
// bounds them.  The design mirrors the forward kernel:
//   * one 256-thread block per (b*h, 64-row tile): a q tile for dq, a kv
//     tile for dk/dv.  The stationary tiles stay in shared memory, the
//     streamed tiles pass through it one after the other;
//   * each thread computes 4 x 4 blocks of s and dp from float4
//     shared-memory reads, forms p and ds in registers, and writes them
//     to shared memory once per tile for the products that follow;
//   * each thread owns 4 rows x D/16 columns of its gradients in
//     registers.
// Because the dkv kernel is kv-stationary, every gradient row is owned by
// one thread of one block: no atomics, fixed reduction orders, and a
// result that depends only on its inputs.
//
// bf16 (the TPU kernels' bf16 instance under AMP): flash_attention_tc.cuh's
// `flash_bwd_dq_tc_kernel` and `flash_bwd_dkv_tc_kernel`, on the bf16
// tensor cores.

#include "flash_attention_common.cuh"
#include "flash_attention_tc.cuh"

namespace paddle_flash {
namespace {

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kTile * (D + kPad) + kTile * kPRow) * (int)sizeof(float);
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (4 * kTile * (D + kPad) + 2 * kTile * kPRow + 2 * kTile) *
         (int)sizeof(float);
}

// dq: block (b*h, q tile); rows ty*4 + i of the q tile, keys tx + 16 j
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const PaddleFlashBwdArgs a) {
  constexpr int R = D + kPad;
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * R;
  float* Ks = dOs + kTile * R;
  float* Vs = Ks + kTile * R;
  float* dSs = Vs + kTile * R;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(Qs, a.q, b, h, q0, a.S);
  load_tile<D>(dOs, a.dout, b, h, q0, a.S);
  float lse[4], di[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    lse[i] = qi < a.S ? a.lse[(long long)bh * a.S + qi] : 0.f;
    di[i] = qi < a.S ? a.di[(long long)bh * a.S + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (a.S + kTile - 1) / kTile;
  if (a.causal) n_kv = min(n_kv, qt + 1);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<D>(Ks, a.k, b, h, k0, a.S);
    load_tile<D>(Vs, a.v, b, h, k0, a.S);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[4], vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ld4(Ks + (tx + 16 * j) * R + d);
        vv[j] = ld4(Vs + (tx + 16 * j) * R + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = ld4(Qs + (ty * 4 + i) * R + d);
        const float4 ov = ld4(dOs + (ty * 4 + i) * R + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qv, kv[j], s[i][j]);
          dp[i][j] = dot4(ov, vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float v = s[i][j] * a.scale;
        if (kj >= a.S || (a.causal && kj > qi)) v = kNegInf;
        const float p = expf(v - lse[i]);
        dSs[(ty * 4 + i) * kPRow + tx + 16 * j] =
            p * (dp[i][j] - di[i]) * a.scale;
      }
    }
    __syncthreads();

    // acc += dS . K for rows ty*4 + i, columns g*64 + tx*4 .. +3
#pragma unroll 2
    for (int kk = 0; kk < kTile; kk += 4) {
      float4 dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dsv[i] = ld4(dSs + (ty * 4 + i) * kPRow + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < D / 64; ++g) {
          const float4 kv = ld4(Ks + (kk + u) * R + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = comp(dsv[i], u);
            acc[i][g * 4 + 0] = fmaf(w, kv.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(w, kv.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(w, kv.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(w, kv.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(a.dq, b, h, q0, a.S, ty, tx, acc, one);
}

// dk, dv: block (b*h, kv tile); kv rows ty*4 + i, queries tx + 16 j
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const PaddleFlashBwdArgs a) {
  constexpr int R = D + kPad;
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * R;
  float* Qs = Vs + kTile * R;
  float* dOs = Qs + kTile * R;
  float* Ps = dOs + kTile * R;
  float* dSs = Ps + kTile * kPRow;
  float* lse_s = dSs + kTile * kPRow;
  float* di_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // the first kv tiles see the most q tiles
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int k0 = kt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(Ks, a.k, b, h, k0, a.S);
  load_tile<D>(Vs, a.v, b, h, k0, a.S);
  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int nq = (a.S + kTile - 1) / kTile;
  for (int qt = a.causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<D>(Qs, a.q, b, h, q0, a.S);
    load_tile<D>(dOs, a.dout, b, h, q0, a.S);
    load_rowstat(lse_s, a.lse, bh, q0, a.S);
    load_rowstat(di_s, a.di, bh, q0, a.S);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], ov[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = ld4(Qs + (tx + 16 * j) * R + d);
        ov[j] = ld4(dOs + (tx + 16 * j) * R + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kv = ld4(Ks + (ty * 4 + i) * R + d);
        const float4 vv = ld4(Vs + (ty * 4 + i) * R + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qv[j], kv, s[i][j]);
          dp[i][j] = dot4(ov[j], vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const int qi = q0 + r;
        float v = s[i][j] * a.scale;
        if (a.causal && kc > qi) v = kNegInf;
        // queries past S do not exist: they contribute nothing
        const float p = qi < a.S ? expf(v - lse_s[r]) : 0.f;
        Ps[(ty * 4 + i) * kPRow + r] = p;
        dSs[(ty * 4 + i) * kPRow + r] = p * (dp[i][j] - di_s[r]) * a.scale;
      }
    }
    __syncthreads();

    // dv += P^T . dO and dk += dS^T . Q for kv rows ty*4 + i, columns
    // g*64 + tx*4 .. +3
#pragma unroll 2
    for (int rr = 0; rr < kTile; rr += 4) {
      float4 pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ld4(Ps + (ty * 4 + i) * kPRow + rr);
        dsv[i] = ld4(dSs + (ty * 4 + i) * kPRow + rr);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < D / 64; ++g) {
          const float4 ov = ld4(dOs + (rr + u) * R + g * 64 + tx * 4);
          const float4 qv = ld4(Qs + (rr + u) * R + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(pv[i], u);
            const float w = comp(dsv[i], u);
            dv[i][g * 4 + 0] = fmaf(p, ov.x, dv[i][g * 4 + 0]);
            dv[i][g * 4 + 1] = fmaf(p, ov.y, dv[i][g * 4 + 1]);
            dv[i][g * 4 + 2] = fmaf(p, ov.z, dv[i][g * 4 + 2]);
            dv[i][g * 4 + 3] = fmaf(p, ov.w, dv[i][g * 4 + 3]);
            dk[i][g * 4 + 0] = fmaf(w, qv.x, dk[i][g * 4 + 0]);
            dk[i][g * 4 + 1] = fmaf(w, qv.y, dk[i][g * 4 + 1]);
            dk[i][g * 4 + 2] = fmaf(w, qv.z, dk[i][g * 4 + 2]);
            dk[i][g * 4 + 3] = fmaf(w, qv.w, dk[i][g * 4 + 3]);
          }
        }
      }
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(a.dk, b, h, k0, a.S, ty, tx, dk, one);
  store_rows<D>(a.dv, b, h, k0, a.S, ty, tx, dv, one);
}

cudaError_t launch_dq_f32(const PaddleFlashBwdArgs* a, cudaStream_t st) {
  switch (a->D) {
    case 64:
      return launch_tiles(flash_bwd_dq_kernel<64>, kThreads,
                          dq_smem_bytes<64>(), *a, st);
    case 128:
      return launch_tiles(flash_bwd_dq_kernel<128>, kThreads,
                          dq_smem_bytes<128>(), *a, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_dkv_f32(const PaddleFlashBwdArgs* a, cudaStream_t st) {
  switch (a->D) {
    case 64:
      return launch_tiles(flash_bwd_dkv_kernel<64>, kThreads,
                          dkv_smem_bytes<64>(), *a, st);
    case 128:
      return launch_tiles(flash_bwd_dkv_kernel<128>, kThreads,
                          dkv_smem_bytes<128>(), *a, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_dq_bf16(const PaddleFlashBwdArgs* a, cudaStream_t st) {
  switch (a->D) {
    case 64:
      return launch_tiles(tc::flash_bwd_dq_tc_kernel<64>, tc::kThreads,
                          tc::dq_smem_bytes<64>(), *a, st);
    case 128:
      return launch_tiles(tc::flash_bwd_dq_tc_kernel<128>, tc::kThreads,
                          tc::dq_smem_bytes<128>(), *a, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_dkv_bf16(const PaddleFlashBwdArgs* a, cudaStream_t st) {
  switch (a->D) {
    case 64:
      return launch_tiles(tc::flash_bwd_dkv_tc_kernel<64>, tc::kThreads,
                          tc::dkv_smem_bytes<64>(), *a, st);
    case 128:
      return launch_tiles(tc::flash_bwd_dkv_tc_kernel<128>, tc::kThreads,
                          tc::dkv_smem_bytes<128>(), *a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace paddle_flash

// Pointers are device pointers, each [B, S, H, D] view 16-byte aligned
// with D contiguous and strides that are multiples of 16 bytes; D is 64
// or 128.  Each entry launches one kernel on `st`, does not synchronise,
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
