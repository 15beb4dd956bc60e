// Fused dequant-matmul of the quantized inference lane, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `dequant_matmul` of
// paddle_tpu/ops/pallas_kernels.py (an instance of its tiled-contraction
// core: int8 weight tiles streamed under a resident activation tile,
// cast in-register, fp32 accumulation, the per-channel scale at
// finalize).
//
//   x [M, K] f32 or bf16, w_q [K, N] int8, scale [N] f32
//   -> out [M, N] f32 or bf16,
//   out[m, n] = (sum_k float(x[m, k]) * float(w_q[k, n])) * scale[n].
// Any M, K and N (the TPU op falls back to plain XLA when no block edge
// divides the shape; N = 1000, the ResNet fc, is such a shape here).
//
// Numerics: a bf16 activation and an int8 weight both convert to fp32
// exactly, and their product (at most 8 + 7 significant bits) is exact in
// fp32, so the kernel matches the plain version (bf16-round, fp32
// matmul, scale) up to the order of the fp32 sums.  bf16 output rounds
// to nearest even, as torch's `.to(torch.bfloat16)`.
//
// Design: a plain tiled GEMM.  One thread block per 64 x 64 output tile
// and K slice, 256 threads each owning a 4 x 4 register tile; K advances
// in chunks of 16, with the x chunk [64 x 16] and the int8 w chunk
// [16 x 64] converted to fp32 as they are staged in shared memory (w is
// read as int8 from device memory: a quarter of the fp32 weight bytes),
// the next chunk fetched into registers while the current one is
// multiplied.  Where the output has too few tiles to fill the card (the
// path's 64 x 1000 output is 16 tiles), K is split over up to 16 blocks
// per tile: each writes its fp32 partial sums to a workspace and a second
// kernel adds the slices in a fixed order, then applies the scale and
// the output cast; with one slice the first kernel does that itself.
//
// What bounds it: at the path's shape (M = 64 bucketed images, K = 2048,
// N = 1000) the work is 262 MFLOP on 2.6 MB, ~100 flops per byte; with
// the bf16 tensor-core rate as the card's peak for bf16 x int8 products
// the least time is the byte time, 0.8 us.  This SIMT kernel is far from
// that: tensor-core (mma.sync / wgmma bf16) tiles and cp.async / TMA
// staging are later work.  No atomics: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace paddle_dequant {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kChunk = 16;
constexpr int kLdt = kTile + 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Multiplies the K slice [k_lo, k_hi) of one 64 x 64 tile.  `part` null:
// out = cast(acc * scale); else part[m * N + n] = acc (fp32).
template <typename TX, typename TO>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const TX* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale, TO* __restrict__ out,
                      float* __restrict__ work, int M, int N, int K,
                      int k_slice) {
  __shared__ __align__(16) float As[2][kChunk * kLdt];  // [k][m]
  __shared__ __align__(16) float Bs[2][kChunk * kLdt];  // [k][n]
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k_lo = blockIdx.z * k_slice;
  const int k_hi = min(K, k_lo + k_slice);
  // x chunk: 16 consecutive k of one row per 16 threads (k is x's
  // contiguous axis); w chunk: 64 consecutive n of one k per 64 threads
  const int xk = t % kChunk, xr = t / kChunk;
  const int wn = t % kTile, wk = t / kTile;
  float ra[kTile / 16], rb[kChunk / 4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kTile / 16; ++i) {
      const int m = m0 + xr + 16 * i, k = k0 + xk;
      ra[i] = (m < M && k < k_hi) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kChunk / 4; ++i) {
      const int k = k0 + wk + 4 * i, n = n0 + wn;
      rb[i] = (k < k_hi && n < N) ? (float)w[(size_t)k * N + n] : 0.f;
    }
  };
  float acc[4][4] = {};
  fetch(k_lo);
  int buf = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kChunk) {
#pragma unroll
    for (int i = 0; i < kTile / 16; ++i)
      As[buf][xk * kLdt + xr + 16 * i] = ra[i];
#pragma unroll
    for (int i = 0; i < kChunk / 4; ++i)
      Bs[buf][(wk + 4 * i) * kLdt + wn] = rb[i];
    __syncthreads();
    if (k0 + kChunk < k_hi) fetch(k0 + kChunk);
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 av =
          *reinterpret_cast<const float4*>(&As[buf][kk * kLdt + 4 * ty]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&Bs[buf][kk * kLdt + 4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    buf ^= 1;
  }
  float* part = work ? work + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= N) continue;
      if (part)
        part[(size_t)m * N + n] = acc[i][j];
      else
        store(out + (size_t)m * N + n, acc[i][j] * __ldg(scale + n));
    }
  }
}

// out = cast((sum over the slices of work, in slice order) * scale)
template <typename TO>
__global__ void __launch_bounds__(kThreads)
reduce_slices_kernel(const float* __restrict__ work,
                     const float* __restrict__ scale, TO* __restrict__ out,
                     int M, int N, int slices) {
  const size_t mn = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * kThreads) {
    float acc = 0.f;
    for (int z = 0; z < slices; ++z) acc += work[z * mn + i];
    store(out + i, acc * __ldg(scale + i % N));
  }
}

template <typename TX, typename TO>
int launch(const void* x, const int8_t* w, const float* scale, void* out,
           float* work, int slices, int M, int N, int K, cudaStream_t st) {
  // K slices of whole chunks
  int k_slice = (K + slices - 1) / slices;
  k_slice = (k_slice + kChunk - 1) / kChunk * kChunk;
  slices = (K + k_slice - 1) / k_slice;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, slices);
  dequant_matmul_kernel<TX, TO><<<grid, kThreads, 0, st>>>(
      static_cast<const TX*>(x), w, scale, static_cast<TO*>(out),
      slices > 1 ? work : nullptr, M, N, K, k_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + kThreads - 1) / kThreads < 1024
                               ? (mn + kThreads - 1) / kThreads : 1024);
  reduce_slices_kernel<TO><<<blocks, kThreads, 0, st>>>(
      work, scale, static_cast<TO*>(out), M, N, slices);
  return cudaGetLastError();
}

}  // namespace
}  // namespace paddle_dequant

// The C interface the port's ctypes wrapper calls
// (paddle_tpu_torch/ops/pallas_kernels.py dequant_matmul).  Pointers are
// device pointers to contiguous tensors the wrapper has checked; x_bf16 /
// out_bf16 select bf16 over fp32; `work` holds `slices` fp32 [M, N]
// partial sums when slices > 1 (the wrapper allocates it).  Returns a
// cudaError_t (0 on launched kernels).
extern "C" int paddle_dequant_matmul(const void* x, int x_bf16,
                                     const int8_t* w, const float* scale,
                                     void* out, int out_bf16, int M, int N,
                                     int K, int slices, float* work,
                                     cudaStream_t st) {
  using namespace paddle_dequant;
  if (M <= 0 || N <= 0 || K <= 0 || slices < 1 || slices > 65535 ||
      (M + kTile - 1) / kTile > 65535 || (slices > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  if (x_bf16)
    return out_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, out, work,
                                                      slices, M, N, K, st)
               : launch<__nv_bfloat16, float>(x, w, scale, out, work, slices,
                                              M, N, K, st);
  return out_bf16 ? launch<float, __nv_bfloat16>(x, w, scale, out, work,
                                                 slices, M, N, K, st)
                  : launch<float, float>(x, w, scale, out, work, slices, M,
                                         N, K, st);
}
