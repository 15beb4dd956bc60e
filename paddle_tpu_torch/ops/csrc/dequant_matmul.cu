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
// Design, fp32 x: a plain tiled GEMM on the SIMT units (TF32 or bf16
// tensor cores would round x, and the plain version is an exact fp32
// contraction).  One thread block per 64 x 64 output tile and K slice,
// 256 threads each owning a 4 x 4 register tile; K advances in chunks of
// 16, with the x chunk [64 x 16] and the int8 w chunk [16 x 64] converted
// to fp32 as they are staged in shared memory (w is read as int8 from
// device memory: a quarter of the fp32 weight bytes), the next chunk
// fetched into registers while the current one is multiplied.
//
// Design, bf16 x (the quantized lane's path: its activations are bf16):
// warp-level mma.sync.m16n8k16 tiles (bf16 in, fp32 accumulators; an
// int8 value is exact in bf16, so the products are exact as in the plain
// version).  One block of 4 warps per 64 x 64 output tile and K slice,
// each warp a 32 x 32 tile; K advances in chunks of 64: the x tile (bf16)
// and the int8 w tile are copied into shared memory by cp.async (16
// bytes where the rows' alignment allows, else 8 or 4; narrower rows are
// gathered into 4-byte words by plain loads) into double buffers, so the
// next chunk loads while this one is multiplied; the w tile is converted
// to bf16 in shared memory, k-major, and read by ldmatrix.trans as the B
// operand.
//
// Both: where the output has too few tiles to fill the card (the path's
// 64 x 1000 output is 16 tiles), K is split over up to 16 blocks per tile:
// each writes its fp32 partial sums to a workspace and a second kernel
// adds the slices in a fixed order, then applies the scale and the output
// cast; with one slice the first kernel does that itself.
//
// What bounds it: at the path's shape (M = 64 bucketed images, K = 2048,
// N = 1000) the work is 262 MFLOP on 2.6 MB, ~100 flops per byte; with
// the bf16 tensor-core rate as the card's peak for bf16 x int8 products
// the least time is the byte time, 0.8 us, which launch and latency
// dominate.  No atomics: the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace paddle_dequant {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kChunk = 16;
constexpr int kLdt = kTile + 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
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

// ---- bf16 x: tensor cores ----

constexpr int kTcThreads = 128;  // 4 warps, 2 along M x 2 along N
constexpr int kTcKC = 64;        // K per chunk
constexpr int kTcLd = kTcKC + paddle_tc::kSkew;    // x tile row [m][k]
constexpr int kTcLdw = kTile + paddle_tc::kSkew;   // bf16 w tile row [k][n]

// Copies `bytes` (16, 8 or 4) from src to dst asynchronously, zeros
// where !valid
__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           bool valid, int bytes) {
  using namespace paddle_tc;
  if (bytes == 16)
    cp_async16(dst, src, valid);
  else if (bytes == 8)
    cp_async8(dst, src, valid);
  else
    cp_async4(dst, src, valid);
}

// The K slice [k_lo, k_hi) of one 64 x 64 tile on the tensor cores;
// `work` as dequant_matmul_kernel's.  xb / wb: the copy width in bytes of
// x and w rows (each divides the row's bytes and its base's alignment;
// below 4, the rows are gathered by plain loads).
template <typename TO>
__global__ void __launch_bounds__(kTcThreads)
dequant_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ scale,
                         TO* __restrict__ out, float* __restrict__ work,
                         int M, int N, int K, int k_slice, int xb, int wb) {
  using namespace paddle_tc;
  __shared__ __align__(16) bf16 Xs[2][kTile * kTcLd];       // [m][k]
  __shared__ __align__(16) int8_t Wr[2][kTcKC * kTile];     // [k][n] int8
  __shared__ __align__(16) bf16 Wb[kTcKC * kTcLdw];         // [k][n] bf16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int k_lo = blockIdx.z * k_slice;
  const int k_hi = min(K, k_lo + k_slice);
  const int nc = (k_hi - k_lo + kTcKC - 1) / kTcKC;
  // Rows whose bytes allow 4-byte pieces go by cp.async; narrower rows
  // (odd K for x, N not a multiple of 4 for w) are gathered into 4-byte
  // words by plain loads, all issued before the words are stored.
  auto fill = [&](int c, int buf) {
    const int k0 = k_lo + c * kTcKC;
    if (xb >= 4) {
      const int xe = xb / 2;                 // elements per x piece
      const int xper = kTcKC / xe;           // pieces per x row
      for (int i = tid; i < kTile * xper; i += kTcThreads) {
        const int r = i / xper, kk = (i - r * xper) * xe;
        const int m = m0 + r, k = k0 + kk;
        const bool v = m < M && k < k_hi;
        copy_piece(&Xs[buf][r * kTcLd + kk],
                   v ? x + (size_t)m * K + k : x, v, xb);
      }
    } else {
      constexpr int kWords = kTile * kTcKC / 2 / kTcThreads;
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
      uint32_t v[kWords];
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int i = tid + j * kTcThreads;
        const int m = m0 + (i >> 5), k = k0 + 2 * (i & 31);
        const unsigned short* src = xs + (size_t)m * K + k;
        const uint32_t lo = (m < M && k < k_hi) ? __ldg(src) : 0u;
        const uint32_t hi = (m < M && k + 1 < k_hi) ? __ldg(src + 1) : 0u;
        v[j] = lo | hi << 16;
      }
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int i = tid + j * kTcThreads;
        *reinterpret_cast<uint32_t*>(
            &Xs[buf][(i >> 5) * kTcLd + 2 * (i & 31)]) = v[j];
      }
    }
    if (wb >= 4) {
      const int wper = kTile / wb;           // pieces per w row
      for (int i = tid; i < kTcKC * wper; i += kTcThreads) {
        const int r = i / wper, nn = (i - r * wper) * wb;
        const int k = k0 + r, n = n0 + nn;
        const bool v = k < k_hi && n < N;
        copy_piece(&Wr[buf][r * kTile + nn], v ? w + (size_t)k * N + n : w,
                   v, wb);
      }
    } else {
      constexpr int kWords = kTcKC * kTile / 4 / kTcThreads;
      const unsigned char* ws = reinterpret_cast<const unsigned char*>(w);
      uint32_t v[kWords];
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int i = tid + j * kTcThreads;
        const int k = k0 + (i >> 4), n = n0 + 4 * (i & 15);
        const unsigned char* src = ws + (size_t)k * N + n;
        uint32_t u = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k < k_hi && n + b < N) u |= (uint32_t)__ldg(src + b) << (8 * b);
        v[j] = u;
      }
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const int i = tid + j * kTcThreads;
        *reinterpret_cast<uint32_t*>(
            &Wr[buf][(i >> 4) * kTile + 4 * (i & 15)]) = v[j];
      }
    }
    cp_async_commit();
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  fill(0, 0);
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    if (c + 1 < nc) {
      fill(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {  // int8 -> bf16, exact: 32 weights a thread, row tid / 2
      const int r = tid >> 1, h = (tid & 1) * 32;
      const uint4* src =
          reinterpret_cast<const uint4*>(&Wr[buf][r * kTile + h]);
      uint4* dst = reinterpret_cast<uint4*>(&Wb[r * kTcLdw + h]);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const uint4 q = src[v];
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t u = words[j];
          o[2 * j] = pack_bf16((float)(int8_t)(u & 0xff),
                               (float)(int8_t)((u >> 8) & 0xff));
          o[2 * j + 1] = pack_bf16((float)(int8_t)((u >> 16) & 0xff),
                                   (float)(int8_t)(u >> 24));
        }
        dst[2 * v] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[2 * v + 1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTcKC / 16; ++ks) {
      if (k_lo + c * kTcKC + 16 * ks >= k_hi) break;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm4(a[mi], smem_u32(&Xs[buf][(wm * 32 + 16 * mi + (lane & 15)) *
                                           kTcLd +
                                       16 * ks + 8 * (lane >> 4)]));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // k rows 16 ks .., n columns 32 wn + 16 np ..: two n-tiles
        uint32_t b[4];
        ldsm4_t(b, smem_u32(&Wb[(16 * ks + (lane & 15)) * kTcLdw +
                                32 * wn + 16 * np + 8 * (lane >> 4)]));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][2 * np], a[mi], b[0], b[1]);
          mma(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  float* part = work ? work + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm * 32 + 16 * mi + g + 8 * (e >> 1);
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + 8 * ni + 2 * tq + (e & 1);
        if (n >= N) continue;
        if (part)
          part[(size_t)m * N + n] = acc[mi][ni][e];
        else
          store(out + (size_t)m * N + n, acc[mi][ni][e] * __ldg(scale + n));
      }
    }
}

// the widest copy (<= 16 bytes) that divides a row of `row_bytes` and the
// base address
inline int copy_bytes(const void* base, long long row_bytes) {
  int b = 16;
  while (b > 1 && (row_bytes % b || (uintptr_t)base % b)) b >>= 1;
  return b;
}

template <typename TX, typename TO>
int launch(const void* x, const int8_t* w, const float* scale, void* out,
           float* work, int slices, int M, int N, int K, cudaStream_t st) {
  // K slices of whole chunks
  constexpr bool tc = std::is_same<TX, __nv_bfloat16>::value;
  constexpr int chunk = tc ? kTcKC : kChunk;
  int k_slice = (K + slices - 1) / slices;
  k_slice = (k_slice + chunk - 1) / chunk * chunk;
  slices = (K + k_slice - 1) / k_slice;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, slices);
  float* part = slices > 1 ? work : nullptr;
  if (tc)
    dequant_matmul_tc_kernel<TO><<<grid, kTcThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, scale,
        static_cast<TO*>(out), part, M, N, K, k_slice,
        copy_bytes(x, 2LL * K), copy_bytes(w, N));
  else
    dequant_matmul_kernel<float, TO><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), w, scale, static_cast<TO*>(out), part,
        M, N, K, k_slice);
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
