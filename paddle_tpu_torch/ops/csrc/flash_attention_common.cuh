// Shared by the flash-attention forward (flash_attention_fwd.cu) and
// backward (flash_attention_bwd.cu) kernels: the argument structs the
// Python wrappers fill through ctypes, the tile geometry, the fp32 tile
// loader and row store, and the launcher every C entry goes through.
//
// Layout.  q, k, v, o and their gradients are [B, S, H, D] views with the
// D axis contiguous and any strides (in elements) over B, S and H, so the
// kernels read the q/k/v column slices of a fused qkv projection in place.
// The row statistics lse and di are [B * H, S] contiguous, fp32.
//
// Element types.  The fp32 entries run the forward's SIMT kernel (with the
// tile loader and the row store below) and the backward's 3xTF32
// tensor-core kernels (flash_attention_bwd.cu) on fp32 operands; the bf16
// entries run the tensor-core kernels of flash_attention_tc.cuh on bf16
// operands.  lse and di are fp32 in both.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// one [B, S, H, D] operand: base pointer (to fp32 or bf16 elements) and
// element strides of B, S, H
struct PaddleT4 {
  void* ptr;
  long long sb, ss, sh;
};

struct PaddleFlashFwdArgs {
  PaddleT4 q, k, v, o;
  float* lse;  // [B * H, S] out
  int B, S, H, D;
  float scale;
  int causal;
};

struct PaddleFlashBwdArgs {
  PaddleT4 q, k, v, dout, dq, dk, dv;
  const float* lse;  // [B * H, S]
  const float* di;   // [B * H, S]: rowsum(dout * o) - dlse
  int B, S, H, D;
  float scale;
  int causal;
};

namespace paddle_flash {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the TPU kernels
constexpr float kTiny = 1e-20f;    // _TINY of the TPU kernels
// q and kv tiles are 64 rows; 256 threads as a 16 x 16 grid, thread
// (ty, tx) owning rows ty*4 .. ty*4+3 of a tile
constexpr int kTile = 64;
constexpr int kThreads = 256;
// a staged row is D + 4 floats: keeps float4 alignment and puts the
// rows tx, tx + 1, ... of a column read in distinct bank groups
constexpr int kPad = 4;
constexpr int kPRow = kTile + kPad;  // row of a staged 64 x 64 score tile

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// one 16-byte load: 4 fp32 elements
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 f = ld4(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Stage rows row0 .. row0 + 63 of head (b, h) of fp32 `t` into `dst`
// (rows of D + kPad floats), 16-byte loads along D; rows at or past S are
// zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const PaddleT4& t,
                                          int b, int h, int row0, int S) {
  constexpr int VEC = 4;  // elements per load
  constexpr int NV = D / VEC;
  const float* base = static_cast<const float*>(t.ptr) + (long long)b * t.sb +
                      (long long)h * t.sh;
  for (int idx = threadIdx.x; idx < kTile * NV; idx += kThreads) {
    const int r = idx / NV;
    const int c = idx - r * NV;
    const int s = row0 + r;
    float v[VEC];
    if (s < S) {
      load16(base + (long long)s * t.ss + c * VEC, v);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) v[u] = 0.f;
    }
    float* d = dst + r * (D + kPad) + c * VEC;
#pragma unroll
    for (int u = 0; u < VEC; u += 4)
      *reinterpret_cast<float4*>(d + u) =
          make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
  }
}

// Store a thread's 4 x (D / 16) accumulator block (rows ty*4 + i, columns
// g*64 + tx*4 .. +3), each row divided by div[i], as tile rows row0.. of
// head (b, h) of fp32 `t`, skipping rows at or past S.
template <int D>
__device__ __forceinline__ void store_rows(const PaddleT4& t, int b, int h,
                                           int row0, int S, int ty, int tx,
                                           const float (&acc)[4][D / 16],
                                           const float (&div)[4]) {
  float* base = static_cast<float*>(t.ptr) + (long long)b * t.sb +
                (long long)h * t.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = row0 + ty * 4 + i;
    if (s >= S) continue;
    float* row = base + (long long)s * t.ss;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      store4(row + g * 64 + tx * 4, acc[i][g * 4 + 0] / div[i],
             acc[i][g * 4 + 1] / div[i], acc[i][g * 4 + 2] / div[i],
             acc[i][g * 4 + 3] / div[i]);
    }
  }
}

// Launch `kernel` on the (b*h, 64-row tile) grid with `threads` threads
// and `smem` bytes of dynamic shared memory, after refusing the shapes no
// flash kernel takes (empty, or a grid past CUDA's limits); returns the
// launch's error.
template <typename Args>
cudaError_t launch_tiles(void (*kernel)(const Args), int threads, int smem,
                         const Args& a, cudaStream_t st) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 ||
      (long long)a.B * a.H > 0x7fffffffLL ||
      (a.S + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + kTile - 1) / kTile);
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace paddle_flash
