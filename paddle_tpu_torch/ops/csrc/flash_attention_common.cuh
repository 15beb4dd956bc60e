// Shared by the flash-attention forward (flash_attention_fwd.cu) and
// backward (flash_attention_bwd.cu) kernels: the argument structs the
// Python wrappers fill through ctypes, the tile geometry, and the tile
// loader.
//
// Layout.  q, k, v, o and their gradients are [B, S, H, D] views with the
// D axis contiguous and any strides (in elements) over B, S and H, so the
// kernels read the q/k/v column slices of a fused qkv projection in place.
// The row statistics lse and di are [B * H, S] contiguous.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// one [B, S, H, D] operand: base pointer and element strides of B, S, H
struct PaddleT4 {
  float* ptr;
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

// Stage rows row0 .. row0 + 63 of head (b, h) of `t` into `dst` (rows of
// D + kPad floats), 16-byte loads along D; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const PaddleT4& t,
                                          int b, int h, int row0, int S) {
  constexpr int V4 = D / 4;
  const float* base = t.ptr + (long long)b * t.sb + (long long)h * t.sh;
  for (int idx = threadIdx.x; idx < kTile * V4; idx += kThreads) {
    const int r = idx / V4;
    const int c4 = idx - r * V4;
    const int s = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) val = ld4(base + (long long)s * t.ss + c4 * 4);
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + c4 * 4) = val;
  }
}

// Stage 64 entries of a [B * H, S] row statistic; zero past S.
__device__ __forceinline__ void load_rowstat(float* dst, const float* src,
                                             int bh, int row0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int s = row0 + r;
    dst[r] = s < S ? src[(long long)bh * S + s] : 0.f;
  }
}

// Store a thread's 4 x (D / 16) accumulator block (rows ty*4 + i, columns
// g*64 + tx*4 .. +3), each row divided by div[i], as tile rows row0.. of
// head (b, h) of `t`, skipping rows at or past S.
template <int D>
__device__ __forceinline__ void store_rows(const PaddleT4& t, int b, int h,
                                           int row0, int S, int ty, int tx,
                                           const float (&acc)[4][D / 16],
                                           const float (&div)[4]) {
  float* base = t.ptr + (long long)b * t.sb + (long long)h * t.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = row0 + ty * 4 + i;
    if (s >= S) continue;
    float* row = base + (long long)s * t.ss;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      *reinterpret_cast<float4*>(row + g * 64 + tx * 4) = make_float4(
          acc[i][g * 4 + 0] / div[i], acc[i][g * 4 + 1] / div[i],
          acc[i][g * 4 + 2] / div[i], acc[i][g * 4 + 3] / div[i]);
    }
  }
}

}  // namespace paddle_flash
