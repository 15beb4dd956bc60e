// Shared by the flash-attention forward (flash_attention_fwd.cu) and
// backward (flash_attention_bwd.cu) kernels: the argument structs the
// Python wrappers fill through ctypes, the tile geometry, and the tile
// loader.
//
// Layout.  q, k, v, o and their gradients are [B, S, H, D] views with the
// D axis contiguous and any strides (in elements) over B, S and H, so the
// kernels read the q/k/v column slices of a fused qkv projection in place.
// The row statistics lse and di are [B * H, S] contiguous, fp32.
//
// Element types.  Each kernel has an fp32 and a bf16 instantiation: the
// [B, S, H, D] operands are all of the entry's type T; every tile is
// converted to fp32 as it is staged in shared memory, products and sums
// are fp32, and outputs are rounded to T as they are stored.
#pragma once

#include <cuda_bf16.h>
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

// p rounded to T and back: the identity for fp32; for bf16 the TPU
// kernels' `.astype(bf16)` of p and ds before their products
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one 16-byte load: 4 fp32 or 8 bf16 elements, as fp32
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 f = ld4(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 4 consecutive elements from fp32 values, rounded to T
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage rows row0 .. row0 + 63 of head (b, h) of `t` into `dst` (rows of
// D + kPad floats), 16-byte loads along D; rows at or past S are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const PaddleT4& t,
                                          int b, int h, int row0, int S) {
  constexpr int VEC = 16 / (int)sizeof(T);  // elements per load
  constexpr int NV = D / VEC;
  const T* base = static_cast<const T*>(t.ptr) + (long long)b * t.sb +
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
// head (b, h) of `t` (rounded to T), skipping rows at or past S.
template <int D, typename T>
__device__ __forceinline__ void store_rows(const PaddleT4& t, int b, int h,
                                           int row0, int S, int ty, int tx,
                                           const float (&acc)[4][D / 16],
                                           const float (&div)[4]) {
  T* base = static_cast<T*>(t.ptr) + (long long)b * t.sb +
            (long long)h * t.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = row0 + ty * 4 + i;
    if (s >= S) continue;
    T* row = base + (long long)s * t.ss;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      store4(row + g * 64 + tx * 4, acc[i][g * 4 + 0] / div[i],
             acc[i][g * 4 + 1] / div[i], acc[i][g * 4 + 2] / div[i],
             acc[i][g * 4 + 3] / div[i]);
    }
  }
}

}  // namespace paddle_flash
