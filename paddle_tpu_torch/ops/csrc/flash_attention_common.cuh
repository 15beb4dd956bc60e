// Shared by the flash-attention forward (flash_attention_fwd.cu) and
// backward (flash_attention_bwd.cu) kernels: the argument structs the
// Python wrappers fill through ctypes, the tile geometry, and the launcher
// every C entry goes through.
//
// Layout.  q, k, v, o and their gradients are [B, S, H, D] views with the
// D axis contiguous and any strides (in elements) over B, S and H, so the
// kernels read the q/k/v column slices of a fused qkv projection in place.
// The row statistics lse and di are [B * H, S] contiguous, fp32.
//
// Element types.  The fp32 entries run 3xTF32 tensor-core kernels on fp32
// operands (their tile helpers: flash_attention_f32.cuh); the bf16 entries
// run the tensor-core kernels of flash_attention_tc.cuh on bf16 operands.
// lse and di are fp32 in both.
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
// q and kv tiles are 64 rows up to D = 128
constexpr int kTile = 64;
// The tile geometry of head dim D.  Up to D = 128 a block's 4 warps own 16
// rows each of a kTile-row tile, every column of D.  At D = 256 the tile
// is 32 rows (a 64-row fp32 tile set, 6 x 64 x 260 x 4 B = 399 KB, is
// past the 227 KB of an SM's shared memory) and warps 2r and 2r + 1 own
// rows 16r .. 16r + 15, columns [0, D / 2) and [D / 2, D) of each
// accumulator: a warp holds 16 x 128 of o, dq, dk and dv, as at D = 128.
// Both warps of a pair form the same s (and dp) over all of D.
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D > 128 ? 32 : kTile;
}
template <int D>
__host__ __device__ constexpr int col_splits() {
  return kTile / tile_rows<D>();
}
// an fp32 tile row is D + 4 floats: keeps 16-byte alignment and puts the
// fragment loads of a warp in distinct banks (flash_attention_f32.cuh)
constexpr int kPad = 4;

// Launch `kernel` on the (b*h, `rows`-row tile) grid with `threads`
// threads and `smem` bytes of dynamic shared memory, after refusing the
// shapes no flash kernel takes (empty, or a grid past CUDA's limits);
// returns the launch's error.
template <typename Args>
cudaError_t launch_tiles(void (*kernel)(const Args), int threads, int smem,
                         const Args& a, cudaStream_t st, int rows = kTile) {
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 ||
      (long long)a.B * a.H > 0x7fffffffLL ||
      (a.S + rows - 1) / rows > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + rows - 1) / rows);
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace paddle_flash
