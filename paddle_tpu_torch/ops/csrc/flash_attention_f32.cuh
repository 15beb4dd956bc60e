// The fp32 flash-attention kernels' tile helpers on the TF32 tensor cores
// at fp32 accuracy (3xTF32, tc_common.cuh), shared by the forward
// (flash_attention_fwd.cu) and the backward (flash_attention_bwd.cu):
// fp32 tiles of tile_rows<D>() rows (64, or 32 at D = 256) staged with cp.async as rows of D + 4 floats (the
// A and B fragment loads — row g, column t; or row 2t, column g — then
// fall in 32 distinct banks), a stationary tile split in place into big
// and small tiles, split fragments of a split or a raw tile, an
// accumulator as the A operand of the next product (a fixed permutation
// of the k order), the block-wide NaN check that sends a block from the
// unclamped split to the clamped one (tc_common.cuh), and the row store
// of a warp's accumulator.  Stationary tiles split once, clamped;
// streamed fragments take the kernel's kClamp.
#pragma once

#include "flash_attention_common.cuh"
#include "tc_common.cuh"

namespace paddle_flash {

using namespace paddle_tc;

constexpr int kF32Threads = 128;  // 4 warps, as the bf16 kernels

template <int D>
__host__ __device__ constexpr int f32_tile() {
  return tile_rows<D>() * (D + kPad);
}

// Stage rows row0 .. row0 + tile_rows<D>() - 1 of head (b, h) of fp32 `t` into `dst` (rows
// of D + kPad floats) with 16-byte cp.async; rows at or past S are zero.
// The caller commits the group.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const PaddleT4& t,
                                          int b, int h, int row0, int S) {
  constexpr int NV = D / 4;
  constexpr int RT = tile_rows<D>();
  const float* base = static_cast<const float*>(t.ptr) + (long long)b * t.sb +
                      (long long)h * t.sh;
  static_assert(RT * NV % kF32Threads == 0, "whole passes over the tile");
#pragma unroll
  for (int it = 0; it < RT * NV / kF32Threads; ++it) {
    const int idx = threadIdx.x + it * kF32Threads;
    const int r = idx / NV;
    const int c = idx - r * NV;
    const int s = row0 + r;
    const bool valid = s < S;
    cp_async16(dst + r * (D + kPad) + c * 4,
               valid ? base + (long long)s * t.ss + c * 4 : base, valid);
  }
}

// Split a staged tile in place: `big` keeps the TF32 big parts, `small`
// receives the small parts.
template <int D>
__device__ __forceinline__ void split_tile(float* big, float* small) {
  for (int i = threadIdx.x; i < f32_tile<D>(); i += kF32Threads) {
    uint32_t hi, lo;
    split_tf32(big[i], hi, lo);
    big[i] = __uint_as_float(hi);
    small[i] = __uint_as_float(lo);
  }
}

// The split A operand of rows r0 .. r0+15, columns c0 .. c0+7 of a split
// row-major tile
template <int D>
__device__ __forceinline__ void load_a_split(SplitA& f, const float* big,
                                             const float* small, int r0,
                                             int c0) {
  const int lane = threadIdx.x & 31;
  const int i0 = (r0 + (lane >> 2)) * (D + kPad) + c0 + (lane & 3);
  const int i1 = i0 + 8 * (D + kPad);
  const int idx[4] = {i0, i1, i0 + 4, i1 + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f.big[e] = __float_as_uint(big[idx[e]]);
    f.small[e] = __float_as_uint(small[idx[e]]);
  }
}

// The B operand of n rows n0 .. n0+7 of a raw n-major tile (a row holds k
// contiguous), k columns k0 .. k0+7, split
template <int D, bool kClamp>
__device__ __forceinline__ void load_b_nk_split(SplitB& f, const float* tile,
                                                int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (n0 + (lane >> 2)) * (D + kPad) + k0 + (lane & 3);
  split_b<kClamp>(f, p[0], p[4]);
}

// The B operand of k rows k0 .. k0+7 of a raw k-major tile (a row holds n
// contiguous), n columns n0 .. n0+7, in the permuted k order of
// acc_to_a_split (k rows 2t and 2t + 1), split
template <int D, bool kClamp>
__device__ __forceinline__ void load_b_kn_split(SplitB& f, const float* tile,
                                                int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const float* p =
      tile + (k0 + 2 * (lane & 3)) * (D + kPad) + n0 + (lane >> 2);
  split_b<kClamp>(f, p[0], p[D + kPad]);
}

// An accumulator n-tile (rows g, g + 8; columns 2t, 2t + 1) as the split A
// operand of its 8 columns, in the permuted k order
template <bool kClamp>
__device__ __forceinline__ void acc_to_a_split(SplitA& f, const float (&c)[4]) {
  split_a<kClamp>(f, c[0], c[2], c[1], c[3]);
}

// Whether any of this thread's accumulators is NaN (the unclamped split's
// mark, tc_common.cuh); kernels OR it over the block with
// __syncthreads_or
template <int N>
__device__ __forceinline__ bool any_nan(const float (&c)[N][4]) {
  bool nan = false;
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) nan |= c[n][e] != c[n][e];
  return nan;
}

// Store a warp's 16 x W fp32 accumulator (rows row0 + g and row0 + g + 8
// of head (b, h) of `t`, n-tile n at columns col0 + 8n + 2t); rows at or
// past S are skipped.
template <int W>
__device__ __forceinline__ void store_acc_f32(const PaddleT4& t, int b, int h,
                                              int row0, int S, int col0,
                                              const float (&acc)[W / 8][4]) {
  const int lane = threadIdx.x & 31;
  float* base = static_cast<float*>(t.ptr) + (long long)b * t.sb +
                (long long)h * t.sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row0 + (lane >> 2) + 8 * half;
    if (s >= S) continue;
    float2* row =
        reinterpret_cast<float2*>(base + (long long)s * t.ss + col0);
#pragma unroll
    for (int n = 0; n < W / 8; ++n)
      row[4 * n + (lane & 3)] =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}


}  // namespace paddle_flash
