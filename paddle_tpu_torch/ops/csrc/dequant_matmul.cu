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
// Numerics, bf16 x: a bf16 activation and an int8 weight both convert to
// fp32 exactly, and their product (at most 8 + 7 significant bits) is
// exact in fp32, so the kernel matches the plain version (bf16-round,
// fp32 matmul, scale) up to the order of the fp32 sums.  bf16 output
// rounds to nearest even, as torch's `.to(torch.bfloat16)`.
//
// Numerics, fp32 x: every int8 value (|w| <= 128) is exact in TF32's
// 10-bit mantissa, so w's fp32 bit pattern is already a TF32 operand and
// only x needs splitting to keep fp32 accuracy on the TF32 tensor cores:
// x = big + small, big = x rounded to nearest TF32 and small the exact
// remainder (`split_tf32` of tc_common.cuh; the tensor core reads small's
// top 19 bits, an error <= 2^-21 |x|).  A block splits x with the
// three-instruction split first and, when its sums hold a NaN (an
// infinite or near-FLT_MAX x, or a NaN input), runs its K slice again
// with the clamped split, which keeps +-inf products +-inf.  Each k-step runs two products,
// small.w and then big.w; 3xTF32's third term, big.w_small, is exactly
// zero.  The tensor cores' fp32 sums do not round to nearest (their
// error grows with K), so the partial sums of each 64 k are promoted into
// an IEEE fp32 running sum, as in the fp32 fused bottleneck.
//
// Design, fp32 x: warp-level mma.sync.m16n8k8 tf32 tiles, fp32
// accumulators.  One block of 8 warps (4 along M x 2 along N, each warp
// 32 x 32) per 128 x 64 output tile and K slice, two blocks an SM; K
// advances in chunks of 64 through two shared-memory slots (the next
// chunk loads while one is multiplied; one barrier a chunk).
// The x tile and the int8 w tile are copied in raw by cp.async (x 16
// bytes a piece where K % 4 == 0 and the base allows it, else 8 or 4; w
// as for bf16 x).  The A fragments are read by ldmatrix (four 8 x 4
// fp32 matrices are the m16n8k8 tf32 A layout) and split in registers as
// they load; a lane's B weights of a k row are one word (its n-tiles'
// columns are adjacent), widened to fp32 exactly by a byte permute and a
// float add (no I2F); the next k-step's fragments load while one k-step
// multiplies.
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
// 64 x 1000 output is 16 tiles, of 64 x 64 or 128 x 64), K is split
// over up to 16 blocks per tile: each writes its fp32 partial sums to a
// workspace and a second kernel adds the slices in a fixed order, then
// applies the scale and the output cast; with one slice the first kernel
// does that itself.
//
// What bounds it: at the path's shape (M = 64 bucketed images, K = 2048,
// N = 1000) the work is 262 MFLOP on 2.6 MB, ~100 flops per byte; with
// the bf16 tensor-core rate as the card's peak for bf16 x int8 products
// the least time is the byte time, 0.8 us, which launch and latency
// dominate.  With fp32 x at a transformer fc shape (M 4096, K 512, N
// 2048: 8.6 GFLOP on 12.6 MB) the operations bound it: 52 us at the
// fp32-accurate 3xTF32 rate (495 / 3 TFLOP/s), 35 us at the two-product
// rate this kernel can reach (495 / 2).  No atomics: the result is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace paddle_dequant {
namespace {

constexpr int kThreads = 256;  // the fp32-x kernel and the slice reduce
constexpr int kTile = 64;      // the bf16-x kernel's output tile edge

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// four adjacent outputs at p (aligned to their size)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(paddle_tc::pack_bf16(v[0], v[1]),
                 paddle_tc::pack_bf16(v[2], v[3]));
}

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

// Stages the int8 w tile [KC][BN] (rows k0 .., zero from k_hi; columns
// n0 .., zero from N) into Wr, row stride LD bytes, with kNThreads
// threads: rows whose bytes allow 4-byte pieces (wb >= 4) go by
// cp.async; narrower rows (N not a multiple of 4) are gathered into
// 4-byte words by plain loads, all issued before the words are stored.
// Commits no cp.async group.
template <int KC, int BN, int LD, int kNThreads>
__device__ __forceinline__ void stage_w(int8_t* Wr, const int8_t* w, int k0,
                                        int k_hi, int n0, int N, int wb,
                                        int tid) {
  if (wb >= 4) {
    const int wper = BN / wb;  // pieces per w row
    for (int i = tid; i < KC * wper; i += kNThreads) {
      const int r = i / wper, nn = (i - r * wper) * wb;
      const int k = k0 + r, n = n0 + nn;
      const bool v = k < k_hi && n < N;
      copy_piece(&Wr[r * LD + nn], v ? w + (size_t)k * N + n : w, v, wb);
    }
  } else {
    constexpr int kWords = KC * BN / 4 / kNThreads;
    constexpr int kRowWords = BN / 4;
    const unsigned char* ws = reinterpret_cast<const unsigned char*>(w);
    uint32_t v[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int i = tid + j * kNThreads;
      const int k = k0 + i / kRowWords, n = n0 + 4 * (i % kRowWords);
      const unsigned char* src = ws + (size_t)k * N + n;
      uint32_t u = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k < k_hi && n + b < N) u |= (uint32_t)__ldg(src + b) << (8 * b);
      v[j] = u;
    }
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int i = tid + j * kNThreads;
      *reinterpret_cast<uint32_t*>(
          &Wr[(i / kRowWords) * LD + 4 * (i % kRowWords)]) = v[j];
    }
  }
}

// ---- fp32 x: TF32 tensor cores, two products ----

constexpr int kF32M = 128, kF32N = 64;  // output tile
constexpr int kF32KC = 64;              // K per chunk
constexpr int kF32Ring = 2;             // staged chunks: one in flight
constexpr int kF32Ldx = kF32KC + 4;     // floats per staged x row [m][k]
// bytes per staged int8 w row [k][n]: 96 (24 words) puts the four rows
// t of a warp's B reads in distinct 8-bank ranges and keeps 16-byte
// pieces aligned
constexpr int kF32Ldw = kF32N + 32;
constexpr int kF32XFloats = kF32M * kF32Ldx;
constexpr int kF32WBytes = kF32KC * kF32Ldw;
constexpr int kF32Smem = kF32Ring * (kF32XFloats * 4 + kF32WBytes);

// byte i of a word of four int8 weights, flipped (u = word ^
// 0x80808080), as fp32 bits, exactly: the float 2^23 + (w + 128) less
// 2^23 + 128 (no I2F, whose rate is a quarter)
__device__ __forceinline__ uint32_t i8_bits(uint32_t u, int i) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 | i)) - 8388736.f);
}

// The K slice [k_lo, k_hi) of one 128 x 64 tile: 8 warps, 4 along M x 2
// along N, each 32 x 32.  Column slot g of the warp's n-tile ni is output
// column 4 g + ni of its 32, so that a lane's four B weights of a k row
// are one word.  `part` null: out = cast(acc * scale); else
// part[m * N + n] = acc (fp32).  xb / wb: the copy width in bytes of x
// pieces (16, 8 or 4) and w rows (each divides the row's bytes and its
// base's alignment; below 4, w rows are gathered by plain loads).
template <typename TO>
__global__ void __launch_bounds__(kThreads, 2)
dequant_matmul_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale, TO* __restrict__ out,
                      float* __restrict__ work, int M, int N, int K,
                      int k_slice, int xb, int wb) {
  using namespace paddle_tc;
  extern __shared__ __align__(16) float smem[];
  float* Xr = smem;  // [ring][M][Ldx] raw x
  int8_t* Wr = reinterpret_cast<int8_t*>(smem + kF32Ring * kF32XFloats);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * kF32M, n0 = blockIdx.x * kF32N;
  const int k_lo = blockIdx.z * k_slice;
  const int k_hi = min(K, k_lo + k_slice);
  const int nc = (k_hi - k_lo + kF32KC - 1) / kF32KC;
  // this thread's x pieces (xb bytes each) in a chunk: rows xr0 + j
  // xstep (j < xn) at column xk
  const int xlog = xb == 16 ? 4 : xb == 8 ? 5 : 6;  // log2(pieces a row)
  const int xr0 = tid >> xlog, xk = (tid & ((1 << xlog) - 1)) * (xb / 4);
  const int xstep = kThreads >> xlog, xn = (kF32M << xlog) / kThreads;
  // stage chunk c (< nc) into slot c % kRing and commit it
  auto fill = [&](int c) {
    const int k0 = k_lo + c * kF32KC, buf = c % kF32Ring, k = k0 + xk;
    float* xd = Xr + buf * kF32XFloats + xr0 * kF32Ldx + xk;
    for (int j = 0; j < xn; ++j) {
      const int m = m0 + xr0 + j * xstep;
      const bool v = m < M && k < k_hi;
      copy_piece(xd + j * xstep * kF32Ldx, v ? x + (size_t)m * K + k : x, v,
                 xb);
    }
    stage_w<kF32KC, kF32N, kF32Ldw, kThreads>(Wr + buf * kF32WBytes, w, k0,
                                              k_hi, n0, N, wb, tid);
    cp_async_commit();
  };
  // acc: the IEEE fp32 running sum; part: the chunk's tensor-core sums
  float acc[2][4][4], part[2][4][4];
  // the K slice with x split unclamped (kClamp false) or clamped
  // (tc_common.cuh); returns with no copy in flight
  auto run = [&](auto clamp) {
    constexpr bool kClamp = decltype(clamp)::value;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = part[i][j][e] = 0.f;
    fill(0);
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<0>();  // chunk c has landed ...
      // ... for every thread, and every thread is done with chunk c - 1,
      // whose ring slot chunk c + 1 refills
      __syncthreads();
      if (c + 1 < nc) fill(c + 1);
      const float* xs = Xr + (c % kF32Ring) * kF32XFloats;
      const unsigned char* ws = reinterpret_cast<const unsigned char*>(
          Wr + (c % kF32Ring) * kF32WBytes);
      // the fragments of k-step ks: A raw by ldmatrix (four 8 x 4 fp32
      // matrices, rows g / g + 8 and k t / t + 4: the m16n8k8 tf32 layout),
      // B as the words of int8 weights at rows k t and k t + 4, columns 4 g
      // .. 4 g + 3 (one per n-tile), flipped for i8_bits
      auto load_frags = [&](int ks, uint32_t (&ar)[2][4], uint32_t (&br)[2]) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm4(ar[mi], smem_u32(xs + (32 * wm + 16 * mi + (lane & 7) +
                                       8 * ((lane >> 3) & 1)) * kF32Ldx +
                                 8 * ks + 4 * (lane >> 4)));
        const unsigned char* p = ws + (8 * ks + tq) * kF32Ldw + 32 * wn + 4 * g;
        br[0] = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
        br[1] = *reinterpret_cast<const uint32_t*>(p + 4 * kF32Ldw) ^ 0x80808080u;
      };
      // every k-step of the chunk runs: past k_hi both tiles hold zeros.
      // The next k-step's fragments load while this one multiplies.
      uint32_t ar[2][2][4], br[2][2];
      load_frags(0, ar[0], br[0]);
#pragma unroll
      for (int ks = 0; ks < kF32KC / 8; ++ks) {
        const int cur = ks & 1;
        if (ks + 1 < kF32KC / 8) load_frags(ks + 1, ar[cur ^ 1], br[cur ^ 1]);
        SplitA a[2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          split_a<kClamp>(a[mi], __uint_as_float(ar[cur][mi][0]),
                  __uint_as_float(ar[cur][mi][1]),
                  __uint_as_float(ar[cur][mi][2]),
                  __uint_as_float(ar[cur][mi][3]));
        // int8 as fp32: already a TF32 operand
        uint32_t b[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          b[ni][0] = i8_bits(br[cur][0], ni);
          b[ni][1] = i8_bits(br[cur][1], ni);
        }
        // small.w over every accumulator, then big.w
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(part[mi][ni], a[mi].small, b[ni][0], b[ni][1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_tf32(part[mi][ni], a[mi].big, b[ni][0], b[ni][1]);
      }
      // promote the chunk's sums (64 k) into the IEEE fp32 running sum
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] += part[i][j][e];
            part[i][j][e] = 0.f;
          }
    }
  };
  // unclamped first; a block whose sums hold a NaN (an infinite or
  // near-FLT_MAX x, or a NaN input) runs again clamped
  run(std::false_type{});
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) nan |= acc[i][j][e] != acc[i][j][e];
  if (__syncthreads_or(nan)) run(std::true_type{});
  // a lane holds, per row, the 8 adjacent columns 8 t .. 8 t + 7 of the
  // warp's 32: accumulator element h of n-tile ni is column 8 t + 4 h +
  // ni; each group of 4 goes out as one vector where the row allows
  float* part_out = work ? work + (size_t)blockIdx.z * M * N : nullptr;
  const bool vec = N % 4 == 0 &&
                   ((uintptr_t)out | (uintptr_t)work) % (4 * sizeof(TO)) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 32 * wm + 16 * mi + g + 8 * hh;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + 32 * wn + 8 * tq + 4 * h;
        float v[4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) v[ni] = acc[mi][ni][2 * hh + h];
        if (part_out) {
          float* dst = part_out + (size_t)m * N + n;
          if (vec && n + 3 < N) {
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (n + i < N) dst[i] = v[i];
          }
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n + i < N) v[i] *= __ldg(scale + n + i);
        TO* dst = out + (size_t)m * N + n;
        if (vec && n + 3 < N) {
          store4(dst, v);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (n + i < N) store(dst + i, v[i]);
        }
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
    stage_w<kTcKC, kTile, kTile, kTcThreads>(Wr[buf], w, k0, k_hi, n0, N,
                                             wb, tid);
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
  constexpr int chunk = tc ? kTcKC : kF32KC;
  int k_slice = (K + slices - 1) / slices;
  k_slice = (k_slice + chunk - 1) / chunk * chunk;
  slices = (K + k_slice - 1) / k_slice;
  float* part = slices > 1 ? work : nullptr;
  if (tc) {
    const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile,
                    slices);
    dequant_matmul_tc_kernel<TO><<<grid, kTcThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, scale,
        static_cast<TO*>(out), part, M, N, K, k_slice,
        copy_bytes(x, 2LL * K), copy_bytes(w, N));
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_matmul_kernel<TO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + kF32N - 1) / kF32N, (M + kF32M - 1) / kF32M,
                    slices);
    dequant_matmul_kernel<TO><<<grid, kThreads, kF32Smem, st>>>(
        static_cast<const float*>(x), w, scale, static_cast<TO*>(out), part,
        M, N, K, k_slice, copy_bytes(x, 4LL * K), copy_bytes(w, N));
  }
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
      (M + kTile - 1) / kTile > 65535 || (slices > 1 && work == nullptr) ||
      (!x_bf16 && (uintptr_t)x % 4))
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
