// Fused ResNet bottleneck for inference (BN folded), fp32 and bf16, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_bottleneck` of
// paddle_tpu/ops/pallas_kernels.py (`_bottleneck_kernel`, one pallas_call
// per block): the whole residual block in one launch, so the two
// intermediate activations never leave the chip.
//
//   x  [N, H, W, C] NHWC, f32 or bf16 (every operand and out alike)
//   w0 [F, C, 1, 1]  b0 [F]     1x1 reduce              + relu
//   w1 [F, F, 3, 3]  b1 [F]     3x3, stride s, pad 1    + relu
//   w2 [C4, F, 1, 1] b2 [C4]    1x1 expand
//   ws [C4, C, 1, 1] bs [C4]    1x1 / s projection shortcut (or identity:
//                                ws == nullptr, s == 1, C == C4)
//   -> out [N, Ho, Wo, C4] = relu(conv2 + b2 + shortcut),
//   Ho = (H - 1) / s + 1, Wo = (W - 1) / s + 1.
// The filters are read in the program's OIHW layout: no transposes per
// run.  Any H and W (odd sizes too), stride 1 or 2.
//
// This file holds the fp32 kernel and the C entries; the bf16 entry
// launches the kernel of fused_bottleneck_tc.cuh, which keeps the TPU
// kernel's bf16 rounding points and takes C, F and C4 multiples of 8.
// Both run on the tensor cores with one structure, and share the launch
// planning of fused_bottleneck_tc.cuh.
//
// Structure (fp32).  One block of 8 warps owns one image and R
// consecutive output rows o0 .. o0 + R - 1 (R picked per shape on the
// host).  It
//   1. computes conv0 + b0 + relu for the E = s (R - 1) + 3 input rows
//      s o0 - 1 .. s (o0 + R - 1) + 1 that the 3x3 taps read, into a
//      shared-memory window [E][W + 2][ldw]; rows outside the image are
//      exact zeros, as the 3x3's zero padding acts on conv0's OUTPUT (the
//      TPU kernel masks those rows the same way), and columns -1 and W
//      are zero columns, so no tap branches;
//   2. computes the 3x3 conv + b1 + relu from that window into a shared
//      row block h [R Wo][ldh];
//   3. accumulates conv2 (from h) and the projection shortcut (from x in
//      device memory, at (s o, s wo)) into one accumulator, adds the
//      biases (or the identity x row), applies relu and writes out.
// Each stage is a GEMM out[m][n] = sum_k A(m, k) B[n][k] in 128 x 64
// block tiles (8 warps of 32 x 32), or 64 x 64 (8 warps of 32 x 16) where
// a block's few rows would leave most of a 128-row tile empty, on
// mma.sync.m16n8k8 TF32 at fp32 accuracy (3xTF32, tc_common.cuh: every
// product is small.big + big.small + big.big, each pass run over all the
// warp's accumulators before the next, summed in fp32; there is no
// rounding point but fp32's):
//   * conv0 and the projection: A is x rows, staged by cp.async (16 bytes
//     where rows are 16-byte aligned, else 4) into a ring of three chunks
//     of 16 k, zero past the k edge; B the filter rows w0 [F][C] / ws
//     [C4][C], read two chunks ahead into registers and split into big and
//     small parts as they are stored to shared memory;
//   * the 3x3: one k-step of 8 is 8 channels of one tap, so the A
//     fragment (pixel g, channels t and t + 4) is read in place from the
//     window at the tap's offset, with no im2col; the stride only changes
//     each lane's pixel.  B is w1 in OIHW: per output channel a block of 8
//     channels is 72 contiguous values (channel-major, tap-minor), staged
//     as they lie (split), and the fragment for tap j reads elements 9t +
//     j and 9 (t + 4) + j;
//   * conv2: A is h read in place, B w2 [C4][F] as conv0's B.
// The window, h and the A tiles are split as their fragments load, with
// the three-instruction split, unclamped: a block that meets a NaN in an
// accumulator (an infinite or near-FLT_MAX operand, or a NaN input) runs
// again with the clamped split (tc_common.cuh), checked on the
// accumulators.  The relus keep a NaN (`relu`, tc_common.cuh), so a NaN
// input costs one rerun and still reaches out.  The filters are split once as staged, clamped.  The
// tensor cores' fp32 accumulation does not round to nearest, and its
// error grows with the number of products on one accumulator (to ~3e-4
// at |out| ~ 8 for a K = 9 x 512 loop); so each 64 k of a 1x1 (four
// chunks) and each 72 k of the 3x3 (one chunk) accumulate into a zeroed
// partial that is added to the block's sum in IEEE fp32.  Row strides keep
// every fragment load free of bank conflicts: 16 + 4 floats for the staged
// tiles, 72 + 4 for w1's chunk, F8 + 4 for h and a stride-1 window, F8 + 2
// for a stride-2 window (F8 = F rounded up to 8), whose 8 fragment rows
// lie 2 pixels apart.  Ragged widths: staged k past the edge is zero, the
// window's and h's pad channels are zero, and the n edge is masked at the
// store; any C, F and C4.
//
// What bounds it: per output pixel the block does C F + 9 F^2 + F C4 (+
// C C4) multiply-adds on one read of x and one write of out, hundreds of
// flops per byte, so the multiply rate bounds it: 67 TFLOP/s on the SIMT
// units, 495 / 3 = 165 TFLOP/s for fp32-accurate products on the TF32
// tensor cores.  Beyond the three products, its costs are conv0's halo
// recompute over (E - s R) rows, M tiles rounded up to whole tiles, the
// split's instructions (three per element loaded), one block an SM at
// most shapes (the fp32 window fills shared memory), mma.sync rather than
// wgmma, and filters re-read from L2 by every block.  The tile and R are
// chosen on the host as for bf16 (pick_rows): the least padded work per
// SM, weighed by whether two blocks fit and, for 64-row tiles, by their
// lower rate.
//
// Sums run in an order fixed by the shape: no atomics, so the result is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "fused_bottleneck_tc.cuh"

namespace paddle_bottleneck {
namespace {

using namespace paddle_tc;
using paddle_bottleneck_tc::kBN;
using paddle_bottleneck_tc::kThreads;

// The block's 8 warps: WM along M and 8 / WM along N, each warp 32 rows
// x 8 WM columns.  WM 4 gives 128-row tiles; WM 2 gives 64-row tiles,
// for shapes whose few rows a block would leave most of a 128-row tile
// empty.
template <int WM>
using Acc = float[2][WM][4];  // [m sub-tile][n sub-tile][fragment]

constexpr int kKC = 16;        // k per staged chunk of the 1x1 GEMMs
constexpr int kLdc = kKC + 4;  // staged row stride of the 1x1 GEMMs
constexpr int kRing = 3;       // staged A chunks of the 1x1 GEMMs
constexpr int kKC3 = 72;       // k per chunk of the 3x3: 8 channels x 9 taps
constexpr int kLd3 = kKC3 + 4;
// the staging area (floats) of a block of 32 WM-row tiles: the ring of A
// tiles and two split B tiles of the 1x1 GEMMs, or the 3x3's split B tile
__host__ __device__ constexpr int stage_floats(int wm) {
  return kRing * 32 * wm * kLdc + 2 * 2 * kBN * kLdc > 2 * kBN * kLd3
             ? kRing * 32 * wm * kLdc + 2 * 2 * kBN * kLdc
             : 2 * kBN * kLd3;
}

typedef paddle_bottleneck_tc::ArgsT<float> Args;

// Wp = W + 2 window columns; ldw, ldh floats per window or h row
struct Geom {
  int Ho, Wo, R, E, Wp, ldw, ldh, wm;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

template <int WM>
__device__ __forceinline__ void zero(Acc<WM>& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += part in IEEE fp32 (round to nearest), and part = 0
template <int WM>
__device__ __forceinline__ void promote(Acc<WM>& acc, Acc<WM>& part) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] += part[i][j][e];
        part[i][j][e] = 0.f;
      }
}

// One k-step of 8 of the warp's 32 x 32 tile: a[mi] are the split A
// fragments of its rows 32 wm + 16 mi; Bb / Bsm the big and small parts
// of an n-major staged tile (row = output channel), read at columns
// kofs .. kofs + 7, or at kofs + kstride t (+ 4 kstride) with kstride 9
// for the 3x3's channel-major chunk.
template <int kStride, int WM>
__device__ __forceinline__ void mma_k8(Acc<WM>& acc, const SplitA (&a)[2],
                                       const float* Bb, const float* Bsm,
                                       int ldb, int kofs) {
  const int lane = threadIdx.x & 31;
  const int wn = (threadIdx.x >> 5) / WM;
  const int base =
      (wn * 8 * WM + (lane >> 2)) * ldb + kofs + kStride * (lane & 3);
  SplitB b[WM];
#pragma unroll
  for (int ni = 0; ni < WM; ++ni) {
    const int i = base + 8 * ni * ldb;
    b[ni].big[0] = __float_as_uint(Bb[i]);
    b[ni].big[1] = __float_as_uint(Bb[i + 4 * kStride]);
    b[ni].small[0] = __float_as_uint(Bsm[i]);
    b[ni].small[1] = __float_as_uint(Bsm[i + 4 * kStride]);
  }
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int ni = 0; ni < WM; ++ni)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mma_3xtf32(acc[mi][ni], a[mi], b[ni], pass);
}

// The split A fragment of rows p0 (pixel g) and p1 (pixel g + 8), each a
// pointer to the fragment's first column
template <bool kClamp>
__device__ __forceinline__ void load_a(SplitA& f, const float* p0,
                                       const float* p1) {
  const int t = threadIdx.x & 3;
  split_a<kClamp>(f, p0[t], p1[t], p0[t + 4], p1[t + 4]);
}

// Whether any of this thread's accumulators is NaN (the unclamped split's
// mark, tc_common.cuh)
template <int WM>
__device__ __forceinline__ bool any_nan(const Acc<WM>& acc) {
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) nan |= acc[i][j][e] != acc[i][j][e];
  return nan;
}

// acc += A[m0 .. m0+32 WM-1][0, K) . B[n0 .. n0+63][0, K)^T for a 1x1
// filter B [N][K].  kStagedA: A rows lie in device memory, and arow[i] is
// the row this thread stages at tile row tid / 4 + 64 i (null: a zero row);
// otherwise A lies in shared memory and arow[2 mi + hh] is this lane's
// row g + 8 hh of m sub-tile mi.  Chunks of kKC k go through a ring of
// kRing A buffers and two B buffers, two chunks in flight ahead of the
// one multiplied, one barrier a chunk.  Ends with a barrier: the staging
// area is free.
template <bool kStagedA, int WM, bool kClamp>
__device__ __forceinline__ void gemm_1x1(Acc<WM>& acc,
                                         const float* const* arow, bool avec,
                                         const float* B, int N, int K, int n0,
                                         float* stage) {
  constexpr int BM = 32 * WM;
  float* As = stage;                         // [kRing][BM][kLdc]
  float* Bs = stage + kRing * BM * kLdc;     // [2][big, small][kBN][kLdc]
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) % WM;
  const int seg = 4 * (tid & 3);         // this thread's 4 k of a chunk row
  const int nc = (K + kKC - 1) / kKC;
  const bool bvec = K % 4 == 0 && aligned16(B);
  const int bn = n0 + (tid >> 2);
  const float* brow = bn < N ? B + (size_t)bn * K : nullptr;
  // stage chunk c of A into buffer buf and commit it (an empty group
  // past K)
  auto fill_a = [&](int c, int buf) {
    if (kStagedA && c < nc) {
      const int k = c * kKC + seg;
#pragma unroll
      for (int i = 0; i < WM / 2; ++i) {
        float* dst = As + (buf * BM + (tid >> 2) + 64 * i) * kLdc + seg;
        if (avec) {
          const bool v = arow[i] != nullptr && k < K;
          cp_async16(dst, v ? arow[i] + k : B, v);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool v = arow[i] != nullptr && k + j < K;
            cp_async4(dst + j, v ? arow[i] + k + j : B, v);
          }
        }
      }
    }
    cp_async_commit();
  };
  // chunk c of this thread's B row segment, into registers
  auto load_b = [&](int c, float4& r) {
    const int k = c * kKC + seg;
    if (bvec) {
      r = brow && k < K ? __ldg(reinterpret_cast<const float4*>(brow + k))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      r.x = brow && k < K ? __ldg(brow + k) : 0.f;
      r.y = brow && k + 1 < K ? __ldg(brow + k + 1) : 0.f;
      r.z = brow && k + 2 < K ? __ldg(brow + k + 2) : 0.f;
      r.w = brow && k + 3 < K ? __ldg(brow + k + 3) : 0.f;
    }
  };
  auto store_b = [&](int buf, const float4& r) {
    float* big = Bs + ((buf * 2) * kBN + (tid >> 2)) * kLdc + seg;
    float* small = big + kBN * kLdc;
    const float v[4] = {r.x, r.y, r.z, r.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(v[j], hi[j], lo[j]);
    *reinterpret_cast<float4*>(big) =
        make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                    __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    *reinterpret_cast<float4*>(small) =
        make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                    __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  };
  // two chunks in flight ahead of the one multiplied: A in a ring of
  // kRing buffers, B in two register sets (chunks c and c + 1), used in
  // turn so that each is indexed at compile time
  float4 breg0, breg1;
  fill_a(0, 0);
  fill_a(1, 1);
  load_b(0, breg0);
  if (nc > 1) load_b(1, breg1);
  Acc<WM> part;
  zero<WM>(part);
  int abuf = 0;
  auto step = [&](int c, float4& r) {
    const int buf = c & 1;
    store_b(buf, r);
    cp_async_wait<1>();  // A chunk c has landed (c + 1 may be in flight) ...
    // ... for every thread, B chunk c is stored, and every thread is done
    // with chunk c - 1, whose A buffer chunk c + 2 refills
    __syncthreads();
    fill_a(c + 2, abuf == 0 ? kRing - 1 : abuf - 1);
    if (c + 2 < nc) load_b(c + 2, r);
    const float* Bb = Bs + (buf * 2) * kBN * kLdc;
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const int k = c * kKC + 8 * ks;
      if (k >= K) break;
      SplitA a[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (kStagedA) {
          const float* p = As + (abuf * BM + wm * 32 + 16 * mi +
                                 (lane >> 2)) * kLdc + 8 * ks;
          load_a<kClamp>(a[mi], p, p + 8 * kLdc);
        } else {
          load_a<kClamp>(a[mi], arow[2 * mi] + k, arow[2 * mi + 1] + k);
        }
      }
      mma_k8<1>(part, a, Bb, Bb + kBN * kLdc, kLdc, 8 * ks);
    }
    if ((c & 3) == 3 || c + 1 == nc) promote(acc, part);
    abuf = abuf == kRing - 1 ? 0 : abuf + 1;
  };
  for (int c = 0; c < nc; c += 2) {
    step(c, breg0);
    if (c + 1 < nc) step(c + 1, breg1);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc += the 3x3 (stride s, the window's zero padding) at the block's
// output pixels m0 .. m0+32 WM-1 (m = r Wo + wo), output channels n0 ..
// n0+63.
// Ends with a barrier.
template <int WM, bool kClamp>
__device__ __forceinline__ void gemm_3x3(Acc<WM>& acc, const Args& a,
                                         const Geom& g, const float* win,
                                         int m0, int n0, float* stage) {
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) % WM;
  const int F = a.F, s = a.stride, ldw = g.ldw;
  const int ncb = (F + 7) / 8;
  // this lane's four A rows: window pixel (s r, s wo) is the tap (0, 0) of
  // output pixel (r, wo); rows past the block's pixels read pixel 0
  const float* arow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + wm * 32 + 16 * (i >> 1) + (lane >> 2) + 8 * (i & 1);
    if (m >= g.R * g.Wo) m = 0;
    const int r = m / g.Wo, wo = m - r * g.Wo;
    arow[i] = win + (s * r * g.Wp + s * wo) * ldw;
  }
  int toff[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    toff[tap] = ((tap / 3) * g.Wp + tap % 3) * ldw;
  // B: thread tid stages 18 of the 72 values of output channel tid / 4,
  // one chunk ahead in registers
  const int bq = 18 * (tid & 3);
  const int bn = n0 + (tid >> 2);
  const bool brow = bn < F;
  const float* wrow = a.w1 + (size_t)(brow ? bn : 0) * 9 * F + bq;
  const bool bvec = F % 2 == 0 && ((uintptr_t)a.w1 & 7) == 0;
  float breg[18];
  auto load_b = [&](int c) {
    const int lim = brow ? 9 * (F - 8 * c) - bq : 0;  // valid values
    const float* src = wrow + 72 * c;
    if (bvec) {
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const float2 v = 2 * j < lim
                             ? __ldg(reinterpret_cast<const float2*>(src) + j)
                             : make_float2(0.f, 0.f);
        breg[2 * j] = v.x;
        breg[2 * j + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 18; ++j) breg[j] = j < lim ? __ldg(src + j) : 0.f;
    }
  };
  float* Bb = stage;
  float* Bsm = stage + kBN * kLd3;
  auto store_b = [&]() {
    float* big = Bb + (tid >> 2) * kLd3 + bq;
    float* small = Bsm + (tid >> 2) * kLd3 + bq;
#pragma unroll
    for (int j = 0; j < 18; j += 2) {
      uint32_t h0, l0, h1, l1;
      split_tf32(breg[j], h0, l0);
      split_tf32(breg[j + 1], h1, l1);
      *reinterpret_cast<float2*>(big + j) =
          make_float2(__uint_as_float(h0), __uint_as_float(h1));
      *reinterpret_cast<float2*>(small + j) =
          make_float2(__uint_as_float(l0), __uint_as_float(l1));
    }
  };
  load_b(0);
  Acc<WM> part;
  zero<WM>(part);
  for (int c = 0; c < ncb; ++c) {
    __syncthreads();  // every warp is done with chunk c - 1
    store_b();
    __syncthreads();
    if (c + 1 < ncb) load_b(c + 1);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      SplitA af[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        load_a<kClamp>(af[mi], arow[2 * mi] + toff[tap] + 8 * c,
               arow[2 * mi + 1] + toff[tap] + 8 * c);
      mma_k8<9>(part, af, Bb, Bsm, kLd3, tap);
    }
    promote(acc, part);
  }
  __syncthreads();
}

// One pass of the fp32 block, the A fragments split with kClamp; returns
// whether this thread met a NaN in an accumulator
template <int WM, bool kClamp>
__device__ __forceinline__ bool bottleneck_pass(const Args& a, const Geom& g,
                                                float* stage) {
  constexpr int BM = 32 * WM;
  bool nan = false;
  float* win = stage + stage_floats(WM);            // [E][Wp][ldw]
  float* hb = win + (size_t)g.E * g.Wp * g.ldw;     // [R Wo][ldh]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM, gq = lane >> 2, tq = lane & 3;
  const int img = blockIdx.y, o0 = blockIdx.x * g.R, s = a.stride;
  const int W = a.W, C = a.C, F = a.F, C4 = a.C4;
  const float* x = a.x + (size_t)img * a.H * W * C;
  const int M1 = g.E * W, M2 = g.R * g.Wo;
  const bool xvec = C % 4 == 0 && aligned16(a.x);

  // zero the window and h: their zero columns and pad channels stay zero
  // (the first GEMM's barriers order this before conv0's stores)
  const int nz = g.E * g.Wp * g.ldw + M2 * g.ldh;
  for (int i = tid; i < nz; i += kThreads) win[i] = 0.f;

  // 1. conv0 + b0 + relu over the window's E W pixels; rows outside the
  //    image are zeros
  for (int m0 = 0; m0 < M1; m0 += BM) {
    const float* arow[2];
#pragma unroll
    for (int i = 0; i < WM / 2; ++i) {
      const int m = m0 + (tid >> 2) + 64 * i;
      const int e = m / W, h = s * o0 - 1 + e;
      arow[i] = (m < M1 && h >= 0 && h < a.H)
                    ? x + ((size_t)h * W + (m - e * W)) * C
                    : nullptr;
    }
    for (int n0 = 0; n0 < F; n0 += kBN) {
      Acc<WM> acc;
      zero<WM>(acc);
      gemm_1x1<true, WM, kClamp>(acc, arow, xvec, a.w0, F, C, n0, stage);
      nan |= any_nan<WM>(acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + wm * 32 + 16 * mi + gq + 8 * hh;
          if (m >= M1) continue;
          const int e = m / W, w = m - e * W, h = s * o0 - 1 + e;
          if (h < 0 || h >= a.H) continue;  // stays zero
          float* dst = win + ((size_t)e * g.Wp + w + 1) * g.ldw;
#pragma unroll
          for (int ni = 0; ni < WM; ++ni) {
            const int n = n0 + wn * 8 * WM + 8 * ni + 2 * tq;
            if (n >= F) continue;
            const float y0 = relu(acc[mi][ni][2 * hh] + __ldg(a.b0 + n));
            const float y1 =
                n + 1 < F
                    ? relu(acc[mi][ni][2 * hh + 1] + __ldg(a.b0 + n + 1))
                    : 0.f;
            *reinterpret_cast<float2*>(dst + n) = make_float2(y0, y1);
          }
        }
    }
  }
  __syncthreads();

  // 2. the 3x3 (stride s) + b1 + relu into h
  for (int m0 = 0; m0 < M2; m0 += BM) {
    for (int n0 = 0; n0 < F; n0 += kBN) {
      Acc<WM> acc;
      zero<WM>(acc);
      gemm_3x3<WM, kClamp>(acc, a, g, win, m0, n0, stage);
      nan |= any_nan<WM>(acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + wm * 32 + 16 * mi + gq + 8 * hh;
          if (m >= M2) continue;
          float* dst = hb + (size_t)m * g.ldh;
#pragma unroll
          for (int ni = 0; ni < WM; ++ni) {
            const int n = n0 + wn * 8 * WM + 8 * ni + 2 * tq;
            if (n >= F) continue;
            const float y0 = relu(acc[mi][ni][2 * hh] + __ldg(a.b1 + n));
            const float y1 =
                n + 1 < F
                    ? relu(acc[mi][ni][2 * hh + 1] + __ldg(a.b1 + n + 1))
                    : 0.f;
            *reinterpret_cast<float2*>(dst + n) = make_float2(y0, y1);
          }
        }
    }
  }
  __syncthreads();

  // 3. conv2 (+ projection) + biases (+ identity) + relu, to out
  const bool proj = a.ws != nullptr;
  for (int m0 = 0; m0 < M2; m0 += BM) {
    const float* hrow[4];  // this lane's fragment rows of h
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + wm * 32 + 16 * (i >> 1) + gq + 8 * (i & 1);
      hrow[i] = hb + (size_t)(m < M2 ? m : 0) * g.ldh;
    }
    const float* xrow[2];  // the projection rows this thread stages
#pragma unroll
    for (int i = 0; i < WM / 2; ++i) {
      const int m = m0 + (tid >> 2) + 64 * i;
      const int r = m / g.Wo, wo = m - r * g.Wo, o = o0 + r;
      xrow[i] = (m < M2 && o < g.Ho)
                    ? x + ((size_t)(s * o) * W + s * wo) * C
                    : nullptr;
    }
    for (int n0 = 0; n0 < C4; n0 += kBN) {
      Acc<WM> acc;
      zero<WM>(acc);
      gemm_1x1<false, WM, kClamp>(acc, hrow, false, a.w2, C4, F, n0, stage);
      if (proj)
        gemm_1x1<true, WM, kClamp>(acc, xrow, xvec, a.ws, C4, C, n0, stage);
      nan |= any_nan<WM>(acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + wm * 32 + 16 * mi + gq + 8 * hh;
          if (m >= M2) continue;
          const int r = m / g.Wo, wo = m - r * g.Wo, o = o0 + r;
          if (o >= g.Ho) continue;
          float* dst = a.out + (((size_t)img * g.Ho + o) * g.Wo + wo) * C4;
          // identity: s == 1 and C == C4, x's pixel (o, wo) is the output's
          const float* sh = proj ? a.bs : x + ((size_t)o * W + wo) * C;
#pragma unroll
          for (int ni = 0; ni < WM; ++ni) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + wn * 8 * WM + 8 * ni + 2 * tq + e;
              if (n < C4)
                dst[n] = relu(acc[mi][ni][2 * hh + e] + __ldg(a.b2 + n) +
                              __ldg(sh + n));
            }
          }
        }
    }
  }
  return nan;
}

// The unclamped pass first; a block that met a NaN runs again clamped,
// writing its rows of out again
template <int WM>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const Args a, const Geom g) {
  extern __shared__ float4 smem_f32[];
  float* stage = reinterpret_cast<float*>(smem_f32);
  if (__syncthreads_or(bottleneck_pass<WM, false>(a, g, stage)))
    bottleneck_pass<WM, true>(a, g, stage);
}

// F8 + 4 floats a row of h, and of a stride-1 window; F8 + 2 a row of a
// stride-2 window, whose fragment rows lie two pixels apart
inline void strides(const Args& a, Geom* g) {
  const int f8 = (a.F + 7) / 8 * 8;
  g->ldh = f8 + 4;
  g->ldw = a.stride == 1 ? f8 + 4 : f8 + 2;
}

inline size_t smem_bytes(const Args& a, const Geom& g, int R, int wm) {
  const size_t E = (size_t)a.stride * (R - 1) + 3;
  return sizeof(float) * (stage_floats(wm) + E * (a.W + 2) * g.ldw +
                          (size_t)R * g.Wo * g.ldh);
}

// One block's MMA work at R rows, M rounded up to whole BM-row tiles, N
// to whole 64-column tiles and k to whole k-steps of 8
inline double block_work(const Args& a, int Wo, int R, int BM) {
  auto up = [](long long v, long long t) { return (v + t - 1) / t * t; };
  const long long E = (long long)a.stride * (R - 1) + 3;
  const double M1 = (double)up(E * a.W, BM);
  const double M2 = (double)up((long long)R * Wo, BM);
  const double Fn = (double)up(a.F, kBN), C4n = (double)up(a.C4, kBN);
  const double k3 = (double)up(a.F, 8) * 9;
  const double k2 = (double)up(a.F, 8) + (a.ws ? (double)up(a.C, 8) : 0.0);
  return M1 * Fn * up(a.C, 8) + M2 * Fn * k3 + M2 * C4n * k2;
}

// Throughput of 64-row tiles against 128-row ones: each A fragment feeds
// two n-tiles rather than four, so the split costs twice the instructions
// per product
constexpr double kHalfTileRate = 0.8;

// The fp32 launch geometry: the tile (WM) and R of least cost by
// pick_rows, the 64-row tiles' work weighed by kHalfTileRate
inline cudaError_t plan(const Args& a, Geom* g, size_t* smem) {
  if (a.N <= 0 || a.H <= 0 || a.W <= 0 || a.C <= 0 || a.F <= 0 ||
      a.C4 <= 0 || (a.stride != 1 && a.stride != 2) || a.N > 65535)
    return cudaErrorInvalidValue;
  if (a.ws == nullptr && (a.stride != 1 || a.C != a.C4))
    return cudaErrorInvalidValue;
  paddle_bottleneck_tc::Limits l;
  const cudaError_t err = paddle_bottleneck_tc::card_limits(&l);
  if (err != cudaSuccess) return err;
  g->Ho = (a.H - 1) / a.stride + 1;
  g->Wo = (a.W - 1) / a.stride + 1;
  g->Wp = a.W + 2;
  strides(a, g);
  const Geom& gc = *g;
  double cost4 = 0.0, cost2 = 0.0;
  const int r4 = paddle_bottleneck_tc::pick_rows(
      a.N, g->Ho, paddle_bottleneck_tc::kernel_regs(bottleneck_kernel<4>), l,
      [&](int R) { return smem_bytes(a, gc, R, 4); },
      [&](int R) { return block_work(a, gc.Wo, R, 128); }, &cost4);
  const int r2 = paddle_bottleneck_tc::pick_rows(
      a.N, g->Ho, paddle_bottleneck_tc::kernel_regs(bottleneck_kernel<2>), l,
      [&](int R) { return smem_bytes(a, gc, R, 2); },
      [&](int R) { return block_work(a, gc.Wo, R, 64) / kHalfTileRate; },
      &cost2);
  if (r2 == 0) return cudaErrorInvalidValue;  // one row does not fit
  const bool half = r4 == 0 || cost2 < cost4;
  g->wm = half ? 2 : 4;
  g->R = half ? r2 : r4;
  g->E = a.stride * (g->R - 1) + 3;
  *smem = smem_bytes(a, *g, g->R, g->wm);
  return cudaSuccess;
}

template <int WM>
cudaError_t launch_wm(const Args& a, const Geom& g, size_t smem,
                      cudaStream_t st) {
  const cudaError_t err =
      paddle_bottleneck_tc::configure(bottleneck_kernel<WM>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.Ho + g.R - 1) / g.R, a.N);
  bottleneck_kernel<WM><<<grid, kThreads, smem, st>>>(a, g);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, cudaStream_t st) {
  Geom g;
  size_t smem = 0;
  const cudaError_t err = plan(a, &g, &smem);
  if (err != cudaSuccess) return err;
  return g.wm == 4 ? launch_wm<4>(a, g, smem, st)
                   : launch_wm<2>(a, g, smem, st);
}

cudaError_t describe(const Args& a, int* out) {
  Geom g;
  size_t smem = 0;
  const cudaError_t err = plan(a, &g, &smem);
  if (err != cudaSuccess) return err;
  const int blocks = ((g.Ho + g.R - 1) / g.R) * a.N;
  return g.wm == 4
             ? paddle_bottleneck_tc::describe_launch(
                   bottleneck_kernel<4>, g.R, blocks, smem, 128, out)
             : paddle_bottleneck_tc::describe_launch(
                   bottleneck_kernel<2>, g.R, blocks, smem, 64, out);
}

}  // namespace
}  // namespace paddle_bottleneck

// The C interface the port's ctypes wrapper calls
// (paddle_tpu_torch/ops/pallas_kernels.py fused_bottleneck).  The
// wrapper has checked shapes, dtypes and contiguity; pointers are device
// pointers to elements of the entry's type (fp32 or bf16).  Returns a
// cudaError_t (0 on a launched kernel).
struct PaddleBottleneckArgs {
  const void* x;
  const void* w0;
  const void* b0;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  const void* ws;
  const void* bs;
  void* out;
  int N, H, W, C, F, C4, stride;
};

template <typename T>
static paddle_bottleneck_tc::ArgsT<T> args_of(const PaddleBottleneckArgs* p) {
  return paddle_bottleneck_tc::ArgsT<T>{
      static_cast<const T*>(p->x),  static_cast<const T*>(p->w0),
      static_cast<const T*>(p->b0), static_cast<const T*>(p->w1),
      static_cast<const T*>(p->b1), static_cast<const T*>(p->w2),
      static_cast<const T*>(p->b2), static_cast<const T*>(p->ws),
      static_cast<const T*>(p->bs), static_cast<T*>(p->out),
      p->N, p->H, p->W, p->C, p->F, p->C4, p->stride};
}

extern "C" int paddle_fused_bottleneck_f32(const PaddleBottleneckArgs* p,
                                           cudaStream_t st) {
  return paddle_bottleneck::launch(args_of<float>(p), st);
}

extern "C" int paddle_fused_bottleneck_bf16(const PaddleBottleneckArgs* p,
                                            cudaStream_t st) {
  return paddle_bottleneck_tc::launch(args_of<paddle_tc::bf16>(p), st);
}

// A kernel's launch geometry for these arguments (pointers may be null;
// ws non-null selects the projection): out[0..5] = R, blocks, dynamic
// shared memory bytes, resident blocks per SM, registers per thread, rows
// of a block's GEMM tile.  Returns a cudaError_t.
extern "C" int paddle_fused_bottleneck_f32_plan(const PaddleBottleneckArgs* p,
                                                int* out) {
  return paddle_bottleneck::describe(args_of<float>(p), out);
}

extern "C" int paddle_fused_bottleneck_bf16_plan(
    const PaddleBottleneckArgs* p, int* out) {
  return paddle_bottleneck_tc::describe(args_of<paddle_tc::bf16>(p), out);
}
