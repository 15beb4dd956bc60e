// Tensor-core body of K6-bf16, the fused ResNet bottleneck in bf16,
// included by fused_bottleneck.cu, whose bf16 C entry launches it; that
// file's fp32 kernel keeps this structure on TF32 tiles and shares the
// launch planning at the end of this header (pick_rows).
//
// Replaces the bf16 instance of the TPU kernel `fused_bottleneck`
// (`_bottleneck_kernel`) of paddle_tpu/ops/pallas_kernels.py, with its
// rounding points: conv0's output after bias + relu is rounded to bf16
// (its `a1.astype`), so is the 3x3's after bias + relu (`h ... .astype`),
// and conv2 + b2 + the shortcut stay fp32 until the output is rounded.
// Every product is bf16 x bf16, exact in the fp32 accumulators, so only
// the order of the fp32 sums differs from the plain version.
//
// Structure, as the SIMT kernel's: one block owns one image and R
// output rows o0 .. o0 + R - 1; it computes conv0 + b0 + relu for the E =
// s (R - 1) + 3 input rows the 3x3 taps read into a window [E][W + 2][F]
// in shared memory (rows outside the image are exact zeros, as the TPU
// kernel masks them; columns -1 and W are zero columns, so no tap
// branches), the 3x3 into h [R Wo][F] in shared memory, then conv2 from h
// plus the projection from x into one accumulator, and the epilogue.
// Window and h hold bf16 values in rows of F + 8 elements (16-byte
// aligned, free of ldmatrix bank conflicts at stride 1).
//
// Each stage is a GEMM out[m][n] = sum_k A(m, k) B[n][k] on warp-level
// mma.sync.m16n8k16 (bf16 in, fp32 accumulators): 256 threads as 8 warps,
// 4 along M x 2 along N, each owning a 32 x 32 tile of the block's 128 x
// 64 tile.  The operands:
//   * conv0 and the projection: A is x rows (C contiguous), B the filter
//     rows w0 [F][C] / ws [C4][C] (k-contiguous per output channel, the
//     mma B layout); both staged by 16-byte cp.async, zero-filled past the
//     edges, into a ring of three chunks of 32 k (two in flight);
//   * the 3x3: k runs over (block of 8 input channels, tap, channel), so
//     each 8 x 8 ldmatrix matrix is 8 contiguous channels of one window
//     pixel: A is read straight from the window with ldmatrix, and the
//     stride only changes each lane's row address.  B is w1 in OIHW:
//     per output channel the 8 x 9 elements of a channel block are 72
//     contiguous values (144 bytes), loaded as nine 16-byte vectors one
//     chunk ahead into registers and transposed to (tap, channel) order
//     as they are stored to shared memory; chunks of two channel blocks
//     (144 k) are nine k16 steps.  No relayout per run: the op keeps its
//     OIHW inputs;
//   * conv2: A is h read with ldmatrix, B w2 [C4][F] by cp.async.
// Epilogues run in the accumulator registers: bias, relu, the image-row
// mask, the rounding, stored as bf16 pairs.
//
// What bounds it: at the fused path (batch 64) the work is 217 GFLOP on
// ~1 GB of bf16 x and out: 0.22 ms of bf16 tensor-core time and 0.30 ms of
// bytes, so the bound is bytes; this kernel is far from it.  Its costs:
// conv0's halo recompute over (E - s R) rows, M tiles rounded up to 128
// rows, mma.sync rather than wgmma, and filters re-read from L2 by every
// block.  R is picked per shape on the host (`plan`): the least serial
// work per SM, ceil(blocks / SMs) x the block's padded MMA work, weighed
// by whether two blocks fit on an SM, among the R whose shared memory
// fits.
//
// Contract: C, F and C4 multiples of 8 (16-byte rows), every operand
// 16-byte aligned; the wrapper (ops/pallas_kernels.py fused_bottleneck)
// checks both.  Sums run in an order fixed by the shape: no atomics, so
// the result is deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace paddle_bottleneck_tc {

using namespace paddle_tc;

constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kBM = 128;       // block tile rows (pixels)
constexpr int kBN = 64;        // block tile columns (output channels)
constexpr int kKC = 32;        // k per staged chunk of the 1x1 GEMMs
constexpr int kLdc = kKC + kSkew;
constexpr int kRing = 3;       // staged chunks of the 1x1 GEMMs
constexpr int kKC3 = 144;      // k per chunk of the 3x3: 2 x (9 taps x 8)
constexpr int kLd3 = kKC3 + kSkew;
// the staging area: the 1x1 GEMMs' ring of A and B tiles, or the 3x3's
// double-buffered B tile
constexpr int kStage1x1 = kRing * (kBM + kBN) * kLdc;
constexpr int kStage3x3 = 2 * kBN * kLd3;
constexpr int kStageElems = kStage1x1 > kStage3x3 ? kStage1x1 : kStage3x3;

// a fused bottleneck's operands, every one of element type T (bf16 here,
// float for fused_bottleneck.cu's fp32 kernel)
template <typename T>
struct ArgsT {
  const T* x;
  const T* w0;
  const T* b0;
  const T* w1;
  const T* b1;
  const T* w2;
  const T* b2;
  const T* ws;  // nullptr: identity shortcut
  const T* bs;
  T* out;
  int N, H, W, C, F, C4, stride;
};
typedef ArgsT<bf16> Args;

// Wp = W + 2 window columns; ld = F + kSkew elements per window or h row
struct Geom {
  int Ho, Wo, R, E, Wp, ld;
};

typedef float Acc[2][4][4];  // [m sub-tile][n sub-tile][fragment]

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

__device__ __forceinline__ float2 ldg_bf16x2(const bf16* p) {
  const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// One k16 step of the warp's 32 x 32 tile: a[mi] are the A fragments of
// its rows 32 wm + 16 mi; B is an n-major staged tile (row = output
// channel, k contiguous), read at columns kofs .. kofs + 15.
__device__ __forceinline__ void mma_k16(Acc& acc, const uint32_t (&a)[2][4],
                                        const bf16* Bt, int ldb, int kofs) {
  const int lane = threadIdx.x & 31;
  const int wn = threadIdx.x >> 7;
  const int q = lane >> 3;
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t b[4];
    ldsm4(b, smem_u32(Bt + (wn * 32 + np * 16 + (lane & 7) + (q >> 1) * 8) *
                               ldb +
                      kofs + (q & 1) * 8));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma(acc[mi][2 * np], a[mi], b[0], b[1]);
      mma(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
    }
  }
}

// acc += A[m0 .. m0+127][0, K) . B[n0 .. n0+63][0, K)^T for a 1x1 filter
// B [N][K].  kStagedA: A rows lie in device memory, and arow[i] is the row
// this thread stages at tile row tid / 4 + 64 i (null: a zero row);
// otherwise A lies in shared memory and arow[mi] is this lane's ldmatrix
// row of m sub-tile mi.  Chunks of kKC k go through a ring of kRing
// buffers, two chunks in flight ahead of the one multiplied, one barrier
// a chunk.  Ends with a barrier: the staging area is free.
template <bool kStagedA>
__device__ __forceinline__ void gemm_1x1(Acc& acc,
                                         const bf16* const* arow,
                                         const bf16* B, int N, int K, int n0,
                                         bf16* stage) {
  bf16* As = stage;                       // [kRing][kBM][kLdc]
  bf16* Bs = stage + kRing * kBM * kLdc;  // [kRing][kBN][kLdc]
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) & 3;
  const int nc = (K + kKC - 1) / kKC;
  // stage chunk c into buffer buf and commit it (an empty group past K)
  auto fill = [&](int c, int buf) {
    const int k = c * kKC + 8 * (tid & 3);
    if (c < nc) {
      if (kStagedA) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool v = arow[i] != nullptr && k < K;
          cp_async16(As + (buf * kBM + (tid >> 2) + 64 * i) * kLdc +
                         8 * (tid & 3),
                     v ? arow[i] + k : B, v);
        }
      }
      const int n = n0 + (tid >> 2);
      const bool v = n < N && k < K;
      cp_async16(Bs + (buf * kBN + (tid >> 2)) * kLdc + 8 * (tid & 3),
                 v ? B + (size_t)n * K + k : B, v);
    }
    cp_async_commit();
  };
  fill(0, 0);
  fill(1, 1);
  int buf = 0;
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<1>();  // chunk c has landed (c + 1 may be in flight)
    // ... for every thread, and every thread is done with chunk c - 1,
    // whose buffer chunk c + 2 refills
    __syncthreads();
    fill(c + 2, buf == 0 ? kRing - 1 : buf - 1);
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      const int k = c * kKC + 16 * ks;
      if (k >= K) break;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p =
            kStagedA ? As + (buf * kBM + wm * 32 + 16 * mi + (lane & 15)) *
                                kLdc + 16 * ks
                     : arow[mi] + k;
        ldsm4(a[mi], smem_u32(p + 8 * (lane >> 4)));
      }
      mma_k16(acc, a, Bs + buf * kBN * kLdc, kLdc, 16 * ks);
    }
    buf = buf == kRing - 1 ? 0 : buf + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// acc += the 3x3 (stride s, the window's zero padding) at the block's
// output pixels m0 .. m0+127 (m = r Wo + wo), output channels n0 .. n0+63.
// Ends with a barrier.
__device__ __forceinline__ void gemm_3x3(Acc& acc, const Args& a,
                                         const Geom& g, const bf16* win,
                                         int m0, int n0, bf16* stage) {
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) & 3;
  const int F = a.F, s = a.stride, ld = g.ld;
  const int ncb = F / 8, nc = (ncb + 1) / 2;
  // this lane's two A rows: window pixel (s r, s wo + 1) is the tap (0, 1)
  // of output pixel (r, wo); rows past the block's pixels read pixel 0
  int pix[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    int m = m0 + wm * 32 + 16 * mi + (lane & 15);
    if (m >= g.R * g.Wo) m = 0;
    const int r = m / g.Wo, wo = m - r * g.Wo;
    pix[mi] = (s * r * g.Wp + s * wo) * ld;
  }
  // k16 step ks of a chunk reads group kg = 2 ks + lane / 16 of this lane:
  // the chunk's channel block kg / 9 at tap kg % 9
  int toff[9];
  unsigned second = 0;
#pragma unroll
  for (int ks = 0; ks < 9; ++ks) {
    const int kg = 2 * ks + (lane >> 4);
    const int hi = kg >= 9, tap = kg - 9 * hi;
    toff[ks] = ((tap / 3) * g.Wp + tap % 3) * ld + 8 * hi;
    second |= (unsigned)hi << ks;
  }
  // B: threads 0 .. 127 each fetch one (output channel, channel block)
  // of the chunk, 72 contiguous OIHW elements, one chunk ahead
  const int bn = tid >> 1, bw = tid & 1;
  const bool bthr = tid < 2 * kBN;
  const bool bn_ok = bthr && n0 + bn < F;
  const bf16* wrow = a.w1 + ((size_t)(n0 + bn) * 9 * F + 72 * bw);
  uint32_t breg[36];
  auto load_b = [&](int c) {
    const bool v = bn_ok && 2 * c + bw < ncb;
    const uint4* src = reinterpret_cast<const uint4*>(wrow + 144 * c);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const uint4 q = v ? __ldg(src + j) : make_uint4(0u, 0u, 0u, 0u);
      breg[4 * j] = q.x;
      breg[4 * j + 1] = q.y;
      breg[4 * j + 2] = q.z;
      breg[4 * j + 3] = q.w;
    }
  };
  // element (channel ci, tap t) sits at 9 ci + t in OIHW order and goes to
  // 8 t + ci: one __byte_perm per output pair
  auto store_b = [&](bf16* Bs) {
    if (!bthr) return;
    uint32_t o[36];
#pragma unroll
    for (int j = 0; j < 36; ++j) {
      const int t = (2 * j) >> 3, ci = (2 * j) & 7;
      const int i0 = 9 * ci + t, i1 = i0 + 9;
      const unsigned sel = ((i0 & 1) ? 0x32u : 0x10u) |
                           (((i1 & 1) ? 0x76u : 0x54u) << 8);
      o[j] = __byte_perm(breg[i0 >> 1], breg[i1 >> 1], sel);
    }
    uint4* dst = reinterpret_cast<uint4*>(Bs + bn * kLd3 + 72 * bw);
#pragma unroll
    for (int t = 0; t < 9; ++t)
      dst[t] = make_uint4(o[4 * t], o[4 * t + 1], o[4 * t + 2], o[4 * t + 3]);
  };
  load_b(0);
  for (int c = 0; c < nc; ++c) {
    bf16* Bs = stage + (c & 1) * kBN * kLd3;
    store_b(Bs);
    __syncthreads();
    if (c + 1 < nc) load_b(c + 1);
    // F / 8 odd: the last chunk's second block lies past F; its lanes read
    // the zero column (window pixel 0) against B's zeros
    const bool half = 2 * c + 1 >= ncb;
    const bf16* wc = win + 16 * c;
#pragma unroll
    for (int ks = 0; ks < 9; ++ks) {
      if (half && ks >= 5) break;  // both groups in the second block
      const bool za = half && ((second >> ks) & 1u);
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm4(af[mi], smem_u32(za ? win : wc + pix[mi] + toff[ks]));
      mma_k16(acc, af, Bs, kLd3, 16 * ks);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
bottleneck_tc_kernel(const Args a, const Geom g) {
  extern __shared__ uint4 smem_tc[];
  bf16* stage = reinterpret_cast<bf16*>(smem_tc);
  bf16* win = stage + kStageElems;                // [E][Wp][ld]
  bf16* hb = win + (size_t)g.E * g.Wp * g.ld;     // [R Wo][ld]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, gq = lane >> 2, tq = lane & 3;
  const int img = blockIdx.y, o0 = blockIdx.x * g.R, s = a.stride;
  const int W = a.W, C = a.C, F = a.F, C4 = a.C4, ld = g.ld;
  const bf16* x = a.x + (size_t)img * a.H * W * C;
  const int M1 = g.E * W, M2 = g.R * g.Wo;

  // the window's zero columns (image columns -1 and W), and h's pad
  // channels, which the last k16 step of conv2 reads when F / 8 is odd
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const int v8 = ld / 8;
  for (int i = tid; i < g.E * 2 * v8; i += kThreads) {
    const int e = i / (2 * v8), rem = i - e * 2 * v8;
    const int col = rem < v8 ? 0 : g.Wp - 1;
    reinterpret_cast<uint4*>(win + ((size_t)e * g.Wp + col) * ld)
        [rem < v8 ? rem : rem - v8] = z;
  }
  for (int i = tid; i < M2; i += kThreads)
    *reinterpret_cast<uint4*>(hb + (size_t)i * ld + F) = z;

  // 1. conv0 + b0 + relu over the window's E W pixels, rounded to bf16;
  //    rows outside the image are zeros
  for (int m0 = 0; m0 < M1; m0 += kBM) {
    const bf16* arow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (tid >> 2) + 64 * i;
      const int e = m / W, h = s * o0 - 1 + e;
      arow[i] = (m < M1 && h >= 0 && h < a.H)
                    ? x + ((size_t)h * W + (m - e * W)) * C
                    : nullptr;
    }
    for (int n0 = 0; n0 < F; n0 += kBN) {
      Acc acc;
      zero(acc);
      gemm_1x1<true>(acc, arow, a.w0, F, C, n0, stage);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + wm * 32 + 16 * mi + gq + 8 * hh;
          if (m >= M1) continue;
          const int e = m / W, w = m - e * W, h = s * o0 - 1 + e;
          const bool inside = h >= 0 && h < a.H;
          bf16* dst = win + ((size_t)e * g.Wp + w + 1) * ld;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int n = n0 + wn * 32 + 8 * ni + 2 * tq;
            if (n >= F) continue;
            const float2 b = ldg_bf16x2(a.b0 + n);
            *reinterpret_cast<uint32_t*>(dst + n) =
                inside ? pack_bf16(relu(acc[mi][ni][2 * hh] + b.x),
                                   relu(acc[mi][ni][2 * hh + 1] + b.y))
                       : 0u;
          }
        }
    }
  }
  __syncthreads();

  // 2. the 3x3 (stride s) + b1 + relu into h, rounded to bf16
  for (int m0 = 0; m0 < M2; m0 += kBM) {
    for (int n0 = 0; n0 < F; n0 += kBN) {
      Acc acc;
      zero(acc);
      gemm_3x3(acc, a, g, win, m0, n0, stage);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + wm * 32 + 16 * mi + gq + 8 * hh;
          if (m >= M2) continue;
          bf16* dst = hb + (size_t)m * ld;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int n = n0 + wn * 32 + 8 * ni + 2 * tq;
            if (n >= F) continue;
            const float2 b = ldg_bf16x2(a.b1 + n);
            *reinterpret_cast<uint32_t*>(dst + n) =
                pack_bf16(relu(acc[mi][ni][2 * hh] + b.x),
                          relu(acc[mi][ni][2 * hh + 1] + b.y));
          }
        }
    }
  }
  __syncthreads();

  // 3. conv2 (+ projection) + biases (+ identity) + relu, to out
  const bool proj = a.ws != nullptr;
  for (int m0 = 0; m0 < M2; m0 += kBM) {
    const bf16* hrow[2];  // this lane's ldmatrix rows of h
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = m0 + wm * 32 + 16 * mi + (lane & 15);
      hrow[mi] = hb + (size_t)(m < M2 ? m : 0) * ld;
    }
    const bf16* xrow[2];  // the projection rows this thread stages
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + (tid >> 2) + 64 * i;
      const int r = m / g.Wo, wo = m - r * g.Wo, o = o0 + r;
      xrow[i] = (m < M2 && o < g.Ho)
                    ? x + ((size_t)(s * o) * W + s * wo) * C
                    : nullptr;
    }
    for (int n0 = 0; n0 < C4; n0 += kBN) {
      Acc acc;
      zero(acc);
      gemm_1x1<false>(acc, hrow, a.w2, C4, F, n0, stage);
      if (proj) gemm_1x1<true>(acc, xrow, a.ws, C4, C, n0, stage);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = m0 + wm * 32 + 16 * mi + gq + 8 * hh;
          if (m >= M2) continue;
          const int r = m / g.Wo, wo = m - r * g.Wo, o = o0 + r;
          if (o >= g.Ho) continue;
          bf16* dst = a.out + (((size_t)img * g.Ho + o) * g.Wo + wo) * C4;
          // identity: s == 1 and C == C4, x's pixel (o, wo) is the output's
          const bf16* xid = x + ((size_t)o * W + wo) * C;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int n = n0 + wn * 32 + 8 * ni + 2 * tq;
            if (n >= C4) continue;
            const float2 b = ldg_bf16x2(a.b2 + n);
            const float2 sh = ldg_bf16x2(proj ? a.bs + n : xid + n);
            *reinterpret_cast<uint32_t*>(dst + n) = pack_bf16(
                relu(acc[mi][ni][2 * hh] + b.x + sh.x),
                relu(acc[mi][ni][2 * hh + 1] + b.y + sh.y));
          }
        }
    }
  }
}

inline size_t smem_bytes(const Args& a, int Wo, int R) {
  const size_t E = (size_t)a.stride * (R - 1) + 3;
  const size_t ld = (size_t)a.F + kSkew;
  return sizeof(bf16) *
         (kStageElems + E * (a.W + 2) * ld + (size_t)R * Wo * ld);
}

// One block's MMA work at R rows, M and N rounded up to whole tiles and
// k to whole k16 steps (the 3x3's to whole chunks)
inline double block_work(const Args& a, int Wo, int R) {
  auto up = [](long long v, long long t) { return (v + t - 1) / t * t; };
  const long long E = (long long)a.stride * (R - 1) + 3;
  const double M1 = (double)up(E * a.W, kBM);
  const double M2 = (double)up((long long)R * Wo, kBM);
  const double Fn = (double)up(a.F, kBN), C4n = (double)up(a.C4, kBN);
  const double k3 = (double)up(a.F / 8, 2) * 72;
  const double k2 = (double)up(a.F, 16) + (a.ws ? (double)up(a.C, 16) : 0.0);
  return M1 * Fn * up(a.C, 16) + M2 * Fn * k3 + M2 * C4n * k2;
}

// The card's limits the row choice reads
struct Limits {
  int max_smem, smem_sm, reserved, sms;
};

inline cudaError_t card_limits(Limits* l) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &l->max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &l->smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &l->reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l->sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  return err;
}

// Registers a thread of `kernel` takes (255 where unknown), read once
template <typename Kernel>
inline int kernel_regs(Kernel kernel) {
  static const int regs = [kernel] {
    cudaFuncAttributes at;
    return cudaFuncGetAttributes(&at, kernel) == cudaSuccess ? at.numRegs
                                                             : 255;
  }();
  return regs;
}

// Blocks of `smem` bytes that an SM holds at once, by shared memory and
// by registers
inline int blocks_per_sm(size_t smem, int regs, const Limits& l) {
  const int by_smem = l.smem_sm / (int)(smem + l.reserved);
  const int by_regs = 65536 / (((regs + 7) / 8 * 8) * kThreads);
  return by_smem < by_regs ? by_smem : by_regs;
}

// Throughput of an SM holding two blocks against one, as measured on the
// H100 at the stage-1 geometry (R 2 with two blocks ran 84 TFLOP/s, R 4
// with one 69): the second block's warps hide the first's barriers
constexpr double kTwoBlockGain = 1.2;

// The rows per block: R minimises each SM's serial work, ceil(blocks /
// SMs) x work(R), over its throughput (kTwoBlockGain where two blocks
// fit), among the R whose shared memory smem(R) fits (ties: the larger R);
// 0 when one row does not fit.  The least cost goes to *cost if given.
template <class Smem, class Work>
inline int pick_rows(int N, int Ho, int regs, const Limits& l, Smem smem,
                     Work work, double* cost_out = nullptr) {
  int best = 0;
  double best_cost = 0.0;
  for (int R = 1; R <= Ho && R <= 64; ++R) {
    const size_t bytes = smem(R);
    if (bytes > (size_t)l.max_smem) break;
    const long long blocks = (long long)N * ((Ho + R - 1) / R);
    const double gain =
        blocks_per_sm(bytes, regs, l) >= 2 ? kTwoBlockGain : 1.0;
    const double cost =
        (double)((blocks + l.sms - 1) / l.sms) * work(R) / gain;
    if (best == 0 || cost <= best_cost) {
      best = R;
      best_cost = cost;
    }
  }
  if (cost_out) *cost_out = best_cost;
  return best;
}

// `smem` bytes of dynamic shared memory a block, and the most shared
// memory per SM, so that two blocks fit where they can
template <typename Kernel>
inline cudaError_t configure(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// What a launch of `kernel` at R rows per block runs: out = {R, blocks,
// dynamic shared memory bytes, resident blocks per SM, registers per
// thread, rows of the block's GEMM tile}
template <typename Kernel>
inline cudaError_t describe_launch(Kernel kernel, int R, int blocks,
                                   size_t smem, int tile_rows, int* out) {
  cudaError_t err = configure(kernel, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = R;
  out[1] = blocks;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = tile_rows;
  return cudaSuccess;
}

// The bf16 launch geometry: R by pick_rows on the padded MMA work
inline cudaError_t plan(const Args& a, Geom* g, size_t* smem) {
  if (a.N <= 0 || a.H <= 0 || a.W <= 0 || a.C <= 0 || a.F <= 0 ||
      a.C4 <= 0 || (a.stride != 1 && a.stride != 2) || a.N > 65535 ||
      a.C % 8 || a.F % 8 || a.C4 % 8)
    return cudaErrorInvalidValue;
  if (a.ws == nullptr && (a.stride != 1 || a.C != a.C4))
    return cudaErrorInvalidValue;
  Limits l;
  const cudaError_t err = card_limits(&l);
  if (err != cudaSuccess) return err;
  g->Ho = (a.H - 1) / a.stride + 1;
  g->Wo = (a.W - 1) / a.stride + 1;
  g->Wp = a.W + 2;
  g->ld = a.F + kSkew;
  const int Wo = g->Wo;
  const int best = pick_rows(
      a.N, g->Ho, kernel_regs(bottleneck_tc_kernel), l,
      [&](int R) { return smem_bytes(a, Wo, R); },
      [&](int R) { return block_work(a, Wo, R); });
  if (best == 0) return cudaErrorInvalidValue;  // one row does not fit
  g->R = best;
  g->E = a.stride * (best - 1) + 3;
  *smem = smem_bytes(a, g->Wo, best);
  return cudaSuccess;
}

inline cudaError_t launch(const Args& a, cudaStream_t st) {
  Geom g;
  size_t smem = 0;
  cudaError_t err = plan(a, &g, &smem);
  if (err == cudaSuccess) err = configure(bottleneck_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.Ho + g.R - 1) / g.R, a.N);
  bottleneck_tc_kernel<<<grid, kThreads, smem, st>>>(a, g);
  return cudaGetLastError();
}

// What `launch` would run, as describe_launch gives it
inline cudaError_t describe(const Args& a, int* out) {
  Geom g;
  size_t smem = 0;
  const cudaError_t err = plan(a, &g, &smem);
  if (err != cudaSuccess) return err;
  return describe_launch(bottleneck_tc_kernel, g.R,
                         ((g.Ho + g.R - 1) / g.R) * a.N, smem, kBM, out);
}

}  // namespace paddle_bottleneck_tc
