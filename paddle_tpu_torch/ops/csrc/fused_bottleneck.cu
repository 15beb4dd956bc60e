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
// This file holds the fp32 kernel (SIMT) and the C entries; the bf16
// entry launches the tensor-core kernel of fused_bottleneck_tc.cuh, which
// keeps this kernel's structure and the TPU kernel's bf16 rounding points
// and takes C, F and C4 multiples of 8.
//
// Design (fp32).  One thread block owns one image and R consecutive
// output rows o0 .. o0 + R - 1 (R picked per shape, below).  It
//   1. computes conv0 + b0 + relu for the E = s (R - 1) + 3 input rows
//      s o0 - 1 .. s (o0 + R - 1) + 1 that the 3x3 taps read, into a
//      shared-memory window [E, W, F]; rows outside the image are exact
//      zeros, as the 3x3's zero padding acts on conv0's OUTPUT (the TPU
//      kernel masks those rows the same way);
//   2. computes the 3x3 conv + b1 + relu from that window (the tap's
//      column outside the image reads 0) into a shared row block
//      h [R Wo, F];
//   3. accumulates conv2 (from h) and the projection shortcut (from x in
//      device memory, at (s o, s wo)) into one register tile, adds the
//      biases (or the identity x row), applies relu and writes out.
// Each stage is a small GEMM, out[m][n] = sum_k A(m, k) B[n][k], with B a
// filter read row by row from device memory (OIHW keeps each output
// channel's K = C, 9 F or F inputs contiguous; for the 3x3, k runs over
// (input channel, tap) in OIHW order and A is the window read as
// im2col).  The block computes 64 x 64 output tiles, 256 threads each
// owning a 4 x 4 register tile, over K in chunks of 16 staged in shared
// memory.  Window and h rows are padded to F + 1 elements so the im2col
// reads of one chunk spread over the banks.
//
// What bounds it: per output pixel the block does C F + 9 F^2 + F C4 (+
// C C4) multiply-adds on one read of x and one write of out, hundreds of
// flops per byte — above the card's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s, ~20 flops per byte), so it is bound by the fp32 FMA rate.  The
// design spends no device-memory traffic on the intermediates; it pays
// for that by recomputing conv0 on the (E - s R) halo rows that
// neighbouring blocks share (R = 1, s = 1: 3x; R = 2: 2x), by SIMT FMAs
// rather than tensor cores, and by re-reading the filters from L2 in
// every block.  TF32 tensor-core tiles, TMA staging and splitting F across
// blocks are later work.
//
// Sums run in a fixed order fixed by the shape: no atomics, so the
// result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "fused_bottleneck_tc.cuh"

namespace paddle_bottleneck {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // BM = BN: output tile edge
constexpr int kChunk = 16;      // K staged per step
constexpr int kLdt = kTile + 4; // staged tile row stride (float4 aligned)
// aim each block at ~2 output tiles of rows, but keep >= 2 blocks per SM
constexpr int kTargetRows = 128;
constexpr long long kMinBlocks = 264;

template <typename T>
struct Args {
  const T* x;
  const T* w0;
  const T* b0;
  const T* w1;
  const T* b1;
  const T* w2;
  const T* b2;
  const T* ws;
  const T* bs;
  T* out;
  int N, H, W, C, F, C4, stride;
};

// an element in shared memory (to_f32) or, through the read-only cache,
// in device memory (ldg_f32); store writes it
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

struct Geom {
  int Ho, Wo, R, E, ldw, ldh;
};

// A block-wide 64 x 64 tile of out[m][n] = sum_k A(m, k) * B[n * ldb + k]:
// thread (ty, tx) owns rows m0 + 4 ty + i and columns n0 + 4 tx + j.
// The A operand is a loader with three parts, so the index arithmetic
// is paid once per row per tile and once per column per chunk, not per
// element: `row(m)` (0 content outside the operand), `col(k)` and
// `at(row, col)`.  B rows n >= N read 0.  The next chunk is fetched into
// registers while the current one is multiplied out of shared memory
// (two staging buffers, one barrier per chunk).  A and B are converted
// to fp32 as they are fetched (the identity for fp32).
template <class ALoad, typename T>
__device__ __forceinline__ void tile_gemm(const ALoad& a,
                                          const T* __restrict__ B,
                                          int ldb, int N, int K, int m0,
                                          int n0, float (&acc)[4][4],
                                          float* As, float* Bs) {
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int lk = t % kChunk;   // the chunk column this thread stages
  const int lr = t / kChunk;   // its first row (then +16, +32, +48)
  typename ALoad::Row rows[kTile / 16];
  const T* brow[kTile / 16];
#pragma unroll
  for (int i = 0; i < kTile / 16; ++i) {
    rows[i] = a.row(m0 + lr + 16 * i);
    const int n = n0 + lr + 16 * i;
    brow[i] = n < N ? B + (size_t)n * ldb : nullptr;
  }
  float ra[kTile / 16], rb[kTile / 16];
  auto fetch = [&](int k) {
    const bool live = k < K;
    const typename ALoad::Col c = a.col(live ? k : 0);
#pragma unroll
    for (int i = 0; i < kTile / 16; ++i) {
      ra[i] = live ? a.at(rows[i], c) : 0.f;
      rb[i] = (live && brow[i]) ? ldg_f32(brow[i] + k) : 0.f;
    }
  };
  fetch(lk);
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    float* as = As + buf * kChunk * kLdt;
    float* bs = Bs + buf * kChunk * kLdt;
#pragma unroll
    for (int i = 0; i < kTile / 16; ++i) {
      as[lk * kLdt + lr + 16 * i] = ra[i];
      bs[lk * kLdt + lr + 16 * i] = rb[i];
    }
    __syncthreads();
    if (k0 + kChunk < K) fetch(k0 + kChunk + lk);
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 av =
          *reinterpret_cast<const float4*>(as + kk * kLdt + 4 * ty);
      const float4 bv =
          *reinterpret_cast<const float4*>(bs + kk * kLdt + 4 * tx);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    buf ^= 1;
  }
  // the caller's next tile stages into these buffers again
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// conv0's A: x at window row e (input row row0 + e), column w; a row is
// a pointer to the pixel's C inputs, or null outside the image.
template <typename T>
struct XWindow {
  typedef const T* Row;
  typedef int Col;
  const T* x;  // this image
  int H, W, C, row0, M;
  __device__ XWindow(const T* x_, int H_, int W_, int C_, int row0_, int M_)
      : x(x_), H(H_), W(W_), C(C_), row0(row0_), M(M_) {}
  __device__ Row row(int m) const {
    if (m >= M) return nullptr;
    const int e = m / W, w = m - e * W;
    const int h = row0 + e;
    if (h < 0 || h >= H) return nullptr;
    return x + ((size_t)h * W + w) * C;
  }
  __device__ Col col(int k) const { return k; }
  __device__ float at(Row r, int k) const { return r ? ldg_f32(r + k) : 0.f; }
};

// the 3x3's A: im2col of the shared window, k = fi * 9 + dy * 3 + dx in
// OIHW order.
template <typename T>
struct Im2col {
  struct Row {
    int base;  // offset of window pixel (s r, s wo - 1)
    int col0;  // s wo - 1; kOutside for a row outside the operand
  };
  static constexpr int kOutside = -(1 << 30);
  struct Col {
    int off;   // fi + (dy W + dx) ldw
    int dx;
  };
  const T* win;
  int W, Wo, s, ldw, M;
  __device__ Im2col(const T* win_, int W_, int Wo_, int s_, int ldw_, int M_)
      : win(win_), W(W_), Wo(Wo_), s(s_), ldw(ldw_), M(M_) {}
  __device__ Row row(int m) const {
    if (m >= M) return Row{0, kOutside};
    const int r = m / Wo, wo = m - r * Wo;
    return Row{(s * r * W + s * wo - 1) * ldw, s * wo - 1};
  }
  __device__ Col col(int k) const {
    const int fi = k / 9, tap = k - fi * 9;
    const int dy = tap / 3, dx = tap - dy * 3;
    return Col{fi + (dy * W + dx) * ldw, dx};
  }
  __device__ float at(const Row& r, const Col& c) const {
    const int col = r.col0 + c.dx;
    if (col < 0 || col >= W) return 0.f;
    return to_f32(win[r.base + c.off]);
  }
};

// conv2's A: the shared row block h.
template <typename T>
struct HRows {
  typedef const T* Row;
  typedef int Col;
  const T* h;
  int ldh, M;
  __device__ HRows(const T* h_, int ldh_, int M_) : h(h_), ldh(ldh_), M(M_) {}
  __device__ Row row(int m) const { return m < M ? h + m * ldh : nullptr; }
  __device__ Col col(int k) const { return k; }
  __device__ float at(Row r, int k) const { return r ? to_f32(r[k]) : 0.f; }
};

// the projection shortcut's A: x at (s o, s wo).
template <typename T>
struct XStrided {
  typedef const T* Row;
  typedef int Col;
  const T* x;  // this image
  int W, C, Wo, Ho, s, o0, M;
  __device__ XStrided(const T* x_, int W_, int C_, int Wo_, int Ho_, int s_,
                      int o0_, int M_)
      : x(x_), W(W_), C(C_), Wo(Wo_), Ho(Ho_), s(s_), o0(o0_), M(M_) {}
  __device__ Row row(int m) const {
    if (m >= M) return nullptr;
    const int r = m / Wo, wo = m - r * Wo;
    const int o = o0 + r;
    if (o >= Ho) return nullptr;
    return x + ((size_t)(s * o) * W + s * wo) * C;
  }
  __device__ Col col(int k) const { return k; }
  __device__ float at(Row r, int k) const { return r ? ldg_f32(r + k) : 0.f; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const Args<T> a, const Geom g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* As = smem;                       // 2 staging buffers each
  float* Bs = As + 2 * kChunk * kLdt;
  T* win = reinterpret_cast<T*>(Bs + 2 * kChunk * kLdt);  // [E * W][ldw]
  T* hbuf = win + g.E * a.W * g.ldw;                      // [R * Wo][ldh]

  const int img = blockIdx.y;
  const int o0 = blockIdx.x * g.R;
  const int s = a.stride;
  const T* x = a.x + (size_t)img * a.H * a.W * a.C;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  float acc[4][4];

  // 1. conv0 + b0 + relu over the window rows, zero outside the image
  const XWindow<T> xa(x, a.H, a.W, a.C, s * o0 - 1, g.E * a.W);
  for (int m0 = 0; m0 < xa.M; m0 += kTile) {
    for (int n0 = 0; n0 < a.F; n0 += kTile) {
      zero(acc);
      tile_gemm(xa, a.w0, a.C, a.F, a.C, m0, n0, acc, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 4 * ty + i;
        if (m >= xa.M) continue;
        const int h = xa.row0 + m / a.W;
        const bool inside = h >= 0 && h < a.H;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 4 * tx + j;
          if (n < a.F)
            store(win + m * g.ldw + n,
                  inside ? fmaxf(acc[i][j] + ldg_f32(a.b0 + n), 0.f) : 0.f);
        }
      }
    }
  }
  __syncthreads();

  // 2. the 3x3 (stride s) + b1 + relu into h
  const Im2col<T> ca(win, a.W, g.Wo, s, g.ldw, g.R * g.Wo);
  const int K1 = 9 * a.F;
  for (int m0 = 0; m0 < ca.M; m0 += kTile) {
    for (int n0 = 0; n0 < a.F; n0 += kTile) {
      zero(acc);
      tile_gemm(ca, a.w1, K1, a.F, K1, m0, n0, acc, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 4 * ty + i;
        if (m >= ca.M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 4 * tx + j;
          if (n < a.F)
            store(hbuf + m * g.ldh + n,
                  fmaxf(acc[i][j] + ldg_f32(a.b1 + n), 0.f));
        }
      }
    }
  }
  __syncthreads();

  // 3. conv2 (+ projection) + biases (+ identity) + relu, to out
  const HRows<T> ha(hbuf, g.ldh, g.R * g.Wo);
  const XStrided<T> sa(x, a.W, a.C, g.Wo, g.Ho, s, o0, g.R * g.Wo);
  const bool proj = a.ws != nullptr;
  for (int m0 = 0; m0 < ha.M; m0 += kTile) {
    for (int n0 = 0; n0 < a.C4; n0 += kTile) {
      zero(acc);
      tile_gemm(ha, a.w2, a.F, a.C4, a.F, m0, n0, acc, As, Bs);
      if (proj) tile_gemm(sa, a.ws, a.C, a.C4, a.C, m0, n0, acc, As, Bs);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 4 * ty + i;
        if (m >= ha.M) continue;
        const int r = m / g.Wo, wo = m - r * g.Wo;
        const int o = o0 + r;
        if (o >= g.Ho) continue;
        const size_t pix = ((size_t)img * g.Ho + o) * g.Wo + wo;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 4 * tx + j;
          if (n >= a.C4) continue;
          float y = acc[i][j] + ldg_f32(a.b2 + n);
          // identity: s == 1 and C == C4, so x's pixel (o, wo) is the
          // output pixel's own
          y += proj ? ldg_f32(a.bs + n)
                    : ldg_f32(x + ((size_t)o * a.W + wo) * a.C + n);
          store(a.out + pix * a.C4 + n, fmaxf(y, 0.f));
        }
      }
    }
  }
}

// staging buffers in fp32; the window and h in T
template <typename T>
size_t smem_bytes(const Args<T>& a, int Wo, int R) {
  const int E = a.stride * (R - 1) + 3;
  const size_t ld = (size_t)a.F + 1;
  return sizeof(float) * 4 * (size_t)kChunk * kLdt +
         sizeof(T) * ((size_t)E * a.W * ld + (size_t)R * Wo * ld);
}

template <typename T>
cudaError_t launch(const Args<T>& a, cudaStream_t st) {
  if (a.N <= 0 || a.H <= 0 || a.W <= 0 || a.C <= 0 || a.F <= 0 ||
      a.C4 <= 0 || (a.stride != 1 && a.stride != 2) || a.N > 65535)
    return cudaErrorInvalidValue;
  if (a.ws == nullptr && (a.stride != 1 || a.C != a.C4))
    return cudaErrorInvalidValue;
  Geom g;
  g.Ho = (a.H - 1) / a.stride + 1;
  g.Wo = (a.W - 1) / a.stride + 1;
  g.ldw = g.ldh = a.F + 1;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // rows per block: ~kTargetRows GEMM rows, fewer while the window does
  // not fit or the grid would leave SMs idle
  int R = kTargetRows / g.Wo;
  if (R < 1) R = 1;
  if (R > g.Ho) R = g.Ho;
  while (R > 1 &&
         (smem_bytes(a, g.Wo, R) > (size_t)max_smem ||
          (long long)a.N * ((g.Ho + R - 1) / R) < kMinBlocks))
    --R;
  const size_t smem = smem_bytes(a, g.Wo, R);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  g.R = R;
  g.E = a.stride * (R - 1) + 3;
  err = cudaFuncSetAttribute(bottleneck_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.Ho + R - 1) / R, a.N);
  bottleneck_kernel<T><<<grid, kThreads, smem, st>>>(a, g);
  return cudaGetLastError();
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

extern "C" int paddle_fused_bottleneck_f32(const PaddleBottleneckArgs* p,
                                           cudaStream_t st) {
  using paddle_bottleneck::Args;
  typedef float T;
  const Args<T> a{static_cast<const T*>(p->x), static_cast<const T*>(p->w0),
                  static_cast<const T*>(p->b0), static_cast<const T*>(p->w1),
                  static_cast<const T*>(p->b1), static_cast<const T*>(p->w2),
                  static_cast<const T*>(p->b2), static_cast<const T*>(p->ws),
                  static_cast<const T*>(p->bs), static_cast<T*>(p->out),
                  p->N, p->H, p->W, p->C, p->F, p->C4, p->stride};
  return paddle_bottleneck::launch(a, st);
}

static paddle_bottleneck_tc::Args tc_args(const PaddleBottleneckArgs* p) {
  typedef paddle_tc::bf16 T;
  return paddle_bottleneck_tc::Args{
      static_cast<const T*>(p->x),  static_cast<const T*>(p->w0),
      static_cast<const T*>(p->b0), static_cast<const T*>(p->w1),
      static_cast<const T*>(p->b1), static_cast<const T*>(p->w2),
      static_cast<const T*>(p->b2), static_cast<const T*>(p->ws),
      static_cast<const T*>(p->bs), static_cast<T*>(p->out),
      p->N, p->H, p->W, p->C, p->F, p->C4, p->stride};
}

extern "C" int paddle_fused_bottleneck_bf16(const PaddleBottleneckArgs* p,
                                            cudaStream_t st) {
  return paddle_bottleneck_tc::launch(tc_args(p), st);
}

// The bf16 kernel's launch geometry for these arguments (pointers may be
// null; ws non-null selects the projection): out[0..4] = R, blocks,
// dynamic shared memory bytes, resident blocks per SM, registers per
// thread.  Returns a cudaError_t.
extern "C" int paddle_fused_bottleneck_bf16_plan(
    const PaddleBottleneckArgs* p, int* out) {
  return paddle_bottleneck_tc::describe(tc_args(p), out);
}
