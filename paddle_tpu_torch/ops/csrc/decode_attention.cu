// Slot-cache decode attention for Hopper (sm_90a): K3 (fp32 caches) and K4
// (int8 caches with per-head dequant scales, and its head-slice entry).
//
// Replaces the TPU kernel `decode_attention` of
// paddle_tpu/ops/pallas_kernels.py — its fp32 branch and its int8 branch
// (`kv_scales`) — and `decode_attention_head_slice`, instances of its
// tiled-contraction core: grid (N, S / block_kv), all heads of one slot
// resident, K/V blocks streamed through the shared online-softmax
// epilogue, int8 tiles dequantized in-register.
//
//   q [P, H, D] f32, k/v cache [P / qps, S, H, D] f32 or int8,
//   lengths [P] i32 -> out [P, H, D] f32
//   out[p, h] = sum_s softmax_s(q[p, h] . k[n, s, h] * scale * ks[h])
//               v[n, s, h] * vs[h]
//   over the live positions s < lengths[p], with n = p / qps and, for
//   int8 caches, ks = kv_scales[0, head_offset + h], vs = kv_scales[1,
//   head_offset + h] (kv_scales [2, h_total] f32; fp32 caches: ks = vs =
//   1, no multiply).
//
// `qps` (q rows per cache slot) lets the speculative verify step attend
// C = qps chunk positions of one slot — each a pseudo-slot with its own
// length — over that slot's cache without copying it C times; the
// plain decode step runs qps = 1.  `head_offset` and `h_total` are the
// head-slice entry: q and the caches hold a block of H local heads, the
// scale table is the whole per-layer [2, h_total] one, read at the
// block's offset in place.
//
// Masking follows the TPU kernel and its plain reference exactly: masked
// scores are the finite -1e30 (so a masked position's weight is an exact
// 0 once one position is live) and the normaliser is floored at 1e-20.
// A slot with length 0 has every score masked, every weight exp(0) = 1,
// and its output is the mean of all S value rows — well defined, and
// computed here the same way.  The int8 algebra is the reference's
// order: the K scale multiplies the scaled score once, (dot * scale) *
// ks; the V scale multiplies the output once, after the normalising
// divide.
//
// What bounds it: one query row per (slot, head) makes the work ~2 flops
// per cached element, far below the card's ridge point, so the kernel is
// bound by the K/V bytes it reads (2 * sum_n length_n * H * D * elem
// bytes per call; at N=8, S=512, H=8, D=64 that is 16.8 MB fp32, ~5 us
// at 3.35 TB/s, and 4.2 MB int8, ~1.3 us).  The design therefore aims at
// reading each live K/V row once, with coalesced loads, and at touching
// nothing past a slot's live length:
//   * one thread block per (pseudo-slot, head) — N * H blocks instead of
//     the TPU grid's N, so more SMs stream at once;
//   * inside a block, groups of D / 4 lanes each own one cached position
//     at a time; a lane reads 4 elements of its K and V rows (a float4,
//     or a char4 converted to fp32 in registers), so a group reads one
//     contiguous row;
//   * the D-long dot product is a butterfly of warp shuffles inside the
//     group, and each group keeps its own online softmax (running max,
//     normaliser, float4 accumulator) in registers over positions
//     g, g + G, g + 2G, ...;
//   * the groups' partial softmax states merge once, through shared
//     memory, at the end.
// Each (pseudo-slot, head) result depends only on that row's inputs and
// the reduction order is fixed by the live length: no atomics, so the
// kernel is deterministic, a slot's output does not depend on N, on
// other slots, on qps or on the head block it was launched in — which
// is what keeps batched decode bit-exact against single-request decode,
// the verify step's pseudo-slots bit-exact against the plain step, and
// the head-slice entry bit-exact against the full table.  Splitting S
// across blocks (flash-decoding), 16-byte int8 loads and TMA pipelining
// are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the TPU kernel
constexpr float kTiny = 1e-20f;    // _TINY of the TPU kernel
constexpr int kThreads = 256;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four int8 cache elements, dequantized to (unscaled) fp32 in registers
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// T: the cache element type (float or int8_t).  LPR: lanes per cached
// row = D / 4 (each lane owns four elements of D).
template <typename T, int LPR>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        const float* __restrict__ kv_scales,
                        float* __restrict__ out, int S, int H, int qps,
                        int h_total, int head_offset, float scale) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int D = LPR * 4;
  constexpr int G = kThreads / LPR;  // position groups per block
  const int p = blockIdx.x / H;      // pseudo-slot: its q row and length
  const int h = blockIdx.x - p * H;
  const int n = p / qps;             // the cache slot it reads
  const int g = threadIdx.x / LPR;
  const int lane = threadIdx.x - g * LPR;

  const int len = lengths[p];
  const int live = min(max(len, 0), S);
  const bool all_masked = live == 0;
  // a length-0 slot reads every row (its output is the mean of V)
  const int n_pos = all_masked ? S : live;

  float k_scale = 1.f, v_scale = 1.f;
  if constexpr (kInt8) {
    k_scale = kv_scales[head_offset + h];
    v_scale = kv_scales[h_total + head_offset + h];
  }

  const size_t qoff = ((size_t)p * H + h) * D;
  const float4 qv = reinterpret_cast<const float4*>(q + qoff)[lane];
  const size_t row = (size_t)H * D;  // elements between cached positions
  const T* kb = k + (size_t)n * S * row + (size_t)h * D + lane * 4;
  const T* vb = v + (size_t)n * S * row + (size_t)h * D + lane * 4;

  float m = -INFINITY;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // every group runs the same trip count, so the shuffles below always
  // see their whole warp; a group past the end contributes nothing
  for (int p0 = 0; p0 < n_pos; p0 += G) {
    const int pos = p0 + g;
    const bool valid = pos < n_pos;
    float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      kv = load4(kb + (size_t)pos * row);
      vv = load4(vb + (size_t)pos * row);
    }
    float dot = qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (valid) {
      float s = dot * scale;
      if constexpr (kInt8) s = s * k_scale;
      if (all_masked) s = kNegInf;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float wt = expf(s - m_new);
      l = l * alpha + wt;
      acc.x = acc.x * alpha + wt * vv.x;
      acc.y = acc.y * alpha + wt * vv.y;
      acc.z = acc.z * alpha + wt * vv.z;
      acc.w = acc.w * alpha + wt * vv.w;
      m = m_new;
    }
  }

  // merge the G partial softmax states (a group that saw no position
  // holds m = -inf and weighs exp(-inf) = 0)
  __shared__ float sm_m[G];
  __shared__ float sm_l[G];
  __shared__ float4 sm_acc[G][LPR];
  if (lane == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
  sm_acc[g][lane] = acc;
  __syncthreads();
  if (threadIdx.x < LPR) {
    const int d4 = threadIdx.x;
    float mx = -INFINITY;
    for (int i = 0; i < G; ++i) mx = fmaxf(mx, sm_m[i]);
    float tot = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < G; ++i) {
      const float w = expf(sm_m[i] - mx);
      const float4 a = sm_acc[i][d4];
      tot += sm_l[i] * w;
      o.x += a.x * w;
      o.y += a.y * w;
      o.z += a.z * w;
      o.w += a.w * w;
    }
    tot = fmaxf(tot, kTiny);
    o = make_float4(o.x / tot, o.y / tot, o.z / tot, o.w / tot);
    if constexpr (kInt8)
      o = make_float4(o.x * v_scale, o.y * v_scale, o.z * v_scale,
                      o.w * v_scale);
    reinterpret_cast<float4*>(out + qoff)[d4] = o;
  }
}

template <typename T>
cudaError_t launch(const float* q, const T* k, const T* v,
                   const int* lengths, const float* kv_scales, float* out,
                   int P, int S, int H, int D, int qps, int h_total,
                   int head_offset, float scale, cudaStream_t st) {
  if (P <= 0 || S <= 0 || H <= 0 || qps <= 0 || P % qps)
    return cudaErrorInvalidValue;
  if ((long long)P * H > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(P * H);
#define PADDLE_DECODE_CASE(DIM, LPR)                                      \
  case DIM:                                                               \
    decode_attention_kernel<T, LPR><<<grid, kThreads, 0, st>>>(           \
        q, k, v, lengths, kv_scales, out, S, H, qps, h_total, head_offset, \
        scale);                                                           \
    break;
  switch (D) {
    PADDLE_DECODE_CASE(4, 1)
    PADDLE_DECODE_CASE(8, 2)
    PADDLE_DECODE_CASE(16, 4)
    PADDLE_DECODE_CASE(32, 8)
    PADDLE_DECODE_CASE(64, 16)
    PADDLE_DECODE_CASE(128, 32)
    default:
      return cudaErrorInvalidValue;
  }
#undef PADDLE_DECODE_CASE
  return cudaGetLastError();
}

}  // namespace

// Pointers are device pointers in the layouts above, contiguous; q and
// out 16-byte aligned, fp32 caches 16-byte and int8 caches 4-byte
// aligned.  D must be 4, 8, 16, 32, 64 or 128; P a multiple of qps >= 1.
// Each launches on `st`, does not synchronise, and returns the launch's
// cudaError_t (cudaSuccess = 0).

// K3: fp32 caches.
extern "C" cudaError_t paddle_decode_attention_f32(
    const float* q, const float* k, const float* v, const int* lengths,
    float* out, int P, int S, int H, int D, int qps, float scale,
    cudaStream_t st) {
  return launch<float>(q, k, v, lengths, nullptr, out, P, S, H, D, qps, H,
                       0, scale, st);
}

// K4: int8 caches; kv_scales [2, h_total] f32, this block's heads at
// [head_offset, head_offset + H).
extern "C" cudaError_t paddle_decode_attention_i8(
    const float* q, const int8_t* k, const int8_t* v, const int* lengths,
    const float* kv_scales, float* out, int P, int S, int H, int D, int qps,
    int h_total, int head_offset, float scale, cudaStream_t st) {
  if (head_offset < 0 || head_offset + H > h_total)
    return cudaErrorInvalidValue;
  return launch<int8_t>(q, k, v, lengths, kv_scales, out, P, S, H, D, qps,
                        h_total, head_offset, scale, st);
}
