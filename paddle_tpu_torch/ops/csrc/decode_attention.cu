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
// per cached element, far below the card's ridge point, so the kernels
// are bound by the K/V bytes they read (2 * sum_n length_n * H * D * elem
// bytes per call; at N=8, S=512, H=8, D=64 that is 16.8 MB fp32, ~5 us
// at 3.35 TB/s, and 4.2 MB int8, ~1.3 us).  Both aim at reading each
// live K/V row once, with coalesced loads, and at touching nothing past
// a row's live length.
//
// K3 (fp32 caches, `decode_attention_kernel<float, LPR>`):
//   * one thread block per (pseudo-slot, head) — N * H blocks instead of
//     the TPU grid's N, so more SMs stream at once;
//   * inside a block, groups of D / 4 lanes each own one cached position
//     at a time; a lane reads 4 elements of its K and V rows (a float4),
//     so a group reads one contiguous row;
//   * the D-long dot product is a butterfly of warp shuffles inside the
//     group, and each group keeps its own online softmax (running max,
//     normaliser, float4 accumulator) in registers over positions
//     g, g + G, g + 2G, ...;
//   * the groups' partial softmax states merge once, through shared
//     memory, at the end.
// (The kernel is a template over the cache type; K4 no longer
// instantiates it.)
//
// K4 (int8 caches, `decode_attention_i8_kernel<D, VEC>`): one block per
// (pseudo-slot, head) left K4 latency-bound — 64 blocks on 132 SMs at the
// decode shape, each walking S in dependent round trips of 16 positions
// with 4-byte loads.  Now each (pseudo-slot, head) is a thread-block
// cluster of CS <= 8 blocks (the portable cluster size), launched once
// with cudaLaunchKernelEx:
//   * block `rank` of the cluster takes positions [rank * share, (rank +
//     1) * share) of the row, cut at its live length, where CS =
//     min(8, ceil(S / R)) and share = ceil(S / CS), R being the rows a
//     block reads in one round trip: each lane loads 4 positions at once
//     with 16-byte loads, so R = 4 * 256 / (D / min(16, D)) — 256 at D =
//     64, where S = 512 makes two blocks of 256 positions, each read in
//     one round trip (more, smaller blocks, one position a lane, cost
//     more in cluster launch and merge than their shorter reads save);
//   * a lane loads VEC int8 elements of its K and V rows at once (VEC =
//     min(16, D) where the caches' bases are 16-byte aligned, else 4: the
//     launcher picks it), D / VEC lanes a row, widened to fp32 in
//     registers; the dot product and the per-group online softmax follow
//     K3's scheme;
//   * the block's groups merge in a fixed order: the block max, each
//     group rescaled to it, a butterfly of shuffles over the groups of a
//     warp, then the warps in order through shared memory;
//   * each block writes its partial (m, l, acc[D]) into rank 0's shared
//     memory (distributed shared memory, map_shared_rank; a relaxed
//     cluster arrive at the start and its wait before the writes make
//     sure every block of the cluster runs), then one cluster.sync();
//     rank 0 merges the CS partials in rank order, floors the
//     normaliser at 1e-20, divides, applies the V scale and writes the
//     row.
// One launch per call, no workspace, no atomics.
//
// Invariants (the chip checks and the serving lanes' bit-exact gates
// rest on them):
//   * Fixed partition.  The positions each block takes, and the merge
//     order, depend only on S, D and the row's own length (and VEC,
//     which depends only on D and the caches' base alignment) — never on
//     N, qps, H or head_offset.  So each (pseudo-slot, head) result
//     depends only on that row's inputs: batched decode is bit-exact
//     against single-request decode, the verify step's pseudo-slots
//     against the plain step, and the head-slice entry against the full
//     table.  K3 holds the same with its one block.
//   * Masking as above: a masked score is the finite -1e30; a length-0
//     row reads all S rows and returns the mean of V; the K scale is
//     applied as (dot * scale) * ks; the V scale once, after the divide.
//   * A block whose share lies past the live length skips its loads but
//     still reaches the cluster barriers (an early return would deadlock
//     the cluster); it holds m = -inf and l = 0, and weighs 0 in the
//     merge.  Rank 0 always holds at least one position.
// Left for later: the same split for K3's fp32 caches, and TMA.

#include <cooperative_groups.h>
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

// ---- K4: int8 caches, each row's positions split over a cluster ----

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kUnroll = 4;      // positions a lane loads per round trip

// The cluster size and each block's share of positions for caches of S
// positions at head dim D: fixed by S and D alone.  A block reads
// kUnroll * 256 / (D / min(16, D)) rows a round trip with 16-byte loads
// (256 at D = 64).
inline void i8_plan(int S, int D, int& cs, int& share) {
  const int rows = kUnroll * kThreads / (D / (D < 16 ? D : 16));
  cs = (S + rows - 1) / rows;
  cs = cs < 1 ? 1 : cs > kMaxCluster ? kMaxCluster : cs;
  share = (S + cs - 1) / cs;
}

// VEC int8 cache elements at p (VEC-byte aligned), as VEC / 4 words
template <int VEC>
__device__ __forceinline__ void load_i8(const int8_t* p,
                                        uint32_t (&u)[VEC / 4]) {
  if constexpr (VEC == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    u[0] = r.x, u[1] = r.y, u[2] = r.z, u[3] = r.w;
  } else if constexpr (VEC == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    u[0] = r.x, u[1] = r.y;
  } else {
    u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// element j of the packed int8 words, as (unscaled) fp32
template <int VEC>
__device__ __forceinline__ float widen(const uint32_t (&u)[VEC / 4], int j) {
  return (float)(int8_t)(u[j >> 2] >> (8 * (j & 3)));
}

// One cluster of `cs` blocks per (pseudo-slot, head); block `rank` of
// the cluster reads positions [rank * share, (rank + 1) * share) of the
// row's live ones, kUnroll positions a lane per round trip.  D / VEC
// lanes per cached row.
template <int D, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_i8_kernel(const float* __restrict__ q,
                           const int8_t* __restrict__ k,
                           const int8_t* __restrict__ v,
                           const int* __restrict__ lengths,
                           const float* __restrict__ kv_scales,
                           float* __restrict__ out, int S, int H, int qps,
                           int h_total, int head_offset, float scale, int cs,
                           int share) {
  constexpr int LPR = D / VEC;
  constexpr int G = kThreads / LPR;  // position groups per block
  constexpr int kWarps = kThreads / 32;
  __shared__ float sm_max[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ __align__(16) float sm_acc[kWarps * D];  // [warp][d]
  // rank 0's: every block's partial softmax state, by rank
  __shared__ float all_m[kMaxCluster], all_l[kMaxCluster];
  __shared__ __align__(16) float all_o[kMaxCluster * D];
  // announce this block (its shared memory may be written from now on);
  // the matching wait comes before the first remote write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int rid = blockIdx.x / cs;  // (pseudo-slot, head)
  const int p = rid / H;            // pseudo-slot: its q row and length
  const int h = rid - p * H;
  const int n = p / qps;            // the cache slot it reads
  const int g = threadIdx.x / LPR;
  const int lane = threadIdx.x - g * LPR;
  const int wlane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int len = lengths[p];
  // q and the scales do not wait on the length
  const float k_scale = kv_scales[head_offset + h];
  const float v_scale = kv_scales[h_total + head_offset + h];
  const size_t qoff = ((size_t)p * H + h) * D;
  float qv[VEC];
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(q + qoff + lane * VEC)[i];
    qv[4 * i] = f.x;
    qv[4 * i + 1] = f.y;
    qv[4 * i + 2] = f.z;
    qv[4 * i + 3] = f.w;
  }
  const int live = min(max(len, 0), S);
  const bool all_masked = live == 0;
  // a length-0 row reads every row (its output is the mean of V)
  const int n_pos = all_masked ? S : live;
  const int lo = rank * share;
  const int hi = min(lo + share, n_pos);  // this block's positions [lo, hi)

  // this block's partial: (mx, lb, o) for element threadIdx.x < D
  float mx = -INFINITY, lb = 0.f, o = 0.f;
  if (lo < hi) {  // uniform over the block
    const size_t row = (size_t)H * D;  // bytes between cached positions
    const int8_t* kb = k + (size_t)n * S * row + (size_t)h * D + lane * VEC;
    const int8_t* vb = v + (size_t)n * S * row + (size_t)h * D + lane * VEC;
    float m = -INFINITY, l = 0.f;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    // every group runs the same trip count, so the shuffles below always
    // see their whole warp; a position past the end contributes nothing
    for (int p0 = lo; p0 < hi; p0 += kUnroll * G) {
      uint32_t kr[kUnroll][VEC / 4], vr[kUnroll][VEC / 4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = p0 + g + u * G;
        if (pos < hi) {
          load_i8<VEC>(kb + (size_t)pos * row, kr[u]);
          load_i8<VEC>(vb + (size_t)pos * row, vr[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC / 4; ++i) kr[u][i] = vr[u][i] = 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          dot = fmaf(qv[j], widen<VEC>(kr[u], j), dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (p0 + g + u * G < hi) {
          float s = dot * scale;
          s = s * k_scale;
          if (all_masked) s = kNegInf;
          const float m_new = fmaxf(m, s);
          const float alpha = expf(m - m_new);
          const float wt = expf(s - m_new);
          l = l * alpha + wt;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] = acc[j] * alpha + wt * widen<VEC>(vr[u], j);
          m = m_new;
        }
      }
    }
    // merge the G groups in a fixed order: the block max (exact in any
    // order); each group's state rescaled to it (a group that saw no
    // position holds m = -inf and weighs 0); a butterfly over the groups
    // of each warp (every lane ends with the same sums); the warps' sums
    // in warp order
    mx = m;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (wlane == 0) sm_max[warp] = mx;
    __syncthreads();
    mx = sm_max[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) mx = fmaxf(mx, sm_max[i]);
    const float f = expf(m - mx);
    l *= f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] *= f;
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
    if (wlane < LPR) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) sm_acc[warp * D + lane * VEC + j] = acc[j];
      if (wlane == 0) sm_l[warp] = l;
    }
    __syncthreads();
    if (threadIdx.x < D) {
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        o += sm_acc[i * D + threadIdx.x];
        lb += sm_l[i];
      }
    }
  }
  // A block past the live length keeps mx = -inf, lb = 0, o = 0 and
  // weighs 0.  Once every block of the cluster has started (the wait
  // below), each writes its partial into rank 0's shared memory; one
  // cluster barrier then publishes them to rank 0.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x < D) {
    cluster.map_shared_rank(all_o, 0)[rank * D + threadIdx.x] = o;
    if (threadIdx.x == 0) {
      cluster.map_shared_rank(all_m, 0)[rank] = mx;
      cluster.map_shared_rank(all_l, 0)[rank] = lb;
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < D) {
    float gm = all_m[0];  // rank 0 always holds a position
    for (int i = 1; i < cs; ++i) gm = fmaxf(gm, all_m[i]);
    float tot = 0.f, acc = 0.f;
    for (int i = 0; i < cs; ++i) {
      const float w = expf(all_m[i] - gm);
      tot += all_l[i] * w;
      acc += all_o[i * D + threadIdx.x] * w;
    }
    tot = fmaxf(tot, kTiny);
    out[qoff + threadIdx.x] = acc / tot * v_scale;
  }
}

template <int D, int VEC>
cudaError_t launch_i8_kernel(const float* q, const int8_t* k,
                             const int8_t* v, const int* lengths,
                             const float* kv_scales, float* out, int P, int S,
                             int H, int qps, int h_total, int head_offset,
                             float scale, int cs, int share,
                             cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(P * H * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_i8_kernel<D, VEC>, q, k, v, lengths, kv_scales,
      out, S, H, qps, h_total, head_offset, scale, cs, share);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_i8(const float* q, const int8_t* k, const int8_t* v,
                      const int* lengths, const float* kv_scales, float* out,
                      int P, int S, int H, int D, int qps, int h_total,
                      int head_offset, float scale, cudaStream_t st) {
  if (P <= 0 || S <= 0 || H <= 0 || qps <= 0 || P % qps)
    return cudaErrorInvalidValue;
  int cs, share;
  i8_plan(S, D, cs, share);
  if ((long long)P * H * cs > 0x7fffffffLL) return cudaErrorInvalidValue;
  // 16-byte loads (min(16, D) bytes at small D) where both caches' bases
  // allow them (every row then starts at a multiple of them), else 4
  const int widest = D < 16 ? D : 16;
  const bool wide =
      (uintptr_t)k % widest == 0 && (uintptr_t)v % widest == 0;
#define PADDLE_I8_CASE(DIM)                                                  \
  case DIM:                                                                  \
    return wide ? launch_i8_kernel<DIM, (DIM < 16 ? DIM : 16)>(              \
                      q, k, v, lengths, kv_scales, out, P, S, H, qps,        \
                      h_total, head_offset, scale, cs, share, st)            \
                : launch_i8_kernel<DIM, 4>(q, k, v, lengths, kv_scales, out, \
                                           P, S, H, qps, h_total,            \
                                           head_offset, scale, cs, share,    \
                                           st);
  switch (D) {
    PADDLE_I8_CASE(4)
    PADDLE_I8_CASE(8)
    PADDLE_I8_CASE(16)
    PADDLE_I8_CASE(32)
    PADDLE_I8_CASE(64)
    PADDLE_I8_CASE(128)
    default:
      break;
  }
#undef PADDLE_I8_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Pointers are device pointers in the layouts above, contiguous; q and
// out 16-byte aligned, fp32 caches 16-byte and int8 caches 4-byte
// aligned (16-byte aligned int8 caches take K4's widest loads).  D must
// be 4, 8, 16, 32, 64 or 128; P a multiple of qps >= 1.
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
  return launch_i8(q, k, v, lengths, kv_scales, out, P, S, H, D, qps,
                   h_total, head_offset, scale, st);
}

// K4's split for caches of S positions at head dim D: the cluster size
// and the positions each block of a cluster takes.  Returns
// cudaErrorInvalidValue for a D the kernel does not take or S < 1.
extern "C" cudaError_t paddle_decode_attention_i8_plan(int S, int D,
                                                       int* cluster,
                                                       int* share) {
  if (S < 1 || (D != 4 && D != 8 && D != 16 && D != 32 && D != 64 &&
                D != 128))
    return cudaErrorInvalidValue;
  i8_plan(S, D, *cluster, *share);
  return cudaSuccess;
}
