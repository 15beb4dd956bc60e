// Slot-cache decode attention for Hopper (sm_90a): K3 (fp32 caches) and K4
// (int8 caches with per-head dequant scales, and its head-slice entry),
// one kernel template over the cache type.
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
// at 3.35 TB/s, and 4.2 MB int8, ~1.3 us).  It aims at reading each live
// K/V row once, with 16-byte loads, at touching nothing past a row's live
// length, and at enough loads in flight to cover the memory latency: one
// block per (slot, head) — 64 blocks on 132 SMs at the decode shape, each
// walking S in dependent round trips — held K3 at 17% and K4 at 5% of
// their byte bounds.
//
// `decode_attention_kernel<T, D, VEC>` (T = float for K3, int8_t for K4):
// each (pseudo-slot, head) is a thread-block cluster of CS <= 8 blocks
// (the portable cluster size), launched once with cudaLaunchKernelEx:
//   * block `rank` of the cluster takes positions [rank * share, (rank +
//     1) * share) of the row, cut at its live length; (CS, share) is the
//     type's plan, fixed by S and D (f32_plan, i8_plan below);
//   * a lane loads VEC cache elements of its K and V rows at once, 16
//     bytes: one float4 of fp32 (VEC = 4), or VEC = min(16, D) int8
//     elements where the int8 caches' bases are 16-byte aligned, else 4
//     (the launcher picks it), widened to fp32 in registers; D / VEC
//     lanes a row, kUnroll positions a lane per round trip;
//   * the D-long dot product is a butterfly of warp shuffles inside the
//     row's lanes, and each group of D / VEC lanes keeps its own online
//     softmax (running max, normaliser, VEC accumulators) in registers;
//   * the block's groups merge in a fixed order: the block max, each
//     group rescaled to it, a butterfly of shuffles over the groups of a
//     warp, then the warps in order through shared memory;
//   * each block writes its partial (m, l, acc[D]) into rank 0's shared
//     memory (distributed shared memory, map_shared_rank; a relaxed
//     cluster arrive at the start and its wait before the writes make
//     sure every block of the cluster runs), then one cluster.sync();
//     rank 0 merges the CS partials in rank order, floors the
//     normaliser at 1e-20, divides, applies the V scale (int8) and
//     writes the row.
// One launch per call, no workspace, no atomics.
//
// The plans.  A block reads R = kUnroll * 256 / (D / VEC) rows a round
// trip (int8 at D = 64: 256 rows of 64 bytes; fp32: 64 rows of 256
// bytes — 16 KB of K and 16 KB of V either way).  K4 takes CS =
// min(8, ceil(S / R)) blocks of share = ceil(S / CS) positions: two
// blocks of 256 at S = 512, each one round trip (more, smaller blocks
// cost more in cluster launch and merge than their shorter reads save).
// K3's fp32 rows are 4x the bytes, so the same S makes 4x the round
// trips: f32_plan gives each block kF32Trips of them, 4 blocks of 128
// positions at S = 512, D = 64 (a sweep of 1, 2, 4 and 8 blocks on the
// card: 8 blocks of one round trip cost more in cluster launch and merge
// than they save; 1 block reads too little at once; PERF.md).
//
// Invariants (the chip checks and the serving lanes' bit-exact gates
// rest on them):
//   * Fixed partition.  The positions each block takes, and the merge
//     order, depend only on S, D and the row's own length (and, for
//     int8, VEC, which depends only on D and the caches' base alignment)
//     — never on N, qps, H or head_offset.  So each (pseudo-slot, head)
//     result depends only on that row's inputs: batched decode is
//     bit-exact against single-request decode, the verify step's
//     pseudo-slots against the plain step, and the head-slice entry
//     against the full table.
//   * Masking as above: a masked score is the finite -1e30; a length-0
//     row reads all S rows and returns the mean of V; the K scale is
//     applied as (dot * scale) * ks; the V scale once, after the divide.
//   * A block whose share lies past the live length skips its loads but
//     still reaches the cluster barriers (an early return would deadlock
//     the cluster); it holds m = -inf and l = 0, and weighs 0 in the
//     merge.  Rank 0 always holds at least one position.
//
// Head dims.  The template's D is a power of two (4 ... 256: D <= kThreads,
// one output element a thread, and D / VEC <= 32, a row's lanes inside one
// warp — so VEC is 8 at D = 256 where it is 4 below: K3 two float4 loads a
// lane, K4's narrow path two 4-byte loads); a head dim
// DR between them runs the next wider template with DR as a runtime
// argument (`kRagged`): a lane past DR loads nothing and holds zeros (q
// and K alike, so its share of the dot product is 0), rows are DR
// elements apart in q, the caches and out, a lane whose VEC elements
// straddle DR (or whose rows are not VEC-aligned, DR % VEC != 0) loads
// element by element, and only the first DR outputs are written.  The
// caches are read in place, never padded.  The split plan is the
// template width's.  The exact widths (kRagged false) compile to the
// code above with no per-lane check.
// Left for later: TMA, and a persistent split that reads the length
// ahead of the rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;  // _NEG_INF of the TPU kernel
constexpr float kTiny = 1e-20f;    // _TINY of the TPU kernel
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kUnroll = 4;      // positions a lane loads per round trip
// K3: round trips of R rows (64 at D = 64) a block takes; f32_plan
constexpr int kF32Trips = 2;

// The cluster size and each block's share of positions, for caches of S
// positions at head dim D read VEC elements a lane, `trips` round trips
// of kUnroll * kThreads / (D / VEC) rows a block: fixed by S and D alone.
inline void split_plan(int S, int D, int vec, int trips, int& cs,
                       int& share) {
  const int rows = trips * kUnroll * kThreads / (D / vec);
  cs = (S + rows - 1) / rows;
  cs = cs < 1 ? 1 : cs > kMaxCluster ? kMaxCluster : cs;
  share = (S + cs - 1) / cs;
}

// K4: int8 rows read min(16, D) elements a lane, one round trip a block
inline void i8_plan(int S, int D, int& cs, int& share) {
  split_plan(S, D, D < 16 ? D : 16, 1, cs, share);
}

// K3: fp32 rows read one float4 a lane (two at D = 256, so that a row's
// lanes stay inside a warp), kF32Trips round trips a block
__host__ __device__ constexpr int f32_vec(int D) { return D > 128 ? 8 : 4; }

inline void f32_plan(int S, int D, int& cs, int& share) {
  split_plan(S, D, f32_vec(D), kF32Trips, cs, share);
}

// K4's narrow loads (caches not 16-byte aligned, or a ragged head dim):
// 4 bytes a lane, 8 at D = 256
__host__ __device__ constexpr int i8_narrow_vec(int D) {
  return D > 128 ? 8 : 4;
}

// VEC cache elements at p (VEC * sizeof(T) bytes, that aligned), as
// 32-bit words
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(
    const T* p, uint32_t (&u)[VEC * sizeof(T) / 4]) {
  constexpr int W = VEC * sizeof(T) / 4;
  if constexpr (W == 8) {
    const uint4 r0 = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 r1 = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    u[0] = r0.x, u[1] = r0.y, u[2] = r0.z, u[3] = r0.w;
    u[4] = r1.x, u[5] = r1.y, u[6] = r1.z, u[7] = r1.w;
  } else if constexpr (W == 4) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    u[0] = r.x, u[1] = r.y, u[2] = r.z, u[3] = r.w;
  } else if constexpr (W == 2 && sizeof(T) == 4) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    u[0] = r.x, u[1] = r.y;
  } else if constexpr (W == 2) {
    // 8 int8 elements as two 4-byte loads: K4's narrow path at D = 256
    // reads caches that are only 4-byte aligned
    u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    u[1] = __ldg(reinterpret_cast<const unsigned int*>(p) + 1);
  } else {
    u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// the first `valid` (< VEC, or rows not VEC-aligned) of VEC cache
// elements at p, element by element, as the words load_vec fills; the
// rest zero
template <typename T, int VEC>
__device__ __forceinline__ void load_vec_masked(
    const T* p, int valid, uint32_t (&u)[VEC * sizeof(T) / 4]) {
  constexpr int W = VEC * sizeof(T) / 4;
#pragma unroll
  for (int i = 0; i < W; ++i) u[i] = 0u;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (j < valid) {
      if constexpr (std::is_same<T, float>::value)
        u[j] = __float_as_uint(__ldg(p + j));
      else
        u[j >> 2] |= (uint32_t)(uint8_t)__ldg(p + j) << (8 * (j & 3));
    }
  }
}

// element j of the loaded words, as fp32 (int8: widened, unscaled)
template <typename T, int VEC>
__device__ __forceinline__ float elem(
    const uint32_t (&u)[VEC * sizeof(T) / 4], int j) {
  if constexpr (std::is_same<T, float>::value)
    return __uint_as_float(u[j]);
  else
    return (float)(int8_t)(u[j >> 2] >> (8 * (j & 3)));
}

// One cluster of `cs` blocks per (pseudo-slot, head); block `rank` of
// the cluster reads positions [rank * share, (rank + 1) * share) of the
// row's live ones, kUnroll positions a lane per round trip.  D / VEC
// lanes per cached row.  kv_scales is read for int8 caches only.  With
// kRagged the head dim is dr < D (rows dr elements apart), else D.
template <typename T, int D, int VEC, bool kRagged>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_kernel(const float* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        const float* __restrict__ kv_scales,
                        float* __restrict__ out, int S, int H, int qps,
                        int h_total, int head_offset, float scale, int cs,
                        int share, int dr) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int LPR = D / VEC;
  constexpr int W = VEC * (int)sizeof(T) / 4;  // words a lane loads
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
  float k_scale = 1.f, v_scale = 1.f;
  if constexpr (kInt8) {
    k_scale = kv_scales[head_offset + h];
    v_scale = kv_scales[h_total + head_offset + h];
  }
  const int DR = kRagged ? dr : D;  // the head dim
  // elements of this lane's VEC below DR, and whether its rows take
  // VEC-wide loads
  const int valid = kRagged ? min(max(DR - lane * VEC, 0), VEC) : VEC;
  const bool wide_ok = !kRagged || (valid == VEC && DR % VEC == 0);
  const size_t qoff = ((size_t)p * H + h) * DR;
  float qv[VEC];
  if constexpr (kRagged) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      qv[j] = j < valid ? q[qoff + lane * VEC + j] : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 f =
          reinterpret_cast<const float4*>(q + qoff + lane * VEC)[i];
      qv[4 * i] = f.x;
      qv[4 * i + 1] = f.y;
      qv[4 * i + 2] = f.z;
      qv[4 * i + 3] = f.w;
    }
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
    const size_t row = (size_t)H * DR;  // elements between cached positions
    const T* kb = k + (size_t)n * S * row + (size_t)h * DR + lane * VEC;
    const T* vb = v + (size_t)n * S * row + (size_t)h * DR + lane * VEC;
    float m = -INFINITY, l = 0.f;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    // every group runs the same trip count, so the shuffles below always
    // see their whole warp; a position past the end contributes nothing
    for (int p0 = lo; p0 < hi; p0 += kUnroll * G) {
      uint32_t kr[kUnroll][W], vr[kUnroll][W];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = p0 + g + u * G;
        if (pos < hi && wide_ok) {
          load_vec<T, VEC>(kb + (size_t)pos * row, kr[u]);
          load_vec<T, VEC>(vb + (size_t)pos * row, vr[u]);
        } else if (kRagged && pos < hi) {
          load_vec_masked<T, VEC>(kb + (size_t)pos * row, valid, kr[u]);
          load_vec_masked<T, VEC>(vb + (size_t)pos * row, valid, vr[u]);
        } else {
#pragma unroll
          for (int i = 0; i < W; ++i) kr[u][i] = vr[u][i] = 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          dot = fmaf(qv[j], elem<T, VEC>(kr[u], j), dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (p0 + g + u * G < hi) {
          float s = dot * scale;
          if constexpr (kInt8) s = s * k_scale;
          if (all_masked) s = kNegInf;
          const float m_new = fmaxf(m, s);
          const float alpha = expf(m - m_new);
          const float wt = expf(s - m_new);
          l = l * alpha + wt;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] = acc[j] * alpha + wt * elem<T, VEC>(vr[u], j);
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
  if (rank == 0 && threadIdx.x < DR) {
    float gm = all_m[0];  // rank 0 always holds a position
    for (int i = 1; i < cs; ++i) gm = fmaxf(gm, all_m[i]);
    float tot = 0.f, acc = 0.f;
    for (int i = 0; i < cs; ++i) {
      const float w = expf(all_m[i] - gm);
      tot += all_l[i] * w;
      acc += all_o[i * D + threadIdx.x] * w;
    }
    tot = fmaxf(tot, kTiny);
    if constexpr (kInt8)
      out[qoff + threadIdx.x] = acc / tot * v_scale;
    else
      out[qoff + threadIdx.x] = acc / tot;
  }
}

template <typename T, int D, int VEC, bool kRagged>
cudaError_t launch_kernel(const float* q, const T* k, const T* v,
                          const int* lengths, const float* kv_scales,
                          float* out, int P, int S, int H, int qps,
                          int h_total, int head_offset, float scale, int cs,
                          int share, int dr, cudaStream_t st) {
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
      &cfg, decode_attention_kernel<T, D, VEC, kRagged>, q, k, v, lengths,
      kv_scales, out, S, H, qps, h_total, head_offset, scale, cs, share, dr);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the template width a head dim D (1 ... 256) runs at
int padded_dim(int D) {
  int w = 4;
  while (w < D) w <<= 1;
  return w;
}

// What no plan takes, and a grid past CUDA's limits
bool bad_dim(int S, int D) { return S < 1 || D < 1 || D > 256; }

bool bad_shape(int P, int S, int H, int D, int qps, int cs) {
  return bad_dim(S, D) || P <= 0 || H <= 0 || qps <= 0 || P % qps ||
         (long long)P * H * cs > 0x7fffffffLL;
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const int* lengths, float* out, int P, int S, int H,
                       int D, int qps, float scale, cudaStream_t st) {
  int cs = 0, share = 0;
  const int DP = padded_dim(D);
  if (!bad_dim(S, D)) f32_plan(S, DP, cs, share);
  if (bad_shape(P, S, H, D, qps, cs)) return cudaErrorInvalidValue;
#define PADDLE_F32_CASE(DIM)                                                 \
  case DIM:                                                                  \
    return D == DIM ? launch_kernel<float, DIM, f32_vec(DIM), false>(        \
                          q, k, v, lengths, nullptr, out, P, S, H, qps, H,   \
                          0, scale, cs, share, D, st)                        \
                    : launch_kernel<float, DIM, f32_vec(DIM), true>(         \
                          q, k, v, lengths, nullptr, out, P, S, H, qps, H,   \
                          0, scale, cs, share, D, st);
  switch (DP) {
    PADDLE_F32_CASE(4)
    PADDLE_F32_CASE(8)
    PADDLE_F32_CASE(16)
    PADDLE_F32_CASE(32)
    PADDLE_F32_CASE(64)
    PADDLE_F32_CASE(128)
    PADDLE_F32_CASE(256)
    default:
      break;
  }
#undef PADDLE_F32_CASE
  return cudaErrorInvalidValue;
}

cudaError_t launch_i8(const float* q, const int8_t* k, const int8_t* v,
                      const int* lengths, const float* kv_scales, float* out,
                      int P, int S, int H, int D, int qps, int h_total,
                      int head_offset, float scale, cudaStream_t st) {
  int cs = 0, share = 0;
  const int DP = padded_dim(D);
  if (!bad_dim(S, D)) i8_plan(S, DP, cs, share);
  if (bad_shape(P, S, H, D, qps, cs)) return cudaErrorInvalidValue;
  // 16-byte loads (min(16, D) bytes at small D) where both caches' bases
  // allow them (every row then starts at a multiple of them), else 4 (8 at
  // D = 256: i8_narrow_vec); a ragged head dim reads that narrow width
  const int widest = DP < 16 ? DP : 16;
  const bool wide =
      (uintptr_t)k % widest == 0 && (uintptr_t)v % widest == 0;
#define PADDLE_I8_CASE(DIM)                                                   \
  case DIM:                                                                   \
    if (D != DIM)                                                             \
      return launch_kernel<int8_t, DIM, i8_narrow_vec(DIM), true>(            \
          q, k, v, lengths, kv_scales, out, P, S, H, qps, h_total,            \
          head_offset, scale, cs, share, D, st);                              \
    return wide ? launch_kernel<int8_t, DIM, (DIM < 16 ? DIM : 16), false>(   \
                      q, k, v, lengths, kv_scales, out, P, S, H, qps,         \
                      h_total, head_offset, scale, cs, share, D, st)          \
                : launch_kernel<int8_t, DIM, i8_narrow_vec(DIM), false>(      \
                      q, k, v, lengths, kv_scales, out, P, S, H, qps,         \
                      h_total, head_offset, scale, cs, share, D, st);
  switch (DP) {
    PADDLE_I8_CASE(4)
    PADDLE_I8_CASE(8)
    PADDLE_I8_CASE(16)
    PADDLE_I8_CASE(32)
    PADDLE_I8_CASE(64)
    PADDLE_I8_CASE(128)
    PADDLE_I8_CASE(256)
    default:
      break;
  }
#undef PADDLE_I8_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Pointers are device pointers in the layouts above, contiguous; q and
// out 16-byte aligned, fp32 caches 16-byte and int8 caches 4-byte
// aligned (16-byte aligned int8 caches take K4's widest loads).  D is 1
// ... 256 (4, 8, 16, 32, 64, 128 and 256 exactly, any other at the next
// of them); P a multiple of qps >= 1.
// Each launches on `st`, does not synchronise, and returns the launch's
// cudaError_t (cudaSuccess = 0).

// K3: fp32 caches, split by f32_plan.
extern "C" cudaError_t paddle_decode_attention_f32(
    const float* q, const float* k, const float* v, const int* lengths,
    float* out, int P, int S, int H, int D, int qps, float scale,
    cudaStream_t st) {
  return launch_f32(q, k, v, lengths, out, P, S, H, D, qps, scale, st);
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

// K3's and K4's splits for caches of S positions at head dim D: the
// cluster size and the positions each block of a cluster takes.  Return
// cudaErrorInvalidValue for a D the kernel does not take or S < 1.
extern "C" cudaError_t paddle_decode_attention_f32_plan(int S, int D,
                                                        int* cluster,
                                                        int* share) {
  if (bad_dim(S, D)) return cudaErrorInvalidValue;
  f32_plan(S, padded_dim(D), *cluster, *share);
  return cudaSuccess;
}

extern "C" cudaError_t paddle_decode_attention_i8_plan(int S, int D,
                                                       int* cluster,
                                                       int* share) {
  if (bad_dim(S, D)) return cudaErrorInvalidValue;
  i8_plan(S, padded_dim(D), *cluster, *share);
  return cudaSuccess;
}
