// Dense attention over a PUL-streamed (B, K, S, hd) KV, for Hopper (sm_90a).
//
// Replaces the two TPU kernels that attend over a dense cache:
//   K7  repro/kernels/pul_attention.py : pul_attention (_kernel) -- flash
//       attention with GQA (h -> h / G), causal masking with the queries
//       end-aligned to the keys (offset S - T), a sliding window
//       (jk > iq - window, applied with or without causal, as the TPU
//       kernel does), a tanh softcap before the mask, and the KV tail past S
//       masked;
//   K6  repro/kernels/pul_decode.py : pul_decode_attention (_kernel) -- one
//       query token per head over a cache masked at length[b], softcap.
// Both are one fp32 online softmax over KV chunks streamed through the same
// shared-memory ring (stream_chunks below), templated on the element type
// (f32 or bf16) and on the chunk's compute: a 64-row register tile for K7,
// the G heads of one kv head for K6. The TPU kernels' constants are kept:
// masked logits are NEG_INF = -2e38 (finite), and l >= 1e-30 at the end.
//
// Bounds on this card. K7 is bound by operations: 4 hd flops per visible
// (query, key) pair, 137 GFLOP for the causal 4096^2 qwen3 prefill (B 2,
// H 16), 0.139 ms at the 989 TFLOP/s of bf16 tensor cores. This kernel does
// them as fp32 FMAs on the CUDA cores (peak 67 TFLOP/s), so it cannot come
// within 15x of that bound: wgmma tiles with TMA loads are a later
// redesign. K6 is bound by bytes: the K and V rows of the visible positions,
// read once (4 G hd flops per 4 hd bytes of bf16 K/V).
//
// What the design does about it:
//   * GQA: a block holds the queries of all G heads of one kv head, so each
//     KV chunk crosses HBM once per kv head, not once per query head. K7's
//     block is 64 query rows, G heads x 64 / G positions (all G heads of a
//     position share its mask); K6's block is the G heads of one token;
//   * the ring (core/pipeline.py PreloadStream / pul_loop, pul_ring.cuh): a
//     chunk of BC keys, BC rows of K then of V, is copied by 16-byte
//     cp.async into slot c % slots, `distance` chunks ahead of the compute.
//     BATCH issues chunk i + d after computing chunk i, SEQUENTIAL before
//     it. Rows past S are zero-filled, as the TPU's padding of the stream;
//   * tiles: the TPU kernel holds a (bt, hd) q tile, a (bt, hd) fp32
//     accumulator and (bt, bs) logits in VMEM; at bt = bs = 128, hd = 128
//     that is 192 KB before any ring slot. Here the accumulator lives in
//     registers (64 rows x 128 columns over 256 threads: 4 x 8 each), q in
//     fp32 shared memory (32 KB), the chunk's probabilities (64 x BC fp32),
//     and a slot is 64 bf16 or 32 f32 keys (34 KB with its padding: each
//     row carries one spare 16-byte granule so that eight threads reading
//     eight rows hit eight bank groups). At d = 4 the host's
//     attention_ring_plan gives 5 slots, 223,232 B: one block per SM;
//   * blocks skip the chunks that no row of theirs can see: above the
//     causal diagonal, before the window, past length[b]. Those add nothing
//     (p = exp(NEG_INF - m) = 0 after a visible key, and before one the
//     first visible key's corr = exp(NEG_INF - m) = 0 cancels them), so
//     skipping them changes no value. A row that sees no key at all (K6's
//     length 0; K7's rows with iq < 0 when T > S) gets the TPU kernel's
//     value: every logit NEG_INF, p = 1 over the whole padded stream of
//     s_pad = ceil(S / bs) bs positions, the sum of the v rows over s_pad.
//     A block holding such a row streams every chunk; positions past s_pad
//     (inside the last chunk) take -inf, so p = 0 there;
//   * K6 has one query per head, so a block of one (b, kv head) has far too
//     little work to hide the stream's latency: the keys are split into
//     segments of seg_chunks chunks, one block each (grid (segments, K, B)),
//     each writing its (m, l, acc) in fp32, and a second kernel merges the
//     segments: M = max m, out = sum(acc e^(m - M)) / sum(l e^(m - M)). A
//     segment past the visible keys writes m = -inf and streams nothing.
//
// K7 visits query tiles heaviest first (the causal diagonal's far end).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGranule = 16;
constexpr int kHd = 128;        // head dim the kernels are built for
constexpr int kRows = 64;       // K7: query rows of one block
constexpr int kMaxG = 16;       // K6: query heads of one kv head

struct Params {
  const void* q;     // K7 (B, H, T, hd); K6 (B, K, G, hd)
  const void* k;     // (B, K, S, hd)
  const void* v;
  void* out;         // like q
  const int* lengths;  // K6 (B,): visible cache positions
  float* part_m;     // K6 (B, K, n_seg, G) segment maxima
  float* part_l;     // K6 (B, K, n_seg, G) segment sums
  float* part_acc;   // K6 (B, K, n_seg, G, hd) segment accumulators
  int K, G, T, S, s_pad;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
  int distance, slots, sequential;
  int seg_chunks, n_seg;
};

// keys of one ring chunk: 64 bf16 or 32 f32 rows, 16 KB of K (plus padding)
template <typename T>
struct Chunk {
  static constexpr int kEpv = kGranule / sizeof(T);  // values per granule
  static constexpr int kBC = sizeof(T) == 2 ? 64 : 32;
  static constexpr int kRowStride = kHd + kEpv;      // one spare granule
  static constexpr int kElems = 2 * kBC * kRowStride;  // K rows, then V rows
};

// 16 bytes of T at smem p, widened to fp32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else {
    // a bf16 is the high half of its fp32: widening is a shift, exactly
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float cap(float x, float softcap) {
  return softcap > 0.f ? softcap * tanhf(x / softcap) : x;
}

// PRELOAD of chunk c (keys [c BC, c BC + BC)) of one (b, kv head) into a
// ring slot; rows past S are zero-filled
template <typename T>
__device__ __forceinline__ void copy_chunk(T* slot, const T* kh, const T* vh,
                                           int c, int S) {
  using C = Chunk<T>;
  constexpr int per_row = kHd / C::kEpv;
  T* sk = slot;
  T* sv = slot + C::kBC * C::kRowStride;
  for (int e = threadIdx.x; e < C::kBC * per_row; e += kThreads) {
    const int r = e / per_row, g = e - r * per_row;
    const int jk = c * C::kBC + r;
    const bool ok = jk < S;
    const size_t off = (size_t)(ok ? jk : 0) * kHd + g * C::kEpv;
    cp_async16_zfill(sk + r * C::kRowStride + g * C::kEpv, kh + off, ok);
    cp_async16_zfill(sv + r * C::kRowStride + g * C::kEpv, vh + off, ok);
  }
}

// The PUL loop over chunks [c0, c0 + n): chunk c0 + i in slot i % slots,
// `distance` chunks in flight. compute(slot, c) runs between two barriers.
template <typename T, class Compute>
__device__ __forceinline__ void stream_chunks(const Params& p, T* ring,
                                              const T* kh, const T* vh, int c0,
                                              int n, Compute compute) {
  const int d = p.distance;
  auto issue = [&](int i) {
    if (i < n)
      copy_chunk<T>(ring + (size_t)(i % p.slots) * Chunk<T>::kElems, kh, vh,
                    c0 + i, p.S);
    // one group per stream position, empty past the end, so the number of
    // groups younger than chunk i is a constant the wait can name
    cp_async_commit();
  };
  for (int i = 0; i < d; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    if (p.sequential) {
      issue(i + d);  // PL[i + d] -> compute[i]; needs slots >= d + 1
      cp_async_wait_dyn(d);
    } else {
      cp_async_wait_dyn(d - 1);
    }
    __syncthreads();  // chunk i visible to every thread
    compute(ring + (size_t)(i % p.slots) * Chunk<T>::kElems, c0 + i);
    __syncthreads();  // chunk i consumed: its slot may be reissued
    if (!p.sequential) issue(i + d);
  }
  cp_async_wait<0>();
}

// masked logit of key jk: -inf past the padded stream (no weight even in a
// row that sees nothing), NEG_INF where the mask hides it
__device__ __forceinline__ float masked(float x, int jk, bool visible,
                                       int s_pad) {
  return jk >= s_pad ? -INFINITY : (visible ? x : kNegInf);
}

// ---------------------------------------------------------------- K7
// Block (query tile, kv head, b): 64 rows, row r = g R + i holds query
// position t0 + i of head kvh G + g (R = 64 / G). Thread (ty, tx) of a
// 16 x 16 grid owns rows ty + 16 u (u < 4): their logits at keys tx + 16 v
// of each chunk, and their accumulator columns 16 Epv w + Epv tx + e.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  using C = Chunk<T>;
  constexpr int BC = C::kBC, EPV = C::kEpv, RS = C::kRowStride;
  constexpr int NV = BC / 16;          // logit columns per thread
  constexpr int NW = kHd / 16 / EPV;   // accumulator granules per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + (size_t)p.slots * C::kElems * sizeof(T));
  float* p_s = q_s + kRows * kHd;      // (64, BC) probabilities

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_qt = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int qt = n_qt - 1 - blockIdx.x;          // heaviest tiles first
  const int G = p.G, R = kRows / G, T_ = p.T, S = p.S;
  const int t0 = qt * R;
  const int H = p.K * G;

  // q tile to fp32 shared memory (rows past T are zero and never stored)
  const T* q = static_cast<const T*>(p.q);
  for (int e = tid; e < kRows * kHd; e += kThreads) {
    const int r = e / kHd, dd = e - r * kHd;
    const int g = r / R, t = t0 + r - g * R;
    q_s[e] = t < T_ ? to_f32(q[(((size_t)b * H + kvh * G + g) * T_ + t) * kHd + dd])
                    : 0.f;
  }

  // the keys this tile's rows can see; a row that sees none needs them all
  const int off = S - T_;
  const int rows = min(R, T_ - t0);
  int lo = S, hi = 0;
  bool empty = false;
  for (int i = 0; i < rows; ++i) {
    const int iq = t0 + i + off;
    const int rlo = p.window > 0 ? max(0, iq - p.window + 1) : 0;
    const int rhi = p.causal ? min(S, iq + 1) : S;
    if (rlo >= rhi) {
      empty = true;
    } else {
      lo = min(lo, rlo);
      hi = max(hi, rhi);
    }
  }
  int c0 = lo / BC, c1 = (hi + BC - 1) / BC;
  if (empty) {
    c0 = 0;
    c1 = (p.s_pad + BC - 1) / BC;
  }

  int iq[4];
  float m[4], l[4], acc[4][NW * EPV];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty + 16 * u;
    iq[u] = t0 + (r % R) + off;
    m[u] = kNegInf;
    l[u] = 0.f;
#pragma unroll
    for (int c = 0; c < NW * EPV; ++c) acc[u][c] = 0.f;
  }

  const size_t head = ((size_t)b * p.K + kvh) * S * kHd;
  const T* kh = static_cast<const T*>(p.k) + head;
  const T* vh = static_cast<const T*>(p.v) + head;
  __syncthreads();  // q_s complete

  stream_chunks<T>(p, ring, kh, vh, c0, c1 - c0, [&](const T* slot, int c) {
    const T* sk = slot;
    const T* sv = slot + BC * RS;
    float s[4][NV];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < NV; ++v) s[u][v] = 0.f;
    for (int d0 = 0; d0 < kHd; d0 += EPV) {
      float kf[NV][EPV], qf[4][EPV];
#pragma unroll
      for (int v = 0; v < NV; ++v) load16<T>(sk + (tx + 16 * v) * RS + d0, kf[v]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < EPV; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              q_s + (ty + 16 * u) * kHd + d0 + e);
          qf[u][e] = x.x;
          qf[u][e + 1] = x.y;
          qf[u][e + 2] = x.z;
          qf[u][e + 3] = x.w;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < EPV; ++e) s[u][v] = fmaf(qf[u][e], kf[v][e], s[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float bmax = -INFINITY;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int jk = c * BC + tx + 16 * v;
        bool vis = jk < S;
        if (p.causal) vis = vis && jk <= iq[u];
        if (p.window > 0) vis = vis && jk > iq[u] - p.window;
        s[u][v] = masked(cap(s[u][v] * p.scale, p.softcap), jk, vis, p.s_pad);
        bmax = fmaxf(bmax, s[u][v]);
      }
      // the 16 threads of a row are one half warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
      const float new_m = fmaxf(m[u], bmax);
      const float corr = expf(m[u] - new_m);
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float pj = expf(s[u][v] - new_m);
        p_s[(ty + 16 * u) * BC + tx + 16 * v] = pj;
        sum += pj;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      m[u] = new_m;
      l[u] = l[u] * corr + sum;
#pragma unroll
      for (int c2 = 0; c2 < NW * EPV; ++c2) acc[u][c2] *= corr;
    }
    __syncthreads();  // p_s complete
#pragma unroll 2
    for (int j = 0; j < BC; ++j) {
      float pj[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) pj[u] = p_s[(ty + 16 * u) * BC + j];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        float vf[EPV];
        load16<T>(sv + j * RS + w * 16 * EPV + tx * EPV, vf);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < EPV; ++e)
            acc[u][w * EPV + e] = fmaf(pj[u], vf[e], acc[u][w * EPV + e]);
      }
    }
  });

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty + 16 * u, g = r / R, t = t0 + r - g * R;
    if (t >= T_) continue;
    const float inv = 1.f / fmaxf(l[u], 1e-30f);
    T* orow = out + (((size_t)b * H + kvh * G + g) * T_ + t) * kHd;
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        orow[w * 16 * EPV + tx * EPV + e] = from_f32<T>(acc[u][w * EPV + e] * inv);
  }
}

// ---------------------------------------------------------------- K6
// Block (segment, kv head, b): the G query heads of kv head kvh over the
// chunks of one segment. Logits: TPK = 256 / BC threads per key, each with
// its own granules of the row; softmax: one warp per head; values: thread
// e owns accumulator entries e + 256 i of the (G, hd) tile.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(Params p) {
  using C = Chunk<T>;
  constexpr int BC = C::kBC, EPV = C::kEpv, RS = C::kRowStride;
  constexpr int TPK = kThreads / BC;            // threads per key
  constexpr int NK = kHd / (TPK * EPV);         // granules per thread
  constexpr int MAXE = kMaxG * kHd / kThreads;  // accumulator entries
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + (size_t)p.slots * C::kElems * sizeof(T));
  float* s_s = q_s + p.G * kHd;    // (G, BC) logits, then probabilities
  float* m_s = s_s + p.G * BC;
  float* l_s = m_s + p.G;
  float* c_s = l_s + p.G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.G, S = p.S, length = p.lengths[b];
  const size_t part = ((size_t)b * p.K + kvh) * p.n_seg + seg;

  // chunks of this segment that hold a visible key; with none visible in
  // the whole row (length 0) every chunk of the padded stream
  const int n_chunks = (p.s_pad + BC - 1) / BC;
  const int vis_chunks = length > 0 ? min((length + BC - 1) / BC, n_chunks)
                                    : n_chunks;
  const int c0 = seg * p.seg_chunks;
  const int c1 = min(c0 + p.seg_chunks, vis_chunks);
  if (c0 >= c1) {  // nothing here: a segment that weighs 0 in the merge
    for (int e = tid; e < G * kHd; e += kThreads) p.part_acc[part * G * kHd + e] = 0.f;
    if (tid < G) {
      p.part_m[part * G + tid] = -INFINITY;
      p.part_l[part * G + tid] = 0.f;
    }
    return;
  }

  const T* q = static_cast<const T*>(p.q) + ((size_t)b * p.K + kvh) * G * kHd;
  for (int e = tid; e < G * kHd; e += kThreads) q_s[e] = to_f32(q[e]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) acc[i] = 0.f;

  const size_t head = ((size_t)b * p.K + kvh) * S * kHd;
  const T* kh = static_cast<const T*>(p.k) + head;
  const T* vh = static_cast<const T*>(p.v) + head;
  __syncthreads();  // q_s, m_s, l_s set

  stream_chunks<T>(p, ring, kh, vh, c0, c1 - c0, [&](const T* slot, int c) {
    const T* sk = slot;
    const T* sv = slot + BC * RS;
    {  // logits (G, BC)
      const int j = tid / TPK, part_k = tid % TPK;
      float kf[NK * EPV];
#pragma unroll
      for (int i = 0; i < NK; ++i)
        load16<T>(sk + j * RS + (i * TPK + part_k) * EPV, kf + i * EPV);
      const int jk = c * BC + j;
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          const float* qg = q_s + g * kHd + (i * TPK + part_k) * EPV;
#pragma unroll
          for (int e = 0; e < EPV; ++e) dot = fmaf(qg[e], kf[i * EPV + e], dot);
        }
#pragma unroll
        for (int o = TPK / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (part_k == 0)
          s_s[g * BC + j] =
              masked(cap(dot * p.scale, p.softcap), jk, jk < length, p.s_pad);
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // online softmax, one warp a head
      float x[BC / 32], bmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < BC / 32; ++i) {
        x[i] = s_s[g * BC + lane + 32 * i];
        bmax = fmaxf(bmax, x[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
      const float m = m_s[g], new_m = fmaxf(m, bmax);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BC / 32; ++i) {
        const float pj = expf(x[i] - new_m);
        s_s[g * BC + lane + 32 * i] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m - new_m);
        m_s[g] = new_m;
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXE; ++i) {
      const int e = tid + kThreads * i;
      if (e < G * kHd) {
        const int g = e / kHd, col = e - g * kHd;
        float pv = 0.f;
        for (int j = 0; j < BC; ++j)
          pv = fmaf(s_s[g * BC + j], to_f32(sv[j * RS + col]), pv);
        acc[i] = acc[i] * c_s[g] + pv;
      }
    }
  });

#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + kThreads * i;
    if (e < G * kHd) p.part_acc[part * G * kHd + e] = acc[i];
  }
  if (tid < G) {
    p.part_m[part * G + tid] = m_s[tid];
    p.part_l[part * G + tid] = l_s[tid];
  }
}

// The merge of K6's segments, block (kv head, b): out = sum_s acc_s
// e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30) with M = max_s m_s.
template <typename T>
__global__ void __launch_bounds__(kThreads) merge_kernel(Params p) {
  const int kvh = blockIdx.x, b = blockIdx.y, G = p.G;
  const size_t part0 = ((size_t)b * p.K + kvh) * p.n_seg;
  T* out = static_cast<T*>(p.out) + ((size_t)b * p.K + kvh) * G * kHd;
  for (int e = threadIdx.x; e < G * kHd; e += kThreads) {
    const int g = e / kHd;
    float M = -INFINITY;
    for (int s = 0; s < p.n_seg; ++s) M = fmaxf(M, p.part_m[(part0 + s) * G + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < p.n_seg; ++s) {
      const float w = expf(p.part_m[(part0 + s) * G + g] - M);
      L += p.part_l[(part0 + s) * G + g] * w;
      A += p.part_acc[(part0 + s) * G * kHd + e] * w;
    }
    out[e] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

template <typename T>
int smem_needed(const Params& p, bool decode) {
  const int aux = decode ? (p.G * kHd + p.G * Chunk<T>::kBC + 3 * p.G) * 4
                         : (kRows * kHd + kRows * Chunk<T>::kBC) * 4;
  return p.slots * Chunk<T>::kElems * (int)sizeof(T) + aux;
}

template <typename T>
int launch_flash(const Params& p, int B, int smem_bytes, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (smem_bytes < smem_needed<T>(p, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = kRows / p.G;
  const dim3 grid((p.T + R - 1) / R, p.K, B);
  flash_kernel<T><<<grid, kThreads, smem_bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_decode(const Params& p, int B, int smem_bytes, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (smem_bytes < smem_needed<T>(p, true))
    return static_cast<int>(cudaErrorInvalidValue);
  decode_kernel<T><<<dim3(p.n_seg, p.K, B), kThreads, smem_bytes, s>>>(p);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  merge_kernel<T><<<dim3(p.K, B), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool common_ok(const void* q, const void* k, const void* v, int dtype, int hd,
               int S, int s_pad, int distance, int slots, int sequential,
               int smem_bytes) {
  return (dtype == 0 || dtype == 1) && hd == kHd && S >= 1 && s_pad >= S &&
         reinterpret_cast<uintptr_t>(q) % kGranule == 0 &&
         reinterpret_cast<uintptr_t>(k) % kGranule == 0 &&
         reinterpret_cast<uintptr_t>(v) % kGranule == 0 &&
         ring_ok(distance, slots, sequential, smem_bytes);
}

}  // namespace

extern "C" {

// K7: out (B, H, T, hd) = attention of q (B, H, T, hd) over k, v
// (B, K, S, hd), H = K G with 64 % G == 0, hd = 128; f32 (dtype 0) or bf16
// (1) throughout. s_pad: the TPU kernel's padded stream, ceil(S / bs) bs.
int pul_flash_attention(const void* q, const void* k, const void* v, void* out,
                        int B, int K, int G, int T, int S, int hd, int s_pad,
                        int causal, int window, float scale, float softcap,
                        int distance, int slots, int sequential, int dtype,
                        int smem_bytes, void* stream) {
  if (!common_ok(q, k, v, dtype, hd, S, s_pad, distance, slots, sequential,
                 smem_bytes) ||
      B < 1 || K < 1 || G < 1 || kRows % G || T < 1 || B > 65535 ||
      K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.K = K;
  p.G = G;
  p.T = T;
  p.S = S;
  p.s_pad = s_pad;
  p.scale = scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_flash<float>(p, B, smem_bytes, s)
                    : launch_flash<bf16>(p, B, smem_bytes, s);
}

// K6: out (B, H, hd) = attention of q (B, H, hd), one token per head, over
// the first lengths[b] rows of k, v (B, K, S, hd); H = K G with G <= 16,
// hd = 128; f32 (dtype 0) or bf16 (1). The keys are cut into n_seg
// segments of seg_chunks ring chunks; part_m / part_l (B, K, n_seg, G) and
// part_acc (B, K, n_seg, G, hd) are fp32 scratch for the merge.
int pul_decode_attention(const void* q, const void* k, const void* v,
                         const int* lengths, void* out, float* part_m,
                         float* part_l, float* part_acc, int B, int K, int G,
                         int S, int hd, int s_pad, float scale, float softcap,
                         int seg_chunks, int n_seg, int distance, int slots,
                         int sequential, int dtype, int smem_bytes,
                         void* stream) {
  const int bc = dtype == 0 ? Chunk<float>::kBC : Chunk<bf16>::kBC;
  if (!common_ok(q, k, v, dtype, hd, S, s_pad, distance, slots, sequential,
                 smem_bytes) ||
      B < 1 || K < 1 || G < 1 || G > kMaxG || seg_chunks < 1 ||
      (long long)n_seg * seg_chunks * bc < s_pad || B > 65535 || K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lengths = lengths;
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.K = K;
  p.G = G;
  p.T = 1;
  p.S = S;
  p.s_pad = s_pad;
  p.scale = scale;
  p.softcap = softcap;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  p.seg_chunks = seg_chunks;
  p.n_seg = n_seg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_decode<float>(p, B, smem_bytes, s)
                    : launch_decode<bf16>(p, B, smem_bytes, s);
}

}  // extern "C"
