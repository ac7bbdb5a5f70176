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
// Every kernel is an online softmax over KV chunks streamed through the same
// shared-memory ring (stream_chunks below), templated on the head dim, hd in
// {16, 32, 64, 112, 128, 256}: every hd of the reference's tests and of the
// model zoo. The TPU kernels' constants are kept: masked logits are
// NEG_INF = -2e38 (finite), and l >= 1e-30 at the end.
//
// Bounds on this card. K7 is bound by operations: 4 hd flops per visible
// (query, key) pair, 137 GFLOP for the causal 4096^2 qwen3 prefill (B 2,
// H 16), 0.139 ms at the 989 TFLOP/s of bf16 tensor cores. K6 is bound by
// bytes: the K and V rows of the visible positions, read once (4 G hd flops
// per 4 hd bytes of bf16 K/V).
//
// K7 has two bodies, chosen by the element type:
//   * bf16: flash_tc_kernel, the FA2 structure on the tensor cores
//     (mma.sync m16n8k16, bf16 in, fp32 accumulate). A block is 128 rows, 8
//     warps of 16; each warp holds its Q fragments in registers (hd <= 128;
//     at hd 256 it reloads them from shared memory by ldmatrix, so that the
//     16 x 256 fp32 O tile keeps its 128 registers), gets S = Q K^T of a
//     chunk in registers (K fragments by ldmatrix from the ring slot),
//     applies scale, softcap, mask and the online max / sum with quad
//     shuffles (in base-2 units, so that exp is one ex2; O is rescaled only
//     where a row's maximum moved), packs P to bf16 in the S accumulator's
//     own layout, which is the m16n8k16 A layout, and accumulates O += P V
//     with V fragments by ldmatrix.trans. P rounded to bf16 is the one
//     rounding the f32 body does not have; l sums the rounded P, so O stays
//     a convex combination of V rows. The chunk is 64 keys (32 at hd 256,
//     for registers);
//   * f32: flash_kernel, fp32 FMAs on the CUDA cores (no TF32): 64 rows over
//     256 threads as a 16 x 16 grid, q and the chunk's probabilities in fp32
//     shared memory, the accumulator in registers, chunks of 32 keys.
// K6 (decode_kernel) does its few flops per byte as fp32 FMAs in both types.
//
// What the design does about the bounds:
//   * GQA: a block holds the queries of all G heads of one kv head, so each
//     KV chunk crosses HBM once per kv head, not once per query head. K7's
//     rows are the flattened (position, head) pairs of those G heads: row r
//     of the (T G) rows is position r / G of head r % G, each with its own
//     mask, so any G works; K6's block is the G heads of one token;
//   * the ring (core/pipeline.py PreloadStream / pul_loop, pul_ring.cuh): a
//     chunk of BC keys, BC rows of K then of V, is copied by 16-byte
//     cp.async into slot c % slots, `distance` chunks ahead of the compute.
//     BATCH issues chunk i + d after computing chunk i, SEQUENTIAL before
//     it. Rows past S are zero-filled, as the TPU's padding of the stream.
//     Each row carries one spare 16-byte granule, so that the eight rows
//     ldmatrix (or eight threads) read at once hit eight bank groups;
//   * tiles: the TPU kernel holds a (bt, hd) q tile, a (bt, hd) fp32
//     accumulator and (bt, bs) logits in VMEM; at bt = bs = hd = 128 that is
//     192 KB before any ring slot. Here the accumulator lives in registers,
//     and the host's attention_tc_plan (bf16) and attention_ring_plan (f32)
//     fit q and the ring's slots into 227 KB at each hd;
//   * blocks skip the chunks that no row of theirs can see: above the
//     causal diagonal, before the window, past length[b]. Those add nothing
//     (p = exp(NEG_INF - m) = 0 after a visible key, and before one the
//     first visible key's corr = exp(NEG_INF - m) = 0 cancels them), so
//     skipping them changes no value. A row that sees no key at all (K6's
//     length 0; K7's rows with iq < 0 when T > S) gets the TPU kernel's
//     value: every logit NEG_INF, p = 1 over the whole padded stream of
//     s_pad = ceil(S / bs) bs positions, the sum of the v rows over s_pad.
//     A block holding such a row streams every chunk; positions past s_pad
//     (inside the last chunk) take -inf, so p = 0 there. The bf16 body skips
//     the mask of a chunk that every row of its block sees whole;
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

#include "pul_hopper.cuh"
#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGranule = 16;
constexpr int kRows = 64;        // K7 f32: query rows of one block
constexpr int kTcRows = 128;     // K7 bf16: query rows of one block
constexpr int kMaxG = 16;        // K6: query heads of one kv head
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// A ring slot: BC keys of K, then BC keys of V, each row of hd values
// padded by one 16-byte granule.
template <typename T, int HD, int BC>
struct Ring {
  using Elem = T;
  static constexpr int kHd = HD;
  static constexpr int kEpv = kGranule / sizeof(T);  // values per granule
  static constexpr int kBC = BC;
  static constexpr int kRowStride = HD + kEpv;
  static constexpr int kElems = 2 * BC * kRowStride;
};

// the chunk of K6 and of K7's f32 body: 64 bf16 or 32 f32 keys
template <typename T, int HD>
using Chunk = Ring<T, HD, sizeof(T) == 2 ? 64 : 32>;
// the chunk of K7's bf16 body: 64 keys, 32 at hd 256 (registers)
template <int HD>
using TcChunk = Ring<bf16, HD, HD == 256 ? 32 : 64>;

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
template <class C>
__device__ __forceinline__ void copy_chunk(typename C::Elem* slot,
                                           const typename C::Elem* kh,
                                           const typename C::Elem* vh, int c,
                                           int S) {
  constexpr int per_row = C::kHd / C::kEpv;
  typename C::Elem* sk = slot;
  typename C::Elem* sv = slot + C::kBC * C::kRowStride;
  for (int e = threadIdx.x; e < C::kBC * per_row; e += kThreads) {
    const int r = e / per_row, g = e - r * per_row;
    const int jk = c * C::kBC + r;
    const bool ok = jk < S;
    const size_t off = (size_t)(ok ? jk : 0) * C::kHd + g * C::kEpv;
    cp_async16_zfill(sk + r * C::kRowStride + g * C::kEpv, kh + off, ok);
    cp_async16_zfill(sv + r * C::kRowStride + g * C::kEpv, vh + off, ok);
  }
}

// The PUL loop over chunks [c0, c0 + n): chunk c0 + i in slot i % slots,
// `distance` chunks in flight. compute(slot, c) runs between two barriers.
template <class C, class Compute>
__device__ __forceinline__ void stream_chunks(const Params& p,
                                              typename C::Elem* ring,
                                              const typename C::Elem* kh,
                                              const typename C::Elem* vh,
                                              int c0, int n, Compute compute) {
  const int d = p.distance;
  auto issue = [&](int i) {
    if (i < n)
      copy_chunk<C>(ring + (size_t)(i % p.slots) * C::kElems, kh, vh, c0 + i,
                    p.S);
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
    compute(ring + (size_t)(i % p.slots) * C::kElems, c0 + i);
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

__device__ __forceinline__ bool visible(const Params& p, int jk, int iq) {
  bool vis = jk < p.S;
  if (p.causal) vis = vis && jk <= iq;
  if (p.window > 0) vis = vis && jk > iq - p.window;
  return vis;
}

// The chunks [c0, c1) of BC keys that the positions [t_first, t_last] of a
// K7 block can see; a row that sees none needs every chunk of the padded
// stream. full_lo / full_hi: the keys every one of those rows sees.
struct KeyRange {
  int c0, c1, full_lo, full_hi;
};

__device__ __forceinline__ KeyRange key_range(const Params& p, int t_first,
                                              int t_last, int BC) {
  const int off = p.S - p.T, S = p.S;
  int lo = S, hi = 0;
  bool empty = false;
  for (int t = t_first; t <= t_last; ++t) {
    const int iq = t + off;
    const int rlo = p.window > 0 ? max(0, iq - p.window + 1) : 0;
    const int rhi = p.causal ? min(S, iq + 1) : S;
    if (rlo >= rhi) {
      empty = true;
    } else {
      lo = min(lo, rlo);
      hi = max(hi, rhi);
    }
  }
  KeyRange r;
  r.c0 = lo / BC;
  r.c1 = (hi + BC - 1) / BC;
  if (empty) {
    r.c0 = 0;
    r.c1 = (p.s_pad + BC - 1) / BC;
  }
  const int iq_first = t_first + off, iq_last = t_last + off;
  r.full_lo = p.window > 0 ? max(0, iq_last - p.window + 1) : 0;
  r.full_hi = p.causal ? min(S, iq_first + 1) : S;
  return r;
}

// ------------------------------------------------------- K7, bf16 body
// Block (row tile, kv head, b): the flattened rows [row0, row0 + 128) of
// the T G (position, head) rows of kv head kvh; warp w owns rows 16 w ..
// 16 w + 15, lane l rows 16 w + l / 4 (fragment half 0) and + 8 (half 1).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_tc_kernel(Params p) {
  using C = TcChunk<HD>;
  constexpr int BC = C::kBC, RS = C::kRowStride;
  constexpr int NS = BC / 8;    // S n-tiles of 8 keys
  constexpr int NO = HD / 8;    // O n-tiles of 8 dims
  constexpr int KQ = HD / 16;   // k-steps of Q K^T
  constexpr bool kQInRegs = HD <= 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* q_s = ring + (size_t)p.slots * C::kElems;  // (kTcRows, RS)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int G = p.G, T_ = p.T, H = p.K * G;
  const int row0 = qt * kTcRows, off = p.S - T_;

  // q rows to shared memory; rows past T G are zero and never stored
  const bf16* q = static_cast<const bf16*>(p.q);
  constexpr int GPR = HD / 8;  // granules of a row
  for (int e = tid; e < kTcRows * GPR; e += kThreads) {
    const int r = e / GPR, gi = e - r * GPR;
    const int gr = row0 + r, t = gr / G, g = gr - t * G;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_)
      x = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * H + kvh * G + g) * T_ + t) * HD + gi * 8);
    *reinterpret_cast<uint4*>(q_s + r * RS + gi * 8) = x;
  }

  const int t_first = row0 / G;
  const int t_last = min(T_ - 1, (row0 + kTcRows - 1) / G);
  const KeyRange kr = key_range(p, t_first, t_last, BC);

  int iq[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + warp * 16 + lane / 4 + 8 * h;
    iq[h] = gr / G + off;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const float scale2 = p.scale * kLog2e;
  const size_t head = ((size_t)b * p.K + kvh) * p.S * HD;
  const bf16* kh = static_cast<const bf16*>(p.k) + head;
  const bf16* vh = static_cast<const bf16*>(p.v) + head;
  // this lane's row of the ldmatrix loads of Q (A: rows l % 16, columns
  // + 8 (l / 16)), of K (B: keys + 8 (l / 16) + l % 8, dims + 8 ((l / 8) %
  // 2)) and of V (B trans: keys + 8 ((l / 8) % 2) + l % 8, dims + 8 (l / 16))
  const bf16* q_lane = q_s + (warp * 16 + lane % 16) * RS + (lane / 16) * 8;
  const int k_row = (lane / 16) * 8 + lane % 8, k_col = ((lane / 8) % 2) * 8;
  const int v_row = ((lane / 8) % 2) * 8 + lane % 8, v_col = (lane / 16) * 8;
  __syncthreads();  // q_s complete

  uint32_t qf[kQInRegs ? KQ : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) ldmatrix_x4(qf[ks], q_lane + ks * 16);
  }

  stream_chunks<C>(p, ring, kh, vh, kr.c0, kr.c1 - kr.c0,
                   [&](const bf16* slot, int c) {
    const bf16* sk = slot;
    const bf16* sv = slot + BC * RS;
    // S = Q K^T over the chunk
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldmatrix_x4(a, q_lane + ks * 16);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, sk + (np * 16 + k_row) * RS + ks * 16 + k_col);
        mma_bf16_16816(s[2 * np], a, kb[0], kb[1]);
        mma_bf16_16816(s[2 * np + 1], a, kb[2], kb[3]);
      }
    }
    // scale, softcap, mask, in base-2 units (the logit times log2 e, so
    // that exp is one ex2); the online max over the quad's columns
    const bool whole = c * BC >= kr.full_lo && c * BC + BC <= kr.full_hi;
    float mx[2] = {-INFINITY, -INFINITY};
    auto logits = [&](auto capped) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, jk = c * BC + 8 * n + 2 * (lane % 4) + e % 2;
          float x;
          if constexpr (decltype(capped)::value)
            x = cap(s[n][e] * p.scale, p.softcap) * kLog2e;
          else
            x = s[n][e] * scale2;
          if (!whole) x = masked(x, jk, visible(p, jk, iq[h]), p.s_pad);
          s[n][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
    };
    if (p.softcap > 0.f)
      logits(std::true_type{});
    else
      logits(std::false_type{});
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float new_m = fmaxf(m[h], mx[h]);
      corr[h] = fast_exp2(m[h] - new_m);
      m[h] = new_m;
      l[h] *= corr[h];
    }
    // O is rescaled only where a row's maximum moved
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= corr[e / 2];
    }
    // P = exp(S - m) rounded to bf16, in the A layout of P V; l sums the
    // rounded values
    uint32_t pa[NS / 2][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 pb =
            __floats2bfloat162_rn(fast_exp2(s[n][2 * h] - m[h]),
                                  fast_exp2(s[n][2 * h + 1] - m[h]));
        const float2 pf = __bfloat1622float2(pb);
        l[h] += pf.x + pf.y;
        pa[n / 2][h + 2 * (n % 2)] = *reinterpret_cast<const uint32_t*>(&pb);
      }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sv + (kk * 16 + v_row) * RS + dp * 16 + v_col);
        mma_bf16_16816(o[2 * dp], pa[kk], vb[0], vb[1]);
        mma_bf16_16816(o[2 * dp + 1], pa[kk], vb[2], vb[3]);
      }
  });

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int gr = row0 + warp * 16 + lane / 4 + 8 * h;
    const int t = gr / G, g = gr - t * G;
    if (t >= T_) continue;
    const float inv = 1.f / fmaxf(lh, 1e-30f);
    bf16* orow = out + (((size_t)b * H + kvh * G + g) * T_ + t) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
  }
}

// -------------------------------------------------------- K7, f32 body
// Block (row tile, kv head, b): the flattened rows [row0, row0 + 64) of the
// T G (position, head) rows of kv head kvh. Thread (ty, tx) of a 16 x 16
// grid owns rows ty + 16 u (u < 4): their logits at keys tx + 16 v of each
// chunk, and their accumulator granules tx + 16 w (of the row's HD / EPV).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  using C = Chunk<T, HD>;
  constexpr int BC = C::kBC, EPV = C::kEpv, RS = C::kRowStride;
  constexpr int NV = BC / 16;                // logit columns per thread
  constexpr int GR = HD / EPV;               // granules of a row
  constexpr int NW = (GR + 15) / 16;         // accumulator granules per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + (size_t)p.slots * C::kElems * sizeof(T));
  float* p_s = q_s + kRows * HD;             // (64, BC) probabilities

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int G = p.G, T_ = p.T, H = p.K * G;
  const int row0 = qt * kRows, off = p.S - T_;

  // q tile to fp32 shared memory (rows past T G are zero and never stored)
  const T* q = static_cast<const T*>(p.q);
  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, dd = e - r * HD;
    const int gr = row0 + r, t = gr / G, g = gr - t * G;
    q_s[e] = t < T_ ? to_f32(q[(((size_t)b * H + kvh * G + g) * T_ + t) * HD + dd])
                    : 0.f;
  }

  const int t_first = row0 / G;
  const int t_last = min(T_ - 1, (row0 + kRows - 1) / G);
  const KeyRange kr = key_range(p, t_first, t_last, BC);

  int iq[4];
  float m[4], l[4], acc[4][NW * EPV];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    iq[u] = (row0 + ty + 16 * u) / G + off;
    m[u] = kNegInf;
    l[u] = 0.f;
#pragma unroll
    for (int c = 0; c < NW * EPV; ++c) acc[u][c] = 0.f;
  }

  const size_t head = ((size_t)b * p.K + kvh) * p.S * HD;
  const T* kh = static_cast<const T*>(p.k) + head;
  const T* vh = static_cast<const T*>(p.v) + head;
  __syncthreads();  // q_s complete

  stream_chunks<C>(p, ring, kh, vh, kr.c0, kr.c1 - kr.c0,
                   [&](const T* slot, int c) {
    const T* sk = slot;
    const T* sv = slot + BC * RS;
    float s[4][NV];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < NV; ++v) s[u][v] = 0.f;
    for (int d0 = 0; d0 < HD; d0 += EPV) {
      float kf[NV][EPV], qf[4][EPV];
#pragma unroll
      for (int v = 0; v < NV; ++v) load16<T>(sk + (tx + 16 * v) * RS + d0, kf[v]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < EPV; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              q_s + (ty + 16 * u) * HD + d0 + e);
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
        s[u][v] = masked(cap(s[u][v] * p.scale, p.softcap), jk,
                         visible(p, jk, iq[u]), p.s_pad);
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
        if (tx + 16 * w >= GR) continue;
        float vf[EPV];
        load16<T>(sv + j * RS + (tx + 16 * w) * EPV, vf);
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
    const int gr = row0 + ty + 16 * u, t = gr / G, g = gr - t * G;
    if (t >= T_) continue;
    const float inv = 1.f / fmaxf(l[u], 1e-30f);
    T* orow = out + (((size_t)b * H + kvh * G + g) * T_ + t) * HD;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (tx + 16 * w >= GR) continue;
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        orow[(tx + 16 * w) * EPV + e] = from_f32<T>(acc[u][w * EPV + e] * inv);
    }
  }
}

// ---------------------------------------------------------------- K6
// Block (segment, kv head, b): the G query heads of kv head kvh over the
// chunks of one segment. Logits: TPK threads per key, each with its own
// granules of the row; softmax: one warp per head; values: thread e owns
// accumulator entries e + 256 i of the (G, hd) tile.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_kernel(Params p) {
  using C = Chunk<T, HD>;
  constexpr int BC = C::kBC, EPV = C::kEpv, RS = C::kRowStride;
  constexpr int GR = HD / EPV;                          // granules of a row
  constexpr int TPK = GR < kThreads / BC ? GR : kThreads / BC;  // threads per key
  constexpr int NK = (GR + TPK - 1) / TPK;              // granules per thread
  constexpr int MAXE = (kMaxG * HD + kThreads - 1) / kThreads;  // accumulator entries
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + (size_t)p.slots * C::kElems * sizeof(T));
  float* s_s = q_s + p.G * HD;     // (G, BC) logits, then probabilities
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
    for (int e = tid; e < G * HD; e += kThreads) p.part_acc[part * G * HD + e] = 0.f;
    if (tid < G) {
      p.part_m[part * G + tid] = -INFINITY;
      p.part_l[part * G + tid] = 0.f;
    }
    return;
  }

  const T* q = static_cast<const T*>(p.q) + ((size_t)b * p.K + kvh) * G * HD;
  for (int e = tid; e < G * HD; e += kThreads) q_s[e] = to_f32(q[e]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) acc[i] = 0.f;

  const size_t head = ((size_t)b * p.K + kvh) * S * HD;
  const T* kh = static_cast<const T*>(p.k) + head;
  const T* vh = static_cast<const T*>(p.v) + head;
  __syncthreads();  // q_s, m_s, l_s set

  stream_chunks<C>(p, ring, kh, vh, c0, c1 - c0, [&](const T* slot, int c) {
    const T* sk = slot;
    const T* sv = slot + BC * RS;
    const int j = tid / TPK, part_k = tid % TPK;
    if (j < BC) {  // logits (G, BC); whole warps sit out where TPK BC < 256
      float kf[NK * EPV];
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        if (i * TPK + part_k < GR)
          load16<T>(sk + j * RS + (i * TPK + part_k) * EPV, kf + i * EPV);
        else
#pragma unroll
          for (int e = 0; e < EPV; ++e) kf[i * EPV + e] = 0.f;
      }
      const int jk = c * BC + j;
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          if (i * TPK + part_k >= GR) continue;
          const float* qg = q_s + g * HD + (i * TPK + part_k) * EPV;
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
      if (e < G * HD) {
        const int g = e / HD, col = e - g * HD;
        float pv = 0.f;
        for (int j2 = 0; j2 < BC; ++j2)
          pv = fmaf(s_s[g * BC + j2], to_f32(sv[j2 * RS + col]), pv);
        acc[i] = acc[i] * c_s[g] + pv;
      }
    }
  });

#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + kThreads * i;
    if (e < G * HD) p.part_acc[part * G * HD + e] = acc[i];
  }
  if (tid < G) {
    p.part_m[part * G + tid] = m_s[tid];
    p.part_l[part * G + tid] = l_s[tid];
  }
}

// The merge of K6's segments, block (kv head, b): out = sum_s acc_s
// e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30) with M = max_s m_s.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) merge_kernel(Params p) {
  const int kvh = blockIdx.x, b = blockIdx.y, G = p.G;
  const size_t part0 = ((size_t)b * p.K + kvh) * p.n_seg;
  T* out = static_cast<T*>(p.out) + ((size_t)b * p.K + kvh) * G * HD;
  for (int e = threadIdx.x; e < G * HD; e += kThreads) {
    const int g = e / HD;
    float M = -INFINITY;
    for (int s = 0; s < p.n_seg; ++s) M = fmaxf(M, p.part_m[(part0 + s) * G + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < p.n_seg; ++s) {
      const float w = expf(p.part_m[(part0 + s) * G + g] - M);
      L += p.part_l[(part0 + s) * G + g] * w;
      A += p.part_acc[(part0 + s) * G * HD + e] * w;
    }
    out[e] = from_f32<T>(A / fmaxf(L, 1e-30f));
  }
}

// ------------------------------------------------------------ launchers
// the opt-in to the full 227 KB, once per kernel
template <typename KernelFn>
cudaError_t allow_full_smem(KernelFn* kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
}

template <int HD>
int launch_flash_tc(const Params& p, int B, int smem_bytes, cudaStream_t s) {
  static const cudaError_t attr = allow_full_smem(flash_tc_kernel<HD>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  using C = TcChunk<HD>;
  if (smem_bytes < (p.slots * C::kElems + kTcRows * C::kRowStride) * 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.T * p.G + kTcRows - 1) / kTcRows, p.K, B);
  flash_tc_kernel<HD><<<grid, kThreads, smem_bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_flash_f32(const Params& p, int B, int smem_bytes, cudaStream_t s) {
  static const cudaError_t attr = allow_full_smem(flash_kernel<float, HD>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  using C = Chunk<float, HD>;
  if (smem_bytes < p.slots * C::kElems * 4 + (kRows * HD + kRows * C::kBC) * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.T * p.G + kRows - 1) / kRows, p.K, B);
  flash_kernel<float, HD><<<grid, kThreads, smem_bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_flash(const Params& p, int B, int dtype, int smem_bytes,
                 cudaStream_t s) {
  return dtype == 0 ? launch_flash_f32<HD>(p, B, smem_bytes, s)
                    : launch_flash_tc<HD>(p, B, smem_bytes, s);
}

template <typename T, int HD>
int launch_decode_t(const Params& p, int B, int smem_bytes, cudaStream_t s) {
  static const cudaError_t attr = allow_full_smem(decode_kernel<T, HD>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  using C = Chunk<T, HD>;
  const int aux = (p.G * HD + p.G * C::kBC + 3 * p.G) * 4;
  if (smem_bytes < p.slots * C::kElems * (int)sizeof(T) + aux)
    return static_cast<int>(cudaErrorInvalidValue);
  decode_kernel<T, HD><<<dim3(p.n_seg, p.K, B), kThreads, smem_bytes, s>>>(p);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  merge_kernel<T, HD><<<dim3(p.K, B), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_decode(const Params& p, int B, int dtype, int smem_bytes,
                  cudaStream_t s) {
  return dtype == 0 ? launch_decode_t<float, HD>(p, B, smem_bytes, s)
                    : launch_decode_t<bf16, HD>(p, B, smem_bytes, s);
}

int flash_for_hd(const Params& p, int B, int hd, int dtype, int smem_bytes,
                 cudaStream_t s) {
  switch (hd) {
    case 16: return launch_flash<16>(p, B, dtype, smem_bytes, s);
    case 32: return launch_flash<32>(p, B, dtype, smem_bytes, s);
    case 64: return launch_flash<64>(p, B, dtype, smem_bytes, s);
    case 112: return launch_flash<112>(p, B, dtype, smem_bytes, s);
    case 128: return launch_flash<128>(p, B, dtype, smem_bytes, s);
    case 256: return launch_flash<256>(p, B, dtype, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool hd_ok(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 112 || hd == 128 ||
         hd == 256;
}

bool common_ok(const void* q, const void* k, const void* v, int dtype, int hd,
               int S, int s_pad, int distance, int slots, int sequential,
               int smem_bytes) {
  return (dtype == 0 || dtype == 1) && hd_ok(hd) && S >= 1 && s_pad >= S &&
         reinterpret_cast<uintptr_t>(q) % kGranule == 0 &&
         reinterpret_cast<uintptr_t>(k) % kGranule == 0 &&
         reinterpret_cast<uintptr_t>(v) % kGranule == 0 &&
         ring_ok(distance, slots, sequential, smem_bytes);
}

}  // namespace

extern "C" {

// K7: out (B, H, T, hd) = attention of q (B, H, T, hd) over k, v
// (B, K, S, hd), H = K G, hd in {16, 32, 64, 112, 128, 256}; f32 (dtype 0,
// the CUDA-core body) or bf16 (1, the tensor-core body) throughout. s_pad:
// the TPU kernel's padded stream, ceil(S / bs) bs.
int pul_flash_attention(const void* q, const void* k, const void* v, void* out,
                        int B, int K, int G, int T, int S, int hd, int s_pad,
                        int causal, int window, float scale, float softcap,
                        int distance, int slots, int sequential, int dtype,
                        int smem_bytes, void* stream) {
  if (!common_ok(q, k, v, dtype, hd, S, s_pad, distance, slots, sequential,
                 smem_bytes) ||
      B < 1 || K < 1 || G < 1 || T < 1 || B > 65535 || K > 65535 ||
      (long long)T * G > (1LL << 30))
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
  return flash_for_hd(p, B, hd, dtype, smem_bytes,
                      static_cast<cudaStream_t>(stream));
}

// K6: out (B, H, hd) = attention of q (B, H, hd), one token per head, over
// the first lengths[b] rows of k, v (B, K, S, hd); H = K G with G <= 16,
// hd in {16, 32, 64, 112, 128, 256}; f32 (dtype 0) or bf16 (1). The keys
// are cut into n_seg segments of seg_chunks ring chunks; part_m / part_l
// (B, K, n_seg, G) and part_acc (B, K, n_seg, G, hd) are fp32 scratch for
// the merge.
int pul_decode_attention(const void* q, const void* k, const void* v,
                         const int* lengths, void* out, float* part_m,
                         float* part_l, float* part_acc, int B, int K, int G,
                         int S, int hd, int s_pad, float scale, float softcap,
                         int seg_chunks, int n_seg, int distance, int slots,
                         int sequential, int dtype, int smem_bytes,
                         void* stream) {
  const int bc = dtype == 0 ? 32 : 64;  // Chunk<T, hd>::kBC
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
  switch (hd) {
    case 16: return launch_decode<16>(p, B, dtype, smem_bytes, s);
    case 32: return launch_decode<32>(p, B, dtype, smem_bytes, s);
    case 64: return launch_decode<64>(p, B, dtype, smem_bytes, s);
    case 112: return launch_decode<112>(p, B, dtype, smem_bytes, s);
    case 128: return launch_decode<128>(p, B, dtype, smem_bytes, s);
    case 256: return launch_decode<256>(p, B, dtype, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
