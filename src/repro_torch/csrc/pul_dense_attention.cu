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
// Every kernel is an online softmax over KV chunks streamed through a
// shared-memory ring, templated on the head dim, hd in {16, 32, 64, 112,
// 128, 256}: every hd of the reference's tests and of the model zoo. The
// TPU kernels' constants are kept: masked logits are NEG_INF = -2e38
// (finite), and l >= 1e-30 at the end.
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
//   * f32: flash_kernel, fp32 FMAs on the CUDA cores (no TF32: the smoke's
//     3e-4 and the reference's f32 tolerance are tighter). Bound by the FMA
//     pipes (67 TFLOP/s: 2 hd FMAs a visible pair, 0.128 ms for the smoke's
//     f32 case). What takes it below that: the data shared memory hands each
//     lane (a value loaded from shared memory costs about as much SM time
//     as an FFMA: see pul_matmul.cu), the exponents and shuffles between the
//     two products, and, for causal rows, blocks of very different lengths. A
//     block is 128 rows (64 at hd 256), a chunk 32 keys, and each warp owns
//     an eighth of the rows: their S = Q K^T in 4 x 4 lane tiles (q and K
//     read four dims at a time from rows padded by a granule: 8 bank
//     groups), the online softmax in base-2 units (the scale times
//     log2 e folded into each logit, one ex2 a logit, as in the bf16 body),
//     P handed to O += P V through the warp's own shared memory, transposed
//     (a __syncwarp, no block barrier), O in 8 x 8 lane tiles at hd >= 112
//     (64 FMAs per 4 LDS.128), rescaled only where a row's maximum moved.
//     One block barrier a chunk: its arrival, which also frees the slot the
//     next preload refills (a second only under BATCH with slots == d). q
//     (67.6 KB at hd 128, copied by cp.async with the first chunk) and the
//     ring leave one block an SM (attention_ring_plan: 4 slots). The grid is
//     1D, so that blocks start in the order of its index: the heaviest row
//     tiles of every (kv head, b) first (a 3D grid starts (tile, 0, 0) for
//     every tile before (0, 1, 0), and the longest causal tiles of the last
//     heads then run alone at the end).
// K6 (decode_split_kernel, decode_merge_kernel) does its few flops per byte
// as fp32 FMAs on the CUDA cores in both types.
//
// What the design does about the bounds:
//   * GQA: a block holds the queries of all G heads of one kv head, so each
//     KV chunk crosses HBM once per kv head, not once per query head. K7's
//     rows are the flattened (position, head) pairs of those G heads: row r
//     of the (T G) rows is position r / G of head r % G, each with its own
//     mask, so any G works; K6's block carries the G heads of one token;
//   * K7's ring (core/pipeline.py PreloadStream / pul_loop, pul_ring.cuh,
//     stream_chunks below): a chunk of BC keys, BC rows of K then of V, is
//     copied by 16-byte cp.async into slot c % slots, `distance` chunks
//     ahead of the compute. BATCH issues chunk i + d after computing chunk
//     i, SEQUENTIAL before it. Rows past S are zero-filled, as the TPU's
//     padding of the stream. Each row carries one spare 16-byte granule, so
//     that the eight rows ldmatrix (or eight threads) read at once hit eight
//     bank groups;
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
//   * K6 has one query per head, a few flops per byte, and rows of any
//     length: what bounds it is keeping every SM's share of HBM (about 25
//     GB/s) in flight and no SM idle. Split-KV on a persistent grid: every
//     block reads `lengths` on the card (the host never does) and counts
//     the chunks each (b, kv head) row streams, ceil(length / BC) (every
//     chunk of the padded stream at length 0); the chunks of all rows, in
//     (b, kv head, chunk) order, are cut into segments of equal size,
//     balanced over the grid (or forced), block x taking segments x, x +
//     grid, ... as one stream, so no block is spent past a row's length.
//     One thread of the block keeps d chunks in flight with two 1D bulk
//     copies each (a chunk's K rows and V rows are contiguous), onto an
//     mbarrier per slot; each warp releases a slot on a second mbarrier,
//     which the issuing thread waits on before refilling it: no block
//     barrier per chunk. A chunk is at most 32 KB (kDecChunkBytes), the ring
//     budgeted for three blocks an SM (the host's decode_ring_plan): at hd
//     128 bf16, two chunks of 64 keys in flight a block;
//   * K6's arithmetic is off the block barrier: warp w carries two query
//     heads (G <= 2) or four and a share of each chunk's keys; a team of
//     kLPK lanes reads a key's row (conflict-free, rows are read along their
//     length), reduces its dot products by shuffles, and keeps its own
//     (m, l, acc) in
//     registers, updated once per four keys (base-2 units, one ex2 a
//     logit). Where a row's piece of the stream ends (its last chunk or the
//     segment's), the teams merge by shuffles, the warps through shared
//     memory, and the block writes the piece's (m, l, acc) in fp32; a second
//     kernel merges each row's pieces: M = max m, out = sum(acc 2^(m - M)) /
//     max(sum(l 2^(m - M)), 1e-30). Keys past S are the stream's zero rows
//     (a zero logit before the mask, no value) and are not copied.
//
// K7 visits query tiles heaviest first (the causal diagonal's far end):
// within each (kv head, b) in the bf16 body, over all of them in the f32
// body.

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
  const void* q;     // (B, H, T, hd)
  const void* k;     // (B, K, S, hd)
  const void* v;
  void* out;         // like q
  int K, G, T, S, s_pad;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
  int distance, slots, sequential;
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

// the chunk of K7's f32 body: 32 keys
template <int HD>
using F32Chunk = Ring<float, HD, 32>;
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
// F32Tile<HD>: block (row tile, kv head, b) holds the flattened rows [row0,
// row0 + BR) of the T G (position, head) rows of kv head kvh, BR = 128 (64
// at hd 256, for shared memory), and warp w owns rows [w WR, w WR + WR) of
// them, WR = BR / 8: their logits, softmax state and accumulator. Two
// register tilings of a warp's lanes, one a phase:
//   * S = Q K^T: lane (rg, kg) = (l / 8, l % 8) holds rows rg + 4 i (i < TR
//     = WR / 4) at keys kg + 8 j (j < 4) of the chunk, so a row's max is
//     shuffles over 8 lanes; each 4-wide step of hd loads TR + 4 granules
//     (q rows, K rows: 8 bank groups) for 16 TR FMAs;
//   * O += P V: lane (og_r, og_d) = (l / DG, l % DG) holds TRO rows (4 og_r
//     + 4 RGW s + ii) x TDO dims (4 og_d + DSTEP s + jj), 8 x 8 at hd 128
//     (RGW = 2 row groups, DG = 16 dim groups); each key loads TRO / 4
//     granules of P^T and TDO / 4 of V for TRO TDO FMAs.
// P (transposed, a key's probabilities of the warp's rows, rows padded so
// that the S lanes' stores hit 32 banks) and each row's corr = 2^(m_old -
// m_new) go from one tiling to the other through the warp's own shared
// memory: a __syncwarp, no block barrier.
template <int HD>
struct F32Tile {
  static constexpr int kBR = HD == 256 ? 64 : 128;
  static constexpr int kBC = F32Chunk<HD>::kBC;
  static constexpr int kWR = kBR / kWarps;
  static constexpr int kTR = kWR / 4;
  static constexpr int kTDO = HD >= 112 ? 8 : 4;
  static constexpr int kDG = HD / kTDO;
  static constexpr int kRGW = 32 / kDG < kWR / 4 ? 32 / kDG : kWR / 4;
  static constexpr int kTRO = kWR / kRGW;
  static constexpr int kDStep = HD / (kTDO / 4);
  static constexpr int kQS = HD + 4;   // q row stride, floats
  static constexpr int kPS = kWR + 4;  // a warp's P^T row stride, floats
  // fp32 values beside the ring: q, each warp's P^T and corr, each row's l
  static constexpr int kWarpAux = kBC * kPS + kWR;
  static constexpr int kAux = kBR * kQS + kWarps * kWarpAux + kBR;
  static_assert(kRGW * kDG <= 32 && kTR >= 1 && kTRO % 4 == 0 &&
                    kBC == 32 && HD % 4 == 0,
                "one O tile a lane, 8 lanes a row in S");
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(Params p) {
  using F = F32Tile<HD>;
  using C = F32Chunk<HD>;
  constexpr int BR = F::kBR, BC = F::kBC, RS = C::kRowStride;
  constexpr int QS = F::kQS, PS = F::kPS, TR = F::kTR, WR = F::kWR;
  constexpr int TRO = F::kTRO, TDO = F::kTDO, DG = F::kDG, RGW = F::kRGW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* q_s = ring + (size_t)p.slots * C::kElems;  // (BR, QS)
  float* l_s = q_s + BR * QS;                       // (BR)

  // a 1D grid, the heaviest row tiles (the causal diagonal's far end) of
  // every (kv head, b) dispatched first: blocks start in index order
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.G, T_ = p.T, H = p.K * G;
  const int tiles = (T_ * G + BR - 1) / BR, heads = gridDim.x / tiles;
  const int qt = tiles - 1 - (int)blockIdx.x / heads;
  const int kvh = (int)blockIdx.x % p.K, b = (int)blockIdx.x % heads / p.K;
  const int row0 = qt * BR, off = p.S - T_;
  // this warp's P^T (BC, PS) and corr (WR)
  float* pt_w = l_s + BR + warp * F::kWarpAux;
  float* corr_w = pt_w + BC * PS;

  // q rows to shared memory by cp.async, a group before the ring's; rows
  // past T G are zero and never stored
  const float* q = static_cast<const float*>(p.q);
  constexpr int GPR = HD / 4;  // granules of a row
  for (int e = tid; e < BR * GPR; e += kThreads) {
    const int r = e / GPR, gi = e - r * GPR;
    const int gr = row0 + r, t = gr / G, g = gr - t * G;
    const bool ok = t < T_;
    cp_async16_zfill(
        q_s + r * QS + gi * 4,
        q + (((size_t)b * H + kvh * G + (ok ? g : 0)) * T_ + (ok ? t : 0)) *
                HD + gi * 4,
        ok);
  }
  cp_async_commit();

  const int t_first = row0 / G;
  const int t_last = min(T_ - 1, (row0 + BR - 1) / G);
  const KeyRange kr = key_range(p, t_first, t_last, BC);

  // S roles: rows wrow + rg + 4 i, keys kg + 8 j; m per row, l this lane's
  // part of it
  const int wrow = warp * WR, rg = lane / 8, kg = lane % 8;
  int iq[TR];
  float m[TR], l[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    iq[r] = (row0 + wrow + rg + 4 * r) / G + off;
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  // O roles: rows wrow + 4 og_r + 4 RGW s + ii, dims 4 og_d + DSTEP s + jj
  const int og_r = lane / DG, og_d = lane - og_r * DG;
  const bool o_active = og_r < RGW;
  const int orow = 4 * og_r, odim = 4 * og_d;
  float o[TRO][TDO];
#pragma unroll
  for (int u = 0; u < TRO; ++u)
#pragma unroll
    for (int v = 0; v < TDO; ++v) o[u][v] = 0.f;

  const float scale2 = p.scale * kLog2e;
  const size_t head = ((size_t)b * p.K + kvh) * p.S * HD;
  const float* kh = static_cast<const float*>(p.k) + head;
  const float* vh = static_cast<const float*>(p.v) + head;

  // the PUL loop over chunks [c0, c1): chunk c0 + i in slot i % slots,
  // `distance` chunks in flight, one block barrier a chunk: its arrival,
  // which also frees the slot SEQUENTIAL refills (BATCH needs a second
  // only where slots == d)
  const int n = kr.c1 - kr.c0, d = p.distance;
  const bool seq = p.sequential, tail = !seq && p.slots == d;
  auto issue = [&](int i) {
    if (i < n)
      copy_chunk<C>(ring + (size_t)(i % p.slots) * C::kElems, kh, vh,
                    kr.c0 + i, p.S);
    cp_async_commit();
  };
  for (int i = 0; i < d; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    const int c = kr.c0 + i;
    cp_async_wait_dyn(d - 1);
    __syncthreads();  // chunk i (and q_s) visible; chunk i - 1 consumed
    if (seq) issue(i + d);  // PL[i + d] -> compute[i]
    const float* sk = ring + (size_t)(i % p.slots) * C::kElems;
    const float* sv = sk + BC * RS;

    // S = Q K^T over the chunk, four dims at a time
    float s[TR][4];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < HD; d0 += 4) {
      float qf[TR][4], kf[4][4];
#pragma unroll
      for (int r = 0; r < TR; ++r)
        load16<float>(q_s + (wrow + rg + 4 * r) * QS + d0, qf[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        load16<float>(sk + (kg + 8 * j) * RS + d0, kf[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[r][j] = fmaf(qf[r][e], kf[j][e], s[r][j]);
    }
    // logits in base-2 units (times log2 e, so that exp is one ex2):
    // scale, softcap, then the mask where the chunk is not whole
    const bool whole = c * BC >= kr.full_lo && c * BC + BC <= kr.full_hi;
    auto logits = [&](auto capped) {
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x;
          if constexpr (decltype(capped)::value)
            x = cap(s[r][j] * p.scale, p.softcap) * kLog2e;
          else
            x = s[r][j] * scale2;
          if (!whole) {
            const int jk = c * BC + kg + 8 * j;
            x = masked(x, jk, visible(p, jk, iq[r]), p.s_pad);
          }
          s[r][j] = x;
        }
    };
    if (p.softcap > 0.f)
      logits(std::true_type{});
    else
      logits(std::false_type{});
    // the online max; P = 2^(S - m) and corr to the warp's shared memory
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int o2 = 1; o2 < 8; o2 <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      const float new_m = fmaxf(m[r], mx);
      const float corr = fast_exp2(m[r] - new_m);
      m[r] = new_m;
      l[r] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = fast_exp2(s[r][j] - new_m);
        l[r] += pj;
        pt_w[(kg + 8 * j) * PS + rg + 4 * r] = pj;
      }
      if (kg == 0) corr_w[rg + 4 * r] = corr;
    }
    __syncwarp();

    // O = O corr + P V over the warp's rows
    if (o_active) {
      float cr[TRO];
#pragma unroll
      for (int s4 = 0; s4 < TRO / 4; ++s4)
        load16<float>(corr_w + 4 * RGW * s4 + orow, cr + 4 * s4);
      bool moved = false;
#pragma unroll
      for (int u = 0; u < TRO; ++u) moved = moved || cr[u] != 1.f;
      if (moved) {
#pragma unroll
        for (int u = 0; u < TRO; ++u)
#pragma unroll
          for (int v = 0; v < TDO; ++v) o[u][v] *= cr[u];
      }
#pragma unroll
      for (int key = 0; key < BC; ++key) {
        float pv[TRO], vv[TDO];
#pragma unroll
        for (int s4 = 0; s4 < TRO / 4; ++s4)
          load16<float>(pt_w + key * PS + 4 * RGW * s4 + orow, pv + 4 * s4);
#pragma unroll
        for (int s4 = 0; s4 < TDO / 4; ++s4)
          load16<float>(sv + key * RS + F::kDStep * s4 + odim, vv + 4 * s4);
#pragma unroll
        for (int u = 0; u < TRO; ++u)
#pragma unroll
          for (int v = 0; v < TDO; ++v) o[u][v] = fmaf(pv[u], vv[v], o[u][v]);
      }
    }
    if (!seq) {
      if (tail) __syncthreads();  // slots == d: chunk i + d refills i's slot
      issue(i + d);
    }
  }
  cp_async_wait<0>();

  // each row's l: the sum of its 8 lanes' parts
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    float lr = l[r];
#pragma unroll
    for (int o2 = 1; o2 < 8; o2 <<= 1)
      lr += __shfl_xor_sync(0xffffffffu, lr, o2);
    if (kg == 0) l_s[wrow + rg + 4 * r] = lr;
  }
  __syncwarp();
  if (!o_active) return;
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int u = 0; u < TRO; ++u) {
    const int r = wrow + 4 * RGW * (u / 4) + orow + u % 4;
    const int gr = row0 + r, t = gr / G, g = gr - t * G;
    if (t >= T_) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    float* orow_p = out + (((size_t)b * H + kvh * G + g) * T_ + t) * HD;
#pragma unroll
    for (int s4 = 0; s4 < TDO / 4; ++s4)
      *reinterpret_cast<float4*>(orow_p + F::kDStep * s4 + odim) =
          make_float4(o[u][4 * s4] * inv, o[u][4 * s4 + 1] * inv,
                      o[u][4 * s4 + 2] * inv, o[u][4 * s4 + 3] * inv);
  }
}

// ---------------------------------------------------------------- K6
// Split-KV over the cache, on a persistent grid (see the note at the head).
constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecChunkBytes = 32768;  // K and V rows of one ring chunk
// shared memory a split block keeps to, so that three share an SM (the
// host's DECODE_SMEM_BYTES)
constexpr int kDecSmemBytes = 233472 / 3 - 1024;
constexpr int kMiniBatch = 4;       // warp steps per online-softmax update
constexpr float kNegInf2 = kNegInf * kLog2e;  // NEG_INF in base-2 units

__host__ __device__ constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

__host__ __device__ constexpr int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

// K6's shapes: a warp carries HPW query heads (2 where G <= 2, else 4); a
// row of HD values of T is kGR 16-byte granules; a team of kLPK lanes reads
// one key's row (kNG granules a lane: two where a warp carries 2 heads, so
// that a team is half as wide and its dot products need one shuffle level
// less), a warp step kKPW keys; a ring chunk is kBC keys of K, then kBC of
// V, at most 32 KB.
template <typename T, int HD, int HPW>
struct Dec {
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kGR = kRowBytes / kGranule;
  static constexpr int kLPKRaw = pow2_ceil(kGR) / (HPW == 2 ? 2 : 1);
  static constexpr int kLPK = kLPKRaw < 1 ? 1 : kLPKRaw > 32 ? 32 : kLPKRaw;
  static constexpr int kNG = (kGR + kLPK - 1) / kLPK;
  static constexpr int kEPV = kGranule / (int)sizeof(T);
  static constexpr int kVPL = kNG * kEPV;  // values of a row one lane holds
  static constexpr int kKPW = 32 / kLPK;
  // the block merge's exchange, (m, l, acc) of each warp's heads, and the
  // block's chunk total
  static constexpr int kXBytes =
      kDecWarps * HPW * (HD + 2) * (int)sizeof(float) + 16;
  // chunks of at most kDecChunkBytes, two of them within kDecSmemBytes
  static constexpr int kChunkCap = (kDecSmemBytes - kXBytes) / 2 - 16;
  static constexpr int kBCRaw = pow2_floor(
      (kChunkCap < kDecChunkBytes ? kChunkCap : kDecChunkBytes) / 2 /
      kRowBytes);
  static constexpr int kBC = kBCRaw < 8 ? 8 : kBCRaw > 128 ? 128 : kBCRaw;
  static constexpr int kChunkBytes = 2 * kBC * kRowBytes;
};

struct DecodeParams {
  const void* q;       // (B, K, G, hd)
  const void* k;       // (B, K, S, hd)
  const void* v;
  void* out;           // like q
  const int* lengths;  // (B,): visible cache positions
  float* part_m;       // (B K, n_piece, G) piece maxima, base-2 units
  float* part_l;       // (B K, n_piece, G) piece sums
  float* part_acc;     // (B K, n_piece, G, hd) piece accumulators
  int* part_n;         // (B K,) pieces of each row
  int B, K, G, S, s_pad;
  float scale, softcap;  // softcap <= 0: none
  int distance, slots, sequential;
  int chunk_keys;  // keys of a ring chunk, as the host planned (Dec::kBC)
  int seg_chunks;  // > 0: chunks of a segment, forced; 0: balanced
  int min_seg;     // balanced segments take at least this many chunks
  int n_piece;     // partial slots of a row
};

// chunks of BC keys row b streams: those that hold a visible key; with none
// visible (length 0) every chunk of the padded stream
__device__ __forceinline__ int vis_chunks(int length, int n_chunks, int BC) {
  return length > 0 ? min((length + BC - 1) / BC, n_chunks) : n_chunks;
}

// A position of the block's chunk stream: chunk c of row (b, kvh), global
// chunk index j (rows in (b, kvh) order, each vis chunks long), inside
// segment u, which ends before chunk `end`.
struct Cursor {
  long long j, end;
  int u, b, kvh, c, vis;
  bool done;
};

// Every lane of the calling warp: place the cursor at global chunk j, by a
// warp-wide prefix sum over the rows' chunk counts.
template <int BC>
__device__ __forceinline__ void locate(Cursor& cur, const DecodeParams& p,
                                       int n_chunks) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (int base = 0; base < p.B; base += 32) {
    const int b = base + lane;
    const int vis = b < p.B ? vis_chunks(p.lengths[b], n_chunks, BC) : 0;
    const long long w = (long long)p.K * vis;
    long long incl = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, cur.j < before + incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const long long rel =
          cur.j - before - __shfl_sync(0xffffffffu, incl - w, src);
      cur.vis = __shfl_sync(0xffffffffu, vis, src);
      cur.b = base + src;
      cur.kvh = (int)(rel / cur.vis);
      cur.c = (int)(rel % cur.vis);
      return;
    }
    before += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// the cursor at the first chunk of segment u (done past the last segment)
template <int BC>
__device__ __forceinline__ void seek(Cursor& cur, const DecodeParams& p,
                                     int u, int n_segs, long long seg,
                                     long long total, int n_chunks) {
  cur.u = u;
  cur.done = u >= n_segs;
  if (cur.done) return;
  cur.j = (long long)u * seg;
  cur.end = min(cur.j + seg, total);
  locate<BC>(cur, p, n_chunks);
}

// the next position of the block's stream: the next chunk of the row, the
// next row, or the block's next segment (gridDim.x segments on)
template <int BC>
__device__ __forceinline__ void advance(Cursor& cur, const DecodeParams& p,
                                        int n_segs, long long seg,
                                        long long total, int n_chunks) {
  if (++cur.j == cur.end) {
    seek<BC>(cur, p, cur.u + gridDim.x, n_segs, seg, total, n_chunks);
    return;
  }
  if (++cur.c == cur.vis) {
    cur.c = 0;
    if (++cur.kvh == p.K) {
      cur.kvh = 0;
      cur.vis = vis_chunks(p.lengths[++cur.b], n_chunks, BC);
    }
  }
}

template <typename T>
__device__ __forceinline__ void widen16(const void* p, float* out) {
  load16<T>(reinterpret_cast<const T*>(p), out);
}

// Block x: the segments x, x + grid, ... of the chunks of every row, in
// (b, kv head, chunk) order, as one stream through its ring. Warp w carries
// heads hg * 4 .. hg * 4 + 3 (hg = w / NKG) and keys kg = w % NKG of each
// chunk; its teams of kLPK lanes each own their keys' (m, l, acc), merged
// (shuffles, then the block through shared memory) where a row's piece of
// the stream ends: its last chunk, or the segment's.
template <typename T, int HD, int HPW>
__global__ void __launch_bounds__(kDecThreads, 3)
    decode_split_kernel(DecodeParams p) {
  using D = Dec<T, HD, HPW>;
  constexpr int kHeadsPerWarp = HPW;
  constexpr int BC = D::kBC, RB = D::kRowBytes, LPK = D::kLPK,
                VPL = D::kVPL, EPV = D::kEPV, KPW = D::kKPW;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* xacc = reinterpret_cast<float*>(smem + (size_t)p.slots * D::kChunkBytes);
  float* xm = xacc + kDecWarps * kHeadsPerWarp * HD;
  float* xl = xm + kDecWarps * kHeadsPerWarp;
  uint64_t* full = reinterpret_cast<uint64_t*>(xl + kDecWarps * kHeadsPerWarp);
  uint64_t* empty = full + p.slots;
  long long* s_total = reinterpret_cast<long long*>(empty + p.slots);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = (p.s_pad + BC - 1) / BC;

  // the chunks every row streams, and the segments' size
  if (warp == 0) {
    long long total = 0;
    for (int b = lane; b < p.B; b += 32)
      total += (long long)p.K * vis_chunks(p.lengths[b], n_chunks, BC);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
    if (lane == 0) {
      *s_total = total;
      for (int s = 0; s < p.slots; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kDecWarps);
      }
      fence_mbar_init();
    }
  }
  __syncthreads();
  const long long total = *s_total;
  const long long seg =
      p.seg_chunks > 0
          ? p.seg_chunks
          : max((long long)p.min_seg, (total + gridDim.x - 1) / gridDim.x);
  const int n_segs = (int)((total + seg - 1) / seg);
  if ((int)blockIdx.x >= n_segs) return;  // no chunk left for this block

  // this warp's heads and keys
  const int n_hg = (p.G + kHeadsPerWarp - 1) / kHeadsPerWarp;
  const int nkg = kDecWarps / n_hg;
  const int hg = warp / nkg, kg = warp % nkg;
  const bool active = hg < n_hg;
  const int h0 = hg * kHeadsPerWarp;
  const int nh = active ? min(kHeadsPerWarp, p.G - h0) : 0;
  const int team = lane / LPK, tl = lane % LPK;
  const int steps = (BC + nkg * KPW - 1) / (nkg * KPW);

  const T* kbase = static_cast<const T*>(p.k);
  const T* vbase = static_cast<const T*>(p.v);
  const int d = p.distance;

  // PRELOAD (warp 0; lane 0 issues): position i, at cursor pc, into slot
  // i % slots, once the warps have released what it held
  Cursor pc;
  if (warp == 0) seek<BC>(pc, p, blockIdx.x, n_segs, seg, total, n_chunks);
  int issued = 0;
  auto issue = [&]() {
    if (pc.done) return;
    const int s = issued % p.slots;
    if (lane == 0) {
      if (issued >= p.slots) mbar_wait(&empty[s], ((issued / p.slots) - 1) & 1);
      const int rows = min(BC, p.S - pc.c * BC);
      const uint32_t bytes = rows > 0 ? (uint32_t)rows * RB : 0u;
      mbar_arrive_expect_tx(&full[s], 2 * bytes);
      if (bytes) {
        const size_t off =
            (((size_t)pc.b * p.K + pc.kvh) * p.S + (size_t)pc.c * BC) * HD;
        unsigned char* dst = ring + (size_t)s * D::kChunkBytes;
        bulk_load(dst, kbase + off, bytes, &full[s]);
        bulk_load(dst + BC * RB, vbase + off, bytes, &full[s]);
      }
    }
    ++issued;
    advance<BC>(pc, p, n_segs, seg, total, n_chunks);
  };
  if (warp == 0)
    for (int i = 0; i < d; ++i) issue();

  // COMPUTE: every warp walks the same stream with its own cursor
  Cursor cc;
  seek<BC>(cc, p, blockIdx.x, n_segs, seg, total, n_chunks);
  float q[kHeadsPerWarp][VPL], acc[kHeadsPerWarp][VPL];
  float m[kHeadsPerWarp], l[kHeadsPerWarp];
  bool fresh = true;  // a piece starts here: its q, its empty state
  for (int i = 0; !cc.done; ++i) {
    if (fresh) {
      const T* qh = static_cast<const T*>(p.q) +
                    (((size_t)cc.b * p.K + cc.kvh) * p.G + h0) * HD;
#pragma unroll
      for (int h = 0; h < kHeadsPerWarp; ++h) {
        m[h] = kNegInf2;
        l[h] = 0.f;
#pragma unroll
        for (int n = 0; n < D::kNG; ++n) {
          const int gi = tl + n * LPK;
          if (h < nh && gi < D::kGR)
            widen16<T>(qh + (size_t)h * HD + gi * EPV, &q[h][n * EPV]);
          else
#pragma unroll
            for (int e = 0; e < EPV; ++e) q[h][n * EPV + e] = 0.f;
#pragma unroll
          for (int e = 0; e < EPV; ++e) acc[h][n * EPV + e] = 0.f;
        }
      }
      fresh = false;
    }
    const int s = i % p.slots;
    if (p.sequential && warp == 0) issue();  // PL[i + d]; slots >= d + 1
    mbar_wait(&full[s], (i / p.slots) & 1);
    const unsigned char* sk = ring + (size_t)s * D::kChunkBytes;
    const unsigned char* sv = sk + BC * RB;
    const int length = p.lengths[cc.b];
    if (active) {
      for (int s0 = 0; s0 < steps; s0 += kMiniBatch) {
        float x[kHeadsPerWarp][kMiniBatch];
#pragma unroll
        for (int st = 0; st < kMiniBatch; ++st) {
          const int kl = ((s0 + st) * nkg + kg) * KPW + team;
          const int jk = cc.c * BC + kl;
          float kf[VPL];
          const bool row = s0 + st < steps && kl < BC && jk < p.S;
#pragma unroll
          for (int n = 0; n < D::kNG; ++n) {
            const int gi = tl + n * LPK;
            if (row && gi < D::kGR)
              widen16<T>(sk + kl * RB + gi * kGranule, &kf[n * EPV]);
            else
#pragma unroll
              for (int e = 0; e < EPV; ++e) kf[n * EPV + e] = 0.f;
          }
#pragma unroll
          for (int h = 0; h < kHeadsPerWarp; ++h) {
            if (h >= nh) continue;  // nh is the warp's: no lane diverges
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < VPL; ++e) dot = fmaf(q[h][e], kf[e], dot);
#pragma unroll
            for (int off = LPK / 2; off > 0; off >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, off);
            // keys past S are the stream's zero rows (dot 0); keys past the
            // chunk's end or the padded stream weigh nothing
            x[h][st] = s0 + st < steps && kl < BC
                           ? masked(cap(dot * p.scale, p.softcap), jk,
                                    jk < length, p.s_pad) * kLog2e
                           : -INFINITY;
          }
        }
#pragma unroll
        for (int h = 0; h < kHeadsPerWarp; ++h) {
          if (h >= nh) continue;
          float bmax = x[h][0];
#pragma unroll
          for (int st = 1; st < kMiniBatch; ++st) bmax = fmaxf(bmax, x[h][st]);
          const float new_m = fmaxf(m[h], bmax);
          const float corr = fast_exp2(m[h] - new_m);
          float sum = 0.f;
#pragma unroll
          for (int st = 0; st < kMiniBatch; ++st) {
            x[h][st] = fast_exp2(x[h][st] - new_m);
            sum += x[h][st];
          }
          l[h] = l[h] * corr + sum;
          m[h] = new_m;
#pragma unroll
          for (int e = 0; e < VPL; ++e) acc[h][e] *= corr;
        }
#pragma unroll
        for (int st = 0; st < kMiniBatch; ++st) {
          const int kl = ((s0 + st) * nkg + kg) * KPW + team;
          const int jk = cc.c * BC + kl;
          if (!(s0 + st < steps && kl < BC && jk < p.S)) continue;  // v = 0
          float vf[VPL];
#pragma unroll
          for (int n = 0; n < D::kNG; ++n) {
            const int gi = tl + n * LPK;
            if (gi < D::kGR)
              widen16<T>(sv + kl * RB + gi * kGranule, &vf[n * EPV]);
            else
#pragma unroll
              for (int e = 0; e < EPV; ++e) vf[n * EPV + e] = 0.f;
          }
#pragma unroll
          for (int h = 0; h < kHeadsPerWarp; ++h) {
            if (h >= nh) continue;
#pragma unroll
            for (int e = 0; e < VPL; ++e)
              acc[h][e] = fmaf(x[h][st], vf[e], acc[h][e]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with slot s

    // the piece ends with its row's last chunk or its segment's
    const bool last = cc.c + 1 == cc.vis || cc.j + 1 == cc.end;
    if (last) {
      // teams of a warp -> one state (all lanes hold it)
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
        for (int h = 0; h < kHeadsPerWarp; ++h) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
          const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
          const float M = fmaxf(m[h], mo);
          const float ws = fast_exp2(m[h] - M), wo = fast_exp2(mo - M);
          l[h] = l[h] * ws + lo * wo;
          m[h] = M;
#pragma unroll
          for (int e = 0; e < VPL; ++e) {
            const float ao = __shfl_xor_sync(0xffffffffu, acc[h][e], off);
            acc[h][e] = acc[h][e] * ws + ao * wo;
          }
        }
      }
      // warps -> the block, through shared memory
      if (active && lane < LPK) {
#pragma unroll
        for (int h = 0; h < kHeadsPerWarp; ++h) {
          if (h >= nh) continue;
          float* xa = xacc + (warp * kHeadsPerWarp + h) * HD;
#pragma unroll
          for (int n = 0; n < D::kNG; ++n) {
            const int gi = tl + n * LPK;
            if (gi >= D::kGR) continue;
#pragma unroll
            for (int e = 0; e < EPV; ++e) xa[gi * EPV + e] = acc[h][n * EPV + e];
          }
          if (lane == 0) {
            xm[warp * kHeadsPerWarp + h] = m[h];
            xl[warp * kHeadsPerWarp + h] = l[h];
          }
        }
      }
      __syncthreads();
      const long long row = (long long)cc.b * p.K + cc.kvh;
      const long long first = cc.j - cc.c;  // the row's chunk 0
      const int piece = cc.u - (int)(first / seg);
      const size_t slot = (size_t)row * p.n_piece + piece;
      for (int e = tid; e < p.G * HD; e += kDecThreads) {
        const int g = e / HD, col = e - g * HD;
        const int w0 = (g / kHeadsPerWarp) * nkg, h = g % kHeadsPerWarp;
        float M = -INFINITY;
        for (int w = w0; w < w0 + nkg; ++w)
          M = fmaxf(M, xm[w * kHeadsPerWarp + h]);
        float A = 0.f, L = 0.f;
        for (int w = w0; w < w0 + nkg; ++w) {
          const float wt = fast_exp2(xm[w * kHeadsPerWarp + h] - M);
          A += xacc[(w * kHeadsPerWarp + h) * HD + col] * wt;
          L += xl[w * kHeadsPerWarp + h] * wt;
        }
        p.part_acc[slot * p.G * HD + e] = A;
        if (col == 0) {
          p.part_m[slot * p.G + g] = M;
          p.part_l[slot * p.G + g] = L;
        }
      }
      if (piece == 0 && tid == 0)
        p.part_n[row] =
            (int)((first + cc.vis - 1) / seg - first / seg) + 1;
      __syncthreads();  // the exchange may be written again
      fresh = true;
    }
    if (!p.sequential && warp == 0) issue();  // PL[i + d]
    advance<BC>(cc, p, n_segs, seg, total, n_chunks);
  }
}

// The merge, block (kv head, b): out = sum_k acc_k 2^(m_k - M) /
// max(sum_k l_k 2^(m_k - M), 1e-30), M = max_k m_k over the row's pieces.
template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads)
    decode_merge_kernel(DecodeParams p) {
  const int kvh = blockIdx.x, b = blockIdx.y, G = p.G;
  const size_t row = (size_t)b * p.K + kvh;
  const int n = p.part_n[row];
  const float* pm = p.part_m + row * p.n_piece * G;
  const float* pl = p.part_l + row * p.n_piece * G;
  const float* pa = p.part_acc + row * p.n_piece * G * HD;
  T* out = static_cast<T*>(p.out) + row * G * HD;
  for (int e = threadIdx.x; e < G * HD; e += kDecThreads) {
    const int g = e / HD;
    float M = -INFINITY;
    for (int k = 0; k < n; ++k) M = fmaxf(M, pm[k * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float w = exp2f(pm[k * G + g] - M);
      L += pl[k * G + g] * w;
      A += pa[(size_t)k * G * HD + e] * w;
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
  static const cudaError_t attr = allow_full_smem(flash_kernel<HD>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (smem_bytes < (p.slots * F32Chunk<HD>::kElems + F32Tile<HD>::kAux) * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int BR = F32Tile<HD>::kBR;
  const long long grid = (long long)((p.T * p.G + BR - 1) / BR) * p.K * B;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_kernel<HD><<<(unsigned)grid, kThreads, smem_bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// blocks of K7's f32 body one SM holds at this dynamic shared memory;
// negative: minus a CUDA error
template <int HD>
int flash_f32_blocks(int smem_bytes) {
  static const cudaError_t attr = allow_full_smem(flash_kernel<HD>);
  if (attr != cudaSuccess) return -static_cast<int>(attr);
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_kernel<HD>, kThreads, smem_bytes);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

template <int HD>
int launch_flash(const Params& p, int B, int dtype, int smem_bytes,
                 cudaStream_t s) {
  return dtype == 0 ? launch_flash_f32<HD>(p, B, smem_bytes, s)
                    : launch_flash_tc<HD>(p, B, smem_bytes, s);
}

// K6's split blocks carry 2 heads a warp where G <= 2, else 4
template <typename T, int HD, int HPW>
int launch_decode_t(const DecodeParams& p, int grid, int smem_bytes,
                    cudaStream_t s) {
  static const cudaError_t attr =
      allow_full_smem(decode_split_kernel<T, HD, HPW>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  using D = Dec<T, HD, HPW>;
  // the host plans with its own chunk (decode_chunk_keys): it must be this
  // kernel's, and n_piece must hold the pieces a row of every chunk of the
  // stream can meet, else the rows' partials would overrun their slots
  const int n_chunks = (p.s_pad + D::kBC - 1) / D::kBC;
  const int seg = p.seg_chunks > 0 ? p.seg_chunks : p.min_seg;
  if (p.chunk_keys != D::kBC || p.n_piece < (n_chunks + seg - 1) / seg + 1 ||
      p.G > kDecWarps * HPW ||
      smem_bytes < p.slots * (D::kChunkBytes + 16) + D::kXBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  decode_split_kernel<T, HD, HPW><<<grid, kDecThreads, smem_bytes, s>>>(p);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  decode_merge_kernel<T, HD><<<dim3(p.K, p.B), kDecThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int HPW>
int decode_blocks_t(int smem_bytes) {
  static const cudaError_t attr =
      allow_full_smem(decode_split_kernel<T, HD, HPW>);
  if (attr != cudaSuccess) return -static_cast<int>(attr);
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_split_kernel<T, HD, HPW>, kDecThreads, smem_bytes);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

// K6's split kernel (launch 1) or its blocks an SM (launch 0) at hd
template <typename T, int HD>
int decode_for_t(const DecodeParams& p, int launch, int grid, int smem_bytes,
                 cudaStream_t s) {
  if (p.G <= 2)
    return launch ? launch_decode_t<T, HD, 2>(p, grid, smem_bytes, s)
                  : decode_blocks_t<T, HD, 2>(smem_bytes);
  return launch ? launch_decode_t<T, HD, 4>(p, grid, smem_bytes, s)
                : decode_blocks_t<T, HD, 4>(smem_bytes);
}

template <int HD>
int decode_for(const DecodeParams& p, int launch, int grid, int dtype,
               int smem_bytes, cudaStream_t s) {
  return dtype == 0 ? decode_for_t<float, HD>(p, launch, grid, smem_bytes, s)
                    : decode_for_t<bf16, HD>(p, launch, grid, smem_bytes, s);
}

int decode_for_hd(const DecodeParams& p, int launch, int grid, int hd,
                  int dtype, int smem_bytes, cudaStream_t s) {
  switch (hd) {
    case 16: return decode_for<16>(p, launch, grid, dtype, smem_bytes, s);
    case 32: return decode_for<32>(p, launch, grid, dtype, smem_bytes, s);
    case 64: return decode_for<64>(p, launch, grid, dtype, smem_bytes, s);
    case 112: return decode_for<112>(p, launch, grid, dtype, smem_bytes, s);
    case 128: return decode_for<128>(p, launch, grid, dtype, smem_bytes, s);
    case 256: return decode_for<256>(p, launch, grid, dtype, smem_bytes, s);
  }
  return launch ? static_cast<int>(cudaErrorInvalidValue)
                : -static_cast<int>(cudaErrorInvalidValue);
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
// hd in {16, 32, 64, 112, 128, 256}; f32 (dtype 0) or bf16 (1). A split
// kernel of `grid` blocks walks the rows' chunks in segments (seg_chunks
// each, or balanced over the grid and at least min_seg when seg_chunks is
// 0; chunks of chunk_keys keys, which must be the kernel's own) and writes
// each row's pieces to part_m / part_l (B K, n_piece, G),
// part_acc (B K, n_piece, G, hd) and their count to part_n (B K); a merge
// kernel of (K, B) blocks combines them.
int pul_decode_attention(const void* q, const void* k, const void* v,
                         const int* lengths, void* out, float* part_m,
                         float* part_l, float* part_acc, int* part_n, int B,
                         int K, int G, int S, int hd, int s_pad, float scale,
                         float softcap, int chunk_keys, int seg_chunks,
                         int min_seg, int n_piece, int grid, int distance,
                         int slots, int sequential, int dtype, int smem_bytes,
                         void* stream) {
  if (!common_ok(q, k, v, dtype, hd, S, s_pad, distance, slots, sequential,
                 smem_bytes) ||
      B < 1 || K < 1 || G < 1 || G > kMaxG || seg_chunks < 0 || min_seg < 1 ||
      n_piece < 1 || grid < 1 || B > 65535 || K > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lengths = lengths;
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.part_n = part_n;
  p.B = B;
  p.K = K;
  p.G = G;
  p.S = S;
  p.s_pad = s_pad;
  p.scale = scale;
  p.softcap = softcap;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  p.chunk_keys = chunk_keys;
  p.seg_chunks = seg_chunks;
  p.min_seg = min_seg;
  p.n_piece = n_piece;
  return decode_for_hd(p, 1, grid, hd, dtype, smem_bytes,
                       static_cast<cudaStream_t>(stream));
}

// Blocks of K6's split kernel (for G query heads a kv head) one SM holds at
// this dynamic shared memory; negative: minus a CUDA error.
int pul_dense_attention_blocks_per_sm(int hd, int dtype, int G,
                                      int smem_bytes) {
  if ((dtype != 0 && dtype != 1) || G < 1 || G > kMaxG)
    return -static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p = {};
  p.G = G;
  return decode_for_hd(p, 0, 1, hd, dtype, smem_bytes, nullptr);
}

// Blocks of K7's f32 body at head dim hd one SM holds at this dynamic
// shared memory; negative: minus a CUDA error.
int pul_flash_attention_blocks_per_sm(int hd, int smem_bytes) {
  switch (hd) {
    case 16: return flash_f32_blocks<16>(smem_bytes);
    case 32: return flash_f32_blocks<32>(smem_bytes);
    case 64: return flash_f32_blocks<64>(smem_bytes);
    case 112: return flash_f32_blocks<112>(smem_bytes);
    case 128: return flash_f32_blocks<128>(smem_bytes);
    case 256: return flash_f32_blocks<256>(smem_bytes);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
