// Paged decode attention over PUL-streamed KV pages, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the paged serving decode:
//   K1  repro/kernels/pul_attention.py : pul_paged_sweep_decode_attention
//       (_paged_sweep_decode_kernel) -- one layer of the single-sweep decode
//       over the full per-layer planes, with the new token's K/V committed
//       in the epilogue;
//   K2  repro/kernels/pul_attention.py : pul_paged_decode_attention
//       (_paged_decode_kernel) -- the same attention over one layer's frames,
//       no commit.
// Both are instantiations of ONE templated body (COMMIT, HAS_NEW), so on the
// same inputs they produce bitwise-equal `out`. The arithmetic uses explicit
// round-to-nearest intrinsics (no compiler contraction), so the instantiations
// cannot diverge through different FMA fusion either.
//
// Bound on this card: bytes. Block (b, kv_h) reads the K and V slab of each
// page that holds a visible position: sum_b ceil(len_b / P) * P * hd * 2 B
// per tensor and kv head. The arithmetic is 4 * G * hd flops per cached
// token (G = H / K query heads share each slab), far below the card's
// flop:byte balance, so the kernel is worth exactly the bytes it moves.
//
// What the design does about that bound:
//   * grid (B, K): one block serves all G query heads of one kv head, so each
//     page slab crosses HBM once per step, not once per query head;
//   * a (P, hd) slab is contiguous in the plane (P * hd * 2 B = 4 KB at
//     P = 16, hd = 128) and is copied with 16-byte cp.async per thread into a
//     shared-memory ring, `distance` pages ahead of the compute -- the port of
//     PreloadStream / pul_loop (core/pipeline.py), page table as the trace.
//     BATCH issues page i + d after computing page i, SEQUENTIAL before;
//   * only pages holding a position < length (and inside the window) are
//     streamed. The TPU kernel streams all n_pages, but the masked pages it
//     reads before the first visible one are cancelled exactly by
//     corr = exp(NEG_INF - m) = 0, and those after the last add p = 0, so
//     skipping them changes no value;
//   * ring size: the TPU ring holds 2d slots (BATCH). At full qwen3 width
//     with the TPU tiers the planner asks for d = 21, i.e. 42 slots x 8 KB =
//     336 KB, beyond the 227 KB a block may use. The host side clamps
//     distance and slots to shared memory (ring_plan in
//     kernels/pul_attention.py, the counterpart of ring_scratch's VMEM check)
//     and to kMaxDistance, the depth of the cp.async.wait_group table
//     (pul_ring.cuh, the ring helpers both paged decode sources share).
//
// The fp32 online softmax keeps the TPU kernel's constants: NEG_INF = -2e38
// for masked logits, l >= 1e-30 at the end, and the current token folded in
// after the stream (always visible, always inside the window). With
// length == 0 and a current token, out == v_new.
//
// The commit epilogue (K1): block (b, kv_h) writes k_new / v_new to row
// offsets[b] of (layer, frames[b], kv_h). That row is position length, and
// the stream above reads only positions < length, so the write never races
// a read. Inactive slots point at the pool's TRASH frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Params {
  const bf16* q;        // (B, K, G, hd)
  bf16* k;              // plane (L, NF, K, P, hd); L = 1 for K2
  bf16* v;
  const int* page_tables;  // (B, n_pages) physical frame per logical page
  const int* lengths;      // (B,) cached tokens per slot
  const bf16* k_new;       // (B, K, hd), or null (K2 without a current token)
  const bf16* v_new;
  const int* frames;       // (B,) commit frame (K1)
  const int* offsets;      // (B,) commit row (K1)
  bf16* out;               // (B, K, G, hd)
  int K, G, P, hd, n_pages, NF, layer;
  float scale, softcap;    // softcap <= 0: none
  int window;              // <= 0: none
  int distance, slots, sequential;
};

__device__ __forceinline__ float cap(float x, float softcap) {
  if (softcap > 0.f) return __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
  return x;
}

// q_s (G, hd) fp32 . row (hd,) bf16 for every g, one warp per g; lane 0 of
// warp g returns the scaled, capped logit into dst[g]
__device__ __forceinline__ void dot_rows(const float* q_s, const bf16* rows,
                                         int G, int P, int hd, float scale,
                                         float softcap, float* dst,
                                         const Params& p, int t, int length,
                                         bool masked) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int pair = warp; pair < G * P; pair += kWarps) {
    const int g = pair / P, j = pair - g * P;
    const float* qg = q_s + g * hd;
    const bf16* kj = rows + j * hd;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32)
      acc = __fmaf_rn(qg[d], __bfloat162float(kj[d]), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      float x = cap(__fmul_rn(acc, scale), softcap);
      if (masked) {
        const int jk = t * P + j;
        bool vis = jk < length;
        if (p.window > 0) vis = vis && (jk > length - p.window);
        x = vis ? x : kNegInf;
      }
      dst[g * P + j] = x;
    }
  }
}

template <bool COMMIT, bool HAS_NEW>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int G = p.G, P = p.P, hd = p.hd, K = p.K;
  const int slab = P * hd;  // elements of one (page, kv head) slab
  const int chunks = slab * (int)sizeof(bf16) / 16;

  bf16* ring = reinterpret_cast<bf16*>(smem);  // slots x {K, V} x slab
  float* q_s = reinterpret_cast<float*>(smem + (size_t)p.slots * 2 * slab * sizeof(bf16));
  float* acc_s = q_s + G * hd;
  float* s_s = acc_s + G * hd;  // (G, P) logits, then probabilities
  float* m_s = s_s + G * P;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const bf16* qb = p.q + (size_t)(b * K + kvh) * G * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    q_s[e] = __bfloat162float(qb[e]);
    acc_s[e] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int length = p.lengths[b];
  int lo_tok = 0;
  if (p.window > 0) lo_tok = max(0, length - p.window + 1);
  const int lo = lo_tok / P;
  const int hi = min((length + P - 1) / P, p.n_pages);
  const int n = max(0, hi - lo);
  const int* pt = p.page_tables + (size_t)b * p.n_pages;
  const size_t layer_base = (size_t)p.layer * p.NF;

  // PRELOAD of stream block i (logical page lo + i) into ring slot i % slots
  auto issue = [&](int i) {
    if (i < n) {
      const int frame = pt[lo + i];
      const size_t base = ((layer_base + frame) * K + kvh) * (size_t)slab;
      const unsigned char* gk = reinterpret_cast<const unsigned char*>(p.k + base);
      const unsigned char* gv = reinterpret_cast<const unsigned char*>(p.v + base);
      unsigned char* sk = reinterpret_cast<unsigned char*>(ring + (size_t)(i % p.slots) * 2 * slab);
      unsigned char* sv = sk + (size_t)slab * sizeof(bf16);
      for (int c = tid; c < chunks; c += kThreads) {
        cp_async16(sk + c * 16, gk + c * 16);
        cp_async16(sv + c * 16, gv + c * 16);
      }
    }
    // one group per stream position, empty past the end, so the number of
    // groups younger than block i is a constant the wait can name
    cp_async_commit();
  };

  const int d = p.distance;
  for (int i = 0; i < d; ++i) issue(i);
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    if (p.sequential) {
      issue(i + d);  // PL[i + d] -> compute[i]; needs slots >= d + 1
      cp_async_wait_dyn(d);
    } else {
      cp_async_wait_dyn(d - 1);
    }
    __syncthreads();
    const bf16* kt = ring + (size_t)(i % p.slots) * 2 * slab;
    const bf16* vt = kt + slab;
    const int t = lo + i;

    dot_rows(q_s, kt, G, P, hd, p.scale, p.softcap, s_s, p, t, length, true);
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      float bmax = kNegInf;
      for (int j = 0; j < P; ++j) bmax = fmaxf(bmax, s_s[g * P + j]);
      const float m = m_s[g];
      const float new_m = fmaxf(m, bmax);
      const float corr = expf(__fsub_rn(m, new_m));
      float sum = 0.f;
      for (int j = 0; j < P; ++j) {
        const float pj = expf(__fsub_rn(s_s[g * P + j], new_m));
        s_s[g * P + j] = pj;
        sum = __fadd_rn(sum, pj);
      }
      m_s[g] = new_m;
      l_s[g] = __fmaf_rn(l_s[g], corr, sum);
      c_s[g] = corr;
    }
    __syncthreads();

    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd, dd = e - g * hd;
      float pv = 0.f;
      for (int j = 0; j < P; ++j)
        pv = __fmaf_rn(s_s[g * P + j], __bfloat162float(vt[j * hd + dd]), pv);
      acc_s[e] = __fmaf_rn(acc_s[e], c_s[g], pv);
    }
    __syncthreads();  // slot i % slots is free again

    if (!p.sequential) issue(i + d);
  }
  cp_async_wait<0>();

  if (HAS_NEW) {
    const bf16* kn = p.k_new + (size_t)(b * K + kvh) * hd;
    const bf16* vn = p.v_new + (size_t)(b * K + kvh) * hd;
    // the current token is one row: logits into s_s[g * 1 + 0]
    dot_rows(q_s, kn, G, 1, hd, p.scale, p.softcap, s_s, p, 0, 0, false);
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      const float m = m_s[g];
      const float ls = s_s[g];
      const float new_m = fmaxf(m, ls);
      const float corr = expf(__fsub_rn(m, new_m));
      const float pn = expf(__fsub_rn(ls, new_m));
      m_s[g] = new_m;
      l_s[g] = __fmaf_rn(l_s[g], corr, pn);
      c_s[g] = corr;
      s_s[g] = pn;
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd, dd = e - g * hd;
      acc_s[e] = __fmaf_rn(acc_s[e], c_s[g],
                           __fmul_rn(s_s[g], __bfloat162float(vn[dd])));
    }
    __syncthreads();
  }

  bf16* ob = p.out + (size_t)(b * K + kvh) * G * hd;
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd;
    ob[e] = __float2bfloat16_rn(__fdiv_rn(acc_s[e], fmaxf(l_s[g], 1e-30f)));
  }

  if (COMMIT) {
    const size_t row = ((layer_base + p.frames[b]) * K + kvh) * (size_t)slab +
                       (size_t)p.offsets[b] * hd;
    const bf16* kn = p.k_new + (size_t)(b * K + kvh) * hd;
    const bf16* vn = p.v_new + (size_t)(b * K + kvh) * hd;
    for (int e = tid; e < hd; e += kThreads) {
      p.k[row + e] = kn[e];
      p.v[row + e] = vn[e];
    }
  }
}

template <bool COMMIT, bool HAS_NEW>
int launch(const Params& p, int B, int smem_bytes, cudaStream_t stream) {
  auto kern = paged_decode_kernel<COMMIT, HAS_NEW>;
  // The opt-in to the full 227 KB is set once per instantiation (the limit
  // only caps the launch; occupancy follows smem_bytes), not on every launch.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (!ring_ok(p.distance, p.slots, p.sequential, smem_bytes) ||
      (p.P * p.hd * 2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(B, p.K), kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, void* k, void* v, const int* page_tables,
                   const int* lengths, const void* k_new, const void* v_new,
                   const int* frames, const int* offsets, void* out, int K,
                   int G, int P, int hd, int n_pages, int NF, int layer,
                   float scale, float softcap, int window, int distance,
                   int slots, int sequential) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<bf16*>(k);
  p.v = static_cast<bf16*>(v);
  p.page_tables = page_tables;
  p.lengths = lengths;
  p.k_new = static_cast<const bf16*>(k_new);
  p.v_new = static_cast<const bf16*>(v_new);
  p.frames = frames;
  p.offsets = offsets;
  p.out = static_cast<bf16*>(out);
  p.K = K;
  p.G = G;
  p.P = P;
  p.hd = hd;
  p.n_pages = n_pages;
  p.NF = NF;
  p.layer = layer;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  return p;
}

}  // namespace

extern "C" {

// K1: one layer of the single-sweep decode over the full (L, NF, K, P, hd)
// planes, committing k_new / v_new at (layer, frames[b], kv_h, offsets[b]).
int pul_paged_sweep_decode(const void* q, void* k_planes, void* v_planes,
                           const int* page_tables, const int* lengths,
                           const void* k_new, const void* v_new,
                           const int* frames, const int* offsets, void* out,
                           int B, int K, int G, int P, int hd, int n_pages,
                           int NF, int layer, float scale, float softcap,
                           int window, int distance, int slots, int sequential,
                           int smem_bytes, void* stream) {
  Params p = make_params(q, k_planes, v_planes, page_tables, lengths, k_new,
                         v_new, frames, offsets, out, K, G, P, hd, n_pages, NF,
                         layer, scale, softcap, window, distance, slots,
                         sequential);
  return launch<true, true>(p, B, smem_bytes, static_cast<cudaStream_t>(stream));
}

// K2: the same attention over one layer's (NP, K, P, hd) frames; k_new /
// v_new may be null (no current token), and nothing is written to the pages.
int pul_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                     const int* page_tables, const int* lengths,
                     const void* k_new, const void* v_new, void* out, int B,
                     int K, int G, int P, int hd, int n_pages, int NP,
                     float scale, float softcap, int window, int distance,
                     int slots, int sequential, int smem_bytes, void* stream) {
  Params p = make_params(q, const_cast<void*>(k_pages),
                         const_cast<void*>(v_pages), page_tables, lengths,
                         k_new, v_new, nullptr, nullptr, out, K, G, P, hd,
                         n_pages, NP, 0, scale, softcap, window, distance,
                         slots, sequential);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_new != nullptr) return launch<false, true>(p, B, smem_bytes, s);
  return launch<false, false>(p, B, smem_bytes, s);
}

}  // extern "C"
