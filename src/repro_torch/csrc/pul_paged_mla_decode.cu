// Absorbed-MLA paged decode attention over PUL-streamed compressed-KV pages,
// for Hopper (sm_90a).
//
// Replaces the two MLA kernels of the paged serving decode:
//   K3  repro/kernels/pul_attention.py : pul_paged_sweep_mla_decode_attention
//       (_paged_sweep_mla_decode_kernel) -- one layer of the single-sweep
//       decode over the full (L, NF, P, kvr) / (L, NF, P, dr) planes, with the
//       current token's compressed rows committed in the epilogue;
//   K4  repro/kernels/pul_attention.py : pul_paged_mla_decode_attention
//       (_paged_mla_decode_kernel) -- the same attention over one layer's
//       frames, no commit.
// Both are instantiations of ONE templated body (COMMIT), so on the same
// inputs their `out` is bitwise equal; explicit round-to-nearest intrinsics
// keep the compiler from fusing the two instantiations differently.
//
// What it computes, per slot b and query head h: logits over the visible
// positions s < length plus the current token,
//   (q_abs[h] . c[s] + q_rope[h] . r[s]) * scale,
// an fp32 online softmax, and out[h] = sum_s p[s] c[s] / l -- the compressed
// row c is also the value stream (absorbed decode).
//
// Bound on this card: bytes. All H query heads share each compressed row, so
// every (kvr + dr)-wide bf16 row feeds H * 2 * (2 kvr + dr) flops: about 238
// flops per byte at full deepseek-v2 width (H = 128, kvr = 512, dr = 64),
// below the bf16 tensor cores' 989 TFLOP/s over 3.35 TB/s (295 flops per
// byte) but far above the fp32 CUDA cores' 67 TFLOP/s (20 flops per byte).
// At the smoke's mixed case (8 slots, 2857 tokens) the bound is 1.7 us of
// bytes (0.8 us of bf16 tensor-core work); this kernel does its math on the
// fp32 CUDA cores, which alone take at least 11.9 us.
//
// What the design does about it, and what it gives up:
//   * grid (B, H / Hb): the TPU kernel holds all H heads in one program, and
//     q_abs plus the fp32 accumulator alone are 2 * H * kvr * 4 B = 512 KB at
//     full width, beyond the 227 KB of shared memory a Hopper block may use.
//     Heads are split into blocks of Hb = 8 (HEAD_BLOCK on the host), which
//     also spreads the arithmetic over B * H / 8 = 128 blocks, about one per
//     SM. The price: each visible page crosses HBM or L2 H / Hb = 16 times
//     per step instead of once, mostly from L2. Since this kernel's fp32 math
//     (11.9 us) outweighs those reads, the trade is taken here; a tensor-core
//     (wgmma) redesign that keeps more heads per block is later work;
//   * a ring of `slots` (P, kvr) + (P, dr) slab pairs in shared memory, filled
//     by 16-byte cp.async `distance` pages ahead of the compute -- the port of
//     PreloadStream / pul_loop (core/pipeline.py), page table as the trace.
//     BATCH issues page i + d after computing page i, SEQUENTIAL before. At
//     Hb = 8 a slot is P * (kvr + dr) * 2 = 18,432 B and the rest of the block
//     (q_abs, q_rope, accumulator, logits, m/l/corr) 35,424 B, so 10 slots fit;
//     the host side (mla_ring_plan) clamps the planner's d* (28 at six
//     layers, 8 at sixty) to them;
//   * only pages holding a position < length are streamed, and within a page
//     only its visible rows enter the logits, the softmax and the value sum;
//   * 512 threads per block: warps take a page's rows for the logits, one
//     warp per head runs the page's softmax step, and in the value sum each
//     thread takes one compressed feature for all Hb heads (one ring load
//     feeds Hb independent FMA chains). The math stays on the fp32 CUDA
//     cores; tensor cores are later work.
//
// The fp32 online softmax keeps the TPU kernel's constants: m starts at
// NEG_INF = -2e38 and l >= 1e-30 at the end. The current token is always
// folded in after the stream, so with length == 0, out == c_new.
//
// The commit epilogue (K3): block (b, 0) alone writes c_new / r_new to row
// offsets[b] of (layer, frames[b]). That row is position length, so it never
// enters this step's softmax; but the other head blocks of slot b may still be
// copying the whole tail-page slab while it is written, and may see a torn
// row. Masked rows therefore leave the sum by selection -- they are never
// read out of the ring -- and not as p = 0 times their value, so a torn row
// cannot reach `out`. Inactive slots point at the pool's TRASH frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pul_ring.cuh"

namespace {

using namespace pul;

// 16 warps: one block of ~215 KB fills an SM, so its own warps are all
// that hide shared-memory latency
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// largest head block; the host side's HEAD_BLOCK
constexpr int kMaxHeads = 8;

struct Params {
  const bf16* q_abs;       // (B, H, kvr)
  const bf16* q_rope;      // (B, H, dr)
  bf16* ckv;               // plane (L, NF, P, kvr); L = 1 for K4
  bf16* kr;                // plane (L, NF, P, dr)
  const int* page_tables;  // (B, n_pages) physical frame per logical page
  const int* lengths;      // (B,) cached tokens per slot
  const bf16* c_new;       // (B, kvr) the current token's compressed row
  const bf16* r_new;       // (B, dr)
  const int* frames;       // (B,) commit frame (K3)
  const int* offsets;      // (B,) commit row (K3)
  bf16* out;               // (B, H, kvr)
  int H, Hb, P, kvr, dr, n_pages, NF, layer;
  float scale;
  int distance, slots, sequential;
};

// Logits of rows [0, rows) of a (c, r) row pair block for the block's Hb
// heads: warp w takes rows w, w + kWarps, ...; its lanes stride the features
// and each lane keeps one partial sum per head. dst[h * stride + j].
__device__ __forceinline__ void row_logits(const bf16* c, const bf16* r,
                                           int rows, const float* qa_s,
                                           const float* qr_s, float* dst,
                                           int stride, const Params& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Hb = p.Hb, kvr = p.kvr, dr = p.dr;
  for (int j = warp; j < rows; j += kWarps) {
    float a[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) a[h] = 0.f;
    const bf16* cj = c + (size_t)j * kvr;
    for (int d = lane; d < kvr; d += 32) {
      const float cv = __bfloat162float(cj[d]);
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < Hb) a[h] = __fmaf_rn(qa_s[h * kvr + d], cv, a[h]);
    }
    const bf16* rj = r + (size_t)j * dr;
    for (int d = lane; d < dr; d += 32) {
      const float rv = __bfloat162float(rj[d]);
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h)
        if (h < Hb) a[h] = __fmaf_rn(qr_s[h * dr + d], rv, a[h]);
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < Hb) {
        const float x = warp_sum(a[h]);
        if (lane == 0) dst[h * stride + j] = __fmul_rn(x, p.scale);
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <bool COMMIT>
__global__ void __launch_bounds__(kThreads) paged_mla_decode_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h0 = blockIdx.y * p.Hb, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int Hb = p.Hb, P = p.P, kvr = p.kvr, dr = p.dr;
  const int c_slab = P * kvr, r_slab = P * dr;  // elements of one page's slabs
  const int slot_elems = c_slab + r_slab;
  const int c_chunks = c_slab * (int)sizeof(bf16) / 16;
  const int r_chunks = r_slab * (int)sizeof(bf16) / 16;

  bf16* ring = reinterpret_cast<bf16*>(smem);  // slots x {c slab, r slab}
  float* qa_s = reinterpret_cast<float*>(
      smem + (size_t)p.slots * slot_elems * sizeof(bf16));
  float* qr_s = qa_s + Hb * kvr;
  float* acc_s = qr_s + Hb * dr;
  float* s_s = acc_s + Hb * kvr;  // (Hb, P) logits, then probabilities
  float* m_s = s_s + Hb * P;
  float* l_s = m_s + Hb;
  float* c_s = l_s + Hb;

  const bf16* qa = p.q_abs + ((size_t)b * p.H + h0) * kvr;
  const bf16* qr = p.q_rope + ((size_t)b * p.H + h0) * dr;
  for (int e = tid; e < Hb * kvr; e += kThreads) {
    qa_s[e] = __bfloat162float(qa[e]);
    acc_s[e] = 0.f;
  }
  for (int e = tid; e < Hb * dr; e += kThreads) qr_s[e] = __bfloat162float(qr[e]);
  if (tid < Hb) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int length = p.lengths[b];
  const int n = min((length + P - 1) / P, p.n_pages);  // pages with a visible row
  const int* pt = p.page_tables + (size_t)b * p.n_pages;
  const size_t layer_base = (size_t)p.layer * p.NF;

  // PRELOAD of stream block i (logical page i) into ring slot i % slots
  auto issue = [&](int i) {
    if (i < n) {
      const size_t frame = layer_base + pt[i];
      const unsigned char* gc =
          reinterpret_cast<const unsigned char*>(p.ckv + frame * c_slab);
      const unsigned char* gr =
          reinterpret_cast<const unsigned char*>(p.kr + frame * r_slab);
      unsigned char* sc =
          reinterpret_cast<unsigned char*>(ring + (size_t)(i % p.slots) * slot_elems);
      unsigned char* sr = sc + (size_t)c_slab * sizeof(bf16);
      for (int c = tid; c < c_chunks; c += kThreads) cp_async16(sc + c * 16, gc + c * 16);
      for (int c = tid; c < r_chunks; c += kThreads) cp_async16(sr + c * 16, gr + c * 16);
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
    const bf16* ct = ring + (size_t)(i % p.slots) * slot_elems;
    const bf16* rt = ct + c_slab;
    const int vis = min(P, length - i * P);  // visible rows of this page, >= 1

    row_logits(ct, rt, vis, qa_s, qr_s, s_s, P, p);
    __syncthreads();

    // the page's online-softmax step, one warp per head (Hb <= kWarps)
    if (warp < Hb) {
      const int h = warp;
      float bmax = kNegInf;
      for (int j = lane; j < vis; j += 32) bmax = fmaxf(bmax, s_s[h * P + j]);
      bmax = warp_max(bmax);
      const float m = m_s[h];
      const float new_m = fmaxf(m, bmax);
      float sum = 0.f;
      for (int j = lane; j < vis; j += 32) {
        const float pj = expf(__fsub_rn(s_s[h * P + j], new_m));
        s_s[h * P + j] = pj;
        sum = __fadd_rn(sum, pj);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(__fsub_rn(m, new_m));
        m_s[h] = new_m;
        l_s[h] = __fmaf_rn(l_s[h], corr, sum);
        c_s[h] = corr;
      }
    }
    __syncthreads();

    // values: each thread takes compressed features dd and all Hb heads, so
    // one ring load feeds Hb independent FMA chains
    for (int dd = tid; dd < kvr; dd += kThreads) {
      float pv[kMaxHeads];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) pv[h] = 0.f;
      for (int j = 0; j < vis; ++j) {
        const float cv = __bfloat162float(ct[j * kvr + dd]);
#pragma unroll
        for (int h = 0; h < kMaxHeads; ++h)
          if (h < Hb) pv[h] = __fmaf_rn(s_s[h * P + j], cv, pv[h]);
      }
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < Hb) {
          float* a = acc_s + h * kvr + dd;
          *a = __fmaf_rn(*a, c_s[h], pv[h]);
        }
      }
    }
    __syncthreads();  // slot i % slots is free again

    if (!p.sequential) issue(i + d);
  }
  cp_async_wait<0>();

  // the current token (position length, not yet paged): always visible
  const bf16* cn = p.c_new + (size_t)b * kvr;
  const bf16* rn = p.r_new + (size_t)b * dr;
  row_logits(cn, rn, 1, qa_s, qr_s, s_s, 1, p);
  __syncthreads();
  for (int h = tid; h < Hb; h += kThreads) {
    const float m = m_s[h];
    const float ls = s_s[h];
    const float new_m = fmaxf(m, ls);
    const float corr = expf(__fsub_rn(m, new_m));
    const float pn = expf(__fsub_rn(ls, new_m));
    m_s[h] = new_m;
    l_s[h] = __fmaf_rn(l_s[h], corr, pn);
    c_s[h] = corr;
    s_s[h] = pn;
  }
  __syncthreads();

  bf16* ob = p.out + ((size_t)b * p.H + h0) * kvr;
  for (int e = tid; e < Hb * kvr; e += kThreads) {
    const int h = e / kvr, dd = e - h * kvr;
    const float a = __fmaf_rn(acc_s[e], c_s[h],
                              __fmul_rn(s_s[h], __bfloat162float(cn[dd])));
    ob[e] = __float2bfloat16_rn(__fdiv_rn(a, fmaxf(l_s[h], 1e-30f)));
  }

  if (COMMIT && blockIdx.y == 0) {
    const size_t frame = layer_base + p.frames[b];
    bf16* cdst = p.ckv + frame * c_slab + (size_t)p.offsets[b] * kvr;
    bf16* rdst = p.kr + frame * r_slab + (size_t)p.offsets[b] * dr;
    for (int e = tid; e < kvr; e += kThreads) cdst[e] = cn[e];
    for (int e = tid; e < dr; e += kThreads) rdst[e] = rn[e];
  }
}

template <bool COMMIT>
int launch(const Params& p, int B, int smem_bytes, cudaStream_t stream) {
  auto kern = paged_mla_decode_kernel<COMMIT>;
  // the opt-in to the full 227 KB, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (!ring_ok(p.distance, p.slots, p.sequential, smem_bytes) || B < 1 ||
      p.Hb < 1 || p.Hb > kMaxHeads || p.H % p.Hb || p.kvr % 8 || p.dr % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(B, p.H / p.Hb), kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q_abs, const void* q_rope, void* ckv, void* kr,
                   const int* page_tables, const int* lengths,
                   const void* c_new, const void* r_new, const int* frames,
                   const int* offsets, void* out, int H, int Hb, int P,
                   int kvr, int dr, int n_pages, int NF, int layer,
                   float scale, int distance, int slots, int sequential) {
  Params p;
  p.q_abs = static_cast<const bf16*>(q_abs);
  p.q_rope = static_cast<const bf16*>(q_rope);
  p.ckv = static_cast<bf16*>(ckv);
  p.kr = static_cast<bf16*>(kr);
  p.page_tables = page_tables;
  p.lengths = lengths;
  p.c_new = static_cast<const bf16*>(c_new);
  p.r_new = static_cast<const bf16*>(r_new);
  p.frames = frames;
  p.offsets = offsets;
  p.out = static_cast<bf16*>(out);
  p.H = H;
  p.Hb = Hb;
  p.P = P;
  p.kvr = kvr;
  p.dr = dr;
  p.n_pages = n_pages;
  p.NF = NF;
  p.layer = layer;
  p.scale = scale;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  return p;
}

}  // namespace

extern "C" {

// K3: one layer of the single-sweep absorbed-MLA decode over the full
// (L, NF, P, kvr) / (L, NF, P, dr) planes, committing c_new / r_new at
// (layer, frames[b], offsets[b]).
int pul_paged_sweep_mla_decode(const void* q_abs, const void* q_rope,
                               void* ckv_planes, void* kr_planes,
                               const int* page_tables, const int* lengths,
                               const void* c_new, const void* r_new,
                               const int* frames, const int* offsets,
                               void* out, int B, int H, int Hb, int P, int kvr,
                               int dr, int n_pages, int NF, int layer,
                               float scale, int distance, int slots,
                               int sequential, int smem_bytes, void* stream) {
  Params p = make_params(q_abs, q_rope, ckv_planes, kr_planes, page_tables,
                         lengths, c_new, r_new, frames, offsets, out, H, Hb, P,
                         kvr, dr, n_pages, NF, layer, scale, distance, slots,
                         sequential);
  return launch<true>(p, B, smem_bytes, static_cast<cudaStream_t>(stream));
}

// K4: the same attention over one layer's (NP, P, kvr) / (NP, P, dr) frames;
// nothing is written to the pages.
int pul_paged_mla_decode(const void* q_abs, const void* q_rope,
                         const void* ckv_pages, const void* kr_pages,
                         const int* page_tables, const int* lengths,
                         const void* c_new, const void* r_new, void* out,
                         int B, int H, int Hb, int P, int kvr, int dr,
                         int n_pages, int NP, float scale, int distance,
                         int slots, int sequential, int smem_bytes,
                         void* stream) {
  Params p = make_params(q_abs, q_rope, const_cast<void*>(ckv_pages),
                         const_cast<void*>(kr_pages), page_tables, lengths,
                         c_new, r_new, nullptr, nullptr, out, H, Hb, P, kvr,
                         dr, n_pages, NP, 0, scale, distance, slots,
                         sequential);
  return launch<false>(p, B, smem_bytes, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
