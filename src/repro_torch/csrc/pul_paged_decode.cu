// Paged decode attention over PUL-streamed KV pages, for Hopper (sm_90a),
// as split-KV over the page table.
//
// Replaces the two TPU kernels of the paged serving decode:
//   K1  repro/kernels/pul_attention.py : pul_paged_sweep_decode_attention
//       (_paged_sweep_decode_kernel) -- one layer of the single-sweep decode
//       over the full per-layer planes, with the new token's K/V committed
//       in the epilogue;
//   K2  repro/kernels/pul_attention.py : pul_paged_decode_attention
//       (_paged_decode_kernel) -- the same attention over one layer's frames,
//       no commit.
// Each entry point launches the same two kernels: split_kernel (one
// instantiation per head-group bound, shared by K1 and K2; the host hands
// it the layer's plane) and merge_kernel<COMMIT, HAS_NEW>, whose arithmetic
// uses explicit round-to-nearest intrinsics (no compiler contraction). So on
// the same inputs K1 and K2 produce bitwise-equal `out`.
//
// Bound on this card: bytes. Row b reads the K and V slab of each page that
// holds a visible position: sum_b ceil(len_b / P) * P * hd * 2 B per tensor
// and kv head. The arithmetic is 4 * G * hd flops per cached token against
// 4 * hd bytes of bf16 K and V: 2 flops per byte at qwen3's G = 2, far below
// the card's flop:byte balance. No tensor cores here, on purpose: an m16
// mma tile would hold G = 2 useful rows of 16, 7/8 of it idle, and the
// kernel would still wait on the same bytes.
//
// What bounded the one-block-per-row design was not the bytes but the
// latency chain of the longest row (63 pages walked by one block, a 5-step
// shuffle per (head, key) and four block barriers per page). The design:
//   * split-KV: grid (n_split, K, B). Row b's visible pages are [lo, hi),
//     from lengths[b] and the window, on the device; split s streams pages
//     [lo + s c, min(hi, lo + (s + 1) c)), c = ceil((hi - lo) / n_split),
//     so a long row spreads over every split and a short row leaves splits
//     empty. The host's paged_split_plan picks n_split from the shapes and
//     the SM count alone (never from lengths or the layer), so K1 and K2
//     get the same plan without a host sync;
//   * one block serves all G query heads of one kv head, so each page slab
//     crosses HBM once per step, not once per query head;
//   * a (P, hd) slab is contiguous in the plane (4 KB at P = 16, hd = 128)
//     and is copied with 16-byte cp.async per thread into a shared-memory
//     ring, `distance` pages ahead of the compute -- the port of
//     PreloadStream / pul_loop (core/pipeline.py), page table as the trace.
//     BATCH issues page i + d after computing page i, SEQUENTIAL before.
//     cp.async, not the 1D bulk copy K5 uses: a split streams a few pages
//     of two 4 KB spans each, four 16-byte copies per thread a page, and a
//     landed page needs one block barrier either way (or an mbarrier wait in
//     every warp); the bulk copy would add an elected producer and empty
//     barriers to save those four instructions;
//   * logits, K6's threads-per-key scheme: a lane group of tpk = hd / 8
//     lanes (rounded up to a power of two) holds one key's row, a 16-byte
//     granule per lane; q of all G heads for the lane's granule sits in
//     registers, so a logit is 8 FMAs and log2(tpk) shuffles;
//   * each lane group keeps its own fp32 online softmax state (m, l and the
//     accumulator of its granule, all G heads) in registers over the keys it
//     owns, two keys at a time. Inside the page loop the only barrier is the
//     ring's; the states are merged once, at the end of the block: by
//     shuffles inside a warp, through shared memory across the four warps.
//     The softmax runs in base-2 units, q pre-scaled by scale * log2(e)
//     (by scale alone under a softcap, whose tanh bends natural units), so
//     each weight is one ex2.approx (2 ulp) and no multiply by the scale
//     is left in the loop; m in the workspace is in those units too;
//   * only pages holding a position < length (and inside the window) are
//     streamed. The TPU kernel streams all n_pages, but the masked pages it
//     reads before the first visible one are cancelled exactly by
//     corr = exp(NEG_INF - m) = 0, and those after the last add p = 0, so
//     skipping them changes no value. Masked keys inside a streamed page get
//     p = 0 outright;
//   * each split writes its fp32 (m, l, acc) to a workspace (B, K, n_split,
//     G[, hd]) that the wrapper allocates on the caller's stream; an empty
//     split writes m = NEG_INF, l = 0, acc = 0;
//   * ring size: distance and slots are clamped to shared memory (227 KB,
//     the counterpart of ring_scratch's VMEM check), to kMaxDistance, the
//     depth of the cp.async.wait_group table (pul_ring.cuh), and to the
//     pages of one split.
//
// The merge, grid (K, B): M = the largest of the splits' m and the current
// token's logit, out = (sum_s acc_s e^(m_s - M) + p_new v_new) /
// max(sum_s l_s e^(m_s - M) + p_new, 1e-30), p_new = e^(logit_new - M). The
// TPU kernel's constants stay: NEG_INF = -2e38 for masked logits, l >= 1e-30
// at the end, the current token (always visible, always inside the window)
// folded in last. With length == 0 and a current token, out == v_new; with
// nothing visible and no current token, out == 0.
//
// The commit (K1) is the merge's: block (kv_h, b) writes k_new / v_new to
// row offsets[b] of (layer, frames[b], kv_h). That row is position length,
// which no split reads, and the splits have finished by then (stream
// order). Inactive slots point at the pool's TRASH frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVals = 8;   // bf16 values of one 16-byte granule
constexpr int kMaxG = 16;  // query heads of one kv head
constexpr int kMaxHd = 32 * kVals;  // a row over at most one warp's lanes

struct Params {
  const bf16* q;           // (B, K, G, hd)
  bf16* k;                 // this layer's frames (NF, K, P, hd)
  bf16* v;
  const int* page_tables;  // (B, n_pages) physical frame per logical page
  const int* lengths;      // (B,) cached tokens per slot
  const bf16* k_new;       // (B, K, hd), or null (K2 without a current token)
  const bf16* v_new;
  const int* frames;       // (B,) commit frame (K1)
  const int* offsets;      // (B,) commit row (K1)
  bf16* out;               // (B, K, G, hd)
  float* part_m;           // (B, K, n_split, G) split maxima
  float* part_l;           // (B, K, n_split, G) split sums
  float* part_acc;         // (B, K, n_split, G, hd) split accumulators
  int K, G, P, hd, n_pages, n_split;
  int tpk;                 // lanes of one key's row: hd / 8 up to a power of two
  float scale, softcap;    // softcap <= 0: none
  int window;              // <= 0: none
  int distance, slots, sequential;
};

__device__ __forceinline__ float cap(float x, float softcap) {
  if (softcap > 0.f) return __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
  return x;
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a logit in base-2 units from the dot product of q pre-scaled by
// q_scale(p): scale * log2(e) without a softcap, scale with one (the cap
// bends natural units)
__device__ __forceinline__ float q_scale(const Params& p) {
  return p.softcap > 0.f ? p.scale : p.scale * kLog2e;
}
__device__ __forceinline__ float logit2(float dot, const Params& p) {
  return p.softcap > 0.f ? cap(dot, p.softcap) * kLog2e : dot;
}

// eight bf16 values of one 16-byte granule, widened
__device__ __forceinline__ void load8(const bf16* src, float (&dst)[kVals]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVals / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Block (split, kv head, b): the G query heads of kv head kvh over the
// pages of one split of row b. GM >= G bounds the heads held in registers
// (heads g >= G hold q = 0 and are never written); TPK = p.tpk is the lane
// group of one key, a compile-time width so that every step below unrolls
// into straight-line code.
template <int GM, int TPK>
__global__ void __launch_bounds__(kThreads) split_kernel(Params p) {
  constexpr int n_grp = kThreads / TPK;  // lane groups of the block
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, P = p.P, hd = p.hd, K = p.K;
  const int part = tid % TPK, grp = tid / TPK;
  const bool mine = part * kVals < hd;  // lanes past the row hold zeros
  const size_t state = ((size_t)b * K + kvh) * p.n_split + split;
  float* pm = p.part_m + state * G;
  float* pl = p.part_l + state * G;
  float* pa = p.part_acc + state * G * hd;

  // q and the length are loaded together: neither waits for the other.
  // The softmax runs in base-2 units (m, l and the logits), q pre-scaled.
  float q[GM][kVals], acc[GM][kVals], m[GM], l[GM];
  const bf16* qb = p.q + ((size_t)b * K + kvh) * G * hd;
  const float qs = q_scale(p);
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G && mine) {
      load8(qb + g * hd + part * kVals, q[g]);
#pragma unroll
      for (int e = 0; e < kVals; ++e) q[g][e] *= qs;
    } else {
#pragma unroll
      for (int e = 0; e < kVals; ++e) q[g][e] = 0.f;
    }
  }
  const int length = p.lengths[b];
  const int lo_tok = p.window > 0 ? max(0, length - p.window + 1) : 0;
  const int lo = lo_tok / P;
  const int hi = min((length + P - 1) / P, p.n_pages);
  const int per = (max(0, hi - lo) + p.n_split - 1) / p.n_split;
  const int t0 = lo + split * per;
  const int n = max(0, min(hi, t0 + per) - t0);
  if (n == 0) {  // nothing here: a split that weighs 0 in the merge
    for (int e = tid; e < G * hd; e += kThreads) pa[e] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      pm[g] = kNegInf;
      pl[g] = 0.f;
    }
    return;
  }

#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVals; ++e) acc[g][e] = 0.f;
  }

  const int slab = P * hd;  // elements of one (page, kv head) slab
  const int chunks = slab * (int)sizeof(bf16) / 16;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // slots x {K, V} x slab
  const int* pt = p.page_tables + (size_t)b * p.n_pages + t0;

  // PRELOAD of stream block i (logical page t0 + i) into ring slot i % slots
  // (kept as a counter, as is the slot computed on); its frame was read one
  // issue earlier, so no issue waits on the table
  int frame = pt[0], fill = 0, use = 0;
  auto issue = [&](int i) {
    if (i < n) {
      const size_t base = ((size_t)frame * K + kvh) * (size_t)slab;
      const unsigned char* gk = reinterpret_cast<const unsigned char*>(p.k + base);
      const unsigned char* gv = reinterpret_cast<const unsigned char*>(p.v + base);
      unsigned char* sk = reinterpret_cast<unsigned char*>(ring + (size_t)fill * 2 * slab);
      if (++fill == p.slots) fill = 0;
      unsigned char* sv = sk + (size_t)slab * sizeof(bf16);
      for (int c = tid; c < chunks; c += kThreads) {
        cp_async16(sk + c * 16, gk + c * 16);
        cp_async16(sv + c * 16, gv + c * 16);
      }
      if (i + 1 < n) frame = pt[i + 1];
    }
    // one group per stream position, empty past the end, so the number of
    // groups younger than block i is a constant the wait can name
    cp_async_commit();
  };

  const int d = p.distance;
  for (int i = 0; i < d; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    cp_async_wait_dyn(d - 1);
    __syncthreads();  // page i landed for every thread; page i - 1 consumed
    if (p.sequential) issue(i + d);  // PL[i + d] -> compute[i]; slots >= d + 1
    const bf16* kt = ring + (size_t)use * 2 * slab;
    const bf16* vt = kt + slab;
    if (++use == p.slots) use = 0;
    const int tok0 = (t0 + i) * P;
    // group grp owns keys grp, grp + n_grp, ...: two of them per step. A
    // step loads both keys' granules, then forms every (key, head) partial
    // dot, then reduces them all across the group one shuffle level at a
    // time, so the chains of the keys and the heads overlap.
    for (int jb = 0; jb < P; jb += 2 * n_grp) {
      float kf[2][kVals], vf[2][kVals], s[2][GM];
      bool vis[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = jb + grp + u * n_grp;
        const int jk = tok0 + j;
        vis[u] = j < P && jk < length && jk >= lo_tok;
        if (j < P && mine) {
          load8(kt + j * hd + part * kVals, kf[u]);
          load8(vt + j * hd + part * kVals, vf[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kVals; ++e) kf[u][e] = vf[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float even = 0.f, odd = 0.f;
#pragma unroll
          for (int e = 0; e < kVals; e += 2) {
            even = fmaf(q[g][e], kf[u][e], even);
            odd = fmaf(q[g][e + 1], kf[u][e + 1], odd);
          }
          s[u][g] = even + odd;
        }
#pragma unroll
      for (int o = TPK / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < GM; ++g)
            s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float x0 = vis[0] ? logit2(s[0][g], p) : kNegInf;
        const float x1 = vis[1] ? logit2(s[1][g], p) : kNegInf;
        const float new_m = fmaxf(m[g], fmaxf(x0, x1));
        const float corr = fast_exp2(m[g] - new_m);
        const float p0 = vis[0] ? fast_exp2(x0 - new_m) : 0.f;
        const float p1 = vis[1] ? fast_exp2(x1 - new_m) : 0.f;
        l[g] = l[g] * corr + p0 + p1;
#pragma unroll
        for (int e = 0; e < kVals; ++e)
          acc[g][e] = fmaf(p1, vf[1][e], fmaf(p0, vf[0][e], acc[g][e] * corr));
        m[g] = new_m;
      }
    }
    if (!p.sequential) {
      if (p.slots <= d) __syncthreads();  // slot i % slots is reloaded next
      issue(i + d);
    }
  }
  cp_async_wait<0>();

  // the lane groups of a warp merge their states by shuffles ...
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int o = TPK; o < 32; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float M = fmaxf(m[g], mo);
      const float ws = fast_exp2(m[g] - M), wo = fast_exp2(mo - M);
      l[g] = l[g] * ws + lo_ * wo;
#pragma unroll
      for (int e = 0; e < kVals; ++e)
        acc[g][e] = acc[g][e] * ws + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * wo;
      m[g] = M;
    }
  }
  // ... and the warps theirs through shared memory, past the ring
  float* w_m = reinterpret_cast<float*>(smem + (size_t)p.slots * 2 * slab * sizeof(bf16));
  float* w_l = w_m + kWarps * G;
  float* w_acc = w_l + kWarps * G;  // (kWarps, G, hd)
  if (lane < TPK && mine) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int e = 0; e < kVals; ++e)
        w_acc[(warp * G + g) * hd + part * kVals + e] = acc[g][e];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      w_m[warp * G + g] = m[g];
      w_l[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = fast_exp2(w_m[w * G + g] - M);
      L = fmaf(w_l[w * G + g], wt, L);
      A = fmaf(w_acc[w * G * hd + e], wt, A);
    }
    pa[e] = A;
    if (e == g * hd) {
      pm[g] = M;
      pl[g] = L;
    }
  }
}

// Block (kv head, b): the splits' states of the G heads merged with the
// current token; K1 also commits k_new / v_new. Every read that does not
// wait on another is issued first: K1's commit row and granules, the
// current token's q and k_new granules (the split kernel's lane groups),
// the splits' maxima of this thread's first head; so the kernel waits on
// two rounds of reads, not five.
template <bool COMMIT, bool HAS_NEW>
__global__ void __launch_bounds__(kThreads) merge_kernel(Params p) {
  __shared__ float s_new[kMaxG];  // the current token's logit per head
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = p.G, hd = p.hd, S = p.n_split, tpk = p.tpk;
  const size_t bk = (size_t)b * p.K + kvh;
  const bf16* kn = HAS_NEW ? p.k_new + bk * hd : nullptr;
  const bf16* vn = HAS_NEW ? p.v_new + bk * hd : nullptr;
  const float* pm = p.part_m + bk * S * G;
  const float* pl = p.part_l + bk * S * G;
  const float* pa = p.part_acc + bk * S * G * hd;

  // K1's commit: granule tid of k_new / v_new to row offsets[b] of frame
  // frames[b] (position length, which no split read)
  const bool commits = COMMIT && tid * kVals < hd;
  uint4 kc, vc;
  size_t row = 0;
  if (commits) {
    row = ((size_t)p.frames[b] * p.K + kvh) * (size_t)(p.P * hd) +
          (size_t)p.offsets[b] * hd + tid * kVals;
    kc = *reinterpret_cast<const uint4*>(kn + tid * kVals);
    vc = *reinterpret_cast<const uint4*>(vn + tid * kVals);
  }
  float M0 = kNegInf;  // the splits' largest m of this thread's first head
  if (tid < G * hd) {
#pragma unroll 8
    for (int s = 0; s < S; ++s) M0 = fmaxf(M0, pm[s * G + tid / hd]);
  }
  if (HAS_NEW) {
    const bf16* qb = p.q + bk * G * hd;
    const int part = tid % tpk;
    const bool mine = part * kVals < hd;
    float kf[kVals];
    if (mine) load8(kn + part * kVals, kf);
    // heads g = tid / tpk, + kThreads / tpk, ...: whole warps take a step
    for (int g0 = 0; g0 < G; g0 += kThreads / tpk) {
      const int g = g0 + tid / tpk;
      float dot = 0.f;
      if (g < G && mine) {
        float qf[kVals];
        load8(qb + g * hd + part * kVals, qf);
#pragma unroll
        for (int e = 0; e < kVals; ++e) dot = __fmaf_rn(qf[e], kf[e], dot);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o < tpk) dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, o));
      if (g < G && part == 0) s_new[g] = logit2(__fmul_rn(dot, q_scale(p)), p);
    }
    __syncthreads();
  }
  bf16* ob = p.out + bk * G * hd;
#pragma unroll 2
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd, dd = e - g * hd;
    float M = HAS_NEW ? s_new[g] : kNegInf;
    if (e == tid) {
      M = fmaxf(M, M0);
    } else {
#pragma unroll 8
      for (int s = 0; s < S; ++s) M = fmaxf(M, pm[s * G + g]);
    }
    float L = 0.f, A = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float w = fast_exp2(__fsub_rn(pm[s * G + g], M));
      L = __fmaf_rn(pl[s * G + g], w, L);
      A = __fmaf_rn(pa[(size_t)s * G * hd + e], w, A);
    }
    if (HAS_NEW) {
      const float pn = fast_exp2(__fsub_rn(s_new[g], M));
      L = __fadd_rn(L, pn);
      A = __fmaf_rn(pn, __bfloat162float(vn[dd]), A);
    }
    ob[e] = __float2bfloat16_rn(__fdiv_rn(A, fmaxf(L, 1e-30f)));
  }
  if (commits) {
    *reinterpret_cast<uint4*>(p.k + row) = kc;
    *reinterpret_cast<uint4*>(p.v + row) = vc;
  }
}

template <int GM, int TPK>
int launch_split(const Params& p, int B, int smem_bytes, cudaStream_t stream) {
  // The opt-in to the full 227 KB is set once per instantiation (the limit
  // only caps the launch; occupancy follows smem_bytes), not on every launch.
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_kernel<GM, TPK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  split_kernel<GM, TPK>
      <<<dim3(p.n_split, p.K, B), kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int GM>
int launch_split_tpk(const Params& p, int B, int smem_bytes, cudaStream_t s) {
  switch (p.tpk) {
    case 2: return launch_split<GM, 2>(p, B, smem_bytes, s);
    case 4: return launch_split<GM, 4>(p, B, smem_bytes, s);
    case 8: return launch_split<GM, 8>(p, B, smem_bytes, s);
    case 16: return launch_split<GM, 16>(p, B, smem_bytes, s);
    case 32: return launch_split<GM, 32>(p, B, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool COMMIT, bool HAS_NEW>
int launch(Params p, int B, int smem_bytes, cudaStream_t stream) {
  const long long ring = (long long)p.slots * 2 * p.P * p.hd * sizeof(bf16);
  const long long merge = (long long)kWarps * p.G * (p.hd + 2) * sizeof(float);
  if (!ring_ok(p.distance, p.slots, p.sequential, smem_bytes) ||
      ring + merge > smem_bytes || p.G < 1 || p.G > kMaxG || p.hd < 2 * kVals ||
      p.hd % kVals || p.hd > kMaxHd || p.n_split < 1 || p.n_split > 65535 ||
      p.K > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.tpk = 1;
  while (p.tpk * kVals < p.hd) p.tpk <<= 1;
  const int rc = p.G <= 2   ? launch_split_tpk<2>(p, B, smem_bytes, stream)
                 : p.G <= 4 ? launch_split_tpk<4>(p, B, smem_bytes, stream)
                 : p.G <= 8 ? launch_split_tpk<8>(p, B, smem_bytes, stream)
                            : launch_split_tpk<16>(p, B, smem_bytes, stream);
  if (rc != 0) return rc;
  merge_kernel<COMMIT, HAS_NEW><<<dim3(p.K, B), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, void* k, void* v, const int* page_tables,
                   const int* lengths, const void* k_new, const void* v_new,
                   const int* frames, const int* offsets, void* out,
                   float* part_m, float* part_l, float* part_acc, int K,
                   int G, int P, int hd, int n_pages, int n_split, float scale,
                   float softcap, int window, int distance, int slots,
                   int sequential) {
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
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.K = K;
  p.G = G;
  p.P = P;
  p.hd = hd;
  p.n_pages = n_pages;
  p.n_split = n_split;
  p.tpk = 1;
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
// part_m / part_l (B, K, n_split, G) and part_acc (B, K, n_split, G, hd) are
// the fp32 workspace of the splits.
int pul_paged_sweep_decode(const void* q, void* k_planes, void* v_planes,
                           const int* page_tables, const int* lengths,
                           const void* k_new, const void* v_new,
                           const int* frames, const int* offsets, void* out,
                           float* part_m, float* part_l, float* part_acc,
                           int B, int K, int G, int P, int hd, int n_pages,
                           int NF, int layer, int n_split, float scale,
                           float softcap, int window, int distance, int slots,
                           int sequential, int smem_bytes, void* stream) {
  const size_t plane = (size_t)layer * NF * K * P * hd;
  Params p = make_params(
      q, static_cast<bf16*>(k_planes) + plane,
      static_cast<bf16*>(v_planes) + plane, page_tables, lengths, k_new,
      v_new, frames, offsets, out, part_m, part_l, part_acc, K, G, P, hd,
      n_pages, n_split, scale, softcap, window, distance, slots, sequential);
  return launch<true, true>(p, B, smem_bytes, static_cast<cudaStream_t>(stream));
}

// K2: the same attention over one layer's (NP, K, P, hd) frames; k_new /
// v_new may be null (no current token), and nothing is written to the pages.
int pul_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                     const int* page_tables, const int* lengths,
                     const void* k_new, const void* v_new, void* out,
                     float* part_m, float* part_l, float* part_acc, int B,
                     int K, int G, int P, int hd, int n_pages, int n_split,
                     float scale, float softcap, int window, int distance,
                     int slots, int sequential, int smem_bytes, void* stream) {
  Params p = make_params(q, const_cast<void*>(k_pages),
                         const_cast<void*>(v_pages), page_tables, lengths,
                         k_new, v_new, nullptr, nullptr, out, part_m, part_l,
                         part_acc, K, G, P, hd, n_pages, n_split, scale,
                         softcap, window, distance, slots, sequential);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k_new != nullptr) return launch<false, true>(p, B, smem_bytes, s);
  return launch<false, false>(p, B, smem_bytes, s);
}

}  // extern "C"
