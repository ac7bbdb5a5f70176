// Absorbed-MLA paged decode attention over PUL-streamed compressed-KV pages,
// for Hopper (sm_90a), as split-KV over the page table on the tensor cores.
//
// Replaces the two MLA kernels of the paged serving decode:
//   K3  repro/kernels/pul_attention.py : pul_paged_sweep_mla_decode_attention
//       (_paged_sweep_mla_decode_kernel) -- one layer of the single-sweep
//       decode over the full (L, NF, P, kvr) / (L, NF, P, dr) planes, with the
//       current token's compressed rows committed in the epilogue;
//   K4  repro/kernels/pul_attention.py : pul_paged_mla_decode_attention
//       (_paged_mla_decode_kernel) -- the same attention over one layer's
//       frames, no commit.
// Each entry point launches the same two kernels: split_kernel (one
// instantiation per accumulator width, shared by K3 and K4; the host hands
// it the layer's plane) and merge_kernel<COMMIT>, whose arithmetic uses
// explicit round-to-nearest intrinsics. So on the same inputs K3 and K4
// produce bitwise-equal `out`.
//
// What it computes, per slot b and query head h: logits over the visible
// positions s < length plus the current token,
//   (q_abs[h] . c[s] + q_rope[h] . r[s]) * scale,
// an fp32 online softmax, and out[h] = sum_s p[s] c[s] / l -- the compressed
// row c is also the value stream (absorbed decode).
//
// Bound on this card: bytes, with the tensor cores. All H query heads share
// each compressed row, so every (kvr + dr)-wide bf16 row feeds
// H * 2 * (2 kvr + dr) flops: about 238 flops per byte at full deepseek-v2
// width (H = 128, kvr = 512, dr = 64), below the bf16 tensor cores' 989
// TFLOP/s over 3.35 TB/s (295 flops per byte) but far above the fp32 CUDA
// cores' 67 TFLOP/s (20 flops per byte). At the smoke's mixed case (8 slots,
// 2857 tokens) the bound is 1.7 us of bytes (0.8 us of bf16 tensor-core
// work), against 11.9 us for the same flops on the fp32 cores.
//
// What bounded the first design (grid (B, H / 8), fp32 FMAs) was the
// latency chain of the longest row: its 63 pages walked one after another
// by each of 16 head blocks, every page read 16 times from L2, the math on
// the CUDA cores. The design:
//   * split-KV: grid (n_split, ceil(H / 64), B). Row b's visible pages are
//     [0, hi), hi = ceil(lengths[b] / P), on the device; split s streams
//     pages [s c, min(hi, (s + 1) c)), c = ceil(hi / n_split), so a long row
//     spreads over every split and a short row leaves splits empty. The
//     host's mla_split_plan picks n_split from the shapes and the SM count
//     alone (never from lengths or the layer), so K3 and K4 get one plan
//     without a host sync;
//   * 64 heads a block (four m16 tiles of mma.sync), so a page crosses L2
//     ceil(H / 64) times a step, twice at 128 heads. A block keeps the heads'
//     q_abs | q_rope as one bf16 (64, F) tile in shared memory, F = kvr +
//     dr rounded up to 16; head rows past H are zero and never written out;
//   * a ring of page slots, each one page's c | r rows side by side in the
//     same (rows, F) layout (rows = P rounded up to 16), filled `distance`
//     pages ahead of the compute -- the port of PreloadStream / pul_loop
//     (core/pipeline.py), page table as the trace. BATCH issues page i + d
//     after computing page i, SEQUENTIAL before. Every shared row is padded
//     by one 16-byte granule, so the eight rows an ldmatrix reads hit eight
//     bank groups. The copies are 1D bulk copies (TMA), one per row and
//     part (a 1 KB c row, a 128 B r row at full width), whose bytes
//     complete the slot's mbarrier; they are spread over the eight warps,
//     since a copy holds its issuing warp for tens of cycles; 16-byte
//     cp.async from every thread, and one warp issuing every bulk copy,
//     were both slower on the card (PERF.md). Only a page's visible rows
//     are copied: rows past `length` in the tail page (the row K3 is about
//     to commit among them) may hold anything in a recycled frame, NaN and
//     Inf included, and the value product multiplies them (0 x Inf = NaN),
//     so those slot rows are zeroed instead;
//   * eight warps: warp w owns m tile w % 4 (16 heads) and half w / 4 of the
//     kvr value columns. Logits S = Q [C | R]^T over a chunk of 16 keys
//     (mma.sync m16n8k16, fp32 accumulate): the two warps of an m tile take
//     half of the F / 16 k-steps each, loading four steps' fragments
//     before their products, and meet in shared memory (double-buffered,
//     one named barrier of the pair a chunk); each adds the other's
//     partial to its own, the same sum in both, so both run the same online
//     softmax on the same numbers with no further exchange;
//   * the online softmax in registers, in base-2 units (the logit times
//     scale * log2 e after the product, so q stays exact in bf16), one
//     ex2.approx a weight, NEG_INF = -2e38 for masked positions; P rounded
//     to bf16 becomes the A operand of O += P C straight from the logits'
//     registers, and l sums the rounded values. C is read from the same ring
//     slot by ldmatrix.trans. A warp's (16, kvr / 2) fp32 accumulator is 128
//     registers at kvr = 512;
//   * each split writes its fp32 (m, l, acc) to a workspace (B, n_split, H[,
//     kvr]) that the wrapper allocates on the caller's stream; an empty split
//     writes m = NEG_INF, l = 0 and no accumulator.
//
// What sets the time now (about 21x the byte bound at the smoke's mixed
// case, PERF.md): each split block's q load before its first page, the
// logits' ldmatrix reads (mma.sync reads a page once per warp and q again
// for every page), and the fp32 workspace's round trip through L2. A
// wgmma body, which reads each operand once per warpgroup, is the next
// step.
//
// A wait on an mbarrier that does not complete within 10 s traps
// (pul_hopper.cuh), so a protocol fault fails the launch.
//
// The merge, grid (ceil(H / 8), B), a warp a head: the current token's logit
// q_abs . c_new + q_rope . r_new, M = the largest of it and the non-empty
// splits' m (the merge recomputes the split layout from lengths and reads
// no other), out = (sum_s acc_s 2^(m_s - M) + p_new c_new) / max(sum_s l_s
// 2^(m_s - M) + p_new, 1e-30). The TPU kernel's constants stay: NEG_INF for
// masked logits, l >= 1e-30, the current token (always visible) folded in
// last, so with length == 0, out == c_new.
//
// The commit (K3) is the merge's: block (0, b) alone writes c_new / r_new to
// row offsets[b] of (layer, frames[b]). That row is position length, which
// no split reads (its slot row is zero-filled), and every split has finished
// reading its pages by then (stream order), so no block can see a torn row.
// Inactive slots point at the pool's TRASH frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pul_hopper.cuh"
#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 256;  // eight warps: four m tiles x two halves
constexpr int kWarps = kThreads / 32;
// query heads of a split block (the host's MLA_HEADS): four m16 tiles
constexpr int kHeads = 64;
// keys of one chunk: two n8 tiles of S, one k-step of P C
constexpr int kTok = 16;
constexpr int kPad = 8;  // bf16 pad of every shared row: one granule
// the pair exchange of the logits' partial sums: parity x m tile x half x
// (two float4 per lane)
constexpr int kXchgFloats = 2 * 4 * 2 * 2 * 32 * 4;
constexpr int kMergeHeads = 8;    // heads of one merge block: a warp each
constexpr int kMaxSplits = 256;   // the host's MLA_MAX_SPLITS
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q_abs;       // (B, H, kvr)
  const bf16* q_rope;      // (B, H, dr)
  bf16* ckv;               // this layer's frames (NF, P, kvr)
  bf16* kr;                // this layer's frames (NF, P, dr)
  const int* page_tables;  // (B, n_pages) physical frame per logical page
  const int* lengths;      // (B,) cached tokens per slot
  const bf16* c_new;       // (B, kvr) the current token's compressed row
  const bf16* r_new;       // (B, dr)
  const int* frames;       // (B,) commit frame (K3)
  const int* offsets;      // (B,) commit row (K3)
  bf16* out;               // (B, H, kvr)
  float* part_m;           // (B, n_split, H) split maxima, base-2 units
  float* part_l;           // (B, n_split, H) split sums
  float* part_acc;         // (B, n_split, H, kvr) split accumulators
  int H, P, kvr, dr, n_pages, n_split;
  int F;                   // features of a shared row: kvr + round16(dr)
  int rows;                // rows of a ring slot: P rounded up to kTok
  float scale;
  int distance, slots, sequential;
};

// 2^x by the SFU (ex2.approx: 2 ulp; 2^-2e38 = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// the two warps of m tile mt (warps mt and mt + 4) meet
__device__ __forceinline__ void pair_sync(int mt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + mt), "r"(2 * 32) : "memory");
}

// Block (split, head block, b): heads [64 hb, 64 hb + 64) over the pages of
// one split of row b. NT bounds the n8 tiles of a warp's accumulator
// (kvr / 16 of them; tiles past that are never touched).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1) split_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 3, half = warp >> 2;
  const int H = p.H, P = p.P, kvr = p.kvr, dr = p.dr, F = p.F;
  const int RS = F + kPad;  // elements of a shared row

  const int length = p.lengths[b];
  const int hi = min((length + P - 1) / P, p.n_pages);
  const int per = (hi + p.n_split - 1) / p.n_split;
  const int t0 = split * per;
  const int n = max(0, min(hi, t0 + per) - t0);
  const size_t state = ((size_t)b * p.n_split + split) * H;
  float* wm = p.part_m + state;
  float* wl = p.part_l + state;
  float* wa = p.part_acc + state * kvr;
  if (n == 0) {  // nothing here: a split the merge does not read
    for (int h = h0 + tid; h < min(H, h0 + kHeads); h += kThreads) {
      wm[h] = kNegInf;
      wl[h] = 0.f;
    }
    return;
  }

  const int slot_elems = p.rows * RS;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // slots x (rows, RS)
  bf16* q_s = ring + (size_t)p.slots * slot_elems;  // (kHeads, RS)
  float4* xchg = reinterpret_cast<float4*>(q_s + kHeads * RS);
  // one mbarrier a slot, then q's
  uint64_t* full = reinterpret_cast<uint64_t*>(xchg + kXchgFloats / 4);
  uint64_t* q_full = full + p.slots;
  if (tid == 0) {
    for (int k = 0; k <= p.slots; ++k) mbar_init(&full[k], 1);
    fence_mbar_init();
  }

  // zeros that no copy writes: columns [kvr + dr, F) of every row (dr not
  // a multiple of 16), slot rows [P, rows), and q rows of heads past H
  const int gF = F / 8;  // granules of a shared row
  const int q_rows = min(kHeads, H - h0);
  if (F != kvr + dr || p.rows != P || q_rows < kHeads) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    const int ring_rows = p.slots * p.rows;
    for (int e = tid; e < (ring_rows + kHeads) * gF; e += kThreads) {
      const int r = e / gF, g = e - r * gF;
      const bool pad_row =
          r < ring_rows ? r % p.rows >= P : r - ring_rows >= q_rows;
      if (pad_row || g * 8 >= kvr + dr)
        *reinterpret_cast<uint4*>(ring + (size_t)r * RS + g * 8) = z;
    }
  }
  __syncthreads();  // the barriers are initialised

  // Copies are 1D bulk copies (TMA), a row's c and r parts one copy each,
  // spread over the warps (copy k from warp k % 8), since a copy holds its
  // issuing warp for tens of cycles; their bytes complete the slot's
  // barrier, whose expected bytes thread 0 announces (the count may run
  // ahead of the announcement: the phase waits for thread 0's arrival).
  // The q rows of the heads first.
  const int c_bytes = kvr * (int)sizeof(bf16), r_bytes = dr * (int)sizeof(bf16);
  const int g_row = (kvr + dr) / 8;  // 16-byte granules of a token's c | r
  const int k_first = warp + kWarps * lane;  // this thread's first copy
  if (tid == 0) mbar_arrive_expect_tx(q_full, q_rows * (c_bytes + r_bytes));
  {
    const size_t hq = (size_t)b * H + h0;
    for (int k = k_first; k < 2 * q_rows; k += kThreads) {
      const int r = k >> 1;
      if (k & 1)
        bulk_load(q_s + r * RS + kvr, p.q_rope + (hq + r) * dr, r_bytes,
                  q_full);
      else
        bulk_load(q_s + r * RS, p.q_abs + (hq + r) * kvr, c_bytes, q_full);
    }
  }

  // PRELOAD of stream block i (logical page t0 + i) into ring slot i % slots
  // (kept as a counter, as is the slot computed on). Only the page's
  // visible rows are copied; the rest of the slot's rows are zeroed, so
  // whatever a recycled frame holds past `length` (NaN, Inf) never reaches
  // the products. A slot's zeroes are seen by its consumers through the
  // block barrier that every issue is separated from its compute by.
  const int* pt = p.page_tables + (size_t)b * p.n_pages + t0;
  int fill = 0, use = 0;
  uint32_t phase = 0;  // parity of the slot `use`'s next completion
  auto issue = [&](int i) {
    if (i < n) {
      const int vis = min(P, length - (t0 + i) * P);
      bf16* slot = ring + (size_t)fill * slot_elems;
      uint64_t* bar = &full[fill];
      if (++fill == p.slots) fill = 0;
      for (int e = tid; e < (P - vis) * g_row; e += kThreads) {
        const int r = vis + e / g_row;
        *reinterpret_cast<uint4*>(slot + r * RS + (e % g_row) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      // this thread's generic accesses to the slot (the zeroes, the reads of
      // earlier rounds) before any later async write to it
      fence_proxy_async();
      if (tid == 0) mbar_arrive_expect_tx(bar, vis * (c_bytes + r_bytes));
      if (k_first < 2 * vis) {
        const size_t frame = (size_t)pt[i];
        const bf16* cf = p.ckv + frame * P * kvr;
        const bf16* rf = p.kr + frame * P * dr;
        for (int k = k_first; k < 2 * vis; k += kThreads) {
          const int r = k >> 1;
          if (k & 1)
            bulk_load(slot + r * RS + kvr, rf + (size_t)r * dr, r_bytes, bar);
          else
            bulk_load(slot + r * RS, cf + (size_t)r * kvr, c_bytes, bar);
        }
      }
    }
  };

  // ldmatrix lane addresses (as K7's tensor-core body): Q as A (rows l % 16,
  // columns + 8 (l / 16)), the keys' [C | R] rows as B (keys 8 (l / 16) +
  // l % 8, features + 8 ((l / 8) % 2)), C as B transposed (keys 8 ((l / 8)
  // % 2) + l % 8, columns + 8 (l / 16))
  const bf16* q_lane = q_s + (mt * 16 + (lane & 15)) * RS + (lane >> 4) * 8;
  const int k_off = ((lane >> 4) * 8 + (lane & 7)) * RS + ((lane >> 3) & 1) * 8;
  const int col0 = half * (kvr / 2);
  const int v_off =
      (((lane >> 3) & 1) * 8 + (lane & 7)) * RS + col0 + (lane >> 4) * 8;
  const int KS = F / 16, ks_half = (KS + 1) / 2;
  const int ks0 = half * ks_half, ks1 = min(KS, ks0 + ks_half);
  const int nt = kvr / 16;  // n8 tiles of this warp's columns
  const float scale2 = __fmul_rn(p.scale, kLog2e);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int par = 0;

  const int d = p.distance;
  for (int i = 0; i < d; ++i) issue(i);
  mbar_wait(q_full, 0);
  for (int i = 0; i < n; ++i) {
    mbar_wait(&full[use], phase);  // page i landed
    __syncthreads();  // ... for every thread; page i - 1 consumed
    if (p.sequential) issue(i + d);  // PL[i + d] -> compute[i]; slots >= d + 1
    const bf16* slot = ring + (size_t)use * slot_elems;
    if (++use == p.slots) {
      use = 0;
      phase ^= 1;
    }
    const int vis = min(P, length - (t0 + i) * P);
    for (int c0 = 0; c0 < vis; c0 += kTok) {
      const bf16* ck = slot + c0 * RS;
      // this warp's share of S = Q [C | R]^T in two accumulator chains; the
      // fragments of four k-steps are loaded before their products, so a
      // load's latency is paid once per four steps, not at every step
      float sa[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[u][t][e] = 0.f;
      for (int ks = ks0; ks < ks1; ks += 4) {
        uint32_t a[4][4], kb[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (ks + u < ks1) {
            ldmatrix_x4(a[u], q_lane + (ks + u) * 16);
            ldmatrix_x4(kb[u], ck + k_off + (ks + u) * 16);
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (ks + u < ks1) {
            mma_bf16_16816(sa[u & 1][0], a[u], kb[u][0], kb[u][1]);
            mma_bf16_16816(sa[u & 1][1], a[u], kb[u][2], kb[u][3]);
          }
        }
      }
      float s[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[t][e] = __fadd_rn(sa[0][t][e], sa[1][t][e]);
      // the pair's halves meet: each adds the other's to its own, the same
      // sum in both warps (a + b == b + a)
      float4* mine = xchg + ((par * 4 + mt) * 2 + half) * 64;
      const float4* other = xchg + ((par * 4 + mt) * 2 + (half ^ 1)) * 64;
      mine[lane] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
      mine[32 + lane] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
      pair_sync(mt);
      const float4 o0 = other[lane], o1 = other[32 + lane];
      par ^= 1;
      const float ov[2][4] = {{o0.x, o0.y, o0.z, o0.w},
                              {o1.x, o1.y, o1.z, o1.w}};

      // scale to base-2 units, mask, and the online max over the quad
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = c0 + 8 * t + 2 * (lane & 3) + (e & 1);
          const float x =
              j < vis ? __fmul_rn(__fadd_rn(s[t][e], ov[t][e]), scale2)
                      : kNegInf;
          s[t][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
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
      // the accumulator is rescaled only where a row's maximum moved
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
      }
      // P = 2^(S - m) rounded to bf16, in the A layout of P C (masked keys
      // give 2^-2e38 = 0); l sums the rounded values
      uint32_t pa[4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 pb = __floats2bfloat162_rn(
              fast_exp2(s[t][2 * h] - m[h]), fast_exp2(s[t][2 * h + 1] - m[h]));
          const float2 pf = __bfloat1622float2(pb);
          l[h] += pf.x + pf.y;
          pa[h + 2 * t] = *reinterpret_cast<const uint32_t*>(&pb);
        }
      // O += P C over this warp's columns, 64 at a time: four transposed
      // fragment loads, then their eight products
#pragma unroll
      for (int g = 0; g < (NT / 2 + 3) / 4; ++g) {
        uint32_t vb[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int dp = 4 * g + u;
          if (dp < NT / 2 && dp < nt / 2)
            ldmatrix_x4_trans(vb[u], ck + v_off + dp * 16);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int dp = 4 * g + u;
          if (dp < NT / 2 && dp < nt / 2) {
            mma_bf16_16816(acc[2 * dp], pa, vb[u][0], vb[u][1]);
            mma_bf16_16816(acc[2 * dp + 1], pa, vb[u][2], vb[u][3]);
          }
        }
      }
    }
    if (!p.sequential) {
      if (p.slots <= d) __syncthreads();  // slot i % slots is reloaded next
      issue(i + d);
    }
  }

  // the split's state: m and l from the first half (the second holds the
  // same), each warp its accumulator columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int row = h0 + mt * 16 + (lane >> 2) + 8 * h;
    if (row >= H) continue;
    if (half == 0 && (lane & 3) == 0) {
      wm[row] = m[h];
      wl[row] = lh;
    }
    float* arow = wa + (size_t)row * kvr + col0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt)
        *reinterpret_cast<float2*>(arow + 8 * j) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// Block (head chunk, b): heads [8 hc, 8 hc + 8) of row b, a warp each for
// the current token's logit, the splits' weights and the sum l; then every
// thread folds groups of four accumulator columns over the non-empty
// splits. K3 (COMMIT) also writes c_new / r_new, from block (0, b) alone.
template <bool COMMIT>
__global__ void __launch_bounds__(kThreads) merge_kernel(Params p) {
  __shared__ float s_w[kMergeHeads][kMaxSplits];  // 2^(m_s - M) per head
  __shared__ float s_pn[kMergeHeads], s_l[kMergeHeads];
  const int hc = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = p.H, kvr = p.kvr, dr = p.dr, S = p.n_split;
  const int h0 = hc * kMergeHeads, nh = min(kMergeHeads, H - h0);
  // the split layout of row b, as the split kernel cut it: splits [0, ns)
  // hold pages, the rest are empty
  const int length = p.lengths[b];
  const int hi = min((length + p.P - 1) / p.P, p.n_pages);
  const int per = (hi + S - 1) / S;
  const int ns = per > 0 ? (hi + per - 1) / per : 0;
  const size_t st = (size_t)b * S;  // (b, s, h) is (st + s) H + h
  const bf16* cn = p.c_new + (size_t)b * kvr;
  const bf16* rn = p.r_new + (size_t)b * dr;

  if (warp < nh) {
    const int h = h0 + warp;
    // the token's q . [c_new | r_new], a 16-byte granule of each a lane
    // step, every granule's loads issued before the sums wait on them
    const size_t bh = (size_t)b * H + h;
    const uint4* qa = reinterpret_cast<const uint4*>(p.q_abs + bh * kvr);
    const uint4* qr = reinterpret_cast<const uint4*>(p.q_rope + bh * dr);
    const uint4* c4n = reinterpret_cast<const uint4*>(cn);
    const uint4* r4n = reinterpret_cast<const uint4*>(rn);
    const int gkv = kvr / 8, g_all = (kvr + dr) / 8;
    float dot = 0.f;
#pragma unroll 4
    for (int g = lane; g < g_all; g += 32) {
      const uint4 qv = g < gkv ? qa[g] : qr[g - gkv];
      const uint4 cv = g < gkv ? c4n[g] : r4n[g - gkv];
      const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
      const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // a bf16 is the high half of its fp32: widening is a shift, exactly
        dot = __fmaf_rn(__uint_as_float(qw[k] << 16),
                        __uint_as_float(cw[k] << 16), dot);
        dot = __fmaf_rn(__uint_as_float(qw[k] & 0xffff0000u),
                        __uint_as_float(cw[k] & 0xffff0000u), dot);
      }
    }
    dot = warp_sum(dot);  // the same value in every lane
    const float x_new = __fmul_rn(dot, __fmul_rn(p.scale, kLog2e));
    float M = x_new;
    for (int s = lane; s < ns; s += 32)
      M = fmaxf(M, p.part_m[(st + s) * H + h]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < ns; s += 32) {
      const size_t k = (st + s) * H + h;
      const float w = fast_exp2(__fsub_rn(p.part_m[k], M));
      s_w[warp][s] = w;
      L = __fmaf_rn(p.part_l[k], w, L);
    }
    L = warp_sum(L);
    if (lane == 0) {
      const float pn = fast_exp2(__fsub_rn(x_new, M));
      s_pn[warp] = pn;
      s_l[warp] = fmaxf(__fadd_rn(L, pn), 1e-30f);
    }
  }
  __syncthreads();

  // each thread folds kEl groups of four columns at once, the splits in
  // order, four splits' loads in flight a group
  constexpr int kEl = 4;
  const int c4 = kvr / 4, n_el = nh * c4;
  for (int e0 = tid; e0 < n_el; e0 += kThreads * kEl) {
    float A[kEl][4];
    int hl[kEl], col[kEl];
#pragma unroll
    for (int u = 0; u < kEl; ++u) {
      const int e = min(e0 + u * kThreads, n_el - 1);
      hl[u] = e / c4;
      col[u] = (e - hl[u] * c4) * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k) A[u][k] = 0.f;
    }
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      float4 a[kEl];
#pragma unroll
      for (int u = 0; u < kEl; ++u)
        a[u] = *reinterpret_cast<const float4*>(
            p.part_acc + ((st + s) * H + h0 + hl[u]) * kvr + col[u]);
#pragma unroll
      for (int u = 0; u < kEl; ++u) {
        const float w = s_w[hl[u]][s];
        A[u][0] = __fmaf_rn(a[u].x, w, A[u][0]);
        A[u][1] = __fmaf_rn(a[u].y, w, A[u][1]);
        A[u][2] = __fmaf_rn(a[u].z, w, A[u][2]);
        A[u][3] = __fmaf_rn(a[u].w, w, A[u][3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kEl; ++u) {
      if (e0 + u * kThreads >= n_el) continue;
      const float pn = s_pn[hl[u]], L = s_l[hl[u]];
      const uint2 cu = *reinterpret_cast<const uint2*>(cn + col[u]);
      const __nv_bfloat162* cb = reinterpret_cast<const __nv_bfloat162*>(&cu);
      const float2 c01 = __bfloat1622float2(cb[0]);
      const float2 c23 = __bfloat1622float2(cb[1]);
      const __nv_bfloat162 o01 = __floats2bfloat162_rn(
          __fdiv_rn(__fmaf_rn(pn, c01.x, A[u][0]), L),
          __fdiv_rn(__fmaf_rn(pn, c01.y, A[u][1]), L));
      const __nv_bfloat162 o23 = __floats2bfloat162_rn(
          __fdiv_rn(__fmaf_rn(pn, c23.x, A[u][2]), L),
          __fdiv_rn(__fmaf_rn(pn, c23.y, A[u][3]), L));
      uint2 o;
      o.x = *reinterpret_cast<const uint32_t*>(&o01);
      o.y = *reinterpret_cast<const uint32_t*>(&o23);
      bf16* orow = p.out + ((size_t)b * H + h0 + hl[u]) * kvr;
      *reinterpret_cast<uint2*>(orow + col[u]) = o;
    }
  }

  if (COMMIT && hc == 0) {
    const size_t row = (size_t)p.frames[b] * p.P + p.offsets[b];
    bf16* cd = p.ckv + row * kvr;
    bf16* rd = p.kr + row * dr;
    for (int e = tid; e < kvr / 8; e += kThreads)
      *reinterpret_cast<uint4*>(cd + e * 8) =
          *reinterpret_cast<const uint4*>(cn + e * 8);
    for (int e = tid; e < dr / 8; e += kThreads)
      *reinterpret_cast<uint4*>(rd + e * 8) =
          *reinterpret_cast<const uint4*>(rn + e * 8);
  }
}

template <int NT>
int launch_split(const Params& p, int B, int smem_bytes, cudaStream_t stream) {
  // The opt-in to the full 227 KB is set once per instantiation (the limit
  // only caps the launch; occupancy follows smem_bytes), not on every launch.
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  split_kernel<NT><<<dim3(p.n_split, (p.H + kHeads - 1) / kHeads, B),
                     kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool COMMIT>
int launch(Params p, int B, int smem_bytes, cudaStream_t stream) {
  if (p.kvr < 32 || p.kvr > 512 || p.kvr % 32 || p.dr < 8 || p.dr % 8 ||
      p.P < 1 || p.H < 1 || B < 1 || B > 65535 || p.n_pages < 1 ||
      (p.H + kHeads - 1) / kHeads > 65535 || p.n_split < 1 ||
      p.n_split > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  p.F = p.kvr + (p.dr + 15) / 16 * 16;
  p.rows = (p.P + kTok - 1) / kTok * kTok;
  const long long need =
      ((long long)p.slots * p.rows + kHeads) * (p.F + kPad) * sizeof(bf16) +
      kXchgFloats * sizeof(float) + (p.slots + 1) * sizeof(uint64_t);
  if (!ring_ok(p.distance, p.slots, p.sequential, smem_bytes) ||
      need > smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = p.kvr / 16;
  const int rc = nt <= 2   ? launch_split<2>(p, B, smem_bytes, stream)
                 : nt <= 8 ? launch_split<8>(p, B, smem_bytes, stream)
                           : launch_split<32>(p, B, smem_bytes, stream);
  if (rc != 0) return rc;
  merge_kernel<COMMIT><<<dim3((p.H + kMergeHeads - 1) / kMergeHeads, B),
                         kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q_abs, const void* q_rope, void* ckv, void* kr,
                   const int* page_tables, const int* lengths,
                   const void* c_new, const void* r_new, const int* frames,
                   const int* offsets, void* out, float* part_m,
                   float* part_l, float* part_acc, int H, int P, int kvr,
                   int dr, int n_pages, int n_split, float scale, int distance,
                   int slots, int sequential) {
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
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.H = H;
  p.P = P;
  p.kvr = kvr;
  p.dr = dr;
  p.n_pages = n_pages;
  p.n_split = n_split;
  p.F = 0;
  p.rows = 0;
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
// (layer, frames[b], offsets[b]). part_m / part_l (B, n_split, H) and
// part_acc (B, n_split, H, kvr) are the fp32 workspace of the splits.
int pul_paged_sweep_mla_decode(const void* q_abs, const void* q_rope,
                               void* ckv_planes, void* kr_planes,
                               const int* page_tables, const int* lengths,
                               const void* c_new, const void* r_new,
                               const int* frames, const int* offsets,
                               void* out, float* part_m, float* part_l,
                               float* part_acc, int B, int H, int P, int kvr,
                               int dr, int n_pages, int NF, int layer,
                               int n_split, float scale, int distance,
                               int slots, int sequential, int smem_bytes,
                               void* stream) {
  const size_t plane = (size_t)layer * NF * P;  // rows before this layer's
  Params p = make_params(
      q_abs, q_rope, static_cast<bf16*>(ckv_planes) + plane * kvr,
      static_cast<bf16*>(kr_planes) + plane * dr, page_tables, lengths, c_new,
      r_new, frames, offsets, out, part_m, part_l, part_acc, H, P, kvr, dr,
      n_pages, n_split, scale, distance, slots, sequential);
  return launch<true>(p, B, smem_bytes, static_cast<cudaStream_t>(stream));
}

// K4: the same attention over one layer's (NP, P, kvr) / (NP, P, dr) frames;
// nothing is written to the pages.
int pul_paged_mla_decode(const void* q_abs, const void* q_rope,
                         const void* ckv_pages, const void* kr_pages,
                         const int* page_tables, const int* lengths,
                         const void* c_new, const void* r_new, void* out,
                         float* part_m, float* part_l, float* part_acc, int B,
                         int H, int P, int kvr, int dr, int n_pages,
                         int n_split, float scale, int distance, int slots,
                         int sequential, int smem_bytes, void* stream) {
  Params p = make_params(q_abs, q_rope, const_cast<void*>(ckv_pages),
                         const_cast<void*>(kr_pages), page_tables, lengths,
                         c_new, r_new, nullptr, nullptr, out, part_m, part_l,
                         part_acc, H, P, kvr, dr, n_pages, n_split, scale,
                         distance, slots, sequential);
  return launch<false>(p, B, smem_bytes, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
