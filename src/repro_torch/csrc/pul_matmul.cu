// PUL matrix product (K10) for Hopper (sm_90a): C = A B with fp32
// accumulation and a cast to the output type, A and B streamed along K
// through a preload ring (the paper's Fig. 1 roofline argument at tile
// granularity).
//
// Replaces the TPU kernel repro/kernels/pul_matmul.py : pul_matmul (_kernel):
// grid (M / bm, N / bn) of output tiles; each grid step streams the
// (bm, bk) tiles of A and (bk, bn) tiles of B along K through distance-d
// rings while the MXU consumes the previous ones, and sends its C tile out
// through a 2-slot unload ring that spans grid steps.
//
// Bound on this card: operations. The product does 2 M N K flops and moves
// A and B once and C once; at 2048^3 f32 that is 17.2 GFLOP, 0.256 ms at the
// data sheet's 67 TFLOP/s fp32 (non-tensor) rate against 0.015 ms of bytes,
// and at 4096^3 bf16 -> f32 137 GFLOP, 0.139 ms at the 989 TFLOP/s bf16
// tensor-core rate against 0.040 ms of bytes.
//
// What the design does, and does not do yet, about that bound:
//   * the block tile is the TPU's output tile, bm x bn = (16 TM) x (16 TN);
//     256 threads as a 16 x 16 grid, thread (ty, tx) accumulating the TM x TN
//     outputs (ty + 16 u, tx + 16 v) in fp32 registers. Every multiply-add
//     is an fp32 FMA on the CUDA cores, also for f32 inputs: no TF32, whose
//     10-bit mantissa the reference's f32 tolerance (rtol 2e-5) does not
//     admit. bf16 inputs are widened to fp32 as they are read; they do not
//     use the tensor cores (mma.sync / wgmma) yet, so the bf16 product runs
//     at the fp32 rate, far from its bound: a later redesign's work;
//   * the ring (core/pipeline.py PreloadStream / pul_loop, pul_ring.cuh):
//     each stream position is one chunk of K, bkc columns of the A tile and
//     bkc rows of the B tile, copied by 16-byte cp.async into slot
//     t % slots, `distance` chunks ahead; BATCH issues chunk t + d after
//     chunk t is consumed, SEQUENTIAL before (slots >= d + 1). The TPU
//     streams whole bk tiles, but at the default (128, 128, 128) f32 tiles
//     one A and B tile pair is 128 KB, so the ring would hold one slot of
//     Hopper's 227 KB; the host's matmul_ring_plan picks bkc, a divisor of
//     bk, so that the slots PULConfig asks for fit (bkc = 16 there: 8 slots
//     of 16 KB at d = 4);
//   * the unload side: each thread stores its C values from registers,
//     cast to the output type. The TPU's C unload ring overlaps one grid
//     step's flush with the next step's compute, since its grid steps run
//     in order on one core; blocks on Hopper run in parallel and share
//     nothing, so that ring has no counterpart: the stores of one block
//     overlap the work of the others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 256;
constexpr int kGranule = 16;

struct Params {
  const void* a;  // (M, K) row-major
  const void* b;  // (K, N) row-major
  void* c;        // (M, N) row-major, f32 or bf16 (out_bf16)
  int M, N, K;
  int bkc;        // K columns of one stream position
  int distance, slots, sequential, out_bf16;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __bfloat162float(x);
}

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kThreads) matmul_kernel(Params p) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i = blockIdx.x, j = blockIdx.y;
  const int bkc = p.bkc, nk = p.K / bkc;
  const size_t slot_elems = (size_t)(BM + BN) * bkc;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  // granules of one A chunk row (bkc values) and of one B chunk row (BN)
  const int ga = bkc * (int)sizeof(T) / kGranule;
  constexpr int gb = BN * (int)sizeof(T) / kGranule;
  constexpr int per = kGranule / (int)sizeof(T);  // values per granule

  // PRELOAD of stream position t (K columns [t * bkc, +bkc)) into slot
  // t % slots: the A chunk (BM, bkc), then the B chunk (bkc, BN)
  auto issue = [&](int t) {
    if (t < nk) {
      T* as = reinterpret_cast<T*>(ring) + (size_t)(t % p.slots) * slot_elems;
      T* bs = as + (size_t)BM * bkc;
      const T* a0 = A + (size_t)i * BM * p.K + (size_t)t * bkc;
      for (int c = tid; c < BM * ga; c += kThreads) {
        const int r = c / ga, g = c - r * ga;
        cp_async16(as + r * bkc + g * per, a0 + (size_t)r * p.K + g * per);
      }
      const T* b0 = B + (size_t)t * bkc * p.N + (size_t)j * BN;
      for (int c = tid; c < bkc * gb; c += kThreads) {
        const int r = c / gb, g = c - r * gb;
        cp_async16(bs + r * BN + g * per, b0 + (size_t)r * p.N + g * per);
      }
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;

  const int d = p.distance;
  for (int t = 0; t < d; ++t) issue(t);
  for (int t = 0; t < nk; ++t) {
    if (p.sequential) {
      issue(t + d);  // PL[t + d] -> compute[t]; needs slots >= d + 1
      cp_async_wait_dyn(d);
    } else {
      cp_async_wait_dyn(d - 1);
    }
    __syncthreads();  // chunk t visible to every thread
    const T* as = reinterpret_cast<const T*>(ring) +
                  (size_t)(t % p.slots) * slot_elems;
    const T* bs = as + (size_t)BM * bkc;
    for (int kk = 0; kk < bkc; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) av[u] = to_f32(as[(ty + 16 * u) * bkc + kk]);
#pragma unroll
      for (int v = 0; v < TN; ++v) bv[v] = to_f32(bs[kk * BN + tx + 16 * v]);
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();  // chunk t consumed: its slot may be reissued
    if (!p.sequential) issue(t + d);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const size_t row = (size_t)i * BM + ty + 16 * u;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const size_t at = row * p.N + (size_t)j * BN + tx + 16 * v;
      if (p.out_bf16)
        static_cast<bf16*>(p.c)[at] = __float2bfloat16_rn(acc[u][v]);
      else
        static_cast<float*>(p.c)[at] = acc[u][v];
    }
  }
}

template <typename T, int TM, int TN>
int launch(const Params& p, int smem_bytes, cudaStream_t stream) {
  // the opt-in to the full 227 KB, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_kernel<T, TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pul::kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(p.M / (16 * TM), p.N / (16 * TN));
  matmul_kernel<T, TM, TN><<<grid, kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// TM, TN in {2, 4, 8}: bm, bn in {32, 64, 128}
template <typename T, int TM>
int launch_tn(const Params& p, int tn, int smem_bytes, cudaStream_t s) {
  switch (tn) {
    case 2: return launch<T, TM, 2>(p, smem_bytes, s);
    case 4: return launch<T, TM, 4>(p, smem_bytes, s);
    case 8: return launch<T, TM, 8>(p, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_tm(const Params& p, int tm, int tn, int smem_bytes, cudaStream_t s) {
  switch (tm) {
    case 2: return launch_tn<T, 2>(p, tn, smem_bytes, s);
    case 4: return launch_tn<T, 4>(p, tn, smem_bytes, s);
    case 8: return launch_tn<T, 8>(p, tn, smem_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K10: c = a b for row-major a (M, K), b (K, N) of f32 (dtype 0) or bf16
// (dtype 1), c f32 (out_bf16 0) or bf16 (1). Output tiles of (bm, bn) with
// bm, bn in {32, 64, 128}; A and B stream along K in chunks of bk_chunk
// columns, which divides K.
int pul_matmul(const void* a, const void* b, void* c, int M, int N, int K,
               int bm, int bn, int bk_chunk, int distance, int slots,
               int sequential, int dtype, int out_bf16, int smem_bytes,
               void* stream) {
  const int item = dtype == 0 ? 4 : 2;
  const bool tile_ok = (bm == 32 || bm == 64 || bm == 128) &&
                       (bn == 32 || bn == 64 || bn == 128);
  if ((dtype != 0 && dtype != 1) || !tile_ok || M < 1 || N < 1 ||
      bk_chunk < 1 || M % bm || N % bn || K % bk_chunk ||
      (bk_chunk * item) % kGranule || (K * item) % kGranule ||
      (N * item) % kGranule || N / bn > 65535 ||
      reinterpret_cast<uintptr_t>(a) % kGranule ||
      reinterpret_cast<uintptr_t>(b) % kGranule ||
      (long long)slots * (bm + bn) * bk_chunk * item > smem_bytes ||
      !pul::ring_ok(distance, slots, sequential, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.a = a;
  p.b = b;
  p.c = c;
  p.M = M;
  p.N = N;
  p.K = K;
  p.bkc = bk_chunk;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  p.out_bf16 = out_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_tm<float>(p, bm / 16, bn / 16, smem_bytes, s)
                    : launch_tm<bf16>(p, bm / 16, bn / 16, smem_bytes, s);
}

}  // extern "C"
