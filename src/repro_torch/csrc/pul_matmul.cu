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
// Two bodies, chosen by the host from the arguments (kernels/pul_matmul.py,
// matmul_body): bf16 inputs with bm in {64, 128} and bn in {32, 64, 128} go
// to the tensor cores, everything else (f32 inputs, bm = 32) to the CUDA
// cores.
//
// The tensor-core body (matmul_wgmma_kernel), what it does about the bound:
//   * one block per (bm, bn) output tile, the TPU's grid (i, j); bm / 64
//     consumer warpgroups each run wgmma m64 n=bn k16 (bf16 in, fp32
//     accumulate) over its 64 rows, the 64 x bn accumulator in registers;
//     one producer warpgroup, which gives its registers back
//     (setmaxnreg.dec), has one thread issue TMA tile loads;
//   * operands: A is K-major, (bm, bkc) tiles by TMA with the swizzle of
//     their bkc * 2-byte rows (128 B at bkc = 64). B is read as (K, N) row-
//     major, MN-major for wgmma: its transpose bit is set, no pass
//     transposes it. TMA loads it in column blocks of 64 values (128-byte
//     swizzle; bn = 32 takes the 64-byte one), so its descriptor's leading
//     offset steps between column blocks and its stride offset between
//     groups of 8 K rows;
//   * the ring (core/pipeline.py PreloadStream / pul_loop) is explicit: a
//     ring position is one K chunk, the (bm, bkc) A tile and the (bkc, bn)
//     B tile, in slot t % slots. Each slot has a FULL mbarrier, which
//     completes when TMA's transaction bytes of chunk t have landed, and an
//     EMPTY mbarrier, which completes when every consumer warp has released
//     the chunk. The producer keeps `distance` chunks in flight ahead of
//     the chunk being consumed: under BATCH it issues chunk t once chunk
//     t - d is released (the release of chunk t - d is the TPU's "compute
//     t - d, then preload t"), under SEQUENTIAL once chunk t - d - 1 is
//     (the preload of t is issued before chunk t - d is computed). slots
//     >= d (BATCH) or d + 1 (SEQUENTIAL) makes the slot of chunk t free by
//     then. The host's matmul_tc_plan takes d and slots from PULConfig
//     (2d BATCH, d + 1 SEQUENTIAL) and clamps them to 227 KB;
//   * a consumer keeps one K chunk's wgmma group in flight: it releases
//     chunk t - 1 once the products of chunk t are issued and those of
//     t - 1 have completed (wgmma.wait_group 1). Under BATCH at d = 1 the
//     producer needs chunk t - 1's release to issue chunk t, so there the
//     consumer waits for chunk t's products and releases chunk t;
//   * a wait on an mbarrier that does not complete within 10 s traps, so a
//     fault of the protocol fails the launch instead of hanging the card;
//   * epilogue: each thread stores its accumulators from registers, cast to
//     the output type. The TPU's C unload ring has no counterpart: blocks
//     run in parallel, and the stores of one overlap the work of others.
//
// The CUDA-core body (matmul_kernel), for f32 (whose reference tolerance,
// rtol 2e-5, TF32's 10-bit mantissa does not admit) and bm = 32:
//   * the block tile is the TPU's output tile, bm x bn = (16 TM) x (16 TN);
//     256 threads as a 16 x 16 grid, thread (ty, tx) accumulating the TM x TN
//     outputs (ty + 16 u, tx + 16 v) in fp32 registers, every multiply-add
//     an fp32 FMA (bf16 inputs widened as they are read);
//   * the ring (pul_ring.cuh): each stream position is one chunk of K, bkc
//     columns of the A tile and bkc rows of the B tile, copied by 16-byte
//     cp.async into slot t % slots, `distance` chunks ahead; BATCH issues
//     chunk t + d after chunk t is consumed, SEQUENTIAL before (slots >=
//     d + 1). The host's matmul_ring_plan picks bkc, a divisor of bk, so
//     that the slots PULConfig asks for fit (bkc = 16 at the default
//     (128, 128, 128) f32 tiles: 8 slots of 16 KB at d = 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pul_hopper.cuh"
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

// ------------------------------------------------------- tensor-core body
struct TcParams {
  void* c;        // (M, N) row-major, f32 or bf16 (out_bf16)
  int M, N, K;
  int bkc;        // K columns of one ring position: 64, 32 or 16
  int distance, slots, sequential, out_bf16;
};

constexpr int kWarpgroup = 128;
constexpr int kSwizzleAlign = 1024;  // a 128-byte swizzle's 8-row atom

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 32)
    wgmma_m64n32k16(d, da, db, 1);
  else if constexpr (BN == 64)
    wgmma_m64n64k16(d, da, db, 1);
  else
    wgmma_m64n128k16(d, da, db, 1);
}

template <int BM, int BN>
__global__ void __launch_bounds__((BM / 64 + 1) * kWarpgroup, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        TcParams p) {
  constexpr int NWG = BM / 64;                  // consumer warpgroups
  constexpr int SWB = BN >= 64 ? 128 : BN * 2;  // bytes of a B tile row
  constexpr int BCOLS = SWB / 2;                // columns of a B block
  constexpr int NB = BN / BCOLS;                // B column blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSwizzleAlign - 1) &
      ~static_cast<uintptr_t>(kSwizzleAlign - 1));
  const int bkc = p.bkc, nk = p.K / bkc, slots = p.slots;
  const int swa = bkc * 2;                      // bytes of an A tile row
  const int a_bytes = BM * swa, tile = a_bytes + BN * swa;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)slots * tile);
  uint64_t* empty = full + slots;
  const int i = blockIdx.x, j = blockIdx.y;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // PRODUCER: chunk t into slot t % slots once chunk t - d (BATCH) or
    // t - d - 1 (SEQUENTIAL) has been released
    setmaxnreg_dec<40>();
    if (threadIdx.x == NWG * kWarpgroup) {
      const int lag = p.distance + (p.sequential ? 1 : 0);
      for (int t = 0; t < nk; ++t) {
        const int r = t - lag;
        if (r >= 0) mbar_wait(&empty[r % slots], (r / slots) & 1);
        const int s = t % slots;
        unsigned char* a_s = smem + (size_t)s * tile;
        mbar_arrive_expect_tx(&full[s], tile);
        tma_load_2d(a_s, &map_a, &full[s], t * bkc, i * BM);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load_2d(a_s + a_bytes + nb * bkc * SWB, &map_b, &full[s],
                      j * BN + nb * BCOLS, t * bkc);
      }
    }
  } else {
    // CONSUMERS: warpgroup wg multiplies rows [64 wg, 64 wg + 64) of A
    float acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    const int lane = threadIdx.x % 32;
    // keep chunk t - 1's group in flight while chunk t's is issued, unless
    // the producer waits for chunk t - 1's release to issue chunk t (BATCH
    // at d = 1)
    const bool hold = p.distance + (p.sequential ? 1 : 0) >= 2;
    for (int t = 0; t < nk; ++t) {
      const int s = t % slots;
      mbar_wait(&full[s], (t / slots) & 1);
      const unsigned char* a_s = smem + (size_t)s * tile + wg * 64 * swa;
      const unsigned char* b_s = smem + (size_t)s * tile + a_bytes;
      wgmma_fence();
      for (int kk = 0; kk < bkc / 16; ++kk)
        wgmma_tile<BN>(acc,
                       smem_desc(a_s + kk * 32, 16, 8 * swa,
                                 swizzle_layout(swa)),
                       smem_desc(b_s + kk * 16 * SWB, bkc * SWB, 8 * SWB,
                                 swizzle_layout(SWB)));
      wgmma_commit();
      if (hold) {
        wgmma_wait<1>();  // chunk t - 1's products are done: release it
        if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % slots]);
      } else {
        wgmma_wait<0>();  // chunk t's products are done: release it
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    wgmma_wait<0>();

    const int w4 = (threadIdx.x / 32) % 4;
    const size_t row = (size_t)i * BM + wg * 64 + 16 * w4 + lane / 4;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const size_t col = (size_t)j * BN + 8 * q + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t at = (row + 8 * h) * p.N + col;
        const float x = acc[4 * q + 2 * h], y = acc[4 * q + 2 * h + 1];
        if (p.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.c) + at) =
              __floats2bfloat162_rn(x, y);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.c) + at) =
              make_float2(x, y);
      }
    }
  }
}

template <int BM, int BN>
int launch_wgmma(const void* a, const void* b, const TcParams& p,
                 int smem_bytes, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_wgmma_kernel<BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, pul::kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int BCOLS = BN >= 64 ? 64 : BN;
  CUtensorMap map_a, map_b;
  int rc = encode_tma_2d_bf16(&map_a, a, p.M, p.K, BM, p.bkc);
  if (rc != 0) return rc;
  rc = encode_tma_2d_bf16(&map_b, b, p.K, p.N, p.bkc, BCOLS);
  if (rc != 0) return rc;
  const dim3 grid(p.M / BM, p.N / BN);
  matmul_wgmma_kernel<BM, BN>
      <<<grid, (BM / 64 + 1) * kWarpgroup, smem_bytes, stream>>>(map_a, map_b,
                                                                 p);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_wgmma_bn(const void* a, const void* b, const TcParams& p, int bn,
                    int smem_bytes, cudaStream_t s) {
  switch (bn) {
    case 32: return launch_wgmma<BM, 32>(a, b, p, smem_bytes, s);
    case 64: return launch_wgmma<BM, 64>(a, b, p, smem_bytes, s);
    case 128: return launch_wgmma<BM, 128>(a, b, p, smem_bytes, s);
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

// K10's tensor-core body: c = a b for row-major bf16 a (M, K), b (K, N), c
// f32 (out_bf16 0) or bf16 (1). Output tiles of (bm, bn), bm in {64, 128},
// bn in {32, 64, 128}; A and B stream along K in chunks of bk_chunk in
// {16, 32, 64} columns, which divides K, through `slots` ring slots of
// (bm + bn) bk_chunk bf16 values and two mbarriers each, behind 1024 bytes
// of alignment: smem_bytes >= slots ((bm + bn) 2 bk_chunk + 16) + 1024.
int pul_matmul_wgmma(const void* a, const void* b, void* c, int M, int N,
                     int K, int bm, int bn, int bk_chunk, int distance,
                     int slots, int sequential, int out_bf16, int smem_bytes,
                     void* stream) {
  const bool tile_ok = (bm == 64 || bm == 128) &&
                       (bn == 32 || bn == 64 || bn == 128) &&
                       (bk_chunk == 16 || bk_chunk == 32 || bk_chunk == 64);
  if (!tile_ok || M < 1 || N < 1 || K < 1 || M % bm || N % bn ||
      K % bk_chunk || (K * 2) % kGranule || (N * 2) % kGranule ||
      N / bn > 65535 || reinterpret_cast<uintptr_t>(a) % kGranule ||
      reinterpret_cast<uintptr_t>(b) % kGranule ||
      (long long)slots * ((bm + bn) * 2 * bk_chunk + 16) + kSwizzleAlign >
          smem_bytes ||
      !pul::ring_ok(distance, slots, sequential, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  TcParams p;
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
  return bm == 64 ? launch_wgmma_bn<64>(a, b, p, bn, smem_bytes, s)
                  : launch_wgmma_bn<128>(a, b, p, bn, smem_bytes, s);
}

}  // extern "C"
