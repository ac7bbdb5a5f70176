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
// rtol 2e-5, TF32's 10-bit mantissa does not admit; no TF32, no split-TF32)
// and bf16 at bm = 32. Every multiply-add is an fp32 FMA, so the bound is
// the 67 TFLOP/s of the FMA pipes. What takes it below that on this card
// is the data shared memory hands each lane: a value loaded from shared
// memory costs about as much SM time as an FFMA (chip_smoke.fma_feed_probe:
// a 4 x 4 register tile, 2 FMAs a loaded value, runs at 59 % of the peak,
// an 8 x 8 tile, 4 FMAs a value, at 74 %), and the copies into the ring
// draw on the same pipe. What the design does about it:
//   * register tiles (FmaTile): a thread accumulates a TM x TN tile of C,
//     (TM / 4) x (TN / 4) sub-tiles of 4 x 4, TM, TN = 8 where bm, bn = 128
//     and 4 below; a warp is 8 x 4 lanes, so its tile is 8 TM x 4 TN (64 x
//     32 at the default 128 x 128 block, whose 256 threads are 2 x 4
//     warps). A K step loads TM / 4 granules of A and TN / 4 of B, 16 bytes
//     each, for TM TN FMAs: 64 FMAs per 4 LDS.128 at 8 x 8;
//   * A is K-major in shared memory: the ring copies it 4 bytes at a time
//     (cp.async.ca, one f32 or two bf16 K values) into row k of bm words,
//     padded by one 16-byte granule, so a thread's 4 rows are one granule,
//     the 8 lanes of a warp that read different rows read 8 contiguous
//     granules, and the copy's 8 words (K) x 4 rows a warp hit 32 banks. B
//     stays (K, N) row-major, read as 4 contiguous columns. bf16 is widened
//     as it is read (a shift). (A row-major A read four K at a time, with
//     16-byte copies, measured slower: its 32 registers of A fragment);
//   * the K loop over a ring position is kFmaChunk = 16 deep at compile
//     time and unrolled, so the compiler loads step k + 1's fragments while
//     step k's FMAs issue;
//   * the ring (pul_ring.cuh) stays explicit: each stream position is one
//     16-deep chunk of K, the (bm, 16) A tile and the (16, bn) B tile, in
//     slot t % slots, `distance` chunks ahead. BATCH issues chunk t + d
//     after computing chunk t, SEQUENTIAL before (after chunk t's arrival
//     barrier, so one barrier a chunk covers both the arrival and the slot
//     it refills: slots >= d + 1); BATCH with slots == d adds the barrier
//     that frees chunk t's own slot. The host's matmul_ring_plan takes d and
//     slots from PULConfig (8 slots of 24,832 B at the default d = 4 and
//     tiles);
//   * two output tiles a block where they pair up: at 128 x 128 f32 with N
//     a multiple of 256 (the default tiles), a block takes two tiles side
//     by side, 8 x 16 thread tiles (64 x 64 warp tiles): each A chunk, the
//     dear 4-byte copies, serves twice the FMAs, and a K step loads 2 + 4
//     granules for 128 FMAs. The 2048^3 product is then 128 blocks, one
//     wave on 132 SMs;
//   * one 256-thread block an SM: a thread's 64 or 128 accumulators take
//     160 registers or more. Two blocks an SM (128 registers, a ring in
//     half the SM's shared memory) spilled and ran no faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pul_hopper.cuh"
#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kGranule = 16;
// K values of one ring position of the CUDA-core body: the compile-time
// depth of its unrolled K loop (the host's FMA_CHUNK)
constexpr int kFmaChunk = 16;

struct Params {
  const void* a;  // (M, K) row-major
  const void* b;  // (K, N) row-major
  void* c;        // (M, N) row-major, f32 or bf16 (out_bf16)
  int M, N, K;
  int distance, slots, sequential, out_bf16;
};

// 4 bytes global -> shared (cp.async takes copies under 16 bytes only
// through L1, .ca)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// The CUDA-core body's tiles at a (BM, BN) block: thread tile TM x TN,
// (TM / 4) x (TN / 4) sub-tiles of 4 x 4; warp tile 8 TM x 4 TN (8 x 4
// lanes); WC warps along N (the host's matmul_fma_tiles). BN = 256 is two
// 128 x 128 output tiles side by side (fma_block_n)
template <int BM, int BN>
struct FmaTile {
  static constexpr int kTM = BM == 128 ? 8 : 4;
  static constexpr int kTN = BN == 256 ? 16 : BN == 128 ? 8 : 4;
  static constexpr int kWM = 8 * kTM;
  static constexpr int kWN = 4 * kTN;
  static constexpr int kWC = BN / kWN;
  static constexpr int kThreads = 32 * (BM / kWM) * kWC;
};

// the K values of one 4-byte word of A (one f32, or two bf16), widened (a
// bf16 is the high half of its fp32: widening is a shift, exactly)
template <typename T>
__device__ __forceinline__ void unpack_word(uint32_t w, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    out[0] = __uint_as_float(w);
  } else {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
}

// four contiguous B values at smem p (16 bytes f32, 8 bf16), widened
template <typename T>
__device__ __forceinline__ void load_b4(const T* p, float* out) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    unpack_word<T>(x.x, out);
    unpack_word<T>(x.y, out + 2);
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(FmaTile<BM, BN>::kThreads, 1)
    matmul_kernel(Params p) {
  using F = FmaTile<BM, BN>;
  constexpr int NT = F::kThreads, TM = F::kTM, TN = F::kTN, KC = kFmaChunk;
  constexpr int P = 4 / (int)sizeof(T);   // K values of an A word
  constexpr int KW = KC / P;              // A words of a row of the chunk
  constexpr int PER = kGranule / (int)sizeof(T);
  constexpr int GB = BN / PER;            // granules of a B chunk row
  constexpr int AS = BM + 4;              // words of a row of A^T (padded)
  constexpr int NW = NT / 32;
  constexpr int A_BYTES = KW * AS * 4;
  constexpr int SLOT_BYTES = A_BYTES + BN * KC * (int)sizeof(T);
  static_assert(BM % (4 * NW) == 0 && KW % 8 == 0,
                "the A copies of a chunk are whole rounds of the block");
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // this thread's C tile: rows row0 + 32 s + ii, columns col0 + 16 t + jj
  const int row0 = (warp / F::kWC) * F::kWM + (lane % 8) * 4;
  const int col0 = (warp % F::kWC) * F::kWN + (lane / 8) * 4;
  const int i = blockIdx.x, j = blockIdx.y, nk = p.K / KC;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  // this thread's A copies: words (K) ak + 8 h of rows ar + 4 NW q, a warp
  // 8 words of 4 rows (32 banks of A^T's padded rows)
  const int ak = lane % 8, ar = 4 * warp + (lane / 8) % 4;

  // PRELOAD of stream position t (K [t KC, t KC + KC)) into slot t % slots:
  // A transposed, then B
  auto issue = [&](int t) {
    if (t < nk) {
      unsigned char* slot = ring + (size_t)(t % p.slots) * SLOT_BYTES;
      uint32_t* aw = reinterpret_cast<uint32_t*>(slot) + ak * AS + ar;
      T* bs = reinterpret_cast<T*>(slot + A_BYTES);
      const T* a0 = A + ((size_t)i * BM + ar) * p.K + (size_t)t * KC + ak * P;
#pragma unroll
      for (int h = 0; h < KW / 8; ++h)
#pragma unroll
        for (int q = 0; q < BM / (4 * NW); ++q)
          cp_async4(aw + 8 * h * AS + 4 * NW * q,
                    a0 + (size_t)(4 * NW * q) * p.K + 8 * h * P);
      const T* b0 = B + (size_t)t * KC * p.N + (size_t)j * BN;
#pragma unroll
      for (int it = 0; it < (KC * GB + NT - 1) / NT; ++it) {
        const int c = tid + it * NT, r = c / GB, g = c - r * GB;
        if (c < KC * GB)
          cp_async16(bs + r * BN + g * PER, b0 + (size_t)r * p.N + g * PER);
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
  const bool seq = p.sequential, tail = !seq && p.slots == d;
  for (int t = 0; t < d; ++t) issue(t);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait_dyn(d - 1);
    // chunk t visible to every thread, chunk t - 1 consumed by every thread
    __syncthreads();
    if (seq) issue(t + d);  // PL[t + d] -> compute[t], slots >= d + 1
    const unsigned char* slot = ring + (size_t)(t % p.slots) * SLOT_BYTES;
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(slot);
    const T* bs = reinterpret_cast<const T*>(slot + A_BYTES);
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      float a[TM][P];
#pragma unroll
      for (int s = 0; s < TM / 4; ++s) {
        const uint4 w = *reinterpret_cast<const uint4*>(
            aw + k * AS + row0 + 32 * s);
        unpack_word<T>(w.x, a[4 * s]);
        unpack_word<T>(w.y, a[4 * s + 1]);
        unpack_word<T>(w.z, a[4 * s + 2]);
        unpack_word<T>(w.w, a[4 * s + 3]);
      }
#pragma unroll
      for (int kk = 0; kk < P; ++kk) {
        float b[TN];
#pragma unroll
        for (int t4 = 0; t4 < TN / 4; ++t4)
          load_b4<T>(bs + (k * P + kk) * BN + col0 + 16 * t4, b + 4 * t4);
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int v = 0; v < TN; ++v)
            acc[u][v] = fmaf(a[u][kk], b[v], acc[u][v]);
      }
    }
    if (!seq) {
      if (tail) __syncthreads();  // slots == d: chunk t + d refills t's slot
      issue(t + d);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const size_t row = (size_t)i * BM + row0 + 32 * (u / 4) + u % 4;
#pragma unroll
    for (int t4 = 0; t4 < TN / 4; ++t4) {
      const size_t at = row * p.N + (size_t)j * BN + col0 + 16 * t4;
      const float x0 = acc[u][4 * t4], x1 = acc[u][4 * t4 + 1];
      const float x2 = acc[u][4 * t4 + 2], x3 = acc[u][4 * t4 + 3];
      if (p.out_bf16) {
        __nv_bfloat162* c2 =
            reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.c) + at);
        c2[0] = __floats2bfloat162_rn(x0, x1);
        c2[1] = __floats2bfloat162_rn(x2, x3);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(p.c) + at) =
            make_float4(x0, x1, x2, x3);
      }
    }
  }
}

// the CUDA-core body at (T, BM, BN): launch it (launch 1) or count the
// blocks an SM holds (launch 0; negative: minus a CUDA error)
template <typename T, int BM, int BN>
int fma_at(const Params& p, int launch, int smem_bytes, cudaStream_t stream) {
  // the opt-in to the full 227 KB, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_kernel<T, BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pul::kMaxSmemBytes);
  if (attr != cudaSuccess)
    return launch ? static_cast<int>(attr) : -static_cast<int>(attr);
  constexpr int NT = FmaTile<BM, BN>::kThreads;
  if (!launch) {
    int n = 0;
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, matmul_kernel<T, BM, BN>, NT, smem_bytes);
    return rc == cudaSuccess ? n : -static_cast<int>(rc);
  }
  const dim3 grid(p.M / BM, p.N / BN);
  matmul_kernel<T, BM, BN><<<grid, NT, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM>
int fma_bn(const Params& p, int bn, int launch, int smem_bytes,
           cudaStream_t s) {
  switch (bn) {
    case 32: return fma_at<T, BM, 32>(p, launch, smem_bytes, s);
    case 64: return fma_at<T, BM, 64>(p, launch, smem_bytes, s);
    case 128: return fma_at<T, BM, 128>(p, launch, smem_bytes, s);
  }
  return launch ? static_cast<int>(cudaErrorInvalidValue)
                : -static_cast<int>(cudaErrorInvalidValue);
}

// The columns of one block: two 128 x 128 f32 output tiles where N holds
// whole pairs (each A chunk copied once for both: its 4-byte copies are the
// dearest), else one output tile (the host's matmul_fma_block_n)
int fma_block_n(int dtype, int bm, int bn, int N) {
  return dtype == 0 && bm == 128 && bn == 128 && N % 256 == 0 ? 256 : bn;
}

// f32 at every tile; bf16 at bm = 32 (bm >= 64 takes the tensor cores);
// block_n: fma_block_n
int fma_for(const Params& p, int dtype, int bm, int block_n, int launch,
            int smem_bytes, cudaStream_t s) {
  if (dtype == 1 && bm == 32)
    return fma_bn<bf16, 32>(p, block_n, launch, smem_bytes, s);
  if (dtype == 0) {
    switch (bm) {
      case 32: return fma_bn<float, 32>(p, block_n, launch, smem_bytes, s);
      case 64: return fma_bn<float, 64>(p, block_n, launch, smem_bytes, s);
      case 128:
        if (block_n == 256)
          return fma_at<float, 128, 256>(p, launch, smem_bytes, s);
        return fma_bn<float, 128>(p, block_n, launch, smem_bytes, s);
    }
  }
  return launch ? static_cast<int>(cudaErrorInvalidValue)
                : -static_cast<int>(cudaErrorInvalidValue);
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
// (dtype 1, bm = 32 only: bf16 at bm >= 64 is pul_matmul_wgmma's), c f32
// (out_bf16 0) or bf16 (1). Output tiles of (bm, bn) with bm, bn in {32,
// 64, 128}, a block taking fma_block_n columns (two tiles, at 128 x 128 f32
// where N holds whole pairs); A and B stream along K in chunks of bk_chunk
// = 16 columns (kFmaChunk), through `slots` ring slots of (bm + block_n +
// 4) 16 values (A^T's rows padded by a granule).
int pul_matmul(const void* a, const void* b, void* c, int M, int N, int K,
               int bm, int bn, int bk_chunk, int distance, int slots,
               int sequential, int dtype, int out_bf16, int smem_bytes,
               void* stream) {
  const int item = dtype == 0 ? 4 : 2;
  const bool tile_ok = (bm == 32 || bm == 64 || bm == 128) &&
                       (bn == 32 || bn == 64 || bn == 128) &&
                       (dtype == 0 || bm == 32);
  const int block_n = fma_block_n(dtype, bm, bn, N);
  if ((dtype != 0 && dtype != 1) || !tile_ok || M < 1 || N < 1 ||
      bk_chunk != kFmaChunk || M % bm || N % bn || K % kFmaChunk ||
      (N * item) % kGranule || N / bn > 65535 ||
      reinterpret_cast<uintptr_t>(a) % kGranule ||
      reinterpret_cast<uintptr_t>(b) % kGranule ||
      (long long)slots * (bm + block_n + 4) * kFmaChunk * item > smem_bytes ||
      !pul::ring_ok(distance, slots, sequential, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.a = a;
  p.b = b;
  p.c = c;
  p.M = M;
  p.N = N;
  p.K = K;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  p.out_bf16 = out_bf16;
  return fma_for(p, dtype, bm, block_n, 1, smem_bytes,
                 static_cast<cudaStream_t>(stream));
}

// Blocks of K10's CUDA-core body (bm rows, block_n columns: fma_block_n,
// this input type) one SM holds at this dynamic shared memory; negative:
// minus a CUDA error.
int pul_matmul_blocks_per_sm(int bm, int block_n, int dtype, int smem_bytes) {
  Params p = {};
  return fma_for(p, dtype, bm, block_n, 0, smem_bytes, nullptr);
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
