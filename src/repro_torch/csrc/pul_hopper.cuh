// Hopper (sm_90a) building blocks of the port's kernels: mbarriers, TMA 2D
// tile loads and their host-side tensor maps, 1D bulk copies between global
// and shared memory (K5's gather), the shared memory descriptors of wgmma for the 32/64/128-byte swizzles, the wgmma
// ops K10 issues (m64 n{32, 64, 128} k16, bf16 in, fp32 accumulate), and
// ldmatrix / mma.sync m16n8k16 for K7's flash attention.
//
// The tensor map is encoded on the host with cuTensorMapEncodeTiled, whose
// entry point the CUDA runtime hands out (cudaGetDriverEntryPoint), so a
// library that uses it links against the runtime only (no -lcuda); kernels
// take the map as a `const __grid_constant__ CUtensorMap` parameter.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pul {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
// A barrier completes a phase when `count` threads have arrived and the
// transaction bytes announced by arrive_expect_tx have landed; waiters name
// the parity of the phase they wait for (k & 1 for the k-th completion).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the inits visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// seconds a wait may take before it traps: a phase that never completes (a
// protocol fault) ends the launch with an error instead of hanging the card
constexpr uint64_t kWaitLimitNs = 10ull * 1000 * 1000 * 1000;

// The clock is read once every 64 polls: a poll that succeeds does not wait
// behind a timer read.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls % 64) continue;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > kWaitLimitNs) {
      __trap();
    }
  }
}

// ------------------------------------------------------------------ TMA
// One 2D tile of the map at (c0 = inner column, c1 = row) into shared
// memory; its bytes count against bar's expected transaction bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// orders this thread's generic-proxy shared-memory accesses before later
// async-proxy ones (TMA, wgmma) on the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------- 1D bulk copies
// One contiguous span of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) copied by the TMA unit in one instruction. A load reports its
// bytes to bar (announced there by arrive_expect_tx); a store joins this
// thread's current bulk group, which bulk_commit closes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's bulk groups are still reading
// their shared-memory source (.read: their global writes may be in flight)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// the same for a runtime count; counts past 32 wait for 32 (earlier, never
// later than asked)
__device__ __forceinline__ void bulk_wait_read_dyn(int n) {
  switch (n) {
#define PUL_BULK_CASE(i)  \
  case i:                 \
    bulk_wait_read<i>();  \
    break;
    PUL_BULK_CASE(0) PUL_BULK_CASE(1) PUL_BULK_CASE(2) PUL_BULK_CASE(3)
    PUL_BULK_CASE(4) PUL_BULK_CASE(5) PUL_BULK_CASE(6) PUL_BULK_CASE(7)
    PUL_BULK_CASE(8) PUL_BULK_CASE(9) PUL_BULK_CASE(10) PUL_BULK_CASE(11)
    PUL_BULK_CASE(12) PUL_BULK_CASE(13) PUL_BULK_CASE(14) PUL_BULK_CASE(15)
    PUL_BULK_CASE(16) PUL_BULK_CASE(17) PUL_BULK_CASE(18) PUL_BULK_CASE(19)
    PUL_BULK_CASE(20) PUL_BULK_CASE(21) PUL_BULK_CASE(22) PUL_BULK_CASE(23)
    PUL_BULK_CASE(24) PUL_BULK_CASE(25) PUL_BULK_CASE(26) PUL_BULK_CASE(27)
    PUL_BULK_CASE(28) PUL_BULK_CASE(29) PUL_BULK_CASE(30) PUL_BULK_CASE(31)
#undef PUL_BULK_CASE
    default:
      bulk_wait_read<32>();
      break;
  }
}

// waits until every bulk group of this thread has completed, its global
// writes included
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major (rows, cols) bf16 matrix read in (box_rows,
// box_cols) tiles, swizzled by the box's row of box_cols * 2 bytes (32, 64
// or 128): the layout wgmma's descriptors below describe. Returns 0 or a
// CUDA error code.
inline int encode_tma_2d_bf16(CUtensorMap* map, const void* base,
                              uint64_t rows, uint64_t cols, uint32_t box_rows,
                              uint32_t box_cols) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const uint32_t bytes = box_cols * 2;
  if (bytes != 32 && bytes != 64 && bytes != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle sw = bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of a table of `rows` rows of row_bytes bytes (a multiple of 16)
// read in (box_rows, box_bytes) tiles from the start of each row: bytes,
// unswizzled, and with no L2 promotion, so a tile of 16-byte columns fetches
// only the sectors it touches. Returns 0 or a CUDA error code.
inline int encode_tma_2d_rows(CUtensorMap* map, const void* base,
                              uint64_t rows, uint64_t row_bytes,
                              uint32_t box_rows, uint32_t box_bytes) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {row_bytes, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_bytes, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------- wgmma
// The descriptor's layout type of a swizzle of `bytes` (128, 64 or 32)
__host__ __device__ constexpr int swizzle_layout(int bytes) {
  return bytes == 128 ? 1 : bytes == 64 ? 2 : 3;
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle's layout type. For a K-major tile
// (rows of `sw` bytes along K) the stride offset is 8 rows, 8 sw bytes, and
// the leading offset is unused; for an MN-major tile the leading offset is
// the step between `sw`-byte column blocks along MN and the stride offset
// the step between groups of 8 K rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a warpgroup that only issues copies gives registers back to the others
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// D (64 x N, fp32, in registers) += A (64 x 16, K-major, descriptor a) B
// (16 x N, MN-major: the transpose bit of B set, descriptor b); scale_d 0
// overwrites D. Register d[i] of thread (warp w, lane l) holds row
// 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ------------------------------------------------------------- mma.sync
// Four 8 x 8 bf16 matrices: lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i; register i of lane l holds its row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 (.trans: its column l / 4, rows 2 (l % 4) and + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D (16 x 8 fp32) += A (16 x 16 bf16, row) B (16 x 8 bf16, col). Lane l
// holds A rows l / 4 (a0, a2) and l / 4 + 8 (a1, a3) at columns 2 (l % 4)
// + {0, 1} (a0, a1) and + 8 (a2, a3); B column l / 4 at rows 2 (l % 4) +
// {0, 1} (b0) and + 8 (b1); D rows l / 4 (d0, d1) and + 8 (d2, d3) at
// columns 2 (l % 4) + {0, 1}.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace pul
