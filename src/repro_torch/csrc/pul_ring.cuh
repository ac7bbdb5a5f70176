// The PUL preload ring's device helpers, shared by the paged decode kernels
// (pul_paged_decode.cu, pul_paged_mla_decode.cu): 16-byte cp.async copies
// into shared memory, one commit group per stream position, a wait whose
// depth is a runtime distance, and a round-to-nearest warp sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pul {

constexpr float kNegInf = -2.0e38f;
// deepest preload distance the cp.async.wait_group table below covers; the
// host side's MAX_RING_DISTANCE
constexpr int kMaxDistance = 32;
// dynamic shared memory one block may use on Hopper (227 KB); the host
// side's SMEM_LIMIT_BYTES
constexpr int kMaxSmemBytes = 232448;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async.wait_group takes an immediate; the distance is a runtime value
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
#define PUL_WAIT_CASE(i) \
  case i:                \
    cp_async_wait<i>();  \
    break;
    PUL_WAIT_CASE(0) PUL_WAIT_CASE(1) PUL_WAIT_CASE(2) PUL_WAIT_CASE(3)
    PUL_WAIT_CASE(4) PUL_WAIT_CASE(5) PUL_WAIT_CASE(6) PUL_WAIT_CASE(7)
    PUL_WAIT_CASE(8) PUL_WAIT_CASE(9) PUL_WAIT_CASE(10) PUL_WAIT_CASE(11)
    PUL_WAIT_CASE(12) PUL_WAIT_CASE(13) PUL_WAIT_CASE(14) PUL_WAIT_CASE(15)
    PUL_WAIT_CASE(16) PUL_WAIT_CASE(17) PUL_WAIT_CASE(18) PUL_WAIT_CASE(19)
    PUL_WAIT_CASE(20) PUL_WAIT_CASE(21) PUL_WAIT_CASE(22) PUL_WAIT_CASE(23)
    PUL_WAIT_CASE(24) PUL_WAIT_CASE(25) PUL_WAIT_CASE(26) PUL_WAIT_CASE(27)
    PUL_WAIT_CASE(28) PUL_WAIT_CASE(29) PUL_WAIT_CASE(30) PUL_WAIT_CASE(31)
    PUL_WAIT_CASE(32)
#undef PUL_WAIT_CASE
    default:
      cp_async_wait<0>();
      break;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The ring's launch-time invariants, checked by both kernels' launchers:
// a distance the wait table covers, enough slots for the issue order.
inline bool ring_ok(int distance, int slots, int sequential, int smem_bytes) {
  return smem_bytes <= kMaxSmemBytes && distance >= 1 &&
         distance <= kMaxDistance && slots >= distance &&
         (!sequential || slots >= distance + 1);
}

}  // namespace pul
