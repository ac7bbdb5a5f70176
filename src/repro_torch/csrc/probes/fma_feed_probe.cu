// How fast the CUDA cores run fp32 FMAs whose operands come from shared
// memory, by register tile (a one-off probe behind the register tiles of
// K10's and K7's f32 bodies; built by chip_smoke.fma_feed_probe and by
// nothing else).
//
// Each thread accumulates an NQ x NK tile over steps of 4 K values: a step
// loads NQ + NK 16-byte granules from shared memory (lane (rg, kg) = (l / 8,
// l % 8) reads rows rg + 4 a and kg + 8 b of rows padded by a granule, the
// pattern of K7's S tiles: conflict-free, broadcast within the warp) and
// does 4 NQ NK FMAs, 4 NQ NK / (4 (NQ + NK)) FMAs a loaded value. With
// loads 0 the operands stay in registers: the FMA pipes' own rate. The
// loads are volatile and change address every iteration, so the compiler
// keeps them in the loop.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 36;  // floats of a row: 32 + one granule

__device__ __forceinline__ void lds128(const float* p, float4& v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
}

template <int NQ, int NK, bool LOADS>
__global__ void __launch_bounds__(kThreads, 1)
    fma_feed(float* out, int iters) {
  // 64 q rows, 64 K rows, and the last row's flip past its end
  __shared__ __align__(16) float buf[2 * 64 * kRow + 8];
  for (int i = threadIdx.x; i < 2 * 64 * kRow; i += kThreads)
    buf[i] = 1e-3f * (i & 63);
  __syncthreads();
  const int lane = threadIdx.x % 32, rg = lane / 8, kg = lane % 8;
  const float* qb = buf + rg * kRow;
  const float* kb = buf + 64 * kRow + kg * kRow;
  float acc[NQ][NK];
  float4 q[NQ], k[NK];
#pragma unroll
  for (int a = 0; a < NQ; ++a) {
    q[a] = make_float4(a, 1.f, 2.f, 3.f);
#pragma unroll
    for (int b = 0; b < NK; ++b) acc[a][b] = 0.f;
  }
#pragma unroll
  for (int b = 0; b < NK; ++b) k[b] = make_float4(b, 1.f, 2.f, 3.f);
  for (int it = 0; it < iters; ++it) {
    const int flip = (it & 1) * 8;
#pragma unroll
    for (int d0 = 0; d0 < 32; d0 += 4) {
      if (LOADS) {
#pragma unroll
        for (int a = 0; a < NQ; ++a)
          lds128(qb + 4 * a * kRow + d0 + flip, q[a]);
#pragma unroll
        for (int b = 0; b < NK; ++b)
          lds128(kb + 8 * b * kRow + d0 + flip, k[b]);
      } else {
        q[0].x += 1e-7f;
      }
#pragma unroll
      for (int a = 0; a < NQ; ++a)
#pragma unroll
        for (int b = 0; b < NK; ++b) {
          acc[a][b] = fmaf(q[a].x, k[b].x, acc[a][b]);
          acc[a][b] = fmaf(q[a].y, k[b].y, acc[a][b]);
          acc[a][b] = fmaf(q[a].z, k[b].z, acc[a][b]);
          acc[a][b] = fmaf(q[a].w, k[b].w, acc[a][b]);
        }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < NQ; ++a)
#pragma unroll
    for (int b = 0; b < NK; ++b) s += acc[a][b];
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// Tile `kind` (0: 8 x 8 in registers; 1: 4 x 4, 2: 4 x 8, 3: 8 x 8 from
// shared memory), `iters` x 8 steps, `blocks` blocks of 256 threads (one an
// SM); out holds blocks x 256 floats. Returns the launch's CUDA error.
int fma_feed_probe(int kind, float* out, int iters, int blocks,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      fma_feed<8, 8, false><<<blocks, kThreads, 0, s>>>(out, iters);
      break;
    case 1:
      fma_feed<4, 4, true><<<blocks, kThreads, 0, s>>>(out, iters);
      break;
    case 2:
      fma_feed<4, 8, true><<<blocks, kThreads, 0, s>>>(out, iters);
      break;
    case 3:
      fma_feed<8, 8, true><<<blocks, kThreads, 0, s>>>(out, iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
