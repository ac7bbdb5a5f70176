// PUL SUM (K8) for Hopper (sm_90a): the fp32 sum of data[trace[i] * r + j]
// over every request i of the trace and row j < r (rows_per_req), the
// paper's trace-driven random aggregation (Exps. 1, 3, 4), through preload
// rings.
//
// Replaces the TPU kernel repro/kernels/pul_sum.py : pul_sum (_kernel), one
// sequential program that streams the whole trace through one ring of
// (r, W) slabs and adds each slab into one fp32 scalar.
//
// Bound on this card: bytes. The kernel reads each requested (r, W) slab
// once and the trace once, and does one add per value read. At the smoke's
// shape (2^24 requests of one 64-byte row) that is 1,140,850,688 B, 0.34 ms
// at 3.35 TB/s; the adds take a few microseconds of the card's fp32 rate.
//
// What a PE is on this card, and what the design does about the bound:
//   * one sequential program would be one block on one of 132 SMs. The trace
//     is cut into runs of consecutive requests, and each run is walked by one
//     PE with its own ring, as K5 cuts its trace (pul_gather.cu);
//   * a PE is a LANE GROUP: the largest power of two of lanes, at most a
//     warp, that does not exceed the request's 16-byte granules (4 lanes for
//     a 64-byte request, a whole warp from 512 bytes up). Lane l of the
//     group copies granules l, l + lanes, ... of every request into its own
//     part of each ring slot and adds only what it copied. So distance d is
//     requests in flight per PE, as in the paper, and a 64-byte request does
//     not leave 28 lanes of a warp idle: one 128-thread block holds 32 PEs,
//     and at d = 4 an H100 SM holds 12 such blocks, 1,536 requests (96 KB)
//     in flight per SM, beyond the ~2 MB in flight the card needs in all.
//     A request above 56 KB does not fit: four PEs of a block hold one each
//     in every slot, within 227 KB (the host's sum_ring_plan raises);
//   * a lane reads only the granules it copied itself, so its own
//     cp.async.wait_group makes them visible to it: the loop has no barrier,
//     and the lanes of a PE (and the PEs of a warp) never wait for each
//     other. Each lane's part of slot s is granule (s * per_lane + k) *
//     kThreads + tid: a warp's 16-byte shared loads hit consecutive banks;
//   * the ring (core/pipeline.py PreloadStream / pul_loop, pul_ring.cuh):
//     16-byte cp.async copies into slot i % slots, `distance` requests ahead,
//     one commit group per stream position (empty past the end). BATCH issues
//     i + d after adding i, SEQUENTIAL before (slots >= d + 1);
//   * the sum is the same bits on every run: each lane adds its values in
//     request order, a warp adds its lanes by a fixed butterfly, a block its
//     warps in order into partials[block], and a second launch of one block
//     adds the partials in a fixed order. No float atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGranule = 16;

struct Params {
  const unsigned char* data;  // (R * r, W) rows; request t is bytes
                              // [t * req_bytes, +req_bytes)
  const int* trace;           // (n_req,) request ids
  float* partials;            // (gridDim.x,) one sum per block
  int n_req, req_bytes;
  int lanes, per_lane;        // lanes per PE; granules per lane and request
  int run;                    // requests one PE walks
  int distance, slots, sequential;
};

// acc plus the values of one 16-byte granule, in memory order
template <typename T>
__device__ __forceinline__ float add_granule(float acc, uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (std::is_same<T, float>::value) {
      acc += __uint_as_float(w[k]);
    } else {                                       // two bf16, low half first
      acc += __uint_as_float(w[k] << 16);
      acc += __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  return acc;
}

// a block's warps in order; every thread of the block calls it
__device__ __forceinline__ float block_sum(float acc, float* scratch) {
  acc = warp_sum(acc);
  __syncthreads();  // scratch may alias the ring other lanes still read
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = acc;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sum_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x;
  const long long pe = (long long)blockIdx.x * (kThreads / p.lanes) +
                       tid / p.lanes;
  const int lane = tid % p.lanes;
  const int granules = p.req_bytes / kGranule;
  const long long i0 = pe * p.run;
  const int n = (int)max(0LL, min((long long)p.run, p.n_req - i0));
  auto part = [&](int slot, int k) {
    return ring + ((size_t)(slot * p.per_lane + k) * kThreads + tid) * kGranule;
  };

  // PRELOAD of stream position i (request i0 + i) into slot i % slots: this
  // lane's granules of it
  auto issue = [&](int i) {
    if (i < n) {
      const unsigned char* src =
          p.data + (size_t)p.trace[i0 + i] * (size_t)p.req_bytes;
      const int s = i % p.slots;
      for (int k = 0; k < p.per_lane; ++k) {
        const int g = lane + k * p.lanes;
        if (g < granules) cp_async16(part(s, k), src + (size_t)g * kGranule);
      }
    }
    cp_async_commit();
  };

  float acc = 0.f;
  const int d = p.distance;
  for (int i = 0; i < d; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    if (p.sequential) {
      issue(i + d);  // PL[i + d] -> add[i]; needs slots >= d + 1
      cp_async_wait_dyn(d);
    } else {
      cp_async_wait_dyn(d - 1);
    }
    const int s = i % p.slots;
    for (int k = 0; k < p.per_lane; ++k) {
      const int g = lane + k * p.lanes;
      if (g < granules)
        acc = add_granule<T>(acc,
                             *reinterpret_cast<const uint4*>(part(s, k)));
    }
    if (!p.sequential) issue(i + d);
  }
  cp_async_wait<0>();
  const float s = block_sum(acc, reinterpret_cast<float*>(ring));
  if (tid == 0) p.partials[blockIdx.x] = s;
}

// one block: out[0] = the partials added in a fixed order
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* partials, int n, float* out) {
  __shared__ float scratch[kWarps];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  const float s = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[0] = s;
}

template <typename T>
cudaError_t opt_in() {
  // the opt-in to the full 227 KB, once per instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pul::kMaxSmemBytes);
  return attr;
}

template <typename T>
int blocks_per_sm(int smem_bytes) {
  cudaError_t e = opt_in<T>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sum_kernel<T>,
                                                    kThreads, smem_bytes);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <typename T>
int launch(const Params& p, int grid, int smem_bytes, float* out,
           cudaStream_t stream) {
  const cudaError_t attr = opt_in<T>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  sum_kernel<T><<<grid, kThreads, smem_bytes, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_kernel<<<1, kThreads, 0, stream>>>(p.partials, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of the SUM kernel one SM holds at this dynamic shared memory, for
// the host's run split; negative: minus a CUDA error. dtype: 0 f32, 1 bf16.
int pul_sum_blocks_per_sm(int dtype, int smem_bytes) {
  return dtype == 0 ? blocks_per_sm<float>(smem_bytes)
                    : blocks_per_sm<bf16>(smem_bytes);
}

// K8: out[0] = sum over i < n_req of the req_bytes of request trace[i],
// read as f32 (dtype 0) or bf16 (dtype 1) values, in fp32. partials holds
// one float per block of the grid. PE p (block p / (kThreads / lanes)) walks
// requests [p * run_len, +run_len).
int pul_sum(const void* data, const int* trace, float* partials, float* out,
            int n_req, int req_bytes, int lanes, int per_lane, int run_len,
            int grid, int distance, int slots, int sequential, int smem_bytes,
            int dtype, void* stream) {
  const long long pes = (long long)grid * (kThreads / (lanes > 0 ? lanes : 1));
  if (n_req < 1 || req_bytes < kGranule || req_bytes % kGranule ||
      lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || per_lane < 1 ||
      (long long)lanes * per_lane * kGranule < req_bytes || run_len < 1 ||
      grid < 1 || pes * run_len < n_req || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(data) % kGranule ||
      (long long)slots * per_lane * kThreads * kGranule > smem_bytes ||
      smem_bytes < kWarps * (int)sizeof(float) ||
      !pul::ring_ok(distance, slots, sequential, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.data = static_cast<const unsigned char*>(data);
  p.trace = trace;
  p.partials = partials;
  p.n_req = n_req;
  p.req_bytes = req_bytes;
  p.lanes = lanes;
  p.per_lane = per_lane;
  p.run = run_len;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, grid, smem_bytes, out, s)
                    : launch<bf16>(p, grid, smem_bytes, out, s);
}

}  // extern "C"
