// A measuring aid, not a kernel of the port: how many bytes the card's DRAM
// moves for a short read of each row of a table. sector_probe_kernel reads
// the first `read_bytes` of every row (16-byte loads, neighbouring lanes on
// neighbouring granules, streaming loads that do not stay in L2) and folds
// them into one word, so that the time of a 16-byte read of each 64-byte
// row can be set beside that of whole rows. Built only by
// chip_smoke.sector_probe(), never by the kernel wrappers:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsector_probe.so sector_probe.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGranule = 16;

__global__ void sector_probe_kernel(const unsigned char* data, unsigned* out,
                                    long long n_rows, int row_bytes,
                                    int read_bytes) {
  // unit w is granule w % gpr of row w / gpr: neighbouring lanes read
  // neighbouring granules, each thread four units at a time
  const int shift = __ffs(read_bytes / kGranule) - 1;  // gpr is a power of 2
  const long long n = n_rows << shift;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long mask = (1LL << shift) - 1;
  unsigned acc = 0;
  long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  auto at = [&](long long w) {
    return reinterpret_cast<const uint4*>(data + (w >> shift) * row_bytes) +
           (w & mask);
  };
  for (; u + 3 * stride < n; u += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldcs(at(u + k * stride));
#pragma unroll
    for (int k = 0; k < 4; ++k) acc ^= v[k].x ^ v[k].y ^ v[k].z ^ v[k].w;
  }
  for (; u < n; u += stride) {
    const uint4 v = __ldcs(at(u));
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) atomicXor(out, acc);
}

}  // namespace

extern "C" {

// xor of the first read_bytes (16 B times a power of two) of each of n_rows
// rows of row_bytes into *out; 0 or the launch's CUDA error.
int sector_probe(const void* data, unsigned* out, long long n_rows,
                 int row_bytes, int read_bytes, int grid, void* stream) {
  if (n_rows < 1 || row_bytes % kGranule || read_bytes < kGranule ||
      read_bytes % kGranule || read_bytes > row_bytes || grid < 1 ||
      (read_bytes / kGranule & (read_bytes / kGranule - 1)) ||
      reinterpret_cast<uintptr_t>(data) % kGranule)
    return static_cast<int>(cudaErrorInvalidValue);
  sector_probe_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(data), out, n_rows, row_bytes,
      read_bytes);
  return static_cast<int>(cudaGetLastError());
}

// The device's cudaLimitMaxL2FetchGranularity before this call; bytes >= 0
// sets it (the probe sets it and puts it back).
int l2_fetch_granularity(int bytes) {
  size_t old = 0;
  cudaError_t rc = cudaDeviceGetLimit(&old, cudaLimitMaxL2FetchGranularity);
  if (rc != cudaSuccess) return -static_cast<int>(rc);
  if (bytes >= 0) {
    rc = cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
    if (rc != cudaSuccess) return -static_cast<int>(rc);
  }
  return static_cast<int>(old);
}

}  // extern "C"
