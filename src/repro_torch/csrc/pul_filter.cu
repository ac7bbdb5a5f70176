// PUL filter with bit-vector or full unloading (K9) for Hopper (sm_90a): the
// predicate row[0] > threshold over a table of f32 rows, streamed in blocks
// of `rows` rows through a preload ring, its result flushed through an
// unload ring (the paper's Exp. 5, Fig. 7):
//   * bit-vector: one bit per row, 32 rows per uint32 word, little-endian
//     (bit k of word w is row 32 w + k);
//   * materialize: the rows themselves, zeroed where the predicate is false.
//
// Replaces the TPU kernel repro/kernels/pul_filter.py : pul_filter
// (_kernel_bitvec, _kernel_materialize): one templated body serves both.
//
// Bound on this card: bytes. The function needs column 0 of every row, one
// 32-byte sector, and writes N / 8 bytes (bit-vector), or also reads the rest
// of each kept row and writes the whole table (materialize). At the smoke's
// table (2^26 rows of 64 B) the bit-vector bound is 2.16 GB, 0.64 ms at
// 3.35 TB/s. The kernel reads every row whole, 4 GiB, as the TPU kernel
// preloads whole row blocks (the paper's record scan, whose unit is the
// row), so in bit-vector mode it moves twice the bytes of its bound.
//
// What the design does about that bound:
//   * the TPU kernel runs one sequential program; here the row blocks are cut
//     into runs of consecutive blocks, each walked by one 128-thread block
//     with its own ring, as K5 and K8 cut their traces;
//   * a row block is contiguous (rows is a multiple of 32, so it is a whole
//     number of 16-byte granules whatever the width): it is copied as one
//     run of granules, thread t taking granules t, t + 128, ..., and a
//     barrier after the wait makes the block visible to every thread. BATCH
//     issues block i + d after block i is consumed, SEQUENTIAL before
//     (slots >= d + 1), with one cp.async commit group per position;
//   * bit-vector: warp w evaluates rows 32 g .. 32 g + 31 for g = w, w + 4,
//     ...; lane k's predicate is bit k of the warp's ballot, so the ballot is
//     the word;
//   * the unload ring (UnloadStream): a block's result is written to slot
//     i % uslots of a shared-memory unload ring and flushed to global memory
//     with one cp.async.bulk store issued by thread 0, in the async proxy
//     (fence.proxy.async first). uslots = unload_distance + 1: before
//     writing slot i % uslots, thread 0 waits with cp.async.bulk.wait_group
//     .read (uslots - 1) for the flush that last read it, so the flushes
//     trail production by unload_distance blocks. unload_distance = 0 is the
//     synchronous flush: thread 0 waits for each flush to complete
//     (cp.async.bulk.wait_group 0) and the barrier that ends the block holds
//     every thread until it has;
//   * a bulk copy moves whole 16-byte units. A bit-vector block of fewer
//     than 128 rows, or of a number of rows that is not a multiple of 128,
//     is not one (64 rows are 8 bytes): there the lanes that hold the words
//     store them straight to global memory, stores that do not block the
//     thread, and with unload_distance = 0 each of them waits for its stores
//     with a fence (__threadfence) before the barrier that ends the block.
//     Either way both distances give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGranule = 16;
constexpr int kMaxUnloadSlots = 8;

struct Params {
  const float* data;   // (n_blocks * rows, width)
  void* out;           // (n_blocks * rows / 32,) words or (n_blocks * rows, width)
  float threshold;
  int n_blocks, rows, width, run;
  int distance, slots, sequential;
  int uslots, unload_distance;  // uslots = 0: thread stores, no unload ring
};

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           unsigned bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gmem),
      "r"(s), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// the flush that last read unload slot (i % uslots) has read it
__device__ __forceinline__ void bulk_wait_read_dyn(int n) {
  switch (n) {
#define PUL_BULK_WAIT_CASE(i) \
  case i:                     \
    bulk_wait_read<i>();      \
    break;
    PUL_BULK_WAIT_CASE(0) PUL_BULK_WAIT_CASE(1) PUL_BULK_WAIT_CASE(2)
    PUL_BULK_WAIT_CASE(3) PUL_BULK_WAIT_CASE(4) PUL_BULK_WAIT_CASE(5)
    PUL_BULK_WAIT_CASE(6) PUL_BULK_WAIT_CASE(7)
#undef PUL_BULK_WAIT_CASE
    default:
      bulk_wait_read<0>();
      break;
  }
}

// every flush issued so far has completed: its writes are done
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes become visible to the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <bool kMaterialize>
__global__ void __launch_bounds__(kThreads) filter_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t in_bytes = (size_t)p.rows * p.width * sizeof(float);
  const size_t out_bytes = kMaterialize ? in_bytes : (size_t)p.rows / 8;
  unsigned char* uring = smem + (size_t)p.slots * in_bytes;
  const int b0 = blockIdx.x * p.run;
  const int n = min(p.run, p.n_blocks - b0);
  const int chunks = (int)(in_bytes / kGranule);
  const bool bulk = p.uslots > 0;
  const float thr = p.threshold;

  // PRELOAD of stream position i (row block b0 + i) into slot i % slots
  auto issue = [&](int i) {
    if (i < n) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(p.data) + (b0 + i) * in_bytes;
      unsigned char* s = smem + (size_t)(i % p.slots) * in_bytes;
      for (int c = tid; c < chunks; c += kThreads)
        cp_async16(s + (size_t)c * kGranule, src + (size_t)c * kGranule);
    }
    cp_async_commit();
  };

  const int d = p.distance;
  for (int i = 0; i < d; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    if (p.sequential) {
      issue(i + d);  // PL[i + d] -> filter[i]; needs slots >= d + 1
      cp_async_wait_dyn(d);
    } else {
      cp_async_wait_dyn(d - 1);
    }
    if (bulk && tid == 0) bulk_wait_read_dyn(p.uslots - 1);
    __syncthreads();  // block i visible to all; its unload slot free
    const float* blk =
        reinterpret_cast<const float*>(smem + (size_t)(i % p.slots) * in_bytes);
    unsigned char* dst_g =
        static_cast<unsigned char*>(p.out) + (size_t)(b0 + i) * out_bytes;
    unsigned char* dst_s = bulk ? uring + (size_t)(i % p.uslots) * out_bytes
                                : dst_g;
    if constexpr (kMaterialize) {
      // granule c holds values 4c .. 4c + 3, all of row 4c / width
      for (int c = tid; c < chunks; c += kThreads) {
        const int row = 4 * c / p.width;
        uint4 v = reinterpret_cast<const uint4*>(blk)[c];
        if (!(blk[(size_t)row * p.width] > thr)) v = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(dst_s)[c] = v;
      }
    } else {
      for (int g = warp; g < p.rows / 32; g += kWarps) {
        const bool keep = blk[(size_t)(32 * g + lane) * p.width] > thr;
        const unsigned word = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) reinterpret_cast<unsigned*>(dst_s)[g] = word;
      }
    }
    if (bulk) {
      fence_proxy_async();
      __syncthreads();  // the slot is written
      if (tid == 0) {
        bulk_store(dst_g, dst_s, (unsigned)out_bytes);
        if (p.unload_distance == 0) bulk_wait_all();
      }
    } else if (p.unload_distance == 0) {
      __threadfence();  // this thread's stores of block i have landed
    }
    __syncthreads();  // block i consumed (its preload slot may be reissued)
    if (!p.sequential) issue(i + d);
  }
  cp_async_wait<0>();
  if (bulk && tid == 0) bulk_wait_all();  // drain before the block exits
}

template <bool M>
cudaError_t opt_in() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      filter_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pul::kMaxSmemBytes);
  return attr;
}

template <bool M>
int blocks_per_sm(int smem_bytes) {
  cudaError_t e = opt_in<M>();
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, filter_kernel<M>,
                                                    kThreads, smem_bytes);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <bool M>
int launch(const Params& p, int grid, int smem_bytes, cudaStream_t stream) {
  const cudaError_t attr = opt_in<M>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  filter_kernel<M><<<grid, kThreads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of the filter kernel one SM holds at this dynamic shared memory;
// negative: minus a CUDA error.
int pul_filter_blocks_per_sm(int materialize, int smem_bytes) {
  return materialize ? blocks_per_sm<true>(smem_bytes)
                     : blocks_per_sm<false>(smem_bytes);
}

// K9: the predicate row[0] > threshold over n_blocks blocks of `rows` rows
// of `width` f32 values; out receives the bit-vector words (materialize 0)
// or the rows zeroed where false (materialize 1). Block b walks row blocks
// [b * run_len, +run_len). uslots > 0: the result leaves through an unload
// ring of uslots = unload_distance + 1 bulk-copy slots; 0: thread stores.
int pul_filter(const float* data, void* out, float threshold, int n_blocks,
               int rows, int width, int run_len, int grid, int distance,
               int slots, int sequential, int uslots, int unload_distance,
               int materialize, int smem_bytes, void* stream) {
  const long long in_bytes = (long long)rows * width * 4;
  const long long out_bytes = materialize ? in_bytes : rows / 8;
  if (n_blocks < 1 || rows < 32 || rows % 32 || width < 4 || width % 4 ||
      run_len < 1 || grid < 1 || (long long)grid * run_len < n_blocks ||
      unload_distance < 0 || uslots < 0 || uslots > kMaxUnloadSlots ||
      (uslots > 0 && (uslots != unload_distance + 1 || out_bytes % kGranule)) ||
      (uslots == 0 && materialize) ||
      reinterpret_cast<uintptr_t>(data) % kGranule ||
      reinterpret_cast<uintptr_t>(out) % kGranule ||
      slots * in_bytes + uslots * out_bytes > smem_bytes ||
      !pul::ring_ok(distance, slots, sequential, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.data = data;
  p.out = out;
  p.threshold = threshold;
  p.n_blocks = n_blocks;
  p.rows = rows;
  p.width = width;
  p.run = run_len;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  p.uslots = uslots;
  p.unload_distance = unload_distance;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return materialize ? launch<true>(p, grid, smem_bytes, s)
                     : launch<false>(p, grid, smem_bytes, s);
}

}  // extern "C"
