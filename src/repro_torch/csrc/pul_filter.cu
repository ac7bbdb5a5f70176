// PUL filter with bit-vector or full unloading (K9) for Hopper (sm_90a): the
// predicate row[0] > threshold over a table of f32, bf16 or f16 rows,
// streamed in blocks of `rows` rows through a preload ring, its result
// flushed through an unload ring (the paper's Exp. 5, Fig. 7):
//   * bit-vector: one bit per row, 32 rows per uint32 word, little-endian
//     (bit k of word w is row 32 w + k);
//   * materialize: the rows themselves, in the table's type, zeroed where
//     the predicate is false.
// The threshold arrives rounded to the table's type and widened to f32 (as
// the reference casts it); column 0 is widened to f32, exactly, for the
// compare, so the bits are those of the compare in the table's type.
//
// Replaces the TPU kernel repro/kernels/pul_filter.py : pul_filter
// (_kernel_bitvec, _kernel_materialize).
//
// Bound on this card: bytes. Bit-vector mode needs column 0 of every row and
// writes N / 8 bytes. The card's DRAM moves 64 bytes for any shorter read
// (chip_smoke.sector_probe: a 16- or 32-byte read of each 64-byte row takes
// as long as the whole row; cudaLimitMaxL2FetchGranularity 32 changes
// nothing), so the least it can read is the 64-byte unit holding column 0:
// the whole table where rows are 64 B or shorter (the smoke's f32 table,
// 4.3 GB, 1.28 ms at 3.35 TB/s), half of it for 128-byte rows. Materialize
// reads every row and writes the whole table.
//
// What the design does about that bound:
//   * the TPU kernel runs one sequential program; here the row blocks are cut
//     into runs of consecutive blocks, each walked by one 128-thread block
//     with its own ring, as K5 and K8 cut their traces;
//   * bit-vector (bitvec_kernel): a ring slot holds the first tile_bytes =
//     min(row, 64 B) of each of the block's rows, copied by the TMA unit
//     from one thread: where the tile is narrower than the row, TMA 2D
//     boxes (16 B a row up to 256 B, up to 256 rows a box) from a tensor map
//     over the (N, row bytes) table, unswizzled and with no L2 promotion, so
//     only the units holding column 0 are fetched; where the tile is the row,
//     the block is contiguous and one 1D bulk copy moves it. Each slot
//     completes on its own mbarrier; BATCH issues block i + d after block i
//     is consumed, SEQUENTIAL before (slots >= d + 1). Warp w evaluates rows
//     32 g .. 32 g + 31 for g = w, w + 4, ...: lane k's predicate is bit k
//     of the warp's ballot, so the ballot is the word. By default the host
//     keeps the ring within a third of an SM (filter_ring_plan), so that
//     three blocks share each SM: one block alone, even with eight tiles in
//     flight, does not keep up with its SM's share (half the rate);
//   * materialize (materialize_kernel): a row block is contiguous (rows is a
//     multiple of 32, so it is a whole number of 16-byte granules): it is
//     copied as one run of granules by 16-byte cp.async, thread t taking
//     granules t, t + 128, ..., and a barrier after the wait makes the
//     block visible to every thread;
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
//   * a bulk copy moves whole 16-byte units. A bit-vector block of a number
//     of rows that is not a multiple of 128 is not one (64 rows are 8
//     bytes): there the lanes that hold the words store them straight to
//     global memory, stores that do not block the thread, and with
//     unload_distance = 0 each of them waits for its stores with a fence
//     (__threadfence) before the barrier that ends the block. Either way
//     both distances give the same bits.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pul_hopper.cuh"
#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGranule = 16;
constexpr int kMaxUnloadSlots = 8;
constexpr int kMaxBoxRows = 256;

// the table's element type, as the host names it
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Params {
  const unsigned char* data;  // (n_blocks * rows) rows of row_bytes
  void* out;         // (n_blocks * rows / 32,) words or the table's shape
  float threshold;   // rounded to the table's type, widened to f32
  int n_blocks, rows, row_bytes, run;
  int distance, slots, sequential;
  int uslots, unload_distance;  // uslots = 0: thread stores, no unload ring
  int box_rows, tile_bytes;     // bit-vector: a TMA box, rows x bytes
};

// column 0 of a row, widened to f32 (exact for every type)
template <int DT>
__device__ __forceinline__ float column0(const unsigned char* row) {
  if constexpr (DT == kF32) {
    return *reinterpret_cast<const float*>(row);
  } else if constexpr (DT == kBF16) {
    return __uint_as_float(
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(row)) << 16);
  } else {
    return __half2float(*reinterpret_cast<const __half*>(row));
  }
}

// The result of block i: in unload slot i % uslots when bulk, flushed by
// thread 0; else the lanes' stores went to global memory directly.
__device__ __forceinline__ void flush(const Params& p, bool bulk,
                                      void* dst_g, const void* dst_s,
                                      unsigned bytes) {
  if (bulk) {
    fence_proxy_async();
    __syncthreads();  // the slot is written
    if (threadIdx.x == 0) {
      bulk_store(dst_g, dst_s, bytes);
      bulk_commit();
      if (p.unload_distance == 0) bulk_wait_all();
    }
  } else if (p.unload_distance == 0) {
    __threadfence();  // this thread's stores of the block have landed
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
    bitvec_kernel(const __grid_constant__ CUtensorMap map, Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned slot_bytes = (unsigned)p.rows * p.tile_bytes;
  const unsigned out_bytes = (unsigned)p.rows / 8;
  unsigned char* uring = smem + (size_t)p.slots * slot_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(uring + p.uslots * out_bytes);
  const int b0 = blockIdx.x * p.run;
  const int n = min(p.run, p.n_blocks - b0);
  const bool bulk = p.uslots > 0;
  const float thr = p.threshold;

  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();

  // PRELOAD of stream position i (row block b0 + i) into slot i % slots:
  // the first tile_bytes of each row, in boxes of box_rows rows (thread 0)
  auto issue = [&](int i) {
    if (i >= n) return;
    uint64_t* bar = &full[i % p.slots];
    unsigned char* dst = smem + (size_t)(i % p.slots) * slot_bytes;
    const long long row0 = (long long)(b0 + i) * p.rows;
    mbar_arrive_expect_tx(bar, slot_bytes);
    if (p.tile_bytes == p.row_bytes)  // whole rows: one contiguous span
      bulk_load(dst, p.data + (size_t)row0 * p.row_bytes, slot_bytes, bar);
    else  // the tensor map's rows: fewer than 2^31 (the host checks)
      for (int r = 0; r < p.rows; r += p.box_rows)
        tma_load_2d(dst + (size_t)r * p.tile_bytes, &map, bar, 0,
                    (int)row0 + r);
  };

  const int d = p.distance;
  if (tid == 0)
    for (int i = 0; i < d; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    if (p.sequential && tid == 0) issue(i + d);  // needs slots >= d + 1
    mbar_wait(&full[i % p.slots], (i / p.slots) & 1);
    if (bulk) {
      if (tid == 0) bulk_wait_read_dyn(p.uslots - 1);
      __syncthreads();  // its unload slot is free
    }
    const unsigned char* blk = smem + (size_t)(i % p.slots) * slot_bytes;
    unsigned char* dst_g =
        static_cast<unsigned char*>(p.out) + (size_t)(b0 + i) * out_bytes;
    unsigned char* dst_s =
        bulk ? uring + (size_t)(i % p.uslots) * out_bytes : dst_g;
    for (int g = warp; g < p.rows / 32; g += kWarps) {
      const bool keep =
          column0<DT>(blk + (32 * g + lane) * p.tile_bytes) > thr;
      const unsigned word = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) reinterpret_cast<unsigned*>(dst_s)[g] = word;
    }
    flush(p, bulk, dst_g, dst_s, out_bytes);
    __syncthreads();  // block i consumed: its slot may be reissued
    if (!p.sequential && tid == 0) issue(i + d);
  }
  if (bulk && tid == 0) bulk_wait_all();  // drain before the block exits
}

template <int DT>
__global__ void __launch_bounds__(kThreads) materialize_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const size_t in_bytes = (size_t)p.rows * p.row_bytes;
  unsigned char* uring = smem + (size_t)p.slots * in_bytes;
  const int b0 = blockIdx.x * p.run;
  const int n = min(p.run, p.n_blocks - b0);
  const int chunks = (int)(in_bytes / kGranule);
  const int per_row = p.row_bytes / kGranule;
  const float thr = p.threshold;

  // PRELOAD of stream position i (row block b0 + i) into slot i % slots
  auto issue = [&](int i) {
    if (i < n) {
      const unsigned char* src = p.data + (size_t)(b0 + i) * in_bytes;
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
    if (tid == 0) bulk_wait_read_dyn(p.uslots - 1);
    __syncthreads();  // block i visible to all; its unload slot free
    const unsigned char* blk = smem + (size_t)(i % p.slots) * in_bytes;
    unsigned char* dst_g =
        static_cast<unsigned char*>(p.out) + (size_t)(b0 + i) * in_bytes;
    unsigned char* dst_s = uring + (size_t)(i % p.uslots) * in_bytes;
    // granule c lies in row c / per_row, whose column 0 decides it
    for (int c = tid; c < chunks; c += kThreads) {
      const int row = c / per_row;
      uint4 v = reinterpret_cast<const uint4*>(blk)[c];
      if (!(column0<DT>(blk + (size_t)row * p.row_bytes) > thr))
        v = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(dst_s)[c] = v;
    }
    flush(p, true, dst_g, dst_s, (unsigned)in_bytes);
    __syncthreads();  // block i consumed (its preload slot may be reissued)
    if (!p.sequential) issue(i + d);
  }
  cp_async_wait<0>();
  if (tid == 0) bulk_wait_all();  // drain before the block exits
}

template <class Kernel>
cudaError_t opt_in(Kernel* kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pul::kMaxSmemBytes);
}

template <int DT>
int blocks_per_sm_t(int materialize, int smem_bytes) {
  static const cudaError_t a = opt_in(bitvec_kernel<DT>);
  static const cudaError_t b = opt_in(materialize_kernel<DT>);
  const cudaError_t e = materialize ? b : a;
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n = 0;
  const cudaError_t rc =
      materialize ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &n, materialize_kernel<DT>, kThreads, smem_bytes)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &n, bitvec_kernel<DT>, kThreads, smem_bytes);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

template <int DT>
int launch(const Params& p, int materialize, int grid, int smem_bytes,
           cudaStream_t stream) {
  if (materialize) {
    static const cudaError_t attr = opt_in(materialize_kernel<DT>);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    materialize_kernel<DT><<<grid, kThreads, smem_bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  static const cudaError_t attr = opt_in(bitvec_kernel<DT>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the tensor map serves the TMA 2D path alone: where the tile is the row,
  // the kernel copies whole blocks and never reads it
  CUtensorMap map = {};
  if (p.tile_bytes < p.row_bytes) {
    const int rc = encode_tma_2d_rows(
        &map, p.data, (uint64_t)p.n_blocks * p.rows, (uint64_t)p.row_bytes,
        (uint32_t)p.box_rows, (uint32_t)p.tile_bytes);
    if (rc != 0) return rc;
  }
  bitvec_kernel<DT><<<grid, kThreads, smem_bytes, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of the filter kernel (materialize 0: bit-vector) one SM holds at
// this dynamic shared memory, for the table type dtype (0 f32, 1 bf16,
// 2 f16); negative: minus a CUDA error.
int pul_filter_blocks_per_sm(int materialize, int dtype, int smem_bytes) {
  switch (dtype) {
    case kF32: return blocks_per_sm_t<kF32>(materialize, smem_bytes);
    case kBF16: return blocks_per_sm_t<kBF16>(materialize, smem_bytes);
    case kF16: return blocks_per_sm_t<kF16>(materialize, smem_bytes);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// K9: the predicate row[0] > threshold over n_blocks blocks of `rows` rows
// of row_bytes bytes (values of type dtype: 0 f32, 1 bf16, 2 f16); out
// receives the bit-vector words (materialize 0) or the rows zeroed where
// false (materialize 1). Block b walks row blocks [b * run_len, +run_len).
// uslots > 0: the result leaves through an unload ring of uslots =
// unload_distance + 1 bulk-copy slots; 0: thread stores (bit-vector only).
// Bit-vector slots are rows * tile_bytes (the first tile_bytes of each row,
// a multiple of 16 up to 256) plus an 8-byte mbarrier, filled by TMA boxes
// of box_rows rows from a tensor map where the tile is narrower than the row
// (the table then has fewer than 2^31 rows), else by one bulk copy of the
// block; materialize slots hold whole row blocks.
int pul_filter(const void* data, void* out, float threshold, int n_blocks,
               int rows, int row_bytes, int dtype, int run_len, int grid,
               int distance, int slots, int sequential, int uslots,
               int unload_distance, int materialize, int box_rows,
               int tile_bytes, int smem_bytes, void* stream) {
  const long long in_bytes = materialize ? (long long)rows * row_bytes
                                         : (long long)rows * tile_bytes + 8;
  const long long out_bytes =
      materialize ? (long long)rows * row_bytes : rows / 8;
  if (n_blocks < 1 || rows < 32 || rows % 32 || row_bytes < kGranule ||
      row_bytes % kGranule || dtype < kF32 || dtype > kF16 || run_len < 1 ||
      grid < 1 || (long long)grid * run_len < n_blocks || unload_distance < 0 ||
      uslots < 0 || uslots > kMaxUnloadSlots ||
      (uslots > 0 && (uslots != unload_distance + 1 || out_bytes % kGranule)) ||
      (uslots == 0 && materialize) ||
      (!materialize && (box_rows < 32 || box_rows > kMaxBoxRows ||
                        rows % box_rows || tile_bytes < kGranule ||
                        tile_bytes % kGranule || tile_bytes > row_bytes ||
                        tile_bytes > kMaxBoxRows ||
                        (tile_bytes < row_bytes &&
                         (long long)n_blocks * rows > 0x7fffffffLL))) ||
      reinterpret_cast<uintptr_t>(data) % kGranule ||
      reinterpret_cast<uintptr_t>(out) % kGranule ||
      slots * in_bytes + uslots * out_bytes > smem_bytes ||
      !pul::ring_ok(distance, slots, sequential, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.data = static_cast<const unsigned char*>(data);
  p.out = out;
  p.threshold = threshold;
  p.n_blocks = n_blocks;
  p.rows = rows;
  p.row_bytes = row_bytes;
  p.run = run_len;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  p.uslots = uslots;
  p.unload_distance = unload_distance;
  p.box_rows = box_rows;
  p.tile_bytes = tile_bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<kF32>(p, materialize, grid, smem_bytes, s);
    case kBF16: return launch<kBF16>(p, materialize, grid, smem_bytes, s);
    default: return launch<kF16>(p, materialize, grid, smem_bytes, s);
  }
}

}  // extern "C"
