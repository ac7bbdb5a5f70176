// PUL gather (K5) for Hopper (sm_90a): out[i * r + j] = table[trace[i] * r + j]
// for every request i of the trace and row j < r (rows_per_req), through a
// shared-memory preload ring.
//
// Replaces the TPU kernel repro/kernels/pul_gather.py : pul_gather
// (_kernel), which the reference's pul_page_gather calls with the page table
// as the trace and r = page_tokens: the serving engine's assembly path
// (use_pallas_gather=True) gathers each slot's pages of the packed
// (NF, P, F) store into a dense (B, S, F) view.
//
// Bound on this card: bytes. The kernel reads each requested (r, W) slab
// once and writes it once; it does no arithmetic. At the full-width qwen3
// serving geometry (8 slots x 64 pages x 16 rows of 114,688 B) that is
// 2 x 939,524,096 B, 0.56 ms at 3.35 TB/s.
//
// What the design does about that bound:
//   * the TPU block is a whole request, an (r, W) slab: one qwen3 page is
//     16 x 114,688 B = 1.84 MB, beyond the 227 KB of shared memory a block
//     may use. The row is cut into tiles of tile_bytes (the host's
//     gather_ring_plan: a 16 KB ring slot, 1 KB of each of 16 rows); block
//     (run, tile) walks requests [run * run_len, +run_len) of the trace
//     through its ring, copying the (r, tile) slab of each. The last tile of
//     a row that does not divide (deepseek-v2's 6,912 B rows: six 1 KB tiles
//     and one of 768 B) is narrower; nothing is padded;
//   * the preload ring (core/pipeline.py PreloadStream, pul_ring.cuh):
//     16-byte cp.async copies into slot i % slots, `distance` requests
//     ahead, one commit group per stream position (empty past the end) so
//     the runtime distance becomes an immediate wait. BATCH issues i + d
//     after copying i out, SEQUENTIAL before (slots >= d + 1);
//   * the unload side: each thread stores the granules it preloaded itself
//     straight from the ring slot to global memory (16-byte loads and
//     stores). A thread's cp.async.wait_group makes its own copies visible
//     to it, and it issues the next copy into a slot only after, in program
//     order, the stores that consumed the slot's previous contents, so no
//     block-wide barrier is needed. The TPU kernel's unload ring of async
//     copies (UnloadStream) has no counterpart: stores do not block the
//     thread, so they already overlap the preloads in flight;
//   * the kernel moves bytes, never values: the output is the table's bytes
//     for any element type whose rows are whole 16-byte granules (f32, bf16,
//     int32 in the wrapper);
//   * the trace may repeat entries (the engine's page tables point every
//     page past a slot's end at the all-zeros frame 0); the table is only
//     read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 128;
constexpr int kGranule = 16;

struct Params {
  const unsigned char* table;  // (R * r, row_bytes)
  const int* trace;            // (n_req,) request ids
  unsigned char* out;          // (n_req * r, row_bytes)
  int n_req, rows, row_bytes, tile_bytes, run;
  int distance, slots, sequential;
};

__global__ void __launch_bounds__(kThreads) gather_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * p.run;
  const int n = min(p.run, p.n_req - i0);
  const int col = blockIdx.y * p.tile_bytes;
  const int granules = min(p.tile_bytes, p.row_bytes - col) / kGranule;
  const int chunks = p.rows * granules;  // granules of one (r, tile) slab
  const size_t slot_bytes = (size_t)p.rows * p.tile_bytes;
  const size_t row_bytes = p.row_bytes;

  // PRELOAD of stream position i (request i0 + i) into slot i % slots
  auto issue = [&](int i) {
    if (i < n) {
      const size_t src = (size_t)p.trace[i0 + i] * p.rows;
      unsigned char* s = ring + (size_t)(i % p.slots) * slot_bytes;
      for (int c = tid; c < chunks; c += kThreads) {
        const int j = c / granules, g = c - j * granules;
        cp_async16(s + (size_t)c * kGranule,
                   p.table + (src + j) * row_bytes + col + g * kGranule);
      }
    }
    cp_async_commit();
  };

  const int d = p.distance;
  for (int i = 0; i < d; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    if (p.sequential) {
      issue(i + d);  // PL[i + d] -> unload[i]; needs slots >= d + 1
      cp_async_wait_dyn(d);
    } else {
      cp_async_wait_dyn(d - 1);
    }
    const unsigned char* s = ring + (size_t)(i % p.slots) * slot_bytes;
    const size_t dst = (size_t)(i0 + i) * p.rows;
    for (int c = tid; c < chunks; c += kThreads) {
      const int j = c / granules, g = c - j * granules;
      const uint4 v = *reinterpret_cast<const uint4*>(s + (size_t)c * kGranule);
      *reinterpret_cast<uint4*>(p.out + (dst + j) * row_bytes + col +
                                g * kGranule) = v;
    }
    if (!p.sequential) issue(i + d);
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

// K5: out[i * rows + j] = table[trace[i] * rows + j] for i < n_req, j < rows;
// rows are row_bytes long, whole 16-byte granules, 16-byte aligned. Block
// (run, tile) copies columns [tile * tile_bytes, +tile_bytes) of requests
// [run * run_len, +run_len).
int pul_gather(const void* table, const int* trace, void* out, int n_req,
               int rows, int row_bytes, int tile_bytes, int run_len,
               int distance, int slots, int sequential, int smem_bytes,
               void* stream) {
  // the opt-in to the full 227 KB, once (the limit only caps the launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pul::kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n_req < 1 || rows < 1 || run_len < 1 || row_bytes < kGranule ||
      row_bytes % kGranule || tile_bytes < kGranule ||
      tile_bytes % kGranule ||
      reinterpret_cast<uintptr_t>(table) % kGranule ||
      reinterpret_cast<uintptr_t>(out) % kGranule ||
      (long long)slots * rows * tile_bytes > smem_bytes ||
      !pul::ring_ok(distance, slots, sequential, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_runs = (n_req + run_len - 1) / run_len;
  const int n_tiles = (row_bytes + tile_bytes - 1) / tile_bytes;
  if (n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.table = static_cast<const unsigned char*>(table);
  p.trace = trace;
  p.out = static_cast<unsigned char*>(out);
  p.n_req = n_req;
  p.rows = rows;
  p.row_bytes = row_bytes;
  p.tile_bytes = tile_bytes;
  p.run = run_len;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  gather_kernel<<<dim3(n_runs, n_tiles), kThreads, smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
