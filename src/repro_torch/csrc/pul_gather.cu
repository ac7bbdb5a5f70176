// PUL gather (K5) for Hopper (sm_90a): out[i * r + j] = table[trace[i] * r + j]
// for every request i of the trace and row j < r (rows_per_req), through a
// shared-memory ring fed and drained by 1D bulk copies (TMA).
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
//   * a request is one contiguous span of r * row_bytes bytes in the table
//     and one in the output (1,835,008 B for a qwen3 page, 110,592 B for a
//     deepseek page). The stream is the sequence of (request, chunk)
//     positions: a chunk is at most chunk_bytes of a span (the host's
//     gather_bulk_plan: 32 KB), the last chunk of a span narrower; nothing
//     is padded. The grid's blocks split the positions evenly, one run
//     each;
//   * one thread per block drives the ring, so a chunk costs two
//     instructions of memory traffic, not 16-byte copies from every thread.
//     The preload ring (core/pipeline.py PreloadStream): position j is
//     loaded into slot j % slots by cp.async.bulk global -> shared, whose
//     bytes complete that slot's "full" mbarrier, `distance` positions
//     ahead of the store. The unload ring (UnloadStream): when position i
//     has landed, cp.async.bulk shared -> global stores it, one bulk group
//     per position. Before a slot is loaded again, cp.async.bulk.wait_group
//     .read makes sure the store of its previous position has read it; the
//     store's global writes stay in flight. BATCH issues the load of i + d
//     after the store of i, SEQUENTIAL before (slots >= d + 1). The host's
//     gather_bulk_plan adds unload_distance slots to the preload ring's, so
//     a reload waits for the store that many positions back, not for the
//     store just issued;
//   * the kernel moves bytes, never values: the output is the table's bytes
//     for any element type whose rows are whole 16-byte granules (f32, bf16,
//     int32 in the wrapper);
//   * the trace may repeat entries (the engine's page tables point every
//     page past a slot's end at the all-zeros frame 0); the table is only
//     read;
//   * a wait on a full mbarrier that does not complete within 10 s traps
//     (pul_hopper.cuh), so a protocol fault fails the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pul_hopper.cuh"
#include "pul_ring.cuh"

namespace {

using namespace pul;

constexpr int kThreads = 32;  // one warp; its lane 0 drives the ring
constexpr int kGranule = 16;

struct Params {
  const unsigned char* table;  // (R * r, row_bytes)
  const int* trace;            // (n_req,) request ids
  unsigned char* out;          // (n_req * r, row_bytes)
  long long n_req, n_pos;      // requests; positions, n_req * chunks
  long long span;              // bytes of one request, r * row_bytes
  int chunks, chunk_bytes;     // chunks of a span, bytes of each
  int last_bytes;              // bytes of a span's last chunk
  int distance, slots, sequential;
};

// A walk over the (request, chunk) positions of a run, one step at a time:
// no division per position, and the next request's table row is read one
// request ahead, so an issue never waits on the trace.
struct Cursor {
  const int* trace;
  long long n_req;
  int chunks, chunk_bytes, last_bytes;
  long long req;   // request of the current position
  int chunk;       // chunk of the current position within its span
  int row;         // trace[req]
  int next_row;    // trace[req + 1] (unused past the end)

  __device__ Cursor(const Params& p, long long pos)
      : trace(p.trace), n_req(p.n_req), chunks(p.chunks),
        chunk_bytes(p.chunk_bytes), last_bytes(p.last_bytes) {
    req = pos / chunks;
    chunk = static_cast<int>(pos - req * chunks);
    row = req < n_req ? trace[req] : 0;
    next_row = req + 1 < n_req ? trace[req + 1] : 0;
  }
  __device__ uint32_t bytes() const {
    return chunk + 1 < chunks ? chunk_bytes : last_bytes;
  }
  __device__ long long offset() const { return (long long)chunk * chunk_bytes; }
  __device__ void advance() {
    if (++chunk < chunks) return;
    chunk = 0;
    ++req;
    row = next_row;
    if (req + 1 < n_req) next_row = trace[req + 1];
  }
};

__global__ void __launch_bounds__(kThreads) gather_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char ring[];
  if (threadIdx.x != 0) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + (size_t)p.slots * p.chunk_bytes);  // one mbarrier per slot
  // this block's run: an even share of the positions
  const long long first = blockIdx.x * p.n_pos / gridDim.x;
  const int n = (int)((blockIdx.x + 1) * p.n_pos / gridDim.x - first);
  for (int s = 0; s < p.slots; ++s) mbar_init(&full[s], 1);
  fence_mbar_init();

  Cursor ld(p, first), st(p, first);  // next position to load, to store
  int stored = 0;  // store groups committed so far
  // PRELOAD of position j (the load cursor's) into slot j % slots, once the
  // store of position j - slots, the slot's previous contents, has read it
  auto load = [&](int j) {
    if (j >= n) return;
    if (j >= p.slots) bulk_wait_read_dyn(stored - (j - p.slots + 1));
    const uint32_t bytes = ld.bytes();
    uint64_t* bar = &full[j % p.slots];
    mbar_arrive_expect_tx(bar, bytes);
    bulk_load(ring + (size_t)(j % p.slots) * p.chunk_bytes,
              p.table + (size_t)ld.row * p.span + ld.offset(), bytes, bar);
    ld.advance();
  };
  // UNLOAD of position i (the store cursor's) once it has landed
  auto store = [&](int i) {
    mbar_wait(&full[i % p.slots], (i / p.slots) & 1);
    bulk_store(p.out + (size_t)st.req * p.span + st.offset(),
               ring + (size_t)(i % p.slots) * p.chunk_bytes, st.bytes());
    bulk_commit();
    ++stored;
    st.advance();
  };

  const int d = p.distance;
  for (int j = 0; j < d; ++j) load(j);
  for (int i = 0; i < n; ++i) {
    if (p.sequential) load(i + d);  // PL[i + d] -> unload[i]
    store(i);
    if (!p.sequential) load(i + d);
  }
  bulk_wait_all();  // the ring's memory ends with the block
}

}  // namespace

extern "C" {

// K5: out[i * rows + j] = table[trace[i] * rows + j] for i < n_req, j < rows;
// a request's span is span_bytes (rows * row_bytes, whole 16-byte granules,
// 16-byte aligned), cut into chunks of chunk_bytes (the last narrower);
// n_runs blocks split the (request, chunk) stream evenly, one run each.
// smem_bytes holds slots chunks and one mbarrier per slot.
int pul_gather(const void* table, const int* trace, void* out, int n_req,
               long long span_bytes, int chunk_bytes, int n_runs,
               int distance, int slots, int sequential, int smem_bytes,
               void* stream) {
  // the opt-in to the full 227 KB, once (the limit only caps the launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pul::kMaxSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n_req < 1 || n_runs < 1 || span_bytes < kGranule ||
      span_bytes % kGranule || chunk_bytes < kGranule ||
      chunk_bytes % kGranule || chunk_bytes > span_bytes ||
      reinterpret_cast<uintptr_t>(table) % kGranule ||
      reinterpret_cast<uintptr_t>(out) % kGranule ||
      (long long)slots * (chunk_bytes + 8) > smem_bytes ||
      !pul::ring_ok(distance, slots, sequential, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.table = static_cast<const unsigned char*>(table);
  p.trace = trace;
  p.out = static_cast<unsigned char*>(out);
  p.span = span_bytes;
  p.chunk_bytes = chunk_bytes;
  p.chunks = static_cast<int>((span_bytes + chunk_bytes - 1) / chunk_bytes);
  p.last_bytes =
      static_cast<int>(span_bytes - (long long)(p.chunks - 1) * chunk_bytes);
  p.n_req = n_req;
  p.n_pos = (long long)n_req * p.chunks;
  p.distance = distance;
  p.slots = slots;
  p.sequential = sequential;
  if (n_runs > p.n_pos) return static_cast<int>(cudaErrorInvalidValue);
  gather_kernel<<<n_runs, kThreads, smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
