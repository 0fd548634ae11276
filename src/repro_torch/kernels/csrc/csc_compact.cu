// CSC chunk gather for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/csc_compact.py::csc_compact (body _kernel).
//
// wire[j] = pool_chunks[idx[j]] for the k selected chunk ids: packs the
// chunks CSC transmits into one dense wire buffer. Pure data movement, so
// the copy works on raw bytes and the result is bit-exact for any dtype.
//
// Bound: bytes. Each selected row is read once and written once:
// 2 x k x 32768 x 4 B at f32, 0.048 ms at k = 616 and 0.253 ms at k = 3233 on
// 3.35 TB/s; no arithmetic. A device-to-device copy does not reach that
// rate: back to back, torch.index_select moves 2.5-2.9 TB/s of reads and
// writes on an H100 (kernels/sweep.py). The design aims at that copy rate
// with nothing lost between blocks: no waves of short blocks each ending in
// a drain of its last loads, one drain per CTA at the end.
//
// Design (the bulk path): a persistent grid of at most SMs x CTAs-per-SM
// one-warp CTAs walks the (row, piece) items in a fixed round-robin order,
// item = row * pieces + piece, CTA b taking items b, b + grid, ...; a piece
// is a stage-sized slice of a row. Lane 0 runs a ring of S stages in
// dynamic shared memory with the Tensor Memory Accelerator: a bulk load
// (cp.async.bulk ... mbarrier::complete_tx) of item t into stage t % S, and,
// S - 2 items behind it, a bulk store (cp.async.bulk ... bulk_group) of the
// stage whose load has landed. A stage is loaded again only after
// cp.async.bulk.wait_group.read has seen its store read it, so S - 1 loads
// and the stores behind them stay in flight across row boundaries and the
// CTA drains once, at its end. No thread holds the data in registers. Both
// copies carry an L2 evict-first policy: every byte passes once, and
// without it the same plan fell behind torch.index_select. The
// warp fetches the chunk ids of 32 items at a time, a batch ahead, and
// lane 0 takes each by shuffle; an index outside [0, C) traps the kernel
// (the launch's stream then reports an error) instead of reading out of
// bounds.
//
// The bulk path needs 16-byte aligned bases and a row byte count that is a
// multiple of 16. Other rows take the vector path of the earlier design: a
// 2-D grid, blockIdx.x the output row and blockIdx.y a slice of it, copies
// in the widest unit (up to 8 bytes) that divides the row's bytes and both
// bases, each thread loading kUnitsPerThread units into registers before it
// stores any. The wrapper (kernels/csc_compact.py, plan) picks the path,
// grid, stage bytes and stages; this file checks them.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 8;
constexpr long long kMaxSlices = 65535;
constexpr int kBulkThreads = 32;
constexpr int kMaxDevices = 64;
constexpr unsigned long long kTimeoutNs = 10000000000ULL;  // 10 s
constexpr int kPathBulk = 0;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the phase of parity `parity` of the barrier to complete. A wait
// longer than kTimeoutNs traps the kernel: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > kTimeoutNs) __trap();
  }
}

// An item (row, piece) of a CTA's walk and the stage it goes through; the
// phase is the parity of the stage's use.
struct Cursor {
  long long row, piece;
  int stage;
  unsigned phase;
  __device__ __forceinline__ void step(long long row_step,
                                       long long piece_step,
                                       long long pieces, int stages) {
    row += row_step;
    piece += piece_step;
    if (piece >= pieces) {
      piece -= pieces;
      ++row;
    }
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One warp: lane 0 moves the data; the whole warp fetches chunk ids.
__global__ void __launch_bounds__(kBulkThreads)
csc_compact_bulk_kernel(const char* __restrict__ src,
                        const long long* __restrict__ idx,
                        long long num_chunks, long long row_bytes,
                        long long stage_bytes, long long pieces,
                        long long items, int stages, char* __restrict__ dst) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      smem + static_cast<long long>(stages) * stage_bytes);
  const int lane = threadIdx.x;
  const long long grid = gridDim.x;
  const long long first = blockIdx.x;
  const long long n = (items - first + grid - 1) / grid;  // my items
  const int lag = stages - 2;  // a store trails its load by this many items
  // Each byte is read once and written once here: evict it from L2 first.
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  if (lane == 0) {
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bars + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // Chunk id of my item t: lane t % 32 of the batch that holds t.
  auto fetch = [&](long long t0) -> long long {
    const long long t = t0 + lane;
    return t < n ? idx[(first + t * grid) / pieces] : 0;
  };
  auto check = [&](long long t0, long long c) {
    if (t0 + lane < n && (c < 0 || c >= num_chunks)) __trap();
  };
  long long cur = fetch(0);
  check(0, cur);
  long long next = fetch(32);

  // The load side walks items t = 0, 1, ... and the store side the same
  // items lag behind, each with a cursor stepped by grid items: no 64-bit
  // division in the loop, where a few of them cost more than issuing a
  // copy of a few KiB.
  const long long row_step = grid / pieces, piece_step = grid % pieces;
  Cursor ld{first / pieces, first % pieces, 0, 0};
  Cursor st = ld;
  for (long long t = 0; t < n + lag; ++t) {
    if ((t & 31) == 0 && t > 0 && t < n) {  // uniform across the warp
      cur = next;
      check(t, cur);
      next = fetch(t + 32);
    }
    const long long c = __shfl_sync(0xffffffffu, cur, t & 31);
    if (lane == 0) {
      if (t < n) {  // load item t into stage t % S
        const long long off = ld.piece * stage_bytes;
        const long long left = row_bytes - off;
        const unsigned bytes = static_cast<unsigned>(
            left < stage_bytes ? left : stage_bytes);
        // The store of item t - S, issued before the latest one, must
        // have read the stage.
        if (t >= stages)
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        const unsigned bar = smem_addr(bars + ld.stage);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
            :: "r"(smem_addr(smem + ld.stage * stage_bytes)),
               "l"(src + c * row_bytes + off), "r"(bytes), "r"(bar),
               "l"(policy)
            : "memory");
        ld.step(row_step, piece_step, pieces, stages);
      }
      if (t >= lag) {  // store item t - lag once its load has landed
        const long long off = st.piece * stage_bytes;
        const long long left = row_bytes - off;
        const unsigned bytes = static_cast<unsigned>(
            left < stage_bytes ? left : stage_bytes);
        mbar_wait(smem_addr(bars + st.stage), st.phase);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
            " [%0], [%1], %2, %3;\n"
            :: "l"(dst + st.row * row_bytes + off),
               "r"(smem_addr(smem + st.stage * stage_bytes)), "r"(bytes),
               "l"(policy)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        st.step(row_step, piece_step, pieces, stages);
      }
    }
    __syncwarp();
  }
  // The stores' writes complete with the kernel; shared memory must
  // outlive their reads.
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
csc_compact_kernel(const U* __restrict__ src, const long long* __restrict__ idx,
                   long long num_chunks, long long row_units,
                   U* __restrict__ dst) {
  const long long j = blockIdx.x;
  const long long c = idx[j];
  if (c < 0 || c >= num_chunks) __trap();
  const U* s = src + c * row_units;
  U* d = dst + j * row_units;
  constexpr long long kSpan = static_cast<long long>(kThreads) *
                              kUnitsPerThread;
  for (long long base = blockIdx.y * kSpan; base < row_units;
       base += gridDim.y * kSpan) {
    U v[kUnitsPerThread];
#pragma unroll
    for (int i = 0; i < kUnitsPerThread; ++i) {
      const long long u = base + i * kThreads + threadIdx.x;
      if (u < row_units) v[i] = s[u];
    }
#pragma unroll
    for (int i = 0; i < kUnitsPerThread; ++i) {
      const long long u = base + i * kThreads + threadIdx.x;
      if (u < row_units) d[u] = v[i];
    }
  }
}

template <typename U>
void launch(const void* src, const long long* idx, long long k,
            long long num_chunks, long long row_bytes, long long slices,
            void* dst, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(k), static_cast<unsigned>(slices));
  csc_compact_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(src), idx, num_chunks,
      row_bytes / static_cast<long long>(sizeof(U)), static_cast<U*>(dst));
}

// The bulk kernel's dynamic shared memory above 48 KB must be granted once
// per device; the largest grant so far is kept.
int launch_bulk(const void* src, const long long* idx, long long k,
                long long num_chunks, long long row_bytes, long long grid,
                long long stage_bytes, int stages, void* dst,
                cudaStream_t stream) {
  static int granted_smem[kMaxDevices];
  const long long pieces = (row_bytes + stage_bytes - 1) / stage_bytes;
  const long long items = k * pieces;
  const long long smem = stages * stage_bytes + 8LL * stages;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || grid > items || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > granted_smem[dev]) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(csc_compact_bulk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted_smem[dev] = static_cast<int>(smem);
  }
  csc_compact_bulk_kernel<<<static_cast<unsigned>(grid), kBulkThreads,
                            static_cast<size_t>(smem), stream>>>(
      static_cast<const char*>(src), idx, num_chunks, row_bytes, stage_bytes,
      pieces, items, stages, static_cast<char*>(dst));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Gathers k rows of row_bytes each from a pool of num_chunks rows; idx is
// int64 on the device. plan is the wrapper's launch plan (kernels/
// csc_compact.py, launch_words): {k, num_chunks, row_bytes, path,
// unit_bytes, grid, stage_bytes, stages}. Path 0 is the bulk path (grid
// CTAs, stages stages of stage_bytes); any other path copies in units of
// unit_bytes with grid slices a row. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a plan the path
// cannot take.
extern "C" int csc_compact_launch(const void* pool, const void* idx,
                                  void* out, const long long* plan,
                                  void* stream) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long k = plan[0], num_chunks = plan[1], row_bytes = plan[2],
                  path = plan[3], unit_bytes = plan[4], grid = plan[5],
                  stage_bytes = plan[6], stages = plan[7];
  if (k <= 0 || k > 0x7fffffffLL || num_chunks <= 0 || row_bytes <= 0 ||
      grid <= 0 || pool == nullptr || idx == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long align =
      reinterpret_cast<unsigned long long>(pool) |
      reinterpret_cast<unsigned long long>(out) |
      static_cast<unsigned long long>(row_bytes);
  const long long* ids = static_cast<const long long*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kPathBulk) {
    if (align % 16 != 0 || stage_bytes <= 0 || stage_bytes % 16 != 0 ||
        stage_bytes >= (1LL << 20) || stages < 3 || stages > 64)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bulk(pool, ids, k, num_chunks, row_bytes, grid,
                       stage_bytes, static_cast<int>(stages), out, s);
  }
  if (unit_bytes <= 0 || unit_bytes > 8 || align % unit_bytes != 0 ||
      grid > kMaxSlices)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (unit_bytes) {
    case 8:
      launch<uint2>(pool, ids, k, num_chunks, row_bytes, grid, out, s);
      break;
    case 4:
      launch<unsigned int>(pool, ids, k, num_chunks, row_bytes, grid, out, s);
      break;
    case 2:
      launch<unsigned short>(pool, ids, k, num_chunks, row_bytes, grid, out,
                             s);
      break;
    case 1:
      launch<unsigned char>(pool, ids, k, num_chunks, row_bytes, grid, out,
                            s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
