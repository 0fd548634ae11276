// Per-chunk L1 census for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/chunk_l1norm.py::chunk_l1norm (body _kernel).
//
// norms[c] = sum_i |pool[c * chunk + i]|, accumulated in f32, for an f32 or
// bf16 pool viewed as (C, chunk). CSC selects next step's chunks from these
// norms, so the sum must come out the same bits on every run.
//
// Bound: bytes. Each element is read once (4 B f32, 2 B bf16) for one abs and
// one add; the f32[C] output is negligible. At 4106 x 32768 f32 that is
// 538 MB, 0.161 ms at 3.35 TB/s, against 0.004 ms of f32 operations at
// 67 TFLOP/s. One block a chunk runs in ~3.9 waves, each block draining its
// loads into a __syncthreads reduction before its SM starts the next chunk.
//
// Design (the bulk path, f32 rows of a multiple of 16 bytes on a 16-byte
// aligned base): a persistent grid of at most SMs x CTAs-per-SM CTAs; CTA b
// owns chunks b, b + grid, ... Each CTA has a producer warp and
// kConsumerWarps consumer warps around a ring of S stages of kStageBytes in
// dynamic shared memory. Lane 0 of the producer keeps S bulk loads
// (cp.async.bulk ... mbarrier::complete_tx, with an L2 evict-first policy:
// each byte is read once) in flight and runs ahead across chunk
// boundaries, a chunk being ceil(chunk_bytes / kStageBytes) pieces, so the
// CTA never drains between chunks. The consumers read each stage with
// 16-byte loads, neighbouring threads on neighbouring addresses, add into
// one f32 partial sum each and release the stage (one arrival a warp).
//
// Same bits always: a chunk's summation order depends only on its length.
// Its 16-byte vector g goes to consumer thread g % kConsumers (kStageBytes
// is a multiple of 16 x kConsumers, so a piece boundary never moves a
// vector to another thread), summed as ((|x0| + |x1|) + |x2|) + |x3| and
// added in increasing g; then a butterfly of warp shuffles, then thread 0
// adds the warps' sums in warp order. Neither the CTA that took the chunk
// nor the grid size enters, so the norms are the same bits on every run and
// on a card with another SM count (kernels/chunk_l1norm.py, census_order,
// is this order in numpy).
//
// bf16 pools and rows that are not 16-byte aligned take the block path of
// the earlier design: one block a chunk (grid-stride past the grid's size),
// 16-byte loads where the row's bytes and the base allow it, else one
// element at a time, and the same fixed-order block reduction. The wrapper
// (kernels/chunk_l1norm.py, plan) picks the path, grid and stages; this file
// checks them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kBulkThreads = kConsumers + 32;  // + the producer warp
constexpr long long kStageBytes = 32768;
constexpr long long kMaxBlocks = 1LL << 20;
constexpr int kMaxDevices = 64;
constexpr unsigned long long kTimeoutNs = 10000000000ULL;  // 10 s
constexpr int kPathBulk = 0, kPathVector = 1, kPathElement = 2;
static_assert(kStageBytes % (16 * kConsumers) == 0,
              "a piece boundary must not move a vector to another thread");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// |x| summed over one 16-byte vector of the element type.
__device__ __forceinline__ float vec_abs_sum(uint4 u, float) {
  return fabsf(__uint_as_float(u.x)) + fabsf(__uint_as_float(u.y)) +
         fabsf(__uint_as_float(u.z)) + fabsf(__uint_as_float(u.w));
}
// A bf16 value is the high half of the f32 with the same bits.
__device__ __forceinline__ float bf16_pair_abs_sum(unsigned w) {
  return fabsf(__uint_as_float(w << 16)) +
         fabsf(__uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float vec_abs_sum(uint4 u, __nv_bfloat16) {
  return bf16_pair_abs_sum(u.x) + bf16_pair_abs_sum(u.y) +
         bf16_pair_abs_sum(u.z) + bf16_pair_abs_sum(u.w);
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

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

__global__ void __launch_bounds__(kBulkThreads)
chunk_l1norm_bulk_kernel(const char* __restrict__ pool, long long num_chunks,
                         long long chunk_bytes, int stages,
                         float* __restrict__ norms) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float warp_sums[2][kConsumerWarps];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      smem + stages * kStageBytes);
  unsigned long long* empty = full + stages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pieces = (chunk_bytes + kStageBytes - 1) / kStageBytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_addr(empty + s)), "r"(kConsumerWarps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    if (lane != 0) return;
    // Each byte is read once: evict it from L2 first.
    unsigned long long policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    int s = 0;
    unsigned phase = 0;
    for (long long c = blockIdx.x; c < num_chunks; c += gridDim.x) {
      const char* row = pool + c * chunk_bytes;
      for (long long p = 0; p < pieces; ++p) {
        const long long left = chunk_bytes - p * kStageBytes;
        const unsigned bytes = static_cast<unsigned>(
            left < kStageBytes ? left : kStageBytes);
        mbar_wait(smem_addr(empty + s), phase ^ 1);  // free on the first lap
        const unsigned bar = smem_addr(full + s);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
            :: "r"(smem_addr(smem + s * kStageBytes)),
               "l"(row + p * kStageBytes), "r"(bytes), "r"(bar),
               "l"(policy)
            : "memory");
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // The consumers: threads 0 .. kConsumers - 1.
  int s = 0;
  unsigned phase = 0;
  int parity = 0;
  for (long long c = blockIdx.x; c < num_chunks; c += gridDim.x) {
    float acc = 0.f;
    for (long long p = 0; p < pieces; ++p) {
      const long long left = chunk_bytes - p * kStageBytes;
      const int nvec = static_cast<int>(
          (left < kStageBytes ? left : kStageBytes) / 16);
      mbar_wait(smem_addr(full + s), phase);
      const uint4* v = reinterpret_cast<const uint4*>(smem + s * kStageBytes);
#pragma unroll 8
      for (int i = threadIdx.x; i < nvec; i += kConsumers)
        acc += vec_abs_sum(v[i], float());
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                     :: "r"(smem_addr(empty + s)) : "memory");
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[parity][warp] = acc;
    // The consumers only: the producer is loading the next chunks.
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
    if (threadIdx.x == 0) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) total += warp_sums[parity][w];
      norms[c] = total;
    }
    // warp_sums[parity] is written again two chunks on, after thread 0 has
    // passed the next chunk's barrier.
    parity ^= 1;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
chunk_l1norm_kernel(const T* __restrict__ pool, long long num_chunks,
                    long long chunk, float* __restrict__ norms) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long c = blockIdx.x; c < num_chunks; c += gridDim.x) {
    const T* row = pool + c * chunk;
    float acc = 0.f;
    if (kVec) {
      constexpr int kPerVec = 16 / sizeof(T);
      const uint4* vrow = reinterpret_cast<const uint4*>(row);
      const long long nvec = chunk / kPerVec;
#pragma unroll 4
      for (long long i = threadIdx.x; i < nvec; i += kThreads)
        acc += vec_abs_sum(vrow[i], T());
    } else {
      for (long long i = threadIdx.x; i < chunk; i += kThreads)
        acc += fabsf(to_float(row[i]));
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
      norms[c] = s;
    }
    __syncthreads();  // warp_sums is reused by the block's next chunk
  }
}

template <typename T>
int launch_block(const void* pool, long long num_chunks, long long chunk,
                 bool vec, long long grid, float* norms,
                 cudaStream_t stream) {
  if (grid > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  const T* p = static_cast<const T*>(pool);
  const unsigned g = static_cast<unsigned>(grid);
  if (vec)
    chunk_l1norm_kernel<T, true><<<g, kThreads, 0, stream>>>(
        p, num_chunks, chunk, norms);
  else
    chunk_l1norm_kernel<T, false><<<g, kThreads, 0, stream>>>(
        p, num_chunks, chunk, norms);
  return static_cast<int>(cudaGetLastError());
}

// The bulk kernel's dynamic shared memory above 48 KB must be granted once
// per device; the largest grant so far is kept.
int granted_smem[kMaxDevices];

int launch_bulk(const void* pool, long long num_chunks, long long chunk_bytes,
                long long grid, int stages, float* norms,
                cudaStream_t stream) {
  const long long smem = stages * kStageBytes + 16LL * stages;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > granted_smem[dev]) {
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem + 2 * kConsumerWarps * 4 > optin)
      return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(chunk_l1norm_bulk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted_smem[dev] = static_cast<int>(smem);
  }
  chunk_l1norm_bulk_kernel<<<static_cast<unsigned>(grid), kBulkThreads,
                             static_cast<size_t>(smem), stream>>>(
      static_cast<const char*>(pool), num_chunks, chunk_bytes, stages,
      norms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// plan is the wrapper's launch plan (kernels/chunk_l1norm.py,
// launch_words): {num_chunks, chunk_elems, dtype, path, grid, stage_bytes,
// stages}. dtype codes: 0 = float32, 1 = bfloat16. Path 0 is the bulk path
// (f32 only; stage_bytes must be this file's kStageBytes), 1 the block path
// with 16-byte loads, 2 the block path element by element; grid is the
// number of CTAs. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a plan the path cannot take.
extern "C" int chunk_l1norm_launch(const void* pool, void* norms,
                                   const long long* plan, void* stream) {
  if (plan == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long num_chunks = plan[0], chunk_elems = plan[1],
                  dtype = plan[2], path = plan[3], grid = plan[4],
                  stage_bytes = plan[5], stages = plan[6];
  if (num_chunks <= 0 || chunk_elems <= 0 || dtype < 0 || dtype > 1 ||
      grid <= 0 || grid > num_chunks || pool == nullptr || norms == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(norms);
  const long long chunk_bytes = chunk_elems * (dtype == 0 ? 4 : 2);
  const bool aligned = chunk_bytes % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(pool) % 16 == 0;
  if (path == kPathBulk) {
    if (dtype != 0 || !aligned || stage_bytes != kStageBytes || stages < 2 ||
        stages > 64)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bulk(pool, num_chunks, chunk_bytes, grid,
                       static_cast<int>(stages), out, s);
  }
  if ((path != kPathVector && path != kPathElement) ||
      (path == kPathVector && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_block<float>(pool, num_chunks, chunk_elems,
                               path == kPathVector, grid, out, s);
  return launch_block<__nv_bfloat16>(pool, num_chunks, chunk_elems,
                                     path == kPathVector, grid, out, s);
}
